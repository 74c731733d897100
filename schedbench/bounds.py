"""The yardstick's peaks and the least time of a `wave_solve` launch.

Peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet,
dense): 3.35 TB/s of HBM and 67 TFLOP/s of float32 outside the tensor
cores. `wave_bound_ms` is a frozen copy of the launch-bound arithmetic of
the repository's chip smoke script (`chip_smoke.wave_bound_ms`).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def wave_bound_ms(p: int, n: int, r: int, c: int, k: int, s: int,
                  feasible_evals: int) -> tuple[float, str]:
    """Least time for one wave_solve launch: the larger of its bytes (each
    input read once, each output written once) over HBM bandwidth and its
    float operations over the fp32 peak. The operations are one live score
    per (order, pod, feasible node), `feasible_evals` summed over orders
    and pods, at 9R + 10 float operations each. p: pods of the chunk as
    launched (padded), n: node columns (padded), r: resource columns, c:
    class rows, k: orders, s: score-shape points."""
    bytes_in = 4 * (2 * p * r + 2 * p + k * p + 3 * n * r + n) \
        + c * math.ceil(n / 8) + 4 * c * n + 5 * r + 8 * s
    bytes_out = 4 * (k * p + 4 * k)
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = feasible_evals * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")
