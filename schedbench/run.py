"""The scheduler benchmark's command.

    python -m schedbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json on cuda:0 and prints, as the last line of
standard output, one JSON object: `correct`, `attempted`, `failed`,
`metrics` (the cell's end-to-end metrics with `--trace 0`, its per-layer
metrics with `--trace 1`), `device` and, traced, `breakdown`; last in it,
`compared`, each number of the check beside its limit, as also printed
last on standard error. `setup` says whether the kernel library was built
in this run (a checkout's first: `setup_s` then counts nvcc's build),
the seconds its build or load took (`kernel_library_s`) and when each
set-up phase ended. `layer_part` is the part of the window, in seconds,
that the per-layer numbers are taken over; an untraced run gives them
over the same part under `layer` (traced, they are `metrics`), and a
traced run gives when its slice started (`trace_start_s`) and its
tracer's warm-up (`trace_warm_up_s`). Exits non-zero, printing no result, without a card,
or when a JAX module is loaded once the window has closed. Kernel and
compiler caches stay in fixed directories under the checkout's `build/`.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(_REPO / "build" / "schedbench" / _sub))
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(_REPO) not in sys.path:
    sys.path.insert(0, str(_REPO))

import argparse  # noqa: E402
import asyncio  # noqa: E402
import json  # noqa: E402

#: top-level module names no run may load (the JAX package's name is a
#: prefix of the port's, so names are compared whole).
FORBIDDEN = {"jax", "jaxlib", "flax", "kubernetes_tpu"}


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def traced_launches(rec, numbers: dict, n_nodes: int, chunk: int) -> list:
    """wave_bound_ms arguments of every wave_solve launch the traced
    dispatches made: one per chunk, four orders, one class row."""
    from schedbench.harness import NODE_PAD
    n_pad = max(NODE_PAD, -(-n_nodes // NODE_PAD) * NODE_PAD)
    traced = {id(d) for d in rec.traced_dispatches}
    out = []
    for d, chunks in zip(numbers["dispatches"], numbers["dispatch_chunks"]):
        if id(d) not in traced:
            continue
        for _route, _p_real, evals in chunks:
            out.append((chunk, n_pad, 2, 2, 4, 2, 4 * evals))
    return out


def execute(spec: dict, seed: int, seconds: float, trace: bool,
            device: str = "cuda:0", fault=None):
    """One run of a cell past the look for a card: (the result's line as a
    dict, the compared rows), or (None, []) when a forbidden module was
    loaded."""
    from schedbench import check, harness

    rec, check_in = asyncio.run(harness.run_cell(
        spec, seed, seconds, trace, device=device, fault=fault))
    found = forbidden_modules()
    if found:
        print(f"schedbench: forbidden modules loaded: {found}",
              file=sys.stderr)
        return None, []
    numbers = check.judge(check_in)
    numbers["dispatches"] = check_in["dispatches"]
    e2e = harness.end_to_end(rec, check_in)
    if "free_occupied_pct" in e2e:
        from schedbench.reference.placement import free_occupied_pct
        cl, tp = check.reference_inputs(check_in)
        idx = {n: i for i, n in enumerate(cl.names)}
        counts = [0] * len(cl.names)
        for k in check_in["first_round_keys"]:
            counts[idx[check_in["final"][k]]] += 1
        import numpy as np
        ref = free_occupied_pct(cl.alloc, np.asarray(counts), tp.req)
        numbers["free_occupied_diff"] = abs(ref - e2e["free_occupied_pct"])
    rows = check.compared(numbers)
    correct = check.is_correct(rows)
    if trace:
        rec.extra["traced_launches"] = traced_launches(
            rec, numbers, len(check_in["nodes"]), check_in["chunk"])
        names = [m["name"] for m in spec["per_layer"]]
        values = harness.per_layer(rec, names)
        units = {m["name"]: m["unit"] for m in spec["per_layer"]}
    else:
        names = [m["name"] for m in spec["end_to_end"]]
        values = {k: e2e[k] for k in names if k in e2e}
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
    device = {"platform": "gpu", "kind": rec.device_kind, "count": int(spec["workload"]["chips"]),
              "memory_peak_bytes": rec.memory_peak_bytes}
    if trace and rec.trace:
        device["busy_s"] = rec.trace["busy_s"]
        device["window_s"] = rec.trace["window_s"]
    compared = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    out = {
        "correct": correct,
        "attempted": len(check_in["created"]),
        "failed": int(numbers["unbound"]),
        "metrics": {k: {"value": values[k], "unit": units[k]}
                    for k in names if k in values},
        "device": device,
    }
    if trace and rec.trace:
        out["breakdown"] = rec.trace["breakdown"]
    out["judged"] = {"pods": numbers["judged"],
                     "misplaced": numbers["misplaced"],
                     "worst_gap": numbers["worst_gap"],
                     "dispatches": len(check_in["dispatches"]),
                     "detail": numbers["detail"][:3]}
    out["rounds"] = rec.extra.get("rounds")
    out["setup"] = {k: rec.extra.get(k) for k in (
        "kernel_cache", "kernel_library_s", "setup_phases")}
    out["layer_part"] = rec.extra.get("layer_part")
    if trace:
        out["trace_start_s"] = rec.extra.get("trace_start_s")
        out["trace_warm_up_s"] = rec.extra.get("trace_warm_up_s")
    else:
        out["layer"] = harness.per_layer(
            rec, [m["name"] for m in spec["per_layer"]])
    out["compared"] = compared
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from schedbench import check, harness

    bench = harness.load_benchmark()
    spec = harness.cell_spec(bench, args.workload)
    chips = int(spec["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"schedbench: {chips} CUDA device(s) needed, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    out, rows = execute(spec, args.seed, args.seconds, bool(args.trace))
    if out is None:
        return 3
    print(f"setup_s {out['setup']}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"compared {k} {v} limit {lim}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
