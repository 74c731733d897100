"""utiltrace: threshold latency tracing (k8s.io/utils/trace).

The scheduler wraps each scheduling attempt in a Trace; steps record
named timestamps, and the whole trace is logged ONLY when total latency
crosses the threshold — the reference's "Trace[...] ... (xx ms)" lines
that make slow attempts debuggable without log spam.
"""

from __future__ import annotations

import logging
import time

logger = logging.getLogger("kubernetes_tpu_torch.trace")


class Trace:
    __slots__ = ("name", "fields", "threshold", "_t0", "_steps")

    def __init__(self, name: str, threshold_ms: float = 100.0, **fields):
        self.name = name
        self.fields = fields
        self.threshold = threshold_ms / 1e3
        self._t0 = time.perf_counter()
        self._steps: list[tuple[float, str]] = []

    def step(self, msg: str) -> None:
        self._steps.append((time.perf_counter(), msg))

    def __enter__(self) -> "Trace":
        return self

    def __exit__(self, *exc) -> None:
        self.log()

    def log(self) -> None:
        total = time.perf_counter() - self._t0
        if total < self.threshold:
            return
        fields = ",".join(f"{k}={v}" for k, v in self.fields.items())
        lines = [f'Trace[{self.name}{{{fields}}}]: total {total * 1e3:.1f}ms'
                 if fields else
                 f'Trace[{self.name}]: total {total * 1e3:.1f}ms']
        prev = self._t0
        for ts, msg in self._steps:
            lines.append(f'  step "{msg}" {1e3 * (ts - prev):.1f}ms')
            prev = ts
        logger.info("\n".join(lines))
