"""Adaptive admission window: dispatch-now vs coalesce, in front of
`SchedulingQueue.pop_batch`.

State machine (README "Online serving path" documents the contract):

    IDLE ──pop──▶ DISPATCH (window 0: lone pods → fast path, batches →
      ▲                     the batch pipeline immediately)
      │
    COALESCE: estimated offered rate is above the trickle threshold AND
      the pop returned fewer pods than the caller's batch budget — hold
      the queue open `window` seconds, then drain whatever accumulated
      (one merged dispatch), then DISPATCH.

The decision inputs are all measured, never configured (the AdaptiveTuner
discipline):

- **offered-rate estimate**: EWMA of pods-per-second observed at the pop
  boundary (the open-loop arrival process as the queue sees it).
- **pop size / backlog depth**: `pop_batch`'s return and
  `queue.backlog_depth()` — a pop that already filled the batch budget
  never waits; a deep backlog means the NEXT pop will fill it, so
  waiting adds latency for nothing.

The window length itself is the AdaptiveTuner policy row
(`AdaptiveTuner.admission_window` — thresholds seeded from the r15
churn knee sweep, BASELINE r15): 0 at or below the 250/s trickle, else
sized to coalesce ~8 pods at the estimated rate, capped at 4 ms (16 ms
when the device is relay-attached — each dispatch pays a
size-independent RTT there, so fuller batches win).

`KTPU_ADMISSION_WINDOW` (milliseconds) pins the window for sweeps and
tests; `0` disables coalescing entirely (every pop dispatches
immediately — the admission half of the KTPU_SERVING=0 degrade).

Copy of `kubernetes_tpu/serving/admission.py`: pure host policy. The
serving loop that consults it waits for the slice that ports the
scheduler's run loop and queue.
"""

from __future__ import annotations

import time

from kubernetes_tpu_torch.ops.backend import AdaptiveTuner
from kubernetes_tpu_torch.utils import flags


def _window_override_ms() -> float | None:
    return flags.get("KTPU_ADMISSION_WINDOW")


class AdmissionWindow:
    #: offered-rate estimation horizon: pods observed at pop boundaries
    #: over the last window, TWO-POINT form — rate = (pods after the
    #: oldest pop) / (time since the oldest pop). Per-pop instantaneous
    #: rates were hopeless: Poisson bunching at a 250/s trickle yields
    #: back-to-back pops whose inst rate reads thousands, and one such
    #: spike through an EWMA flipped the tier into a chunk excursion
    #: mid-trickle. The two-point estimate is exact for any steady
    #: process regardless of bunching; a window with fewer than two
    #: pops reads 0 (unknown — the mid-drain pressure abort owns the
    #: cold-burst case).
    RATE_WINDOW_S = 0.5

    def __init__(self, tuner: AdaptiveTuner | None = None, metrics=None):
        self.tuner = tuner
        self.metrics = metrics
        self.rate_est = 0.0
        from collections import deque
        self._pops: "deque[tuple[float, int]]" = deque()
        self._pop_sum = 0
        #: decisions, for introspection/tests.
        self.immediate_dispatches = 0
        self.coalesce_windows = 0

    def observe_pop(self, n_pods: int, now: float | None = None) -> None:
        """Feed one pop boundary into the rate estimate."""
        now = time.monotonic() if now is None else now
        self._pops.append((now, n_pods))
        self._pop_sum += n_pods
        while self._pops and self._pops[0][0] < now - self.RATE_WINDOW_S \
                and len(self._pops) > 2:
            _, n = self._pops.popleft()
            self._pop_sum -= n
        if len(self._pops) >= 2:
            t0, n0 = self._pops[0]
            span = now - t0
            self.rate_est = (self._pop_sum - n0) / span if span > 0 else 0.0
        else:
            self.rate_est = 0.0

    def window_for(self, popped: int, backlog: int,
                   batch_budget: int) -> float:
        """Seconds to hold the queue open before dispatching this pop
        (0.0 = dispatch immediately)."""
        override = _window_override_ms()
        if override is not None:
            w = override * 1e-3
        else:
            latency = 0.0
            if self.tuner is not None and self.tuner.latency_s is not None:
                latency = self.tuner.latency_s
            w = AdaptiveTuner.admission_window(latency, self.rate_est)
        if popped >= batch_budget or backlog >= batch_budget:
            # The batch budget is already met (or the next pop meets it):
            # waiting only adds latency.
            w = 0.0
        if self.metrics is not None:
            # Base-unit seconds (scheduler_admission_window_seconds) —
            # the old _ms gauge was the metrics lint's first real catch.
            self.metrics.admission_window.set(round(w, 6))
        if w > 0.0:
            self.coalesce_windows += 1
        else:
            self.immediate_dispatches += 1
        return w
