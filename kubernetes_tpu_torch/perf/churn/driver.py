"""Open-loop churn driver + rate-sweep (knee) harness.

ChurnDriver walks a precomputed arrival timeline on an ABSOLUTE clock
anchored at phase start: each pod create fires at `t0 + offset` whether
or not earlier pods scheduled. Creates are spawned, not awaited inline —
awaiting each write would close the loop through the transport and turn
saturation into a slower arrival clock instead of queue growth (the
failure mode the drain families can't see). A backlog sampler rides
along, feeding the `scheduler_pending_pods{queue}` gauge and recording
the peak/final depth that the knee test reads.

The sweep harness (`run_rate_sweep`) runs one workload per arrival rate
and reports, per row, the exact p50/p99/p999 attempt latency (r11's
WindowedLatencyRecorder via the measured window) with queue growth as
the saturation witness; `find_knee` names the highest offered rate the
scheduler absorbed (backlog at window end under `saturation_frac` of
the window's offered arrivals) and the first rate it didn't.

Copy of `kubernetes_tpu/perf/churn/driver.py`; the sweep runs the port's
`PerfRunner`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Mapping

from kubernetes_tpu_torch.perf.churn.arrivals import ArrivalProcess

logger = logging.getLogger(__name__)

#: in-flight create tasks above this high-water mark fall back to an
#: awaited create: a memory backstop, not pacing (hit only when the
#: TRANSPORT — not the scheduler — is the bottleneck; counted so a run
#: that degraded open-loop honesty says so in its result).
_MAX_INFLIGHT_CREATES = 10_000


class ChurnPhaseResult:
    """What one open-loop phase measured (folded into WorkloadResult)."""

    def __init__(self):
        self.offered_rate = 0.0       # the arrival process's target
        self.achieved_rate = 0.0      # arrivals actually enqueued / wall
        self.arrivals_total = 0
        self.arrival_model = ""
        self.duration = 0.0
        self.backlog_peak = 0
        self.backlog_final = 0
        self.pending_final: dict[str, int] = {}
        self.late_arrivals = 0        # fired >50ms past their offset
        self.throttled_creates = 0    # backstop-awaited (transport-bound)
        self.create_errors = 0
        #: seconds spent draining in-flight create tasks AFTER the
        #: window closed — nonzero means the TRANSPORT (not the
        #: scheduler) lagged the arrival clock.
        self.create_drain_s = 0.0


class ChurnDriver:
    """Drives one open-loop arrival phase against a live run."""

    def __init__(self, process: ArrivalProcess, duration: float, *,
                 create_pod: Callable[[str], Any],
                 backlog_stats: Callable[[], Mapping[str, int]],
                 on_backlog: Callable[[Mapping[str, int]], None]
                 | None = None,
                 metrics=None,
                 name_prefix: str = "churn",
                 sample_period: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        self.process = process
        self.duration = float(duration)
        self.create_pod = create_pod
        self.backlog_stats = backlog_stats
        self.on_backlog = on_backlog
        self.metrics = metrics
        self.name_prefix = name_prefix
        self.sample_period = sample_period
        self.clock = clock
        self.result = ChurnPhaseResult()

    async def run(self, t0: float | None = None) -> ChurnPhaseResult:
        res = self.result
        res.offered_rate = self.process.rate
        res.arrival_model = self.process.kind
        res.duration = self.duration
        timeline = self.process.timeline(self.duration)
        if t0 is None:
            t0 = self.clock()
        pending: set[asyncio.Task] = set()
        sampler = asyncio.ensure_future(self._sample_backlog(t0))
        seq = 0
        loop_end = None
        try:
            for offset in timeline:
                delay = (t0 + offset) - self.clock()
                if delay > 0:
                    await asyncio.sleep(delay)
                elif delay < -0.05:
                    res.late_arrivals += 1
                name = f"{self.name_prefix}-{seq}"
                seq += 1
                if len(pending) >= _MAX_INFLIGHT_CREATES:
                    res.throttled_creates += 1
                    await self._create(name)
                else:
                    t = asyncio.ensure_future(self._create(name))
                    pending.add(t)
                    t.add_done_callback(pending.discard)
            # Phase runs to its full duration even if the last arrival
            # landed early: the window's percentiles cover steady state,
            # not an arrival-truncated prefix.
            tail = (t0 + self.duration) - self.clock()
            if tail > 0:
                await asyncio.sleep(tail)
            # WINDOW-END accounting, before the create drain below:
            # offered work not yet absorbed = the scheduler's queue
            # PLUS creates still in the transport — counting only the
            # former would let a slow wire masquerade as headroom.
            loop_end = self.clock()
            stats = dict(self.backlog_stats())
            res.pending_final = stats
            res.backlog_final = sum(stats.values()) + len(pending)
            res.backlog_peak = max(res.backlog_peak, res.backlog_final)
        finally:
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
            sampler.cancel()
            try:
                await sampler
            except (asyncio.CancelledError, Exception):
                pass
        res.arrivals_total = seq
        end = loop_end if loop_end is not None else self.clock()
        res.create_drain_s = max(self.clock() - end, 0.0)
        # Achieved rate is measured at pacing-loop end: the arrival
        # clock is what's open-loop, not create completion.
        res.achieved_rate = seq / max(end - t0, 1e-9)
        if self.metrics is not None:
            self.metrics.arrivals.inc(seq, model=self.process.kind)
            self.metrics.backlog_peak.set(res.backlog_peak)
        return res

    async def _create(self, name: str) -> None:
        try:
            await self.create_pod(name)
        except asyncio.CancelledError:
            raise
        except Exception:
            self.result.create_errors += 1
            logger.exception("churn arrival create %s failed", name)

    async def _sample_backlog(self, t0: float) -> None:
        """Keep scheduler_pending_pods fresh while the loop is saturated
        (the scheduler only refreshes it per popped batch) and track the
        peak the knee detection reads."""
        while True:
            await asyncio.sleep(self.sample_period)
            stats = dict(self.backlog_stats())
            self.result.backlog_peak = max(self.result.backlog_peak,
                                           sum(stats.values()))
            if self.on_backlog is not None:
                self.on_backlog(stats)


# -- rate sweep / knee ----------------------------------------------------


def is_saturated(arrivals_total: int, backlog_final: int,
                 saturation_frac: float = 0.2,
                 offered_rate: float | None = None,
                 achieved_rate: float | None = None) -> bool:
    """The one saturation rule (single runs and the knee sweep share
    it). Two witnesses, either suffices:

    - queue growth: at window end the backlog (scheduler tiers PLUS
      in-flight creates) holds more than `saturation_frac` of
      everything the window offered — fraction-of-offered is
      duration-invariant (a seconds-of-work rule degenerates when the
      window is shorter than the horizon it measures in);
    - clock slip: ChurnDriver could not even FIRE arrivals at half the
      offered rate (event loop / transport jammed) — the rate is
      beyond the system, harness included, whatever the queue shows.
    """
    if backlog_final > max(saturation_frac * arrivals_total, 16.0):
        return True
    return bool(offered_rate and achieved_rate is not None
                and achieved_rate < 0.5 * offered_rate)


def find_knee(rows: list[Mapping], saturation_frac: float = 0.2) -> dict:
    """Pick the knee from sweep rows (each needs churn_offered_rate,
    churn_arrivals_total and churn_backlog_final).

    A row is SATURATED per is_saturated — open-loop arrivals mean
    backlog growth IS the saturation signal (p-latency alone can't
    distinguish "slow but keeping up" from "diverging").
    Knee = highest non-saturated offered rate; the first saturated rate
    above it bounds the knee from above."""
    annotated = []
    for row in sorted(rows, key=lambda r: r["churn_offered_rate"]):
        rate = row["churn_offered_rate"]
        saturated = is_saturated(row["churn_arrivals_total"],
                                 row["churn_backlog_final"],
                                 saturation_frac,
                                 offered_rate=rate,
                                 achieved_rate=row.get(
                                     "churn_achieved_rate"))
        annotated.append((rate, saturated, row))
    # Highest non-saturated row WHEREVER it sits: saturation need not be
    # monotonic in rate (the trickle regime's un-amortized dispatch can
    # trip the threshold at LOW rates while mid rates absorb fine), and
    # an absorbed rate must never be reported as "no knee".
    knee = None
    for rate, saturated, row in annotated:
        if not saturated:
            knee = row
    knee_rate = knee["churn_offered_rate"] if knee else None
    # The knee's upper bound: the lowest saturated rate ABOVE it (a
    # saturated trickle row below the knee is the dispatch pathology,
    # not the knee's bracket).
    first_saturated = None
    for rate, saturated, row in annotated:
        if saturated and (knee_rate is None or rate > knee_rate):
            first_saturated = row
            break
    return {
        "knee_rate": knee["churn_offered_rate"] if knee else None,
        "knee_p999_ms": knee.get("attempt_p999_ms") if knee else None,
        "knee_p99_ms": knee.get("attempt_p99_ms") if knee else None,
        "knee_p50_ms": knee.get("attempt_p50_ms") if knee else None,
        "first_saturated_rate":
            first_saturated["churn_offered_rate"]
            if first_saturated else None,
        "saturation_frac": saturation_frac,
    }


def churn_template(*, nodes: int, rate: float, duration: float,
                   seed: int, model: str = "poisson",
                   warmup: int = 0, agents: bool = False,
                   faults: list | None = None,
                   grace: float = 2.0, toleration: float = 0.25,
                   recovery_threshold: int = 10,
                   recovery_timeout: float = 60.0,
                   saturation_frac: float = 0.2,
                   lease_period: float | None = None) -> list[dict]:
    """One ChurnDay workload template: stage nodes (agent-backed when
    faults need a kill target), warm the jit caches with a drained
    burst, then the measured open-loop phase.

    lease_period None auto-scales with fleet size (~nodes/400 s,
    floor 0.5) so heartbeat traffic stays bounded, and the effective
    grace period is floored at 3× the lease — a lease period at or
    above the grace period makes every HEALTHY node flap unreachable
    between renewals (detection time therefore scales with fleet size
    here, exactly as production grace periods do)."""
    if lease_period is None:
        lease_period = min(max(0.5, nodes / 400.0), 10.0)
    grace = max(grace, 3.0 * lease_period)
    stage = {"opcode": "startAgents", "count": nodes,
             "leasePeriod": lease_period} if agents else \
            {"opcode": "createNodes", "count": nodes}
    ops: list[dict] = [stage]
    if warmup:
        ops += [{"opcode": "createPods", "count": warmup},
                {"opcode": "barrier"}]
    churn_op = {
        "opcode": "churnOpenLoop", "collectMetrics": True,
        "arrival": {"model": model, "rate": rate},
        "duration": duration, "seed": seed,
        "recoveryThreshold": recovery_threshold,
        # One threshold for BOTH verdicts: the row's churn_saturated
        # flag and find_knee must never contradict each other.
        "saturationFrac": saturation_frac,
    }
    if faults:
        churn_op["faults"] = list(faults)
        churn_op["nodeGracePeriod"] = grace
        churn_op["tolerationSeconds"] = toleration
        churn_op["recoveryTimeout"] = recovery_timeout
    ops.append(churn_op)
    return ops


def run_rate_sweep(*, nodes: int, rates: list[float], duration: float,
                   seed: int = 17, model: str = "poisson",
                   warmup: int = 0, agents: bool = False,
                   fault: Mapping | None = None, fault_rate: float | None = None,
                   grace: float = 2.0, toleration: float = 0.25,
                   recovery_threshold: int = 10,
                   recovery_timeout: float = 60.0,
                   saturation_frac: float = 0.2,
                   runner_factory: Callable[[], Any] | None = None,
                   timeout: float = 600.0) -> dict:
    """Walk arrival rate to the knee, then (optionally) rerun one rate
    with a fault injected mid-wave. One PerfRunner run per rate — fresh
    store/scheduler/backend each, like run_suite — so rows are
    independent measurements.

    Returns {"rows": [detail dicts], "knee": find_knee(...),
             "fault_row": detail dict | None}."""
    from kubernetes_tpu_torch.perf.scheduler_perf import PerfRunner

    def default_runner():
        return PerfRunner()

    make_runner = runner_factory or default_runner
    rows: list[dict] = []
    for rate in rates:
        template = churn_template(
            nodes=nodes, rate=rate, duration=duration, seed=seed,
            model=model, warmup=warmup, agents=agents,
            recovery_threshold=recovery_threshold,
            saturation_frac=saturation_frac)
        res = asyncio.run(make_runner().run(template, {}, timeout=timeout))
        rows.append(res.as_dict())
    knee = find_knee(rows, saturation_frac=saturation_frac)
    fault_row = None
    if fault is not None:
        rate = float(fault_rate if fault_rate is not None
                     else (knee["knee_rate"] or rates[0]))
        template = churn_template(
            nodes=nodes, rate=rate, duration=duration, seed=seed,
            model=model, warmup=warmup, agents=True,
            faults=[dict(fault)], grace=grace, toleration=toleration,
            recovery_threshold=recovery_threshold,
            recovery_timeout=recovery_timeout,
            saturation_frac=saturation_frac)
        res = asyncio.run(make_runner().run(template, {}, timeout=timeout))
        fault_row = res.as_dict()
    return {"rows": rows, "knee": knee, "fault_row": fault_row}
