"""ServingTier: the admission window + fast path wired into the
scheduler's dispatch loop.

`Scheduler.run` delegates each iteration to `schedule_next` when the
tier is attached (serving/__init__.maybe_attach_serving — flagless,
KTPU_SERVING=0 kill switch):

    pop_batch ──▶ admission window (dispatch now / coalesce) ──▶
        dispatch ≤ fast-path cap ──▶ drain pod-by-pod through the
            pinned C=1 solve (resident planes, solve_one); the first
            ineligible / no-fit pod and everything behind it falls to ─┐
        dispatch > cap ────────────▶ Scheduler._schedule_pods ◀───────┘
                                     (the unchanged batch pipeline)

Why a CAP and not "len == 1": a chunk's wall is fixed (the scan runs
the padded width) while a fast solve is a few launches, so BELOW
chunk/fast pods the serial drain is faster outright — and, more importantly, it keeps the queue in the lone-pod
regime. The r15 trickle pathology was self-sustaining: arrivals
accumulating during one chunk wall guaranteed the next pop was another
chunk, so 250/s traffic ran batch-every-0.4s forever. Draining small
dispatches serially converges back to empty-queue/lone-pod steady
state; genuine bursts blow past the cap and get the batch pipeline.
Both walls are measured medians fed from the tier's own dispatches
(AdaptiveTuner.fast_path_cap is the pure-policy row; seeds cover the
pre-measurement window, and the first fast sample is excluded). The
fast path runs once off the serve path during the first dispatch the
tier sees (`warm`, one discarded solve), so a measured serve window
never pays a first-call cost.

The drain preserves queue (priority) order exactly: pods ahead of the
first fall-through pod place first, the remainder dispatches as one
batch in order. Everything below the dispatch decision — assume,
Reserve, Permit, the async binding cycle, failure handling, preemption
— is the scheduler's existing machinery, untouched.

Copy of `kubernetes_tpu/serving/loop.py`, with one departure: no
fallback. The reference swallows a fast-path exception (the pod reroutes
through the normal path) and a warm-up exception; here both propagate out
of `Scheduler.run`, so a failure of the card or a kernel is never hidden.
"""

from __future__ import annotations

import asyncio
import statistics
import time
from collections import deque

from kubernetes_tpu_torch.ops.backend import AdaptiveTuner
from kubernetes_tpu_torch.scheduler.framework import CycleState
from kubernetes_tpu_torch.serving.admission import AdmissionWindow
from kubernetes_tpu_torch.serving.fastpath import SinglePodFastPath
from kubernetes_tpu_torch.serving.resident import ResidentPlanes
from kubernetes_tpu_torch.utils.tracing import traceparent_of

#: window of recent wall samples per estimator: the MEDIAN is the
#: estimate, so a first-call outlier (a fresh cluster shape) cannot
#: crater the fast-path cap the way an EWMA poisoned by one slow sample
#: did — that spiral locked the tier into the batch regime for the rest
#: of a serve window.
_WALL_WINDOW = 15


class ServingTier:
    def __init__(self, sched):
        self.sched = sched
        backend = sched.backend
        self.window = AdmissionWindow(
            tuner=getattr(backend, "_tuner", None), metrics=sched.metrics)
        self.resident = ResidentPlanes(backend, metrics=sched.metrics)
        self.fastpath = SinglePodFastPath(
            backend, self.resident, metrics=sched.metrics)
        # Batch assigns now seed their device chain from the resident
        # planes too (ops/backend._start).
        backend.resident = self.resident
        #: recent wall samples; the medians feed the cap policy row
        #: (0.0 = unmeasured, the policy row's seeds apply).
        self._fast_walls: deque = deque(maxlen=_WALL_WINDOW)
        self._chunk_walls: deque = deque(maxlen=_WALL_WINDOW)
        self._fast_samples = 0
        self._last_fast_t = 0.0

    #: fast-wall samples older than this with nothing newer are dropped:
    #: a couple of outlier samples in a near-empty window (a mid-serve
    #: compile that slipped past warmup) would otherwise suppress the
    #: fast path forever — suppression itself prevents the fresh samples
    #: that would heal the median. Decay turns it into a bounded retry.
    _FAST_WALL_STALE_S = 10.0

    @property
    def fast_wall_est(self) -> float:
        if not self._fast_walls:
            return 0.0
        if time.monotonic() - self._last_fast_t > self._FAST_WALL_STALE_S:
            self._fast_walls.clear()
            return 0.0
        return statistics.median(self._fast_walls)

    @property
    def chunk_wall_est(self) -> float:
        return statistics.median(self._chunk_walls) if self._chunk_walls \
            else 0.0

    def fast_path_cap(self) -> int:
        return AdaptiveTuner.fast_path_cap(
            self.chunk_wall_est, self.fast_wall_est,
            n_nodes=len(self.sched.cache.nodes))

    async def schedule_next(self, batch_size: int) -> bool:
        """One dispatch-loop iteration. Returns False when the queue
        closed (mirrors Scheduler.schedule_batch's contract)."""
        sched = self.sched
        pods = await sched.queue.pop_batch(batch_size)
        if not pods:
            return False
        self.window.observe_pop(len(pods))
        # Coalescing reads POPPABLE backlog only (activeQ): in-flight
        # pods can never fill the next pop, and counting them disabled
        # coalescing in exactly the above-trickle regime it serves.
        wait = self.window.window_for(
            len(pods), sched.queue.stats()["active"], batch_size)
        if wait > 0 and len(pods) < batch_size:
            # COALESCE: hold the queue open, then merge what arrived.
            await asyncio.sleep(wait)
            more = await sched.queue.pop_now(batch_size - len(pods))
            if more:
                pods.extend(more)
                # Merged pods count toward the offered-rate estimate
                # too — under heavy coalescing they're the majority,
                # and missing them would read the rate far low exactly
                # when the utilization gates need it accurate.
                self.window.observe_pop(len(more))
                sched.metrics.serving_coalesced_batches.inc()
        # Two routing signals, both measured: (a) total OUTSTANDING work
        # (this dispatch + everything still queued or in a cycle —
        # parked unschedulable/gated pods deliberately EXCLUDED: a
        # standing unschedulable set is not poppable work and must not
        # permanently disable the fast path) within the fast-path cap,
        # and (b) the estimated OFFERED rate within the serial drain's
        # capacity (utilization headroom) — a sustained drain through a
        # shared-loop wire self-throttles its own creates to the drain
        # rate, so backlog alone never reveals the pressure and serial
        # solves would silently become the throughput ceiling. Fail
        # either → the pipelined batch path.
        qs = sched.queue.stats()  # re-read: the coalesce merge moved it
        outstanding = qs["active"] + qs["in_flight"]
        if sched.backend is not None and not sched.extenders:
            if not self.fastpath.warmed:
                # Retried until a usable donor pod appears (a dispatch
                # may carry only ineligible shapes), WHATEVER branch
                # this dispatch takes — warming only on the batch
                # branch once left the fused variants cold, and their
                # mid-serve compiles poisoned the wall estimate.
                self._warm_fast_path(pods[0])
            if outstanding <= self.fast_path_cap() \
                    and self.window.rate_est \
                    <= AdaptiveTuner.fast_path_rate_limit(
                        self.fast_wall_est,
                        n_nodes=len(sched.cache.nodes)):
                pods = await self._drain_fast(pods)
                if not pods:
                    return True
        await self._schedule_batch_timed(pods)
        return True

    # -- the fast drain -----------------------------------------------------

    #: mid-drain pressure check cadence (pods).
    _DRAIN_CHECK_EVERY = 4
    #: fresh arrivals waiting in activeQ that mean a burst is landing
    #: NOW: a kept-up serial drain leaves active in the low single
    #: digits (arrivals per fast solve = rate × fast_wall < 1 inside
    #: the rate limit), so tens of queued pods mid-drain can only be a
    #: burst/drain onset — abort to the batch path within ~4 pods.
    _DRAIN_ABORT_ACTIVE = 32

    async def _drain_fast(self, pods: list) -> list:
        """Place the eligible PREFIX of a small dispatch pod-by-pod
        through the fast path; returns the remainder (first ineligible /
        no-fit pod onward, order preserved) for the batch pipeline.

        Every few pods the drain re-checks queue pressure: when fresh
        arrivals landing DURING the serial drain exceed the abort
        threshold (or push remaining+queued past the cap), it aborts to
        the batch path — the entry gates can't see a burst that starts
        cold (the two-point rate estimate reads 0 until a second pop
        exists), but the burst betrays itself here within a few pods."""
        cap = self.fast_path_cap()
        stats = self.sched.queue.stats
        for k, pi in enumerate(pods):
            if k and k % self._DRAIN_CHECK_EVERY == 0:
                active = stats()["active"]
                if active > self._DRAIN_ABORT_ACTIVE \
                        or len(pods) - k + active > cap:
                    return pods[k:]
            if not await self._try_fast_path(pi):
                return pods[k:]
        return []

    async def _try_fast_path(self, pi) -> bool:
        sched = self.sched
        if sched.backend is None or pi.nominated_node:
            return False
        fwk = sched.profiles.get(pi.scheduler_name)
        if fwk is None:
            return False
        if sched.backend_profiles is not None \
                and pi.scheduler_name not in sched.backend_profiles:
            return False
        # Zero-copy snapshot: consumed synchronously inside this cycle
        # (ct build → eligibility → solve → verify), dropped before the
        # assume mutates the cache — the light contract.
        snapshot = sched.cache.light_snapshot()
        if sched.tracer.enabled:
            with sched.tracer.span(
                    "scheduler.attempt", pod=pi.key,
                    profile=fwk.profile_name, fast_path=True,
                    traceparent=traceparent_of(pi.pod)):
                sched._record_queue_wait(pi)
                return await self._fast_cycle(pi, snapshot, fwk)
        return await self._fast_cycle(pi, snapshot, fwk)

    async def _fast_cycle(self, pi, snapshot, fwk) -> bool:
        sched = self.sched
        t0 = time.perf_counter()
        # No try: a fast-path exception propagates out of run().
        node = self.fastpath.try_schedule(pi, snapshot, fwk)
        wall = time.perf_counter() - t0
        if node is None:
            return False
        self._fast_samples += 1
        if self._fast_samples > 1:
            # The first sample carries the first-call cost when warmup
            # was skipped — policy seeds cover until a warm sample lands.
            self._fast_walls.append(wall)
            self._last_fast_t = time.monotonic()
        sched.metrics.observe_attempt("scheduled", fwk.profile_name, wall)
        await sched._assume_and_bind(fwk, CycleState(), pi, node)
        return True

    # -- batch side ---------------------------------------------------------

    async def _schedule_batch_timed(self, pods: list) -> None:
        """The unchanged batch pipeline, with the per-chunk solve wall
        sampled off scheduler_tpu_solve_seconds (which TorchBackend
        observes per chunk) for the cap policy."""
        sched = self.sched
        h = sched.metrics.solve_duration
        c0, s0 = h.count(), h.sum()
        await sched._schedule_pods(pods)
        dc = h.count() - c0
        if dc > 0:
            self._chunk_walls.append((h.sum() - s0) / dc)

    def _warm_fast_path(self, pi) -> None:
        """Run every fast-path variant once OFF the serve path (one
        discarded solve + both fused refresh buckets) — nothing assumed,
        nothing counted, and no measured lone-pod placement pays a
        first-call cost. Retried (cheaply) until fastpath.warmed flips;
        a no-fit donor works, only ineligible shapes are skipped. An
        exception propagates (no fallback)."""
        sched = self.sched
        fwk = sched.profiles.get(pi.scheduler_name)
        if fwk is None or pi.nominated_node:
            return
        self.fastpath.warm(pi, sched._snapshot(), fwk)
