"""The 3-tier scheduling queue: activeQ / backoffQ / unschedulablePods.

Parity target: pkg/scheduler/internal/queue/scheduling_queue.go
(`PriorityQueue`: `Pop` blocks on the activeQ heap in QueueSort order;
`AddUnschedulableIfNotPresent` parks failed pods with per-pod exponential
backoff (podInitialBackoffSeconds 1s → podMaxBackoffSeconds 10s);
`MoveAllToActiveOrBackoffQueue` reacts to cluster events via QueueingHint
functions; `flushBackoffQCompleted` + `flushUnschedulablePodsLeftover` (60s)
timers; nominator tracks nominated nodes of preemptor pods).

Batch deviation: `pop_batch(max_pods)` drains up to P pods in one call —
the batched solver schedules them together, resolving intra-batch resource
contention inside the assignment solve instead of serially (SURVEY §3.1).
Single-pod `pop()` remains for the reference-shaped loop and tests.

Copy of `kubernetes_tpu/scheduler/queue.py`.
"""

from __future__ import annotations

import asyncio
import heapq
import itertools
import time
from typing import Callable

from kubernetes_tpu_torch.metrics.registry import WindowedLatencyRecorder
from kubernetes_tpu_torch.scheduler.framework import Framework
from kubernetes_tpu_torch.scheduler.types import PodInfo


class ClusterEvent:
    """"Resource/Action" event that may make unschedulable pods schedulable
    (framework.ClusterEvent)."""

    __slots__ = ("resource", "action", "label")

    def __init__(self, resource: str, action: str):
        self.resource = resource
        self.action = action
        self.label = f"{resource}/{action}"


# QueueingHint verdicts (framework.QueueingHint)
QUEUE = "Queue"
QUEUE_SKIP = "QueueSkip"

#: hint fn: (pod, event) -> QUEUE | QUEUE_SKIP
HintFn = Callable[[PodInfo, ClusterEvent], str]


def wait_start(pi: PodInfo) -> float:
    """Where the pod's wait in activeQ for this attempt began: its
    `enqueued_at`, re-stamped on every activeQ entry, so a retried pod's
    wait leaves out its earlier cycles and backoff; else its `queued_at`
    (0.0: never stamped)."""
    return pi.enqueued_at or pi.queued_at


class SchedulingQueue:
    def __init__(
        self,
        framework: Framework,
        initial_backoff: float = 1.0,
        max_backoff: float = 10.0,
        unschedulable_flush_interval: float = 60.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.framework = framework
        self.initial_backoff = initial_backoff
        self.max_backoff = max_backoff
        self.unschedulable_flush_interval = unschedulable_flush_interval
        self.clock = clock

        self._seq = itertools.count()
        # activeQ: heap of (sort_key, seq, PodInfo)
        self._active: list[tuple[tuple, int, PodInfo]] = []
        self._active_keys: set[str] = set()
        # backoffQ: heap of (ready_time, seq, PodInfo)
        self._backoff: list[tuple[float, int, PodInfo]] = []
        self._backoff_keys: set[str] = set()
        # unschedulable: key -> (PodInfo, parked_at)
        self._unschedulable: dict[str, tuple[PodInfo, float]] = {}
        # gated (PreEnqueue rejected): key -> PodInfo
        self._gated: dict[str, PodInfo] = {}
        self._cond = asyncio.Condition()
        self._closed = False
        # moveRequestCycle bookkeeping: event hints per plugin.
        self._hints: dict[str, list[tuple[str, HintFn]]] = {}
        self._in_flight: set[str] = set()
        # Pods whose cycle was in flight when a cluster event fired: they
        # failed *concurrently* with the event, so they go to backoff (prompt
        # retry) instead of unschedulable (the reference's moveRequestCycle
        # comparison in AddUnschedulableIfNotPresent).
        self._moved_while_in_flight: set[str] = set()
        #: each pop's wait in activeQ, `wait_start` to `dequeued_at` in
        #: the queue's clock; the scheduler renders it as a summary.
        self.wait = WindowedLatencyRecorder()

    # -- configuration -----------------------------------------------------

    def register_hint(self, event_label: str, plugin: str, fn: HintFn) -> None:
        self._hints.setdefault(event_label, []).append((plugin, fn))

    # -- internals ---------------------------------------------------------

    def _sort_key(self, pi: PodInfo) -> tuple:
        # QueueSort order via framework.less is a comparator; encode the
        # default PrioritySort (priority desc, then FIFO) directly as a key
        # and let custom sorts override via plugin-provided key().
        for p in self.framework.queue_sort_plugins:
            key_fn = getattr(p, "key", None)
            if key_fn is not None:
                return key_fn(pi)
        return (-pi.priority, pi.queued_at)

    def _push_active(self, pi: PodInfo) -> None:
        if pi.key in self._active_keys:
            return
        # Every activeQ entry (first add, backoff flush, move_all) stamps
        # the queue-wait start for this attempt's retroactive span.
        pi.enqueued_at = self.clock()
        heapq.heappush(self._active, (self._sort_key(pi), next(self._seq), pi))
        self._active_keys.add(pi.key)

    def _backoff_duration(self, pi: PodInfo) -> float:
        # per-pod exponential: initial * 2^(attempts-1), capped.
        n = max(pi.attempts, 1)
        return min(self.initial_backoff * (2 ** (n - 1)), self.max_backoff)

    # -- public API --------------------------------------------------------

    async def add(self, pi: PodInfo) -> None:
        """New pending pod enters activeQ (unless gated by PreEnqueue)."""
        async with self._cond:
            if pi.queued_at == 0.0:
                pi.queued_at = self.clock()
            st = self.framework.run_pre_enqueue(pi)
            if not st.is_success():
                pi.unschedulable_plugins = {st.plugin} if st.plugin else set()
                self._gated[pi.key] = pi
                return
            self._remove_everywhere(pi.key)
            self._push_active(pi)
            self._cond.notify_all()

    async def update(self, pi: PodInfo) -> None:
        """Pod object changed while queued: refresh it wherever it sits; a
        gated pod gets re-evaluated (SchedulingGates removal path). add()
        handles removal from every tier via _remove_everywhere."""
        await self.add(pi)

    def _remove_everywhere(self, key: str) -> None:
        if key in self._active_keys:
            self._active = [(k, s, p) for (k, s, p) in self._active if p.key != key]
            heapq.heapify(self._active)
            self._active_keys.discard(key)
        if key in self._backoff_keys:
            self._backoff = [(t, s, p) for (t, s, p) in self._backoff if p.key != key]
            heapq.heapify(self._backoff)
            self._backoff_keys.discard(key)
        self._unschedulable.pop(key, None)
        self._gated.pop(key, None)

    async def delete(self, key: str) -> None:
        async with self._cond:
            self._remove_everywhere(key)

    async def pop(self) -> PodInfo | None:
        """Blocking pop of the highest-priority pod (queue.Pop)."""
        batch = await self.pop_batch(1)
        return batch[0] if batch else None

    async def pop_batch(self, max_pods: int) -> list[PodInfo]:
        """Drain up to max_pods from activeQ; blocks until ≥1 available.
        Flushes due backoff pods first so a ready backoff pod can't be
        starved by an empty activeQ."""
        async with self._cond:
            while True:
                self._flush_backoff_locked()
                if self._active or self._closed:
                    break
                # Wake when the earliest backoff pod becomes ready.
                timeout = None
                if self._backoff:
                    timeout = max(self._backoff[0][0] - self.clock(), 0.01)
                try:
                    await asyncio.wait_for(self._cond.wait(), timeout)
                except asyncio.TimeoutError:
                    continue
            if self._closed and not self._active:
                return []
            return self._drain_locked(max_pods)

    def _drain_locked(self, max_pods: int) -> list[PodInfo]:
        out: list[PodInfo] = []
        now = self.clock()
        while self._active and len(out) < max_pods:
            _, _, pi = heapq.heappop(self._active)
            self._active_keys.discard(pi.key)
            pi.attempts += 1
            # Queue-wait endpoint: this attempt's wait is observed here,
            # and the scheduler's retroactive scheduler.queue.wait span
            # reads the same two stamps (wait_start → dequeued_at).
            pi.dequeued_at = now
            start = wait_start(pi)
            if start:
                self.wait.observe(now - start)
            self._in_flight.add(pi.key)
            out.append(pi)
        return out

    async def pop_now(self, max_pods: int) -> list[PodInfo]:
        """NON-blocking drain: whatever is ready right now (due backoff
        flushed first), possibly empty — the serving tier's admission
        window merges this into a held dispatch after its coalesce
        sleep, where a blocking pop would stall the batch it already
        holds."""
        async with self._cond:
            self._flush_backoff_locked()
            if self._closed:
                return []
            return self._drain_locked(max_pods)

    def _flush_backoff_locked(self) -> None:
        now = self.clock()
        while self._backoff and self._backoff[0][0] <= now:
            _, _, pi = heapq.heappop(self._backoff)
            self._backoff_keys.discard(pi.key)
            self._push_active(pi)

    async def add_unschedulable(self, pi: PodInfo) -> None:
        """Failed cycle: park the pod (AddUnschedulableIfNotPresent). If a
        cluster event fired while this pod's cycle was in flight, the event
        may have already fixed the failure — send the pod to backoff for a
        prompt retry instead of parking it (moveRequestCycle semantics)."""
        async with self._cond:
            self._in_flight.discard(pi.key)
            if pi.key in self._moved_while_in_flight:
                self._moved_while_in_flight.discard(pi.key)
                if pi.key not in self._active_keys and pi.key not in self._backoff_keys:
                    ready = self.clock() + self._backoff_duration(pi)
                    heapq.heappush(self._backoff, (ready, next(self._seq), pi))
                    self._backoff_keys.add(pi.key)
                    self._cond.notify_all()
                return
            if pi.key in self._active_keys or pi.key in self._backoff_keys:
                return
            self._unschedulable[pi.key] = (pi, self.clock())

    async def done(self, pod_key: str) -> None:
        """Cycle finished without requeue (scheduled or error-dropped)."""
        async with self._cond:
            self._in_flight.discard(pod_key)
            self._moved_while_in_flight.discard(pod_key)

    async def move_to_backoff(self, pi: PodInfo) -> None:
        async with self._cond:
            self._in_flight.discard(pi.key)
            self._moved_while_in_flight.discard(pi.key)
            if pi.key in self._active_keys or pi.key in self._backoff_keys:
                return
            ready = self.clock() + self._backoff_duration(pi)
            heapq.heappush(self._backoff, (ready, next(self._seq), pi))
            self._backoff_keys.add(pi.key)
            self._cond.notify_all()

    async def move_all(self, event: ClusterEvent) -> int:
        """Cluster event: re-activate unschedulable pods whose QueueingHints
        say the event may help (MoveAllToActiveOrBackoffQueue)."""
        return await self.move_all_batch([event])

    async def move_all_batch(self, events: list[ClusterEvent]) -> int:
        """One pass over the parked pods for a TICK's worth of coalesced
        events: a preemption wave deletes thousands of victims in bursts,
        and scanning every unschedulable pod once per delete event made
        event handling O(events × parked) — the batch scan moves a pod if
        ANY of the tick's events hints QUEUE, the same outcome as the
        sequential per-event scans over an unchanged queue state."""
        moved = 0
        async with self._cond:
            # Cycles currently in flight may be failing for a reason this
            # event just fixed; mark them so their failure lands in backoff.
            self._moved_while_in_flight.update(self._in_flight)
            # Gated pods re-run PreEnqueue: a gate can lift on events that
            # don't touch the pod object itself (e.g. Coscheduling's
            # minMember gate lifts when a SIBLING pod is created).
            for key in list(self._gated):
                pi = self._gated[key]
                if self.framework.run_pre_enqueue(pi).is_success():
                    del self._gated[key]
                    self._push_active(pi)
                    moved += 1
            for key in list(self._unschedulable):
                pi, _ = self._unschedulable[key]
                if not any(self._hint_says_queue(pi, event)
                           for event in events):
                    continue
                del self._unschedulable[key]
                if pi.attempts > 0 and self._backoff_duration(pi) > 0:
                    ready = self.clock() + self._backoff_duration(pi)
                    heapq.heappush(self._backoff, (ready, next(self._seq), pi))
                    self._backoff_keys.add(pi.key)
                else:
                    self._push_active(pi)
                moved += 1
            if moved:
                self._cond.notify_all()
        return moved

    def _hint_says_queue(self, pi: PodInfo, event: ClusterEvent) -> bool:
        hints = self._hints.get(event.label, [])
        if not hints:
            return True  # no hints registered for event → conservative requeue
        # Only hints from plugins that rejected this pod matter
        # (UnschedulablePlugins recorded at failure time).
        relevant = [fn for plugin, fn in hints
                    if not pi.unschedulable_plugins or plugin in pi.unschedulable_plugins]
        if not relevant:
            return False
        return any(fn(pi, event) == QUEUE for fn in relevant)

    async def flush_unschedulable_leftover(self) -> int:
        """Safety valve: pods parked longer than the flush interval re-enter
        backoff (flushUnschedulablePodsLeftover, 60s default)."""
        moved = 0
        async with self._cond:
            now = self.clock()
            for key in list(self._unschedulable):
                pi, parked_at = self._unschedulable[key]
                if now - parked_at < self.unschedulable_flush_interval:
                    continue
                del self._unschedulable[key]
                ready = now + self._backoff_duration(pi)
                heapq.heappush(self._backoff, (ready, next(self._seq), pi))
                self._backoff_keys.add(pi.key)
                moved += 1
            if moved:
                self._cond.notify_all()
        return moved

    async def run_flushers(self) -> None:
        """Background timers (SchedulingQueue.Run)."""
        try:
            while not self._closed:
                await asyncio.sleep(1.0)
                async with self._cond:
                    self._flush_backoff_locked()
                    self._cond.notify_all()
                await self.flush_unschedulable_leftover()
        except asyncio.CancelledError:
            return

    async def close(self) -> None:
        async with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- introspection (metrics: scheduler_pending_pods{queue=...}) --------

    def stats(self) -> dict[str, int]:
        return {
            "active": len(self._active),
            "backoff": len(self._backoff),
            "unschedulable": len(self._unschedulable),
            "gated": len(self._gated),
            "in_flight": len(self._in_flight),
        }

    def backlog_depth(self) -> int:
        """Total pods the scheduler still owes work for (every tier plus
        in-flight cycles) — the open-loop churn battery's saturation
        signal: under sustained arrivals this growing without bound IS
        the knee, where a drain bench would only show a slower clock."""
        return (len(self._active) + len(self._backoff)
                + len(self._unschedulable) + len(self._gated)
                + len(self._in_flight))

    def has_parked(self) -> bool:
        """Anything a cluster event could wake (gated or unschedulable)."""
        return bool(self._gated or self._unschedulable)
