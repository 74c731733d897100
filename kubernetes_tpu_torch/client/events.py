"""Event recording — user-facing explainability ("FailedScheduling" etc.).

Parity target: staging/src/k8s.io/client-go/tools/record/event.go
(`EventRecorder.Eventf` → Event API objects with involvedObject/reason/message,
count-aggregated). The scheduler keeps emitting per-pod failure reasons though
its plugins run fused on the device: the per-plugin unsat masks feed
`reason`/`message` here. Copy of `kubernetes_tpu/client/events.py`.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Mapping

from kubernetes_tpu_torch.api.meta import name_of, namespace_of, new_object, now_iso
from kubernetes_tpu_torch.store.mvcc import MVCCStore, StoreError
from kubernetes_tpu_torch.utils.tracing import range_end, range_start

logger = logging.getLogger(__name__)
_seq = itertools.count(1)


def _is_decade(n: int) -> bool:
    """True at 1, 10, 100, 1000, ... — the buffer-full drop log fires
    once per decade of drops per (source, reason)."""
    while n >= 10 and n % 10 == 0:
        n //= 10
    return n == 1


class _SpamFilter:
    """Per-(source, reason) token bucket (events_cache.go
    EventSourceObjectSpamFilter, keyed coarser: the reference keys by
    source+object; at scheduler_perf scale per-object buckets never
    fill, so the budget here is per reason FAMILY — a FailedScheduling
    retry storm drains its own bucket without touching "Scheduled"'s)."""

    def __init__(self, burst: int = 512, qps: float = 256.0):
        self.burst = burst
        self.qps = qps
        #: (component, reason) -> [tokens, last_refill_monotonic]
        self._buckets: dict[tuple[str, str], list[float]] = {}

    def allow(self, source: str, reason: str) -> bool:
        now = time.monotonic()
        b = self._buckets.get((source, reason))
        if b is None:
            self._buckets[(source, reason)] = [self.burst - 1.0, now]
            return True
        tokens = min(self.burst, b[0] + (now - b[1]) * self.qps)
        b[1] = now
        if tokens < 1.0:
            b[0] = tokens
            return False
        b[0] = tokens - 1.0
        return True


class EventRecorder:
    """Buffered broadcaster: events are queued synchronously and drained by
    ONE background task (the reference's record.EventBroadcaster watch loop)
    instead of one asyncio task per event — at scheduler_perf scale the
    per-event task + write copies were a top host cost."""

    #: Bounded queue, reference semantics: record.NewBroadcaster(1000)
    #: with DropIfChannelFull — under a scheduling burst the sink cannot
    #: keep up, and events beyond the buffer are dropped (counted), never
    #: allowed to backpressure the scheduling path.
    MAX_PENDING = 1000

    #: Reasons that carry per-pod signal a drop would DESTROY (the
    #: 1000-agent mark-Running shedding fix): "Scheduled" is emitted once
    #: per bind, so unlike a FailedScheduling retry storm no later event
    #: repeats the information. Priority events (a) bypass the spam
    #: filter, (b) ride a deeper bound (MAX_PENDING_PRIORITY), (c) may
    #: evict a buffered non-priority event when the shared bound is hit,
    #: and (d) drain first.
    PRIORITY_REASONS = frozenset({"Scheduled"})

    #: bound for priority-reason events: deep enough to absorb one
    #: scheduler super-batch of binds (bench batch-size 16384 order),
    #: still a hard cap — DropIfChannelFull semantics survive.
    MAX_PENDING_PRIORITY = 16384

    #: create() concurrency per drain window: the wire transport coalesces
    #: a whole window into one multiplexed frame, so draining 128-wide
    #: instead of one-awaited-create-per-tick is what keeps the buffer
    #: ahead of a scheduling burst (the drop-rate fix).
    DRAIN_WINDOW = 128

    #: The window scales with the drained backlog (batch/4, capped here):
    #: a 5000-agent mark-Running burst lands ~5k events in one batch, and
    #: at a fixed 128 the drain takes ~40 sequential gather round trips —
    #: long enough for the NEXT burst to overflow even the priority bound
    #: (the r8 5000Nodes row's residual ≤1.6k drops). Proportional width
    #: keeps round trips per batch roughly constant as agent count grows.
    DRAIN_WINDOW_MAX = 1024

    def __init__(self, store: MVCCStore, component: str):
        self.store = store
        self.component = component
        #: per-(source, reason) token bucket: a repeating reason that
        #: outruns its refill budget sheds EARLY, before it can occupy
        #: buffer slots the priority reasons need.
        self._spam = _SpamFilter()
        self._pending: list[dict] = []
        #: EventCorrelator-lite (record/events_cache.go EventAggregator):
        #: (kind, namespace, name, type, reason) → the pending Event dict,
        #: so a repeat while the first is still buffered bumps `count`
        #: instead of occupying another slot. Aggregation is buffer-local
        #: — once drained, a recurrence creates a fresh Event (the
        #: reference would PATCH the stored one; not worth a read-modify-
        #: write per recurrence here).
        self._pending_by_key: dict[tuple, dict] = {}
        self._draining = False
        #: the running drain, which `flush` waits on.
        self._drain_task: asyncio.Future | None = None
        self.dropped = 0
        #: every event() call, dropped or not — dropped/emitted is the
        #: drop RATE consumers (the perf harness detail JSON) report.
        self.emitted = 0
        #: event() calls folded into an already-pending Event's count.
        self.aggregated = 0
        #: drops attributable to the per-(source, reason) spam filter
        #: (a subset of `dropped`).
        self.spam_filtered = 0
        #: buffer-full drops per (source component, reason), for log
        #: rate limiting only — one warning per DECADE of drops per key
        #: (1st, 10th, 100th, ...), so a storm of one reason can't bury
        #: the first drop of another. The public counters above are the
        #: accounting; this dict never feeds metrics.
        self._full_drops_by_key: dict[tuple[str, str], int] = {}
        #: cumulative host seconds of the drain's event writes into the
        #: store, each write timed alone, so the drain's own waits are not
        #: in it; a write that suspends (a store over a wire) also counts
        #: what other tasks ran meanwhile.
        self.timings = {"drain_s": 0.0}

    def event(self, obj: Mapping, event_type: str, reason: str, message: str) -> None:
        """Fire-and-forget, like the reference's buffered broadcaster."""
        self.emitted += 1
        agg_key = (obj.get("kind", ""), namespace_of(obj), name_of(obj),
                   event_type, reason)
        pending = self._pending_by_key.get(agg_key)
        if pending is not None:
            pending["count"] = pending.get("count", 1) + 1
            pending["lastTimestamp"] = now_iso()
            self.aggregated += 1
            # Still kick the drainer: the buffer may predate the loop
            # (events recorded before asyncio.run), and an aggregated
            # recurrence must flush it just like a fresh event would.
            self._kick_drain()
            return
        priority = reason in self.PRIORITY_REASONS
        if not priority and not self._spam.allow(self.component, reason):
            # Reason family over its token budget: shed here, before the
            # repeat can occupy a slot (EventSourceObjectSpamFilter).
            self.spam_filtered += 1
            self.dropped += 1
            return
        limit = self.MAX_PENDING_PRIORITY if priority else self.MAX_PENDING
        if len(self._pending) >= limit:
            if priority and self._evict_non_priority():
                self.dropped += 1  # the evicted event
            else:
                self.dropped += 1
                key = (self.component, reason)
                n = self._full_drops_by_key.get(key, 0) + 1
                self._full_drops_by_key[key] = n
                # Log on the 1st, 10th, 100th, ... drop of each
                # (source, reason) — a power-of-ten check, so the log
                # volume is O(log drops) per key however hot the storm.
                if _is_decade(n):
                    logger.warning(
                        "event buffer full (%d pending); dropped %d "
                        "%s/%s events (%d total) so far "
                        "(DropIfChannelFull)",
                        len(self._pending), n, self.component, reason,
                        self.dropped)
                return
        ev = new_object(
            "Event",
            f"{name_of(obj)}.{next(_seq):x}",
            namespace_of(obj) or "default",
            involvedObject={
                "kind": obj.get("kind", ""),
                "name": name_of(obj),
                "namespace": namespace_of(obj),
                "uid": obj.get("metadata", {}).get("uid", ""),
            },
            type=event_type,  # Normal | Warning
            reason=reason,
            message=message,
            source={"component": self.component},
            firstTimestamp=now_iso(),
            count=1,
        )
        self._pending.append(ev)
        self._pending_by_key[agg_key] = ev
        self._kick_drain()

    def _evict_non_priority(self) -> bool:
        """Drop the newest buffered NON-priority event to admit a
        priority one (the drain-priority bump's admission side): under a
        bind burst, "Scheduled" displaces retry noise, never vice versa.
        Scans from the tail — recent entries are the likely noise; runs
        only on the already-degraded buffer-full path."""
        for i in range(len(self._pending) - 1, -1, -1):
            ev = self._pending[i]
            if ev.get("reason") in self.PRIORITY_REASONS:
                continue
            del self._pending[i]
            io = ev.get("involvedObject") or {}
            self._pending_by_key.pop(
                (io.get("kind", ""), io.get("namespace", ""),
                 io.get("name", ""), ev.get("type", ""),
                 ev.get("reason", "")), None)
            return True
        return False

    def _kick_drain(self) -> None:
        if self._draining or not self._pending:
            return
        # Only create the drain coroutine when a loop is actually
        # running — otherwise it would be dropped un-awaited and warn.
        # With no loop (sync unit tests) the buffer flushes with the
        # next event recorded under a loop.
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return
        self._drain_task = asyncio.ensure_future(self._drain())
        self._draining = True

    async def flush(self) -> None:
        """Wait until every buffered event has been written or refused
        by the store. A caller that is about to close the store calls
        this first, so that no write is still in flight when it goes."""
        self._kick_drain()
        while self._draining:
            await self._drain_task
            self._kick_drain()

    async def _write(self, ev: dict) -> None:
        """One buffered event into the store, timed into
        `timings["drain_s"]`."""
        rng = range_start("recorder.drain")
        t0 = time.perf_counter()
        try:
            await self.store.create("events", ev, _owned=True,
                                    return_copy=False)
        finally:
            self.timings["drain_s"] += time.perf_counter() - t0
            range_end(rng)

    async def _drain(self) -> None:
        try:
            while self._pending:
                batch, self._pending = self._pending, []
                # Batch taken: its entries can no longer aggregate (the
                # writes are in flight); recurrences start fresh Events.
                self._pending_by_key.clear()
                # Drain-priority bump: priority reasons write first, so a
                # mid-drain process exit or store failure loses noise,
                # not per-pod "Scheduled" signal. Stable sort keeps
                # arrival order within each class.
                batch.sort(key=lambda ev:
                           ev.get("reason") not in self.PRIORITY_REASONS)
                window = min(max(self.DRAIN_WINDOW, len(batch) // 4),
                             self.DRAIN_WINDOW_MAX)
                for lo in range(0, len(batch), window):
                    # The recorder built these and never touches them
                    # again (_owned); store rejections are per-event debug
                    # noise (the pre-batch behavior), but a programming
                    # error must stay loud — not vanish into a dropped
                    # gather result.
                    results = await asyncio.gather(
                        *(self._write(ev) for ev in batch[lo:lo + window]),
                        return_exceptions=True)
                    for r in results:
                        if isinstance(r, StoreError):
                            logger.debug("event write failed: %s", r)
                        elif isinstance(r, Exception):
                            logger.exception("event drain error",
                                             exc_info=r)
                        elif isinstance(r, BaseException):
                            raise r  # CancelledError: stop draining
        finally:
            self._draining = False
