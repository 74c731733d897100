"""Rate-limited work queues.

Parity target: staging/src/k8s.io/client-go/util/workqueue
(`Type` (dedup + in-flight tracking), `delaying_queue.go`,
`rate_limiting_queue.go`, `default_rate_limiters.go`:
ItemExponentialFailureRateLimiter + BucketRateLimiter `MaxOfRateLimiter`).

Semantics preserved exactly, because controllers depend on them:
- An item added while queued is deduped (one entry).
- An item added while *being processed* is re-queued only after the worker
  calls done() — so a given key is never processed concurrently.
- forget() resets an item's failure count; num_requeues() exposes it.

asyncio-native (workers are tasks, not goroutines). Copy of
`kubernetes_tpu/client/workqueue.py` (the PV binder controller's queue).
"""

from __future__ import annotations

import asyncio
import heapq
import time
from collections import deque
from typing import Any, Hashable


class ExponentialFailureRateLimiter:
    """per-item exponential backoff: base * 2^failures, capped."""

    def __init__(self, base_delay: float = 0.005, max_delay: float = 1000.0):
        self.base_delay = base_delay
        self.max_delay = max_delay
        self._failures: dict[Hashable, int] = {}

    def when(self, item: Hashable) -> float:
        n = self._failures.get(item, 0)
        self._failures[item] = n + 1
        return min(self.base_delay * (2 ** n), self.max_delay)

    def forget(self, item: Hashable) -> None:
        self._failures.pop(item, None)

    def num_requeues(self, item: Hashable) -> int:
        return self._failures.get(item, 0)


class WorkQueue:
    """Deduping queue with in-flight ("dirty"/"processing") tracking."""

    def __init__(self):
        self._queue: deque[Hashable] = deque()
        self._dirty: set[Hashable] = set()
        self._processing: set[Hashable] = set()
        self._cond = asyncio.Condition()
        self._shutting_down = False

    def __len__(self) -> int:
        return len(self._queue)

    async def add(self, item: Hashable) -> None:
        async with self._cond:
            if self._shutting_down or item in self._dirty:
                return
            self._dirty.add(item)
            if item in self._processing:
                return  # re-queued by done()
            self._queue.append(item)
            self._cond.notify()

    async def get(self) -> tuple[Any, bool]:
        """Returns (item, shutdown). Blocks until an item or shutdown."""
        async with self._cond:
            while not self._queue and not self._shutting_down:
                await self._cond.wait()
            if not self._queue:
                return None, True
            item = self._queue.popleft()
            self._processing.add(item)
            self._dirty.discard(item)
            return item, False

    async def done(self, item: Hashable) -> None:
        async with self._cond:
            self._processing.discard(item)
            if item in self._dirty:
                self._queue.append(item)
                self._cond.notify()

    async def shut_down(self) -> None:
        async with self._cond:
            self._shutting_down = True
            self._cond.notify_all()

    @property
    def shutting_down(self) -> bool:
        return self._shutting_down


class DelayingQueue(WorkQueue):
    """add_after support via a heap + single timer task.

    The timer is woken whenever a new item lands with an earlier deadline than
    the one it is sleeping toward (the reference's delaying_queue wakes its
    loop via waitingForAddCh on every AddAfter) — otherwise a 5 ms requeue
    would be stuck behind a minutes-long backoff.
    """

    def __init__(self):
        super().__init__()
        self._heap: list[tuple[float, int, Hashable]] = []
        self._seq = 0
        self._timer: asyncio.Task | None = None
        self._wake = asyncio.Event()

    async def add_after(self, item: Hashable, delay: float) -> None:
        if delay <= 0:
            await self.add(item)
            return
        at = time.monotonic() + delay
        earlier = not self._heap or at < self._heap[0][0]
        heapq.heappush(self._heap, (at, self._seq, item))
        self._seq += 1
        if self._timer is None or self._timer.done():
            self._timer = asyncio.ensure_future(self._drain())
        elif earlier:
            self._wake.set()

    async def _drain(self) -> None:
        while self._heap and not self._shutting_down:
            at, _, _ = self._heap[0]
            now = time.monotonic()
            if at > now:
                self._wake.clear()
                try:
                    await asyncio.wait_for(self._wake.wait(), at - now)
                except asyncio.TimeoutError:
                    pass
                continue
            _, _, item = heapq.heappop(self._heap)
            await self.add(item)

    async def shut_down(self) -> None:
        if self._timer:
            self._timer.cancel()
        await super().shut_down()


class RateLimitingQueue(DelayingQueue):
    """DelayingQueue + per-item failure rate limiter."""

    def __init__(self, rate_limiter: ExponentialFailureRateLimiter | None = None):
        super().__init__()
        self.rate_limiter = rate_limiter or ExponentialFailureRateLimiter()

    async def add_rate_limited(self, item: Hashable) -> None:
        await self.add_after(item, self.rate_limiter.when(item))

    def forget(self, item: Hashable) -> None:
        self.rate_limiter.forget(item)

    def num_requeues(self, item: Hashable) -> int:
        return self.rate_limiter.num_requeues(item)
