"""Cross-process ResourceVersion allocation.

The in-process sharded store (store/sharded.py) keeps RVs globally
monotonic by handing ONE `RVCounter` object to every shard. When each
shard becomes its own OS process that object can't be shared by
reference anymore — this module replaces it with a counter over a
`multiprocessing.Value("q")` in shared memory, so allocation stays a
single atomic increment (no allocator process, no RPC on the commit
path) and the contract the single counter gave us survives:

- a merged LIST's RV is resumable on any shard's watch,
- pinned continue tokens address one global snapshot on every shard,
- per-key event order any watcher observes is cluster-wide commit order.

`SharedRVCounter` is duck-compatible with `RVCounter` (`next()`, a
mutable `.value`) so `MVCCStore(rv_source=...)` takes it unchanged.
The one semantic addition: the `.value` SETTER is monotonic (max).
A recovering shard calls `MVCCStore.load()` / WAL replay, which
assigns the snapshot's RV — under a shared counter that assignment
must never roll the cluster-wide clock back past RVs other shards
already handed out.

Copy of `kubernetes_tpu/multiproc/rv.py`.
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.sharedctypes


class SharedRVCounter:
    """`RVCounter` over shared memory: one atomic int64 across every
    control-plane process. Picklable through the spawn channel (the
    synchronized Value rides `multiprocessing.Process` args)."""

    __slots__ = ("_shared",)

    def __init__(self, shared=None, *, ctx=None):
        if shared is None:
            ctx = ctx or multiprocessing.get_context("spawn")
            shared = ctx.Value("q", 0)
        self._shared = shared

    def next(self) -> int:
        with self._shared.get_lock():
            self._shared.value += 1
            return self._shared.value

    @property
    def value(self) -> int:
        with self._shared.get_lock():
            return self._shared.value

    @value.setter
    def value(self, v: int) -> None:
        # Monotonic: recovery (snapshot load, WAL replay) fast-forwards
        # the global clock to at least its own high-water mark but can
        # never regress RVs other shards already allocated.
        v = int(v)
        with self._shared.get_lock():
            if v > self._shared.value:
                self._shared.value = v
