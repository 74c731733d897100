"""Runtime lock-order and dispatch-hygiene detector (`KTPU_LOCK_CHECK=1`).

Copy of `kubernetes_tpu/utils/locking.py`: the runtime detector of lock
order inversions and of locks held across a device fetch.

`new_lock(name)` is the only constructor the tree uses. With the flag
off (the default) it returns a plain `threading.Lock` — ZERO overhead,
nothing imported on the hot path, no bookkeeping. With
`KTPU_LOCK_CHECK=1` it returns an `InstrumentedLock` that

- records the per-thread acquisition stack and the global observed
  order graph (directed edges outer→inner, keyed by lock NAME so
  instances of one class alias to one node);
- raises `LockOrderError` the moment an acquisition INVERTS an edge
  observed earlier (the classic ABBA deadlock, caught on first
  occurrence instead of on the unlucky interleaving);
- backs `check_dispatch_seam()`: the sanctioned device-fetch and
  wire-send seams call it, and it raises `LockHeldAcrossDispatchError`
  when the calling thread still holds any instrumented lock — a lock
  held across a device round-trip or a socket write is a stall.

`check_dispatch_seam` is free when nothing is instrumented: it reads
one thread-local and returns — no env read, no branch on flag state —
so it can sit on per-chunk and per-frame paths unconditionally.
"""

from __future__ import annotations

import threading
import traceback

from kubernetes_tpu_torch.utils import flags

__all__ = ["InstrumentedLock", "LockOrderError",
           "LockHeldAcrossDispatchError", "new_lock",
           "check_dispatch_seam", "held_locks", "reset_observed"]


class LockOrderError(RuntimeError):
    """An acquisition inverted a previously observed lock order."""


class LockHeldAcrossDispatchError(RuntimeError):
    """A dispatch/fetch/wire-send seam ran with a lock held."""


_tls = threading.local()
#: observed order edges {(outer_name, inner_name): "site"} — guarded by
#: _graph_lock (a PLAIN lock: the detector must not instrument itself).
_edges: dict[tuple[str, str], str] = {}
_graph_lock = threading.Lock()


def _held_stack() -> list:
    stack = getattr(_tls, "held", None)
    if stack is None:
        stack = _tls.held = []
    return stack


class InstrumentedLock:
    """A `threading.Lock` that records acquisition order per thread.

    Same-NAME nesting is exempt from ordering (many instances share one
    name — e.g. every Counter's `metrics.counter` lock — and ordering
    between interchangeable instances carries no deadlock information
    the name-level graph can express)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()

    def _record_edges(self) -> None:
        stack = _held_stack()
        if not stack:
            return
        site = "".join(traceback.format_stack(limit=6)[:-2])
        with _graph_lock:
            for outer in stack:
                if outer.name == self.name:
                    continue
                inv = _edges.get((self.name, outer.name))
                if inv is not None:
                    raise LockOrderError(
                        f"lock order inversion: acquiring {self.name!r} "
                        f"while holding {outer.name!r}, but the opposite "
                        f"order ({self.name!r} -> {outer.name!r}) was "
                        f"observed earlier at:\n{inv}")
                _edges.setdefault((outer.name, self.name), site)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # Order is checked BEFORE blocking: an inversion must raise, not
        # deadlock the test run it exists to protect.
        self._record_edges()
        got = self._lock.acquire(blocking, timeout)
        if got:
            _held_stack().append(self)
        return got

    def release(self) -> None:
        stack = _held_stack()
        if self in stack:
            stack.remove(self)
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "InstrumentedLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


def new_lock(name: str):
    """The tree's lock constructor: a plain `threading.Lock` when the
    detector is off (zero overhead), an `InstrumentedLock` when
    `KTPU_LOCK_CHECK=1` — decided at construction, so long-lived locks
    created inside an enabled test are instrumented for their lifetime."""
    if flags.get("KTPU_LOCK_CHECK"):
        return InstrumentedLock(name)
    return threading.Lock()


def check_dispatch_seam(seam: str) -> None:
    """Raise when the calling thread holds any instrumented lock.

    Called from the sanctioned device-fetch seams (backend chunk fetch,
    fast-path fetch) and the wire send path; free when nothing is held."""
    stack = getattr(_tls, "held", None)
    if not stack:
        return
    names = [lk.name for lk in stack]
    raise LockHeldAcrossDispatchError(
        f"{seam}: dispatch seam entered while holding lock(s) {names} — "
        "a lock held across a device fetch or wire send stalls every "
        "other holder for the round-trip")


def held_locks() -> tuple[str, ...]:
    """Names of instrumented locks held by the calling thread."""
    stack = getattr(_tls, "held", None)
    return tuple(lk.name for lk in stack) if stack else ()


def reset_observed() -> None:
    """Clear the global order graph (test isolation)."""
    with _graph_lock:
        _edges.clear()
