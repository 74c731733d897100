"""Store durability: WAL + periodic snapshot + crash recovery.

Parity target (SURVEY §5.4 "Build: store WAL+snapshot"): etcd's raft
log + snapshot cycle, scaled to the in-process store. Every committed
event appends one line to an append-only log BEFORE watch dispatch; a
periodic (or size-triggered) snapshot writes the full `dump()` and
starts a fresh log segment; recovery loads the newest snapshot and
replays its segment's tail.

Files in the durability directory:
    snapshot-<rv>.json      full store state as of <rv>
    wal-<rv>.log            events with rv > <rv>, one JSON line each:
                            [rv, TYPE, resource, object]

Semantics (tests/test_torch_durability.py holds them against the
reference):
- recovered stores keep RESOURCEVERSION CONTINUITY: the next write gets
  the next rv, uids survive, CAS preconditions keep working;
- watches resume across restart: replayed WAL events re-seed the watch
  ring, so `watch(resource_version=rv_before_crash)` streams the writes
  the watcher missed; rv older than the newest snapshot → 410 Expired
  (the relist signal), exactly the informer contract;
- fsync policy: "always" (fsync per commit — the reference's default
  etcd posture) or "batch" (fsync on flush ticks — group commit).

Copy of `kubernetes_tpu/store/durable.py`: the same file names, record
layout and JSON encoding, so either package recovers the other's
directory.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import re
import time
from typing import Iterable

from kubernetes_tpu_torch.store.mvcc import Event, MVCCStore

logger = logging.getLogger(__name__)

_SNAP_RE = re.compile(r"^snapshot-(\d+)\.json$")
_WAL_RE = re.compile(r"^wal-(\d+)\.log$")


class WriteAheadLog:
    """Append-only event log attached to a store via add_event_sink."""

    def __init__(self, store: MVCCStore, directory: str, *,
                 fsync: str | None = None, metrics=None):
        from kubernetes_tpu_torch.metrics.registry import DurabilityMetrics
        from kubernetes_tpu_torch.utils import flags
        self.store = store
        self.dir = directory
        #: fsync policy: explicit argument wins, else KTPU_WAL_FSYNC
        #: ("batch" group commit / "always" per-commit).
        self.fsync = fsync or flags.get("KTPU_WAL_FSYNC")
        self.metrics = metrics or DurabilityMetrics()
        os.makedirs(directory, exist_ok=True)
        self._base_rv = store.resource_version
        self._fh = open(self._wal_path(self._base_rv), "a",
                        encoding="utf-8")
        self._dirty = False
        #: set on the first append/flush failure: the log stops growing
        #: (a HOLE in the log would be worse than a shorter durable
        #: prefix) and the health flag surfaces the degradation.
        self.broken = False
        #: KTPU_WAL=0 structural kill switch: snapshot-only durability
        #: (the r16 shape) — the sink never attaches, so commits cost
        #: zero and recovery replays nothing between snapshots.
        self.enabled = bool(flags.get("KTPU_WAL"))
        if self.enabled:
            store.add_event_sink(self._on_event)

    def _wal_path(self, base_rv: int) -> str:
        return os.path.join(self.dir, f"wal-{base_rv}.log")

    def _snap_path(self, rv: int) -> str:
        return os.path.join(self.dir, f"snapshot-{rv}.json")

    # -- appending ---------------------------------------------------------

    def _on_event(self, resource: str, ev: Event) -> None:
        if ev.type == "BOOKMARK" or self.broken:
            return
        record = [ev.rv, ev.type, resource, ev.object]
        if ev.prev_labels is not None or ev.prev_fields is not None:
            # Label/field-transition info survives replay, so selector and
            # field watches resuming across restart still see synthesized
            # ADDED/DELETED transitions (cacher prevObject semantics).
            record.append(ev.prev_labels)
            if ev.prev_fields is not None:
                record.append(ev.prev_fields)
        try:
            self._fh.write(json.dumps(record, separators=(",", ":"))
                           + "\n")
            self.metrics.appends.inc()
            if self.fsync == "always":
                # Synchronous durability (the etcd posture): the commit
                # is not acknowledged cheaper than the disk. "batch"
                # trades a flush-interval durability window for keeping
                # fsync off the commit path.
                self._fh.flush()
                t0 = time.perf_counter()
                os.fsync(self._fh.fileno())
                self.metrics.fsync_seconds.observe(
                    time.perf_counter() - t0)
            else:
                self._dirty = True
        except (OSError, ValueError, TypeError):
            # TypeError: unserializable object — skipping just one record
            # would punch a silent hole in the log, so freeze instead.
            self.broken = True
            logger.exception(
                "WAL append failed; log is now FROZEN at a consistent "
                "prefix (durability degraded, store stays live)")

    def flush(self) -> None:
        """Group commit (fsync="batch"), synchronous: python buffer → OS
        → disk. Safe only from the event loop (TextIOWrapper is not
        thread-safe against concurrent writes)."""
        if self._dirty and not self.broken:
            try:
                self._fh.flush()
                t0 = time.perf_counter()
                os.fsync(self._fh.fileno())
                self.metrics.fsync_seconds.observe(
                    time.perf_counter() - t0)
                self._dirty = False
            except (OSError, ValueError):
                self.broken = True
                logger.exception("WAL flush failed; log FROZEN")

    def flush_to_os(self) -> int | None:
        """Loop-side half of the threaded group commit: drain the
        TextIOWrapper buffer (must happen on the loop — concurrent
        write()/flush() on a text file corrupts it) and return the fd
        for the caller to fsync OFF the loop. None = nothing to sync."""
        if not self._dirty or self.broken:
            return None
        try:
            self._fh.flush()
            self._dirty = False
            return self._fh.fileno()
        except (OSError, ValueError):
            self.broken = True
            logger.exception("WAL flush failed; log FROZEN")
            return None

    # -- snapshot + compaction --------------------------------------------

    def snapshot(self) -> int:
        """Write a full-state snapshot at the current rv, rotate to a
        fresh WAL segment, and delete obsolete files. Returns the rv."""
        data, rv = self.begin_snapshot()
        self.write_snapshot(data, rv)
        return rv

    def begin_snapshot(self) -> tuple[str, int]:
        """Phase A, ATOMIC ON THE EVENT LOOP (no awaits): capture state
        and rotate the segment in one step, so no event can land in the
        old segment after the captured rv (an event there would be
        skipped by recovery once the new snapshot exists) and none can
        hit a closed file handle."""
        rv = self.store.resource_version
        data = self.store.dump()
        self.flush()
        self._fh.close()
        self._base_rv = rv
        self._fh = open(self._wal_path(rv), "a", encoding="utf-8")
        return data, rv

    def write_snapshot(self, data: str, rv: int) -> None:
        """Phase B, thread-safe (no store access): persist the captured
        state and only THEN compact older files — a crash in between
        leaves old snapshot + both segments, which recovery handles."""
        tmp = self._snap_path(rv) + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self._snap_path(rv))
        self._gc(keep_rv=rv)

    def _gc(self, keep_rv: int) -> None:
        for fn in os.listdir(self.dir):
            m = _SNAP_RE.match(fn) or _WAL_RE.match(fn)
            # A crash between the tmp write and os.replace leaves a
            # .tmp orphan; recovery never reads one (the name doesn't
            # match), so reclaim it with the other obsolete files.
            if fn.endswith(".tmp") or (m and int(m.group(1)) < keep_rv):
                try:
                    os.unlink(os.path.join(self.dir, fn))
                except OSError:
                    pass

    def close(self) -> None:
        self.store.remove_event_sink(self._on_event)
        self.flush()
        self._fh.close()


class DurabilityManager:
    """Owns the WAL + the periodic flush/snapshot loop for one store."""

    def __init__(self, store: MVCCStore, directory: str, *,
                 fsync: str | None = None, flush_interval_s: float = 0.05,
                 snapshot_interval_s: float = 30.0,
                 snapshot_every_events: int = 100_000,
                 metrics=None):
        self.store = store
        self.wal = WriteAheadLog(store, directory, fsync=fsync,
                                 metrics=metrics)
        self.flush_interval_s = flush_interval_s
        self.snapshot_interval_s = snapshot_interval_s
        self.snapshot_every_events = snapshot_every_events
        self._task: asyncio.Task | None = None
        #: in-flight background write_snapshot (an executor future).
        #: Cancelling _task mid-await does NOT stop the worker thread,
        #: so stop() awaits this before its own final snapshot — two
        #: writers interleaving segment rotation was the crash-corruption
        #: window tests/test_torch_durability.py pins closed.
        self._snap_inflight = None

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._loop())

    async def _loop(self) -> None:
        import time
        last_snap = time.monotonic()
        try:
            while True:
                await asyncio.sleep(self.flush_interval_s)
                # Buffer drain on the loop (text I/O is not thread-safe
                # against concurrent writes); only the fsync goes to a
                # worker thread. Durability window in "batch" mode is
                # one flush interval.
                fd = self.wal.flush_to_os()
                if fd is not None:
                    try:
                        t0 = time.perf_counter()
                        await asyncio.to_thread(os.fsync, fd)
                        self.wal.metrics.fsync_seconds.observe(
                            time.perf_counter() - t0)
                    except OSError:
                        # Genuine sync failure (nothing rotates this fd
                        # concurrently — snapshot rotation runs later in
                        # THIS task): records the store already
                        # acknowledged may not be on disk → freeze, same
                        # contract as an append failure.
                        self.wal.broken = True
                        logger.exception(
                            "WAL fsync failed; log FROZEN")
                now = time.monotonic()
                log_span = self.store.resource_version - self.wal._base_rv
                if log_span > 0 and (
                        now - last_snap >= self.snapshot_interval_s
                        or log_span >= self.snapshot_every_events):
                    # Capture + rotate atomically on the loop; the disk
                    # write runs in a worker thread. The executor future
                    # is kept (not to_thread) so stop() can await the
                    # thread even after cancelling this task. Idle
                    # clusters (log_span 0) skip re-snapshotting
                    # identical state.
                    data, rv = self.wal.begin_snapshot()
                    self._snap_inflight = \
                        asyncio.get_running_loop().run_in_executor(
                            None, self.wal.write_snapshot, data, rv)
                    # shield: cancelling THIS task must detach the
                    # awaiter, not cancel the future — a cancelled
                    # wrapper is unawaitable while its worker thread
                    # still writes, which is exactly what stop() needs
                    # to wait out.
                    await asyncio.shield(self._snap_inflight)
                    # Cleared only AFTER a normal completion: a
                    # cancellation mid-await leaves the reference for
                    # stop() to drain.
                    self._snap_inflight = None
                    last_snap = now
        except asyncio.CancelledError:
            return

    async def stop(self, *, final_snapshot: bool = False) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        # Serialize against a background write_snapshot whose worker
        # thread survived the cancellation: letting the final snapshot
        # below run concurrently with it interleaves two segment
        # rotations + two _gc passes (the mid-snapshot corruption the
        # crash-atomicity satellite exists to rule out).
        inflight, self._snap_inflight = self._snap_inflight, None
        if inflight is not None:
            try:
                await inflight
            except Exception:
                logger.exception(
                    "background snapshot failed during stop")
        if final_snapshot:
            self.wal.snapshot()
        self.wal.close()


def _latest(directory: str, pattern: re.Pattern) -> list[tuple[int, str]]:
    out = []
    for fn in os.listdir(directory):
        m = pattern.match(fn)
        if m:
            out.append((int(m.group(1)), os.path.join(directory, fn)))
    return sorted(out)


def _iter_wal(path: str) -> Iterable[
        tuple[int, str, str, dict, dict | None, dict | None]]:
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                rv, ev_type, resource, obj = rec[:4]
                prev_labels = rec[4] if len(rec) > 4 else None
                prev_fields = rec[5] if len(rec) > 5 else None
            except (json.JSONDecodeError, ValueError, IndexError):
                # Torn tail write from a crash: everything before it is
                # durable; the torn record never committed to callers
                # (fsync order) — stop replay here, like etcd.
                logger.warning("WAL %s: torn record, truncating replay",
                               path)
                return
            yield int(rv), ev_type, resource, obj, prev_labels, prev_fields


def recover_store(directory: str,
                  factory=None, *, rv_source=None,
                  metrics=None) -> MVCCStore:
    """Rebuild a store from the newest snapshot + its WAL segment tail.

    `factory` (optional) builds the empty store when there is no
    snapshot — pass `new_cluster_store` to get validation/subresources
    installed; recovery with a snapshot uses MVCCStore.load then the
    caller re-installs hooks (install_core_validation is idempotent).
    `rv_source` threads a shared RV counter into the rebuilt store (the
    multi-process shard restart path: recovery must never regress the
    live global counter). `metrics` (DurabilityMetrics) counts replayed
    events into wal_replay_entries_total.

    Replayed events re-enter the watch ring: a watcher resuming with an
    rv newer than the snapshot base sees exactly the missed events; an
    older rv raises Expired (410) → relist, the informer contract.
    """
    from kubernetes_tpu_torch.store.mvcc import binding_subresource
    snaps = _latest(directory, _SNAP_RE)
    if snaps:
        snap_rv, snap_path = snaps[-1]
        with open(snap_path, encoding="utf-8") as f:
            store = MVCCStore.load(f.read(), rv_source=rv_source)
    else:
        snap_rv = 0
        if factory is not None:
            store = factory()
        else:
            store = MVCCStore(rv_source=rv_source)
    # Core subresources survive recovery (new_cluster_store parity).
    store.register_subresource("pods", "binding", binding_subresource)
    # Replay WAL segments based at or after the snapshot (older segments
    # were compacted; a crash between snapshot and _gc leaves both).
    for base_rv, path in _latest(directory, _WAL_RE):
        if base_rv < snap_rv:
            continue
        for rv, ev_type, resource, obj, prev_labels, prev_fields \
                in _iter_wal(path):
            if rv <= snap_rv:
                continue  # already inside the snapshot
            table = store._table(resource)
            key = store._key(obj)
            if ev_type == "DELETED":
                table.pop(key, None)
            else:
                table[key] = obj
            store._rv = max(store.resource_version, rv)
            if metrics is not None:
                metrics.replayed.inc()
            store._events.append(
                (resource, Event(ev_type, obj, rv, prev_labels,
                                 prev_fields)))
    # Watch-resume window: everything since the snapshot is replayable;
    # anything older is compacted (410 Expired → relist).
    store._first_retained_rv = snap_rv + 1
    return store
