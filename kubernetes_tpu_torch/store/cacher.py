"""Watch-cache serving tier: RV-snapshotted reads in front of the mvcc core.

Parity target: `storage/cacher/cacher.go` + `watch_cache.go` (SURVEY §L0).
The reference apiserver never serves LISTs or watch backfill from storage —
a dedicated watch cache fans ONE store watch out to N clients and answers
LIST/initial-sync from RV-snapshotted memory. This module is that tier:
every committed mvcc event flows through `Cacher.ingest`
(the single fan-in point `MVCCStore._record` calls — the in-process analog
of the cacher's one etcd watch), which maintains, per resource:

- a **snapshot**: key → stored object (refs shared with the store — the
  watch-event immutability discipline already covers them), plus a sorted
  key list and a tracked-field exact-value index, so a kubelet-shaped
  LIST (`spec.nodeName=<me>`) is O(matching) instead of an O(table)
  scan-and-copy per agent — the cold-start relist storm of N agents
  becomes N reads of one shared snapshot;
- an **event ring**: the last `ring_capacity` events with their
  pre-update objects, so watch backfill ("start at RV") is a bisect +
  slice instead of a scan over the store's global history, and LIST *at
  any cached RV* is a roll-back of the current snapshot — which is what
  pins paginated `continue` tokens to one snapshot RV across pages on
  every wire.

RV-semantics contract:

- LIST with no resourceVersion: the current snapshot, stamped with the
  store RV (the cacher is sink-fed, so it is always exactly fresh —
  the reference's waitUntilFreshAndList degenerates to a direct read).
- LIST resourceVersion=N + resourceVersionMatch=Exact: the snapshot as
  of RV N, rolled back through the ring; RVs older than the ring raise
  Expired (410), the client relists — same contract as watch backfill.
- LIST resourceVersion=N (NotOlderThan / legacy): the current snapshot
  (always ≥ N here); N beyond the store RV is Invalid.
- continue tokens are `"<rv>:<last-key>"`: every page of one paginated
  LIST is served at the first page's snapshot RV.
- WATCH from RV: backfill from the ring when the RV is retained;
  otherwise the request falls back to the mvcc core's global replay
  (`watch_direct`), which enforces the 410 window — so expiry behavior
  is exactly the store's.

The r8 interned selector index (`_ResourceWatchers`) remains the live
dispatch structure; with the cacher active every event reaches it through
this tier's fan-in, and watch *establishment* (the backfill scan) no
longer touches the store's global event list. `KTPU_WATCH_CACHE=0`
disables the tier entirely (MVCCStore then routes straight to its direct
paths).

Copy of `kubernetes_tpu/store/cacher.py`.
"""

from __future__ import annotations

import logging
from bisect import bisect_right, insort
from collections import OrderedDict
from typing import Any, Mapping

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.api.meta import deep_copy, namespace_of
from kubernetes_tpu_torch.metrics.registry import WatchCacheMetrics

logger = logging.getLogger(__name__)

#: Per-resource replay-ring depth. Unlike the store's single global
#: event window, the ring is per resource: lease-heartbeat churn cannot
#: age pod backfill out of reach.
DEFAULT_RING_CAPACITY = 100_000

#: Rolled-back historical snapshots memoized per (resource, rv): a
#: paginated LIST's continue pages all hit the same entry, so a storm of
#: same-RV pages materializes the snapshot once.
_SNAPSHOT_MEMO_SLOTS = 4


def make_continue(rv: int, last_key: str) -> str:
    """Snapshot-pinned continue token: `"<rv>:<last-key>"`. Keys are
    `ns/name` / `name` (DNS-ish, never containing ':'), so the split is
    unambiguous; legacy bare-key tokens parse as unpinned."""
    return f"{rv}:{last_key}"


def parse_continue(token: str | None) -> tuple[int | None, str | None]:
    """(pinned rv | None, continue key | None). Accepts legacy bare-key
    tokens (no pin) and the `"<rv>:"` empty-key form gRPC clients use to
    request an exact-RV first page without a proto field."""
    if not token:
        return None, None
    head, sep, rest = token.partition(":")
    if sep and head.isdigit():
        return int(head), rest or None
    return None, token


class _ResourceCache:
    """One resource's snapshot + ring (watch_cache.go watchCache)."""

    __slots__ = ("resource", "snapshot", "keys", "ring", "ring_floor",
                 "tracked", "field_index", "_ring_key")

    def __init__(self, resource: str, store):
        self.resource = resource
        table = store._table(resource)
        # Shared refs with the store: the one cold table read per
        # resource (the "≤1 mvcc LIST per resource" seed).
        self.snapshot: dict[str, dict] = dict(table)
        self.keys: list[str] = sorted(table.keys())
        #: ring entries (rv, key, Event, prev_obj|None), rv-monotonic.
        self.ring: list[tuple[int, str, Any, dict | None]] = []
        #: every event with rv > ring_floor is retained in the ring;
        #: requests below it fall back to the mvcc core.
        self.ring_floor = store.resource_version
        self.tracked: tuple[str, ...] = \
            store._tracked_fields.get(resource, ())
        self.field_index: dict[str, dict[str, set[str]]] = \
            {f: {} for f in self.tracked}
        if self.tracked:
            from kubernetes_tpu_torch.store.mvcc import _field_value
            for key, obj in table.items():
                for f in self.tracked:
                    self.field_index[f].setdefault(
                        _field_value(obj, f), set()).add(key)
        self._ring_key = (resource,)  # cached gauge label tuple


class Cacher:
    """The serving tier for one MVCCStore. Owned by the store
    (`MVCCStore.cacher`); `list()`/`watch()` are what the store's routed
    public methods delegate to when the tier is active."""

    def __init__(self, store, ring_capacity: int = DEFAULT_RING_CAPACITY):
        self._store = store
        self._ring_capacity = ring_capacity
        self._caches: dict[str, _ResourceCache] = {}
        self.metrics = WatchCacheMetrics()
        #: (resource, rv) -> (snapshot dict, sorted keys) LRU.
        self._memo: OrderedDict[tuple[str, int],
                                tuple[dict, list[str]]] = OrderedDict()

    # -- cache maintenance -------------------------------------------------

    def _cache(self, resource: str) -> _ResourceCache:
        c = self._caches.get(resource)
        if c is None:
            # Cold read of a never-written resource (writes seed their
            # resource in `ingest`): the table is empty or pre-seeded
            # state, one read, and the request is served from the tier
            # — not a miss; misses count requests handed to the core.
            c = self._caches[resource] = _ResourceCache(
                resource, self._store)
        return c

    def ingest(self, resource: str, ev) -> None:
        """Apply one committed event (called by `MVCCStore._record` for
        every write, before watch dispatch — the single fan-in). A
        resource's first write seeds its cache (the reference cacher
        runs from server start, so ring coverage spans the store's
        lifetime): the table copy already includes this event, so the
        seed absorbs it and coverage begins at `ev.rv`."""
        c = self._caches.get(resource)
        if c is None:
            self._caches[resource] = _ResourceCache(resource, self._store)
            return
        key = self._store._key(ev.object)
        prev = c.snapshot.get(key)
        if ev.type == "DELETED":
            if prev is not None:
                del c.snapshot[key]
                i = bisect_right(c.keys, key) - 1
                if 0 <= i < len(c.keys) and c.keys[i] == key:
                    del c.keys[i]
                self._index_move(c, key, prev, None)
        else:
            c.snapshot[key] = ev.object
            if prev is None:
                insort(c.keys, key)
            self._index_move(c, key, prev, ev.object)
        ring = c.ring
        ring.append((ev.rv, key, ev, prev))
        # Capped at the store's own event window too: a per-resource ring
        # must never serve an RV the store has contractually compacted
        # (the 410 window is API surface clients relist on).
        cap = min(self._ring_capacity, self._store._event_window)
        if len(ring) > cap:
            drop = len(ring) - cap
            c.ring_floor = ring[drop - 1][0]
            del ring[:drop]
        self.metrics.ring_len.set_key(c._ring_key, len(ring))

    @staticmethod
    def _index_move(c: _ResourceCache, key: str,
                    old: dict | None, new: dict | None) -> None:
        if not c.tracked:
            return
        from kubernetes_tpu_torch.store.mvcc import _field_value
        for f in c.tracked:
            idx = c.field_index[f]
            ov = _field_value(old, f) if old is not None else None
            nv = _field_value(new, f) if new is not None else None
            if ov == nv:
                continue
            if ov is not None:
                bucket = idx.get(ov)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        del idx[ov]
            if nv is not None:
                idx.setdefault(nv, set()).add(key)

    # -- historical snapshots ----------------------------------------------

    def _at(self, c: _ResourceCache,
            rv: int | None) -> tuple[dict, list[str]]:
        """(snapshot, sorted keys) as of `rv` (None = current). Rolls the
        current snapshot back through the ring's pre-update objects;
        memoized so paginated pages at one RV share the materialization.
        Caller has already range-checked rv against the ring floor."""
        if rv is None or rv >= self._store.resource_version:
            return c.snapshot, c.keys
        memo_key = (c.resource, rv)
        hit = self._memo.get(memo_key)
        if hit is not None:
            self._memo.move_to_end(memo_key)
            return hit
        snap = dict(c.snapshot)
        for erv, key, ev, prev in reversed(c.ring):
            if erv <= rv:
                break
            if prev is None:
                snap.pop(key, None)     # undo ADDED
            else:
                snap[key] = prev        # undo MODIFIED / DELETED
        keys = sorted(snap)
        self._memo[memo_key] = (snap, keys)
        while len(self._memo) > _SNAPSHOT_MEMO_SLOTS:
            self._memo.popitem(last=False)
        return snap, keys

    # -- LIST --------------------------------------------------------------

    async def list(
        self,
        resource: str,
        namespace: str | None = None,
        selector: Selector | None = None,
        limit: int = 0,
        continue_key: str | None = None,
        fields: Mapping[str, str] | None = None,
        resource_version: int | None = None,
        exact: bool = False,
        copy: bool = True,
    ):
        """LIST from the snapshot — bit-identical to the mvcc scan at the
        same RV (same sort order, same filters, same paging), without
        touching the store table. `exact` pins to the historical snapshot
        at `resource_version`; otherwise any cached RV means "current".
        `copy=False` skips the per-item deep copy for callers that only
        encode the result (the serving wires)."""
        from kubernetes_tpu_torch.store.mvcc import (
            Expired,
            Invalid,
            ListResult,
            _fields_match,
        )
        c = self._cache(resource)
        cur_rv = self._store.resource_version
        target: int | None = None
        if resource_version:
            if resource_version > cur_rv:
                raise Invalid(
                    f"resourceVersion {resource_version} is ahead of the "
                    f"store (current: {cur_rv})")
            if exact and resource_version != cur_rv:
                if resource_version < c.ring_floor:
                    raise Expired(
                        f"resourceVersion {resource_version} is too old "
                        f"(oldest retained: {c.ring_floor + 1})")
                target = resource_version
        self.metrics.hits.inc()
        snap, keys = self._at(c, target)
        out_rv = target if target is not None else cur_rv

        # Tracked-field exact-value candidates: the kubelet LIST shape
        # (`spec.nodeName=<me>`) reads its own keys off the index instead
        # of scanning the table — only on the live snapshot (historical
        # rollbacks carry no index and just scan).
        scan_keys = keys
        rest_fields = fields
        if fields and target is None:
            f = next((f for f in fields if f in c.tracked), None)
            if f is not None:
                scan_keys = sorted(c.field_index[f].get(fields[f], ()))
        if continue_key:
            scan_keys = scan_keys[bisect_right(scan_keys, continue_key):]

        has_sel = selector is not None and selector.requirements
        items: list[dict] = []
        last_key = None
        for k in scan_keys:
            obj = snap[k]
            if namespace and namespace_of(obj) != namespace:
                continue
            if has_sel and not selector.matches(
                    obj.get("metadata", {}).get("labels")):
                continue
            if rest_fields and not _fields_match(rest_fields, obj):
                continue
            items.append(deep_copy(obj) if copy else obj)
            last_key = k
            if limit and len(items) >= limit:
                break
        cont = None
        if limit and len(items) >= limit and last_key is not None:
            cont = make_continue(out_rv, last_key)
        return ListResult(items=items, resource_version=out_rv, cont=cont)

    # -- WATCH establishment -----------------------------------------------

    async def watch(
        self,
        resource: str,
        resource_version: int = 0,
        namespace: str | None = None,
        selector: Selector | None = None,
        *,
        fields: Mapping[str, str] | None = None,
        bookmarks: bool = True,
    ):
        """Watch with ring-served backfill: events after `resource_version`
        come from this resource's ring (bisect + slice) instead of a scan
        over the store's global history. RVs older than the ring fall back
        to the mvcc core's replay path, which owns the 410 contract. Live
        dispatch (the interned selector index) is shared with the core."""
        from kubernetes_tpu_torch.store.mvcc import Expired
        c = self._cache(resource)
        if resource_version and resource_version > self._store.resource_version:
            # A future RV means the client's view predates a store
            # restart (RV counter regressed): resuming would silently
            # drop every event until the counter catches up. Expired
            # forces the relist that actually recovers.
            raise Expired(
                f"resourceVersion {resource_version} is ahead of the "
                f"store (current: {self._store.resource_version}); relist")
        if resource_version and resource_version < c.ring_floor:
            self.metrics.misses.inc()
            return await self._store.watch_direct(
                resource, resource_version, namespace, selector,
                fields=fields, bookmarks=bookmarks)
        self.metrics.hits.inc()
        replay = []
        if resource_version:
            ring = c.ring
            i = bisect_right(ring, resource_version,
                             key=lambda e: e[0])
            replay = [e[2] for e in ring[i:]]
        return self._store._open_watch(
            resource, resource_version, namespace, selector,
            fields=fields, bookmarks=bookmarks, replay=replay)
