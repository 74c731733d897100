"""In-memory MVCC object store with etcd-compatible semantics.

Capability parity with the reference's storage stack
(staging/src/k8s.io/apiserver/pkg/storage/etcd3/store.go: `Create`, `Get`,
`GuaranteedUpdate` (CAS loop on ResourceVersion), `Delete`, `List`;
etcd3/watcher.go + storage/cacher/cacher.go: watch streams, bookmarks,
"410 Gone" on compacted revisions). etcd itself is out of scope — it is an
external dependency of the reference too; what every component actually
depends on is *these semantics*:

- A single monotonically-increasing **ResourceVersion** across the whole store.
- Every write bumps it; objects carry the RV of their last write.
- LIST returns a consistent snapshot + the store RV to resume watching from.
- WATCH(rv) replays every event after rv in order, then streams live events,
  with periodic **bookmark** events carrying the current RV.
- WATCH from an RV older than the retained window ⇒ **Expired** (410 Gone),
  client must relist (client-go Reflector handles this).
- **GuaranteedUpdate** = optimistic-concurrency read-modify-write retried on
  conflict — the primitive Binding, status updates, and controllers build on.

Concurrency model: single asyncio loop owns all state (the analog of the
reference's "one mutex around cacheImpl" discipline); the public API is async
and must be called from that loop.

Copy of `kubernetes_tpu/store/mvcc.py`.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Mapping

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.utils import flags
from kubernetes_tpu_torch.metrics.registry import WatchMetrics
from kubernetes_tpu_torch.utils.tracing import range_end, range_start
from kubernetes_tpu_torch.api.meta import (
    deep_copy,
    name_of,
    namespace_of,
    new_uid,
    set_creation_timestamp,
)

logger = logging.getLogger(__name__)


class StoreError(Exception):
    status = 500


class NotFound(StoreError):
    status = 404


class AlreadyExists(StoreError):
    status = 409


class Conflict(StoreError):
    """ResourceVersion precondition failed (optimistic concurrency)."""
    status = 409


class Expired(StoreError):
    """Requested RV has been compacted out of the event window (410 Gone)."""
    status = 410


class Invalid(StoreError):
    status = 422


@dataclass
class Event:
    """watch.Event (apimachinery pkg/watch): ADDED/MODIFIED/DELETED/BOOKMARK.

    `prev_labels` carries the pre-update labels (not on the wire) so selector
    watchers can be told when an object transitions *out* of their selector
    set — the reference cacher synthesizes a DELETED event in that case
    (cacher.go updateResourceVersion/dispatchEvent prevObject handling).
    """
    type: str
    object: dict
    rv: int
    prev_labels: dict | None = None
    #: pre-update values of registered field-selector fields (e.g. pods
    #: spec.nodeName) so field watchers see enter/leave transitions the
    #: same way label watchers do.
    prev_fields: dict | None = None
    #: `time.perf_counter()` when the store recorded the event (0.0: not
    #: recorded by this process's store, e.g. a bookmark or a wire
    #: event): informers read their watch lag from it.
    recorded_at: float = field(default=0.0, compare=False, repr=False)

    def to_wire(self) -> dict:
        return {"type": self.type, "object": self.object}


def _synth(ev: Event, ev_type: str) -> Event:
    """Synthesized enter/leave twin of `ev` (same object, same rv, new
    type). `_wire_src` links it back so the wire encoders reuse the one
    per-codec encoding of the shared object (encode-once fan-out): a
    MODIFIED event synthesized into ADDED for a whole selector group
    costs zero extra serializations."""
    twin = Event(ev_type, ev.object, ev.rv, ev.prev_labels, ev.prev_fields,
                 ev.recorded_at)
    twin._wire_src = ev
    return twin


@dataclass
class _WatchChannel:
    queue: asyncio.Queue
    resource: str
    namespace: str | None
    selector: Selector | None
    fields: Mapping[str, str] | None = None
    closed: bool = False
    #: index slot this channel registered under (see _ResourceWatchers):
    #: ("plain",) | ("field", f, v) | ("sel", sig) | ("residue",)
    slot: tuple | None = None


def _selector_sig(sel: Selector) -> tuple:
    """Intern key for a selector: order-insensitive requirement tuple, so
    N informers sharing one selector (however constructed) land in one
    dispatch group — the `_term_sig` interning idiom from ops/affinity."""
    return tuple(sorted(
        (r.key, r.op, tuple(r.values)) for r in sel.requirements))


class _ResourceWatchers:
    """Interned watcher index for ONE resource — the watch cache's
    per-selector indexed-trigger analog (cacher.go triggerFunc +
    watchCache indexed watchers, SURVEY §3.3). Dispatch cost is
    O(matching watchers + distinct selector signatures), not O(watchers):

    - `plain`: no selector, no fields — every event matches (modulo
      namespace); no predicate evaluation at all.
    - `fields`: tracked-field exact-value reverse map {field → {value →
      [channels]}} — a bind event routes to exactly the one agent bucket
      its spec.nodeName names (plus the pre-value bucket on MODIFIED so
      enter/leave transitions reach the side the object left).
    - `groups`: label-selector interning by signature — N watchers
      sharing a selector pay ONE predicate evaluation per event and
      share ONE synthesized enter/leave Event (and its wire encoding).
    - `residue`: watchers on untracked fields — the full joint predicate
      per event, exactly the pre-index behavior.
    """

    __slots__ = ("plain", "fields", "groups", "residue")

    def __init__(self):
        self.plain: list[_WatchChannel] = []
        self.fields: dict[str, dict[str, list[_WatchChannel]]] = {}
        self.groups: dict[tuple, tuple[Selector, list[_WatchChannel]]] = {}
        self.residue: list[_WatchChannel] = []

    def empty(self) -> bool:
        return not (self.plain or self.fields or self.groups
                    or self.residue)


def _field_value(obj: Mapping, dotted: str):
    """Walk `spec.nodeName`-style paths; missing → '' (the apiserver
    treats absent fields as empty strings in field selectors)."""
    cur = obj
    for part in dotted.split("."):
        if not isinstance(cur, Mapping):
            return ""
        cur = cur.get(part)
        if cur is None:
            return ""
    return cur if isinstance(cur, str) else str(cur)


def _fields_match(fields: Mapping[str, str], obj: Mapping) -> bool:
    return all(_field_value(obj, f) == v for f, v in fields.items())


@dataclass
class ListResult:
    items: list[dict]
    resource_version: int
    #: snapshot-pinned continue token (`"<rv>:<last-key>"`) when a
    #: limited page came off the watch-cache tier — every later page of
    #: the same LIST is served at this page's snapshot RV, on any wire.
    cont: str | None = None


# Retain this many events for watch replay before declaring RVs expired.
# (etcd compaction analog; sized so a relisting client never loses events
# under scheduler_perf churn.)
DEFAULT_EVENT_WINDOW = 200_000
BOOKMARK_INTERVAL_S = 5.0

# Debug guard (KTPU_DEBUG_FREEZE=1, enabled in tests): stored objects — which
# watch events share — are recursively frozen, so a handler that mutates a
# delivered object fails loudly instead of silently corrupting the source of
# truth with no RV bump. deep_copy() rebuilds plain dicts/lists, so copies
# handed to callers stay mutable.
_DEBUG_FREEZE = flags.get("KTPU_DEBUG_FREEZE")


def _frozen(*_a, **_k):
    raise TypeError(
        "attempt to mutate a stored/watch-delivered object; informer handlers "
        "must treat delivered objects as immutable (copy before modifying)")


class FrozenDict(dict):
    __setitem__ = __delitem__ = __ior__ = _frozen
    setdefault = update = pop = popitem = clear = _frozen


class FrozenList(list):
    __setitem__ = __delitem__ = __iadd__ = __imul__ = _frozen
    append = extend = insert = pop = remove = clear = sort = reverse = _frozen


def deep_freeze(obj):
    if isinstance(obj, dict):
        return FrozenDict((k, deep_freeze(v)) for k, v in obj.items())
    if isinstance(obj, list):
        return FrozenList(deep_freeze(v) for v in obj)
    return obj


def _maybe_freeze(obj: dict) -> dict:
    return deep_freeze(obj) if _DEBUG_FREEZE else obj


class RVCounter:
    """Mutable ResourceVersion source. One per store by default; the
    sharded control plane (store/sharded.py) hands ONE counter to all of
    its per-shard stores, so RVs stay globally monotonic across shards —
    a merged LIST's RV is resumable on every shard's watch, and pinned
    continue tokens address one global snapshot whichever shard serves
    the page (the etcd-revision-per-cluster contract, kept under
    partitioning)."""

    __slots__ = ("value",)

    def __init__(self, value: int = 0):
        self.value = value

    def next(self) -> int:
        self.value += 1
        return self.value


class MVCCStore:
    """The store. One instance per "cluster"; resources are table names
    ("pods", "nodes", "events", ...) — the GVR analog."""

    def __init__(self, event_window: int = DEFAULT_EVENT_WINDOW,
                 rv_source: RVCounter | None = None):
        # resource -> key -> object (key = "ns/name" or "name")
        self._tables: dict[str, dict[str, dict]] = {}
        self._rv_counter = rv_source or RVCounter()
        # Ring of (resource, Event) for watch replay.
        self._events: list[tuple[str, Event]] = []
        self._event_window = event_window
        self._first_retained_rv = 1
        self._watchers: list[_WatchChannel] = []
        #: resource -> interned watcher index; `_watchers` stays the flat
        #: registry (bookmarks, stop); the index is the dispatch path.
        self._index: dict[str, _ResourceWatchers] = {}
        #: dispatch efficiency counters (metrics/registry.py); the bench
        #: harness reports the deltas per measured phase.
        self.watch_metrics = WatchMetrics()
        #: cumulative host seconds of `_record`'s history append and trim,
        #: sinks and cacher ingest (`record_s`) and of its watch fan-out
        #: (`fanout_s`), and the events recorded. Their time is part of
        #: the caller's: a create's, a bind's, the event recorder's drain.
        #: The apiserver renders them at /metrics (`StoreClockMetrics`).
        self.timings = {"record_s": 0.0, "fanout_s": 0.0, "events": 0}
        self._bookmark_task: asyncio.Task | None = None
        # Subresource hooks, e.g. ("pods", "binding") -> handler.
        self._subresources: dict[tuple[str, str], Callable[..., Awaitable[dict]]] = {}
        # Admission/validation hooks per resource, run before create/update.
        self._validators: dict[str, list[Callable[[dict], None]]] = {}
        self._mutators: dict[
            str, list[tuple[Callable[[dict], None], frozenset[str]]]] = {}
        # CRD-registered kinds are store-local, not process globals: two
        # stores in one process must not share custom kind mappings, and a
        # deleted CRD must drop its entries (install_crd_support).
        self.custom_kinds: dict[str, str] = {}
        self.custom_cluster_scoped: set[str] = set()
        #: durability sinks (add_event_sink) — called per committed event.
        self._event_sinks: list = []
        #: resource -> fields whose PRE-update values ride each MODIFIED
        #: event so field watchers get enter/leave transitions. pods
        #: spec.nodeName is the registered default — the kubelet's watch
        #: shape (the reference apiserver indexes exactly this field).
        self._tracked_fields: dict[str, tuple[str, ...]] = {
            "pods": ("spec.nodeName", "status.phase")}
        #: direct (uncached) LIST scans per resource — the smoke guard's
        #: witness that a relist storm rides the cacher, not the table.
        self.list_direct_total: dict[str, int] = {}
        #: the watch-cache serving tier (store/cacher.py): RV-snapshotted
        #: LISTs, ring-served watch backfill, pinned continue tokens.
        #: Active by default; KTPU_WATCH_CACHE=0 is the kill switch that
        #: degrades every read to the direct-mvcc path below.
        self.cacher = None
        if flags.get("KTPU_WATCH_CACHE"):
            from kubernetes_tpu_torch.store.cacher import Cacher
            self.cacher = Cacher(self)

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def _key(obj: Mapping) -> str:
        ns = namespace_of(obj)
        return f"{ns}/{name_of(obj)}" if ns else name_of(obj)

    def _table(self, resource: str) -> dict[str, dict]:
        return self._tables.setdefault(resource, {})

    def _next_rv(self) -> int:
        return self._rv_counter.next()

    @property
    def _rv(self) -> int:
        return self._rv_counter.value

    @_rv.setter
    def _rv(self, value: int) -> None:
        self._rv_counter.value = value

    @property
    def resource_version(self) -> int:
        return self._rv_counter.value

    def _record(self, resource: str, ev: Event) -> None:
        tm = self.timings
        rng = range_start("store.record")
        t0 = ev.recorded_at = time.perf_counter()
        try:
            self._events.append((resource, ev))
            if len(self._events) > self._event_window:
                drop = len(self._events) - self._event_window
                self._first_retained_rv = self._events[drop - 1][1].rv + 1
                del self._events[:drop]
            # Durability sinks (store/durable.py WAL) observe every
            # committed event BEFORE watch dispatch — the etcd raft-log
            # position. A sink failure must not fail the (already
            # committed) write nor starve live watchers of the event: the
            # sink owns its own degradation (the WAL marks itself broken
            # and stops appending).
            for sink in self._event_sinks:
                try:
                    sink(resource, ev)
                except Exception:
                    logger.exception(
                        "event sink failed; write stays committed")
            # Single fan-in for the serving tier (SURVEY §L0: the cacher's
            # one store watch): the snapshot/ring absorb the event BEFORE
            # watch dispatch, so a handler that reads during dispatch sees
            # a cache consistent with the event it was handed.
            if self.cacher is not None:
                self.cacher.ingest(resource, ev)
        finally:
            t1 = time.perf_counter()
            tm["record_s"] += t1 - t0
            tm["events"] += 1
            range_end(rng)
        # One profiler check an event: the fan-out's range only where the
        # record's opened.
        rng = range_start("store.fanout") if rng is not None else None
        try:
            self._dispatch(resource, ev)
        finally:
            tm["fanout_s"] += time.perf_counter() - t1
            range_end(rng)

    def add_event_sink(self, sink) -> None:
        """Register a synchronous (resource, Event) observer for every
        committed write (SURVEY §5.4 WAL attachment point)."""
        self._event_sinks.append(sink)

    def remove_event_sink(self, sink) -> None:
        try:
            self._event_sinks.remove(sink)
        except ValueError:
            pass

    @staticmethod
    def _select_for(ev: Event, chan: _WatchChannel) -> Event | None:
        """JOINT label+field selection with set-transition synthesis:
        matched-before but not-after ⇒ DELETED; not-before but after ⇒
        ADDED (cacher.go dispatchEvent prevObject semantics; the field
        half is how `spec.nodeName=` watches serve kubelets — a bind looks
        like ADDED to the node's agent).

        prev/cur are each the CONJUNCTION of label-match and field-match
        BEFORE the event type is synthesized, like the reference cacher's
        joint predicate. Chaining one selector's synthesis into the other
        mis-delivers opposite-direction transitions (labels enter while
        spec.nodeName leaves in one update: joint prev and cur are both
        non-matching, yet the chain synthesized a DELETED for an object
        the watcher never saw)."""
        sel = chan.selector
        has_sel = sel is not None and sel.requirements
        fields = chan.fields
        if not has_sel and not fields:
            return ev
        cur_l = (not has_sel) or sel.matches(
            ev.object.get("metadata", {}).get("labels"))
        cur_f = (not fields) or _fields_match(fields, ev.object)
        cur = cur_l and cur_f
        if ev.type == "ADDED":
            prev = False
        else:
            prev_l = cur_l if not has_sel or ev.prev_labels is None \
                else sel.matches(ev.prev_labels)
            prev_f = cur_f if not fields or ev.prev_fields is None \
                else all(
                    ev.prev_fields.get(f, _field_value(ev.object, f)) == v
                    for f, v in fields.items())
            prev = prev_l and prev_f
        if ev.type == "DELETED":
            return ev if (cur or prev) else None
        if cur and not prev:
            return _synth(ev, "ADDED")
        if prev and not cur:
            return _synth(ev, "DELETED")
        return ev if cur else None

    @staticmethod
    def _select_labels(ev: Event, sel: Selector, labels) -> Event | None:
        """Label-only selection for an interned selector group (channels
        with no field predicate): evaluated ONCE per (event, signature);
        the result — including a synthesized enter/leave twin — is shared
        by every channel in the group."""
        cur = sel.matches(labels)
        if ev.type == "ADDED":
            prev = False
        else:
            prev = cur if ev.prev_labels is None \
                else sel.matches(ev.prev_labels)
        if ev.type == "DELETED":
            return ev if (cur or prev) else None
        if cur and not prev:
            return _synth(ev, "ADDED")
        if prev and not cur:
            return _synth(ev, "DELETED")
        return ev if cur else None

    # -- watcher registry / interned dispatch index ------------------------

    def _register_watcher(self, chan: _WatchChannel) -> None:
        """Classify a channel into its dispatch slot. Channels carrying a
        TRACKED field predicate index by that field's exact value (the
        kubelet's spec.nodeName watch shape); selector-only channels
        intern by selector signature; untracked-field channels fall back
        to the linear residue."""
        self._watchers.append(chan)
        idx = self._index.setdefault(chan.resource, _ResourceWatchers())
        has_sel = chan.selector is not None and chan.selector.requirements
        if chan.fields:
            tracked = self._tracked_fields.get(chan.resource, ())
            f = next((f for f in chan.fields if f in tracked), None)
            if f is not None:
                v = chan.fields[f]
                idx.fields.setdefault(f, {}).setdefault(v, []).append(chan)
                chan.slot = ("field", f, v)
            else:
                idx.residue.append(chan)
                chan.slot = ("residue",)
        elif has_sel:
            sig = _selector_sig(chan.selector)
            grp = idx.groups.get(sig)
            if grp is None:
                grp = idx.groups[sig] = (chan.selector, [])
            grp[1].append(chan)
            chan.slot = ("sel", sig)
        else:
            idx.plain.append(chan)
            chan.slot = ("plain",)

    def _unregister_watcher(self, chan: _WatchChannel) -> None:
        try:
            self._watchers.remove(chan)
        except ValueError:
            pass
        idx = self._index.get(chan.resource)
        if idx is None or chan.slot is None:
            return
        kind = chan.slot[0]
        try:
            if kind == "field":
                _, f, v = chan.slot
                bucket = idx.fields[f][v]
                bucket.remove(chan)
                if not bucket:
                    del idx.fields[f][v]
                    if not idx.fields[f]:
                        del idx.fields[f]
            elif kind == "sel":
                sig = chan.slot[1]
                chans = idx.groups[sig][1]
                chans.remove(chan)
                if not chans:
                    del idx.groups[sig]
            elif kind == "plain":
                idx.plain.remove(chan)
            else:
                idx.residue.remove(chan)
        except (KeyError, ValueError):
            pass
        chan.slot = None
        if idx.empty():
            self._index.pop(chan.resource, None)

    def _dispatch(self, resource: str, ev: Event) -> None:
        idx = self._index.get(resource)
        if idx is None:
            return
        m = self.watch_metrics
        ev_ns = namespace_of(ev.object)
        delivered = 0
        checks = 0
        # Plain watchers (informers): no predicate at all.
        for w in idx.plain:
            if w.closed or (w.namespace and ev_ns != w.namespace):
                continue
            w.queue.put_nowait(ev)
            delivered += 1
        # Tracked-field exact-value routing: the post-value bucket plus,
        # on MODIFIED with a changed value, the pre-value bucket — so
        # both sides of an enter/leave transition see it. Candidates run
        # the full joint predicate (they may carry extra fields or a
        # selector); candidate count is O(matching watchers).
        for f, buckets in idx.fields.items():
            cur_v = _field_value(ev.object, f)
            cand = (buckets.get(cur_v),)
            if ev.type == "MODIFIED" and ev.prev_fields is not None:
                prev_v = ev.prev_fields.get(f, cur_v)
                if prev_v != cur_v:
                    cand = (cand[0], buckets.get(prev_v))
            hit = False
            for bucket in cand:
                if not bucket:
                    continue
                hit = True
                for w in bucket:
                    if w.closed or (w.namespace and ev_ns != w.namespace):
                        continue
                    checks += 1
                    selected = self._select_for(ev, w)
                    if selected is not None:
                        w.queue.put_nowait(selected)
                        delivered += 1
            if hit:
                m.index_hits.inc()
        # Interned selector groups: one predicate evaluation (and one
        # synthesized twin, shared wire bytes) per signature.
        if idx.groups:
            labels = ev.object.get("metadata", {}).get("labels")
            for sel, chans in idx.groups.values():
                checks += 1
                selected = self._select_labels(ev, sel, labels)
                if selected is None:
                    continue
                for w in chans:
                    if w.closed or (w.namespace and ev_ns != w.namespace):
                        continue
                    w.queue.put_nowait(selected)
                    delivered += 1
        # Untracked-field watchers: the pre-index linear path.
        for w in idx.residue:
            if w.closed or (w.namespace and ev_ns != w.namespace):
                continue
            checks += 1
            selected = self._select_for(ev, w)
            if selected is not None:
                w.queue.put_nowait(selected)
                delivered += 1
        if delivered:
            m.events_dispatched.inc(delivered)
        if checks:
            m.predicate_checks.inc(checks)

    def register_subresource(
        self, resource: str, sub: str, handler: Callable[..., Awaitable[dict]]
    ) -> None:
        self._subresources[(resource, sub)] = handler

    def register_validator(self, resource: str, fn: Callable[[dict], None]) -> None:
        self._validators.setdefault(resource, []).append(fn)

    def register_mutator(self, resource: str, fn: Callable[[dict], None], *,
                         on: tuple[str, ...] = ("create", "update")) -> None:
        """`on` restricts which operations run the mutator — admission
        plugins like DefaultStorageClass apply at create only."""
        self._mutators.setdefault(resource, []).append((fn, frozenset(on)))

    def _admit(self, resource: str, obj: dict, op: str = "create") -> None:
        for fn, ops in self._mutators.get(resource, []):
            if op in ops:
                fn(obj)
        if op != "delete":  # schema validation guards writes, not removal
            for fn in self._validators.get(resource, []):
                fn(obj)

    # -- kind/scope lookup (built-ins + this store's CRDs) ------------------

    def resource_for_kind(self, kind: str) -> str | None:
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        return self.custom_kinds.get(kind) or KIND_TO_RESOURCE.get(kind)

    def is_cluster_scoped(self, resource: str) -> bool:
        from kubernetes_tpu_torch.api.meta import CLUSTER_SCOPED_RESOURCES
        return (resource in CLUSTER_SCOPED_RESOURCES
                or resource in self.custom_cluster_scoped)

    def kind_map(self) -> dict[str, str]:
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        merged = dict(KIND_TO_RESOURCE)
        merged.update(self.custom_kinds)
        return merged

    # -- CRUD --------------------------------------------------------------

    async def create(self, resource: str, obj: Mapping, *,
                     _owned: bool = False, return_copy: bool = True) -> dict | None:
        """etcd3 Create: txn If(ModRevision==0).Then(Put).

        `_owned=True` hands ownership of `obj` to the store (no entering
        copy — the caller must not touch it afterwards); `return_copy=False`
        skips the exit copy and returns None. Both are hot-path options
        (event recording, binding): deep-copying every wire object 4× per
        write is the store's top CPU cost at scheduler_perf scale.
        """
        obj = dict(obj) if _owned else deep_copy(dict(obj))
        key = self._key(obj)
        if not name_of(obj):
            raise Invalid(f"{resource}: metadata.name is required")
        table = self._table(resource)
        if key in table:
            raise AlreadyExists(f"{resource} {key!r} already exists")
        self._admit(resource, obj)
        set_creation_timestamp(obj)
        # The apiserver, not the client, owns uid assignment (registry
        # store PrepareForCreate). Constructor-made objects already carry
        # one; raw dicts (custom resources, YAML applies) get theirs here
        # so ownerReferences/GC work uniformly.
        obj["metadata"].setdefault("uid", new_uid())
        rv = self._next_rv()
        obj["metadata"]["resourceVersion"] = str(rv)
        obj = _maybe_freeze(obj)
        table[key] = obj
        # The watch event SHARES the stored object: watch consumers must
        # never mutate delivered objects — the convention client-go's shared
        # informer imposes (handlers all receive the one cached object).
        # Updates never mutate stored objects in place (they replace
        # table[key]), so shared references stay frozen at their RV. The
        # *returned* object stays a private copy: read-modify-write on it is
        # idiomatic for callers. KTPU_DEBUG_FREEZE=1 enforces the convention.
        self._record(resource, Event("ADDED", obj, rv))
        return deep_copy(obj) if return_copy else None

    async def get(self, resource: str, key: str) -> dict:
        table = self._table(resource)
        if key not in table:
            raise NotFound(f"{resource} {key!r} not found")
        return deep_copy(table[key])

    async def update(self, resource: str, obj: Mapping, *,
                     _owned: bool = False, return_copy: bool = True) -> dict | None:
        """Full replace with RV precondition when the object carries one.

        `_owned`/`return_copy`: see create().
        """
        obj = dict(obj) if _owned else deep_copy(dict(obj))
        key = self._key(obj)
        table = self._table(resource)
        if key not in table:
            raise NotFound(f"{resource} {key!r} not found")
        current = table[key]
        want_rv = obj.get("metadata", {}).get("resourceVersion")
        if want_rv and want_rv != current["metadata"]["resourceVersion"]:
            raise Conflict(
                f"{resource} {key!r}: resourceVersion mismatch "
                f"(have {current['metadata']['resourceVersion']}, got {want_rv})"
            )
        self._admit(resource, obj, "update")
        # Immutable metadata carries over (uid, creationTimestamp).
        obj["metadata"]["uid"] = current["metadata"].get("uid", obj["metadata"].get("uid"))
        obj["metadata"].setdefault(
            "creationTimestamp", current["metadata"].get("creationTimestamp")
        )
        rv = self._next_rv()
        obj["metadata"]["resourceVersion"] = str(rv)
        prev_labels = dict(current.get("metadata", {}).get("labels") or {})
        tracked = self._tracked_fields.get(resource)
        prev_fields = {f: _field_value(current, f)
                       for f in tracked} if tracked else None
        obj = _maybe_freeze(obj)
        table[key] = obj
        # Shared-object discipline: see create().
        self._record(resource,
                     Event("MODIFIED", obj, rv, prev_labels, prev_fields))
        return deep_copy(obj) if return_copy else None

    async def guaranteed_update(
        self, resource: str, key: str, mutate: Callable[[dict], dict | None],
        max_retries: int = 16, return_copy: bool = True,
    ) -> dict | None:
        """storage.GuaranteedUpdate: read → mutate → CAS-write, retry on
        Conflict. `mutate` gets a private copy; returning None aborts
        (an unchanged copy of the current object is returned).
        `return_copy=False` skips the result copy and returns None."""
        for _ in range(max_retries):
            current = await self.get(resource, key)  # already a private copy
            want_rv = current["metadata"]["resourceVersion"]
            updated = mutate(current)
            if updated is None:
                if not return_copy:
                    return None
                # mutate may have scribbled on `current` before aborting;
                # honor the "unchanged" contract with a fresh read. If the
                # object was deleted in between, fall back to the pre-read
                # copy (it WAS current at read time) rather than surfacing
                # a NotFound the caller never had to handle before.
                try:
                    return await self.get(resource, key)
                except NotFound:
                    return current
            updated["metadata"]["resourceVersion"] = want_rv
            try:
                return await self.update(resource, updated, _owned=True,
                                         return_copy=return_copy)
            except Conflict:
                continue
        raise Conflict(f"{resource} {key!r}: too many conflicts in guaranteed_update")

    async def delete(self, resource: str, key: str, *, uid: str | None = None) -> dict:
        table = self._table(resource)
        if key not in table:
            raise NotFound(f"{resource} {key!r} not found")
        current = table[key]
        if uid and current["metadata"].get("uid") != uid:
            raise Conflict(f"{resource} {key!r}: uid precondition failed")
        self._admit(resource, current, "delete")
        del table[key]
        rv = self._next_rv()
        tomb = deep_copy(current)
        tomb["metadata"]["resourceVersion"] = str(rv)
        # deep_freeze builds a fresh container tree, so the returned tomb
        # stays a private mutable copy either way.
        self._record(resource, Event("DELETED", _maybe_freeze(tomb), rv))
        return tomb

    async def list(
        self,
        resource: str,
        namespace: str | None = None,
        selector: Selector | None = None,
        limit: int = 0,
        continue_key: str | None = None,
        fields: Mapping[str, str] | None = None,
        *,
        resource_version: int | None = None,
        resource_version_match: str | None = None,
        copy: bool = True,
    ) -> ListResult:
        """Consistent LIST, served from the watch-cache tier when active
        (store/cacher.py documents the RV-semantics contract; `exact`
        RVs and snapshot-pinned continue tokens ride the cacher's ring).
        With the tier disabled, exact RVs other than the current one
        raise Expired — the clean degradation the kill switch promises.
        `copy=False` skips per-item deep copies for encode-only callers
        (only honored on the cacher path; the direct path always copies).
        """
        from kubernetes_tpu_torch.store.cacher import parse_continue
        pinned_rv, cont = parse_continue(continue_key)
        rv = pinned_rv if pinned_rv is not None else resource_version
        exact = pinned_rv is not None or resource_version_match == "Exact"
        if self.cacher is not None:
            return await self.cacher.list(
                resource, namespace, selector, limit, cont, fields,
                resource_version=rv, exact=exact, copy=copy)
        if rv and exact and rv != self._rv:
            raise Expired(
                f"resourceVersion {rv} is not servable (watch cache "
                f"disabled; only the current RV {self._rv} is)")
        return await self.list_direct(
            resource, namespace, selector, limit, cont, fields)

    async def list_direct(
        self,
        resource: str,
        namespace: str | None = None,
        selector: Selector | None = None,
        limit: int = 0,
        continue_key: str | None = None,
        fields: Mapping[str, str] | None = None,
    ) -> ListResult:
        """The uncached mvcc scan: sorted table keys, filter, deep-copy.
        The cacher's differential suite pins `list()` bit-equal to this
        at matching RVs; `list_direct_total` counts these scans so the
        relist-storm smoke can prove agents never land here."""
        self.list_direct_total[resource] = \
            self.list_direct_total.get(resource, 0) + 1
        table = self._table(resource)
        keys = sorted(table.keys())
        if continue_key:
            keys = [k for k in keys if k > continue_key]
        items: list[dict] = []
        for k in keys:
            obj = table[k]
            if namespace and namespace_of(obj) != namespace:
                continue
            if selector is not None and not selector.matches(
                obj.get("metadata", {}).get("labels")
            ):
                continue
            if fields and not _fields_match(fields, obj):
                continue
            items.append(deep_copy(obj))
            if limit and len(items) >= limit:
                break
        return ListResult(items=items, resource_version=self._rv)

    # -- WATCH -------------------------------------------------------------

    async def watch(
        self,
        resource: str,
        resource_version: int = 0,
        namespace: str | None = None,
        selector: Selector | None = None,
        *,
        fields: Mapping[str, str] | None = None,
        bookmarks: bool = True,
    ) -> AsyncIterator[Event]:
        """Stream events after `resource_version`.

        rv=0 means "from now" (reference semantics for unset RV on the cacher
        path: start at current state — callers pair it with a LIST).
        Raises Expired if rv predates the retained window. With the
        watch-cache tier active, backfill is served from the per-resource
        ring (store/cacher.py); the direct path scans global history.
        """
        if self.cacher is not None:
            return await self.cacher.watch(
                resource, resource_version, namespace, selector,
                fields=fields, bookmarks=bookmarks)
        return await self.watch_direct(
            resource, resource_version, namespace, selector,
            fields=fields, bookmarks=bookmarks)

    async def watch_direct(
        self,
        resource: str,
        resource_version: int = 0,
        namespace: str | None = None,
        selector: Selector | None = None,
        *,
        fields: Mapping[str, str] | None = None,
        bookmarks: bool = True,
    ) -> AsyncIterator[Event]:
        """The uncached watch path: global-history backfill scan. Owns
        the 410 window contract; the cacher falls back here for RVs its
        ring no longer holds, so expiry behavior is identical on both.
        RVs ahead of the store (a client that outlived an RV-resetting
        restart) are Expired too — resuming there would silently drop
        every event until the counter caught up; a relist recovers."""
        if resource_version and resource_version > self._rv:
            raise Expired(
                f"resourceVersion {resource_version} is ahead of the "
                f"store (current: {self._rv}); relist")
        if resource_version and resource_version + 1 < self._first_retained_rv:
            raise Expired(
                f"resourceVersion {resource_version} is too old "
                f"(oldest retained: {self._first_retained_rv})"
            )
        replay = [
            ev for res, ev in self._events
            if res == resource and ev.rv > resource_version
        ] if resource_version else []
        return self._open_watch(
            resource, resource_version, namespace, selector,
            fields=fields, bookmarks=bookmarks, replay=replay)

    def _open_watch(
        self,
        resource: str,
        resource_version: int,
        namespace: str | None,
        selector: Selector | None,
        *,
        fields: Mapping[str, str] | None,
        bookmarks: bool,
        replay: list[Event],
    ) -> AsyncIterator[Event]:
        """Register a channel and stream `replay` then live events —
        shared by the ring-backfilled (cacher) and scan-backfilled
        (direct) establishment paths. Registration and the caller's
        replay computation happen in one loop tick, so no event is lost
        between replay and live."""
        chan = _WatchChannel(
            queue=asyncio.Queue(), resource=resource,
            namespace=namespace, selector=selector, fields=fields or None,
        )
        self._register_watcher(chan)
        self._ensure_bookmarks()

        async def gen() -> AsyncIterator[Event]:
            try:
                for ev in replay:
                    if chan.namespace and namespace_of(ev.object) != chan.namespace:
                        continue
                    selected = self._select_for(ev, chan)
                    if selected is None:
                        continue
                    yield selected
                # Live events queued during replay are already in chan.queue —
                # but replayed ones may also be queued (we registered early).
                # Skip duplicates by rv.
                last_rv = replay[-1].rv if replay else resource_version
                while not chan.closed:
                    ev = await chan.queue.get()
                    if ev.type != "BOOKMARK" and ev.rv <= last_rv:
                        continue
                    if not bookmarks and ev.type == "BOOKMARK":
                        continue
                    yield ev
            finally:
                chan.closed = True
                self._unregister_watcher(chan)

        return gen()

    def _ensure_bookmarks(self) -> None:
        if self._bookmark_task is None or self._bookmark_task.done():
            self._bookmark_task = asyncio.ensure_future(self._bookmark_loop())

    async def _bookmark_loop(self) -> None:
        """Periodic bookmark events so idle watchers learn the current RV
        (cacher.go dispatches bookmarks ~1/min; we use 5s for test speed)."""
        while self._watchers:
            await asyncio.sleep(BOOKMARK_INTERVAL_S)
            bk = Event("BOOKMARK", {"metadata": {"resourceVersion": str(self._rv)}}, self._rv)
            for w in list(self._watchers):
                if not w.closed:
                    w.queue.put_nowait(bk)

    def stop(self) -> None:
        for w in self._watchers:
            w.closed = True
            w.queue.put_nowait(Event("BOOKMARK", {"metadata": {}}, self._rv))
        self._watchers.clear()
        self._index.clear()
        if self._bookmark_task:
            self._bookmark_task.cancel()
            self._bookmark_task = None

    async def apply(self, resource: str, obj: Mapping, *,
                    field_manager: str, force: bool = False) -> dict:
        """Server-side apply (store/apply.py): declarative field
        ownership with managedFields + conflict detection."""
        from kubernetes_tpu_torch.store.apply import server_side_apply
        return await server_side_apply(
            self, resource, obj, field_manager=field_manager, force=force)

    # -- subresources ------------------------------------------------------

    async def subresource(self, resource: str, key: str, sub: str, body: Mapping) -> dict:
        handler = self._subresources.get((resource, sub))
        if handler is None:
            raise NotFound(f"subresource {resource}/{sub} not registered")
        return await handler(self, key, body)

    # -- persistence (WAL-lite) -------------------------------------------

    def dump(self) -> str:
        """Serialize full state (snapshot checkpoint; SURVEY §5.4: the store IS
        the checkpoint)."""
        return json.dumps({"rv": self._rv, "tables": self._tables})

    @classmethod
    def load(cls, data: str,
             rv_source: RVCounter | None = None) -> "MVCCStore":
        """Rebuild from dump(). `rv_source` threads a shared counter
        through recovery (the multi-process control plane's coordinated
        RV scheme): a recovering shard adopts the LIVE global counter,
        and the snapshot's rv only ever advances it — the counter's
        monotonic setter means a restart can never hand out an rv the
        cluster already moved past."""
        raw = json.loads(data)
        store = cls(rv_source=rv_source)
        store._rv = raw["rv"]
        store._tables = raw["tables"]
        store._first_retained_rv = raw["rv"] + 1
        return store


# ---------------------------------------------------------------------------
# Binding subresource (pkg/registry/core/pod/storage/storage.go BindingREST)
# ---------------------------------------------------------------------------

async def binding_subresource(store: MVCCStore, key: str, binding: Mapping) -> dict:
    """POST pods/<key>/binding: set spec.nodeName via guaranteed update.

    Fails with Conflict if the pod is already bound to a different node
    (BindingREST.setPodHostAndAnnotations: "pod X is already assigned to node").
    """
    target = (binding.get("target") or {}).get("name")
    if not target:
        raise Invalid("binding.target.name is required")
    want_uid = binding.get("metadata", {}).get("uid")

    # Selective-copy read-modify-write instead of guaranteed_update: the
    # bind only touches spec.nodeName + the PodScheduled condition, so
    # copying just those containers (sharing the untouched sub-objects
    # with the frozen stored object — the watch-event discipline) saves a
    # full pod deep-copy on the perf path's hottest write. Atomicity: no
    # await between the table read and store.update on one loop; update's
    # RV precondition would catch an interleave anyway.
    table = store._table("pods")
    cur_obj = table.get(key)
    if cur_obj is None:
        raise NotFound(f"pods {key!r} not found")
    if want_uid and cur_obj["metadata"].get("uid") != want_uid:
        raise Conflict(f"binding {key!r}: uid mismatch")
    cur = (cur_obj.get("spec") or {}).get("nodeName")
    if cur and cur != target:
        raise Conflict(
            f"binding {key!r}: pod is already assigned to node {cur!r}")
    conds = [dict(c) for c in
             (cur_obj.get("status") or {}).get("conditions") or []]
    for c in conds:
        if c.get("type") == "PodScheduled":
            c["status"] = "True"
            break
    else:
        conds.append({"type": "PodScheduled", "status": "True"})
    new_obj = {**cur_obj,
               "metadata": dict(cur_obj["metadata"]),
               "spec": {**(cur_obj.get("spec") or {}), "nodeName": target},
               "status": {**(cur_obj.get("status") or {}),
                          "conditions": conds}}
    # BindingREST.Create returns metav1.Status, not the pod — which also
    # saves the exit deep-copy.
    await store.update("pods", new_obj, _owned=True, return_copy=False)
    return {"kind": "Status", "apiVersion": "v1", "status": "Success"}


def new_cluster_store(shards: int | None = None):
    """Store with the core subresources registered. `shards > 1` builds
    the partitioned control plane (store/sharded.py ShardedNodeStore:
    node-keyed resources hash-partition across per-shard mvcc stores
    under one global RV counter); None resolves the KTPU_SHARDS
    override, default 1 — the classic single store."""
    if shards is None:
        shards = flags.get("KTPU_SHARDS") or 1
    if shards > 1:
        from kubernetes_tpu_torch.store.sharded import ShardedNodeStore
        store = ShardedNodeStore(shards)
    else:
        store = MVCCStore()
    store.register_subresource("pods", "binding", binding_subresource)
    return store
