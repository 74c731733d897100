"""Sharded control plane: hash-partitioned per-shard mvcc stores.

The single-process control plane tops out where one mvcc store has to
absorb every node's writes, serve every LIST off one snapshot, and run
one watch-dispatch loop for the whole cluster (at 50k+ nodes the bound
stops being the device solve and becomes the store around it). This
module partitions the NODE axis of the control plane over S shards.

Design:

- **Partitioning.** Node-keyed resources (`PARTITIONED_RESOURCES`:
  nodes, leases, noderesourcetopologies, resourceslices — objects whose
  name IS a node name) route to shard `crc32(name) % S`. Everything
  else (pods, events, config objects, CRDs) lives on the *meta* shard
  (shard 0), so pod scheduling traffic and policy objects keep the
  single-store semantics they had.
- **One RV counter.** All shards share one `RVCounter` (mvcc.py), so
  ResourceVersions stay globally monotonic: a merged LIST's RV can
  resume a watch on ANY shard, pinned continue tokens (`"<rv>:<key>"`)
  roll every shard's cacher back to the same global snapshot, and the
  per-key event order any single watcher observes is the cluster-wide
  commit order — the etcd-revision contract, kept under partitioning.
- **Per-shard serving tiers.** Each shard owns its own watch-cache tier
  (store/cacher.py) and event ring: a node-churn storm on one shard
  cannot age another shard's backfill window, and the O(table) costs of
  snapshot maintenance (sorted-key insort at ingest) divide by S.
- **Reads.** LIST of a partitioned resource fans out to every shard and
  merge-sorts by key — bit-identical to the single-store scan (same
  sort order, same paging, same RV semantics; differential-tested).
  WATCH takes an optional `shard=` to consume one shard's stream (the
  per-shard informer path — client/informer.ShardedInformer); with no
  shard it multiplexes all shards into one stream with conservative
  merged bookmarks (min across shards), so unsharded-client wires
  (HTTP, gRPC) keep working unchanged.

Activation: `new_cluster_store(shards=S)`; bench.py resolves S flagless
from the node count (`control_plane_shards`: ≥ KTPU_SHARD_THRESHOLD
nodes → KTPU_SHARDS or 8). `KTPU_SHARDS=1` is the kill switch — S=1
is the plain single `MVCCStore` (new_cluster_store doesn't construct
this facade at all), so degradation is structural, not a code path.

Copy of `kubernetes_tpu/store/sharded.py`.
"""

from __future__ import annotations

import asyncio
import json
import zlib
from typing import Any, AsyncIterator, Callable, Mapping

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.metrics.registry import WatchMetrics
from kubernetes_tpu_torch.utils import flags
from kubernetes_tpu_torch.store.mvcc import (
    DEFAULT_EVENT_WINDOW,
    Event,
    ListResult,
    MVCCStore,
    RVCounter,
)

#: Resources whose object NAME is a node name; these partition.
PARTITIONED_RESOURCES = (
    "nodes", "leases", "noderesourcetopologies", "resourceslices")

#: Flagless activation threshold (node count) and default shard count.
DEFAULT_SHARD_THRESHOLD = 100_000
DEFAULT_SHARDS = 8


def shard_of(name: str, shards: int) -> int:
    """Stable hash partition (crc32 — process-independent, unlike
    `hash()`): which shard owns the node-keyed object `name`."""
    if shards <= 1:
        return 0
    return zlib.crc32(name.encode()) % shards


def control_plane_shards(n_nodes: int, override: int | None = None) -> int:
    """The flagless shard-count policy shared by bench.py and the host
    prep: explicit override > KTPU_SHARDS env > node-count threshold
    (KTPU_SHARD_THRESHOLD, default 100k → 8 shards; below it 1 — the
    5k/50k presets keep the single-store path bit-for-bit)."""
    if override is not None:
        return max(1, int(override))
    env = flags.get("KTPU_SHARDS")
    if env is not None:
        # 0 clamps to 1 like every other value ≤ 1 (the single-store
        # kill switch), matching new_cluster_store's `or 1` — falling
        # through to the threshold policy here would hand an 8-shard
        # prep accounting to a 1-shard store.
        return max(1, env)
    threshold = flags.get("KTPU_SHARD_THRESHOLD")
    return DEFAULT_SHARDS if n_nodes >= threshold else 1


def _name_of_key(key: str) -> str:
    """Object name from a store key ('ns/name' or 'name')."""
    return key.rsplit("/", 1)[-1]


class ShardedNodeStore:
    """S per-shard MVCCStores behind the MVCCStore public surface.

    Pods and other unpartitioned resources live on `self.meta`
    (shard 0); node-keyed resources hash across `self.shards`. All
    shards share one RV counter, one WatchMetrics, and one
    WatchCacheMetrics, so the facade's observability reads like one
    store's."""

    def __init__(self, shards: int = DEFAULT_SHARDS,
                 event_window: int = DEFAULT_EVENT_WINDOW):
        self.node_shards = max(2, int(shards))
        self._rv_counter = RVCounter()
        self.shards: list[MVCCStore] = [
            MVCCStore(event_window, rv_source=self._rv_counter)
            for _ in range(self.node_shards)]
        self.meta = self.shards[0]
        self.partitioned_resources = PARTITIONED_RESOURCES
        # One metrics instance across shards: counters sum naturally.
        self.watch_metrics = WatchMetrics()
        for s in self.shards:
            s.watch_metrics = self.watch_metrics
        # One clock dict across shards too (MVCCStore.timings).
        self.timings = self.meta.timings
        for s in self.shards[1:]:
            s.timings = self.timings
        if self.meta.cacher is not None:
            shared = self.meta.cacher.metrics
            for s in self.shards[1:]:
                s.cacher.metrics = shared

    # -- routing -----------------------------------------------------------

    def _check_shard(self, shard: int) -> int:
        """Validate a CLIENT-supplied shard index (the wire passes it
        through verbatim): negatives must not silently alias shard S-1
        and out-of-range must be a clean 422, not an IndexError."""
        from kubernetes_tpu_torch.store.mvcc import Invalid
        s = int(shard)
        if not 0 <= s < self.node_shards:
            raise Invalid(
                f"shard {s} out of range (store has {self.node_shards})")
        return s

    def shard_index(self, resource: str, name: str) -> int:
        if resource not in self.partitioned_resources:
            return 0
        return shard_of(name, self.node_shards)

    def _store_for(self, resource: str, name: str) -> MVCCStore:
        return self.shards[self.shard_index(resource, name)]

    def _store_for_key(self, resource: str, key: str) -> MVCCStore:
        return self._store_for(resource, _name_of_key(key))

    def _store_for_obj(self, resource: str, obj: Mapping) -> MVCCStore:
        name = (obj.get("metadata") or {}).get("name", "")
        return self._store_for(resource, name)

    # -- facade properties the harness/servers read ------------------------

    @property
    def resource_version(self) -> int:
        return self._rv_counter.value

    @property
    def _rv(self) -> int:
        return self._rv_counter.value

    @property
    def cacher(self):
        """The meta shard's cacher — its metrics object is shared by
        every shard's tier, so hits/misses read cluster-wide."""
        return self.meta.cacher

    @property
    def list_direct_total(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for s in self.shards:
            for r, n in s.list_direct_total.items():
                out[r] = out.get(r, 0) + n
        return out

    @property
    def custom_kinds(self) -> dict[str, str]:
        return self.meta.custom_kinds

    @property
    def custom_cluster_scoped(self) -> set[str]:
        return self.meta.custom_cluster_scoped

    @property
    def _tracked_fields(self):
        return self.meta._tracked_fields

    def _table(self, resource: str) -> dict[str, dict]:
        """Single-shard resources return the live table; partitioned
        resources return a merged COPY (read-only uses: admission's
        config scans, server diagnostics)."""
        if resource not in self.partitioned_resources:
            return self.meta._table(resource)
        merged: dict[str, dict] = {}
        for s in self.shards:
            merged.update(s._table(resource))
        return merged

    def resource_for_kind(self, kind: str) -> str | None:
        return self.meta.resource_for_kind(kind)

    def is_cluster_scoped(self, resource: str) -> bool:
        return self.meta.is_cluster_scoped(resource)

    def kind_map(self) -> dict[str, str]:
        return self.meta.kind_map()

    # -- registration fans out (resource-routed at call time) --------------

    def register_subresource(self, resource: str, sub: str, handler) -> None:
        for s in self.shards:
            s.register_subresource(resource, sub, handler)

    def register_validator(self, resource: str, fn) -> None:
        for s in self.shards:
            s.register_validator(resource, fn)

    def register_mutator(self, resource: str, fn, *,
                         on: tuple[str, ...] = ("create", "update")) -> None:
        for s in self.shards:
            s.register_mutator(resource, fn, on=on)

    def _admit(self, resource: str, obj: dict, op: str = "create") -> None:
        """Mutators + validators without a write (the apiserver's
        ?dryRun=All path): registration fans out identically to every
        shard, so shard 0 is authoritative."""
        self.meta._admit(resource, obj, op)

    def add_event_sink(self, sink) -> None:
        for s in self.shards:
            s.add_event_sink(sink)

    def remove_event_sink(self, sink) -> None:
        for s in self.shards:
            s.remove_event_sink(sink)

    # -- CRUD (routed) -----------------------------------------------------

    async def create(self, resource: str, obj: Mapping, *,
                     _owned: bool = False, return_copy: bool = True):
        return await self._store_for_obj(resource, obj).create(
            resource, obj, _owned=_owned, return_copy=return_copy)

    async def get(self, resource: str, key: str) -> dict:
        return await self._store_for_key(resource, key).get(resource, key)

    async def update(self, resource: str, obj: Mapping, *,
                     _owned: bool = False, return_copy: bool = True):
        return await self._store_for_obj(resource, obj).update(
            resource, obj, _owned=_owned, return_copy=return_copy)

    async def guaranteed_update(self, resource: str, key: str,
                                mutate: Callable[[dict], dict | None],
                                max_retries: int = 16,
                                return_copy: bool = True):
        return await self._store_for_key(resource, key).guaranteed_update(
            resource, key, mutate, max_retries=max_retries,
            return_copy=return_copy)

    async def delete(self, resource: str, key: str, *,
                     uid: str | None = None) -> dict:
        return await self._store_for_key(resource, key).delete(
            resource, key, uid=uid)

    async def apply(self, resource: str, obj: Mapping, *,
                    field_manager: str, force: bool = False) -> dict:
        from kubernetes_tpu_torch.store.apply import server_side_apply
        return await server_side_apply(
            self._store_for_obj(resource, obj), resource, obj,
            field_manager=field_manager, force=force)

    async def subresource(self, resource: str, key: str, sub: str,
                          body: Mapping) -> dict:
        return await self._store_for_key(resource, key).subresource(
            resource, key, sub, body)

    # -- LIST (merged or shard-scoped) -------------------------------------

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
        shard: int | None = None,
    ) -> ListResult:
        """Merged LIST: fan out, merge-sort by key, re-apply the limit.
        Bit-identical to the single-store scan (same sort order, same
        continue semantics — keys are globally comparable and the
        shared RV counter makes pinned tokens mean one global snapshot
        on every shard). `shard=` scopes to one shard (the per-shard
        informer's relist path)."""
        kw: dict[str, Any] = dict(
            resource_version=resource_version,
            resource_version_match=resource_version_match, copy=copy)
        if resource not in self.partitioned_resources:
            return await self.meta.list(
                resource, namespace, selector, limit, continue_key,
                fields, **kw)
        if shard is not None:
            return await self.shards[self._check_shard(shard)].list(
                resource, namespace, selector, limit, continue_key,
                fields, **kw)
        # ATOMIC fan-out: per-shard list bodies contain no suspension
        # point (cacher.list / list_direct are sync-bodied), so plain
        # sequential awaits run in ONE loop tick — no write can
        # interleave, every shard serves the same global RV, and the
        # merged result is a true point-in-time snapshot. (gather()
        # would wrap each coroutine in a task and tick the loop between
        # shards, letting a write land mid-scan — an event a watcher
        # resuming from the merged RV would then never see.)
        results = [await s.list(resource, namespace, selector, limit,
                                continue_key, fields, **kw)
                   for s in self.shards]
        items = [it for lst in results for it in lst.items]
        items.sort(key=lambda o: _sort_key(o))
        rv = results[0].resource_version
        assert all(r.resource_version == rv for r in results), \
            "shard lists diverged within one loop tick"
        cont = None
        if limit and len(items) >= limit:
            items = items[:limit]
            # Pin the merged page at the (shared) serve RV — the same
            # token shape each shard's cacher emits, so later pages
            # roll every shard back to this one global snapshot.
            from kubernetes_tpu_torch.store.cacher import make_continue
            cont = make_continue(rv, _sort_key(items[-1]))
        return ListResult(items=items, resource_version=rv, cont=cont)

    async def list_direct(self, resource: str, *args, **kw) -> ListResult:
        if resource not in self.partitioned_resources:
            return await self.meta.list_direct(resource, *args, **kw)
        # Sequential awaits of sync-bodied coroutines: atomic (see list).
        results = [await s.list_direct(resource, *args, **kw)
                   for s in self.shards]
        items = [it for lst in results for it in lst.items]
        items.sort(key=lambda o: _sort_key(o))
        return ListResult(
            items=items,
            resource_version=max(r.resource_version for r in results))

    # -- WATCH (per-shard or multiplexed) ----------------------------------

    async def watch(
        self,
        resource: str,
        resource_version: int = 0,
        namespace: str | None = None,
        selector: Selector | None = None,
        *,
        fields: Mapping[str, str] | None = None,
        bookmarks: bool = True,
        shard: int | None = None,
    ) -> AsyncIterator[Event]:
        """`shard=` consumes one shard's stream (per-shard informers —
        the scale path: S independent streams, S independent backfill
        rings). Without it, all shards multiplex into one stream so
        single-stream consumers (HTTP/gRPC wires, controllers) work
        unchanged; merged bookmarks advance at the MINIMUM of the
        per-shard bookmark RVs so a resume-from-bookmark can never skip
        an event still queued on a slower shard."""
        if resource not in self.partitioned_resources:
            return await self.meta.watch(
                resource, resource_version, namespace, selector,
                fields=fields, bookmarks=bookmarks)
        if shard is not None:
            return await self.shards[self._check_shard(shard)].watch(
                resource, resource_version, namespace, selector,
                fields=fields, bookmarks=bookmarks)
        # Sequential establishment (sync-bodied, one loop tick — see
        # list()): all S channels register before any write can land,
        # so an rv=0 "from now" merged watch has one consistent "now".
        watches = [await s.watch(resource, resource_version, namespace,
                                 selector, fields=fields, bookmarks=True)
                   for s in self.shards]
        return self._multiplex(watches, bookmarks)

    def _multiplex(self, watches: list, bookmarks: bool
                   ) -> AsyncIterator[Event]:
        return multiplex_watches(watches, bookmarks)

    # -- lifecycle ---------------------------------------------------------

    def stop(self) -> None:
        for s in self.shards:
            s.stop()

    def dump(self) -> str:
        """Merged snapshot checkpoint (tables unioned per resource)."""
        tables: dict[str, dict] = {}
        for s in self.shards:
            for r, t in s._tables.items():
                tables.setdefault(r, {}).update(t)
        return json.dumps({"rv": self.resource_version, "tables": tables})


async def multiplex_watches(watches: list, bookmarks: bool
                            ) -> AsyncIterator[Event]:
    """Fan S shard streams into one. Per-key ordering is exact (a
    key lives on one shard); cross-key ordering is arrival order
    with globally-valid RVs. Shared by the in-process facade above
    and the cross-process one (multiproc/client.py) — merged
    bookmarks advance at the MINIMUM of the per-shard bookmark RVs
    in both."""
    queue: asyncio.Queue = asyncio.Queue()
    marks = [0] * len(watches)
    sent_mark = 0
    _END = object()  # per-pump end-of-stream sentinel

    async def pump(i: int, w) -> None:
        try:
            async for ev in w:
                await queue.put((i, ev))
            await queue.put((i, _END))
        except Exception as e:
            await queue.put((i, e))

    tasks = [asyncio.ensure_future(pump(i, w))
             for i, w in enumerate(watches)]
    live = len(watches)
    try:
        while live:
            i, ev = await queue.get()
            if ev is _END:
                # A shard's stream ended (store stopped): the merged
                # stream ends when every shard's has — matching the
                # single-store watch, which terminates on stop().
                live -= 1
                continue
            if isinstance(ev, Exception):
                raise ev
            if ev.type == "BOOKMARK":
                marks[i] = max(marks[i], ev.rv)
                low = min(marks)
                if bookmarks and low > sent_mark:
                    sent_mark = low
                    yield Event("BOOKMARK", {"metadata": {
                        "resourceVersion": str(low)}}, low)
                continue
            marks[i] = max(marks[i], ev.rv)
            yield ev
    finally:
        for t in tasks:
            t.cancel()
        for w in watches:
            aclose = getattr(w, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass


def _sort_key(obj: Mapping) -> str:
    ns = (obj.get("metadata") or {}).get("namespace")
    name = (obj.get("metadata") or {}).get("name", "")
    return f"{ns}/{name}" if ns else name
