"""Reflector + shared informer: the LIST+WATCH cache every component runs on.

Parity target: staging/src/k8s.io/client-go/tools/cache —
`reflector.go` (`Reflector.ListAndWatch`: LIST at RV, then WATCH from that RV,
relist on Expired/410), `thread_safe_store.go` (indexed object cache),
`shared_informer.go` (`sharedIndexInformer`: one reflector fanned out to many
event handlers, handlers get add/update/delete with old+new objects).

Deviation from the reference: no DeltaFIFO stage. The reference needs it to
decouple the watch goroutine from handler processing and to compress deltas
during slow consumption; under a single asyncio loop, events are applied to the
cache and dispatched to handlers in the same tick, which preserves the ordering
guarantees DeltaFIFO exists to protect (cache is updated *before* handlers see
the event — same as HandleDeltas).

Copy of `kubernetes_tpu/client/informer.py`.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Callable, Iterable, Mapping

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.api.meta import namespaced_name, resource_version_of
from kubernetes_tpu_torch.metrics.registry import WindowedLatencyRecorder
from kubernetes_tpu_torch.store.mvcc import Expired, MVCCStore
from kubernetes_tpu_torch.utils.tracing import range_end, range_start

logger = logging.getLogger(__name__)


class Indexer:
    """thread_safe_store.go ThreadSafeStore: key→object plus named indices
    (index fn → set of keys). Single-loop ownership; no lock needed."""

    def __init__(self, indexers: Mapping[str, Callable[[Mapping], list[str]]] | None = None):
        self._objects: dict[str, dict] = {}
        self._indexers = dict(indexers or {})
        # index name -> index value -> set of object keys
        self._indices: dict[str, dict[str, set[str]]] = {n: {} for n in self._indexers}

    def __len__(self) -> int:
        return len(self._objects)

    def __contains__(self, key: str) -> bool:
        return key in self._objects

    def get(self, key: str) -> dict | None:
        return self._objects.get(key)

    def list(self) -> list[dict]:
        return list(self._objects.values())

    def keys(self) -> list[str]:
        return list(self._objects.keys())

    def by_index(self, index_name: str, value: str) -> list[dict]:
        keys = self._indices.get(index_name, {}).get(value, ())
        return [self._objects[k] for k in keys]

    def add_indexer(self, name: str,
                    fn: Callable[[Mapping], list[str]]) -> None:
        """Register a named index after construction (AddIndexers); existing
        objects are back-filled. Idempotent for the same name."""
        if name in self._indexers:
            return
        self._indexers[name] = fn
        idx: dict[str, set[str]] = {}
        self._indices[name] = idx
        for key, obj in self._objects.items():
            for v in fn(obj):
                idx.setdefault(v, set()).add(key)

    def _update_indices(self, key: str, old: Mapping | None, new: Mapping | None) -> None:
        for name, fn in self._indexers.items():
            idx = self._indices[name]
            old_vals = set(fn(old)) if old is not None else set()
            new_vals = set(fn(new)) if new is not None else set()
            for v in old_vals - new_vals:
                bucket = idx.get(v)
                if bucket:
                    bucket.discard(key)
                    if not bucket:
                        del idx[v]
            for v in new_vals - old_vals:
                idx.setdefault(v, set()).add(key)

    def upsert(self, obj: dict) -> dict | None:
        key = namespaced_name(obj)
        old = self._objects.get(key)
        self._objects[key] = obj
        self._update_indices(key, old, obj)
        return old

    def delete(self, obj: Mapping) -> dict | None:
        key = namespaced_name(obj)
        old = self._objects.pop(key, None)
        if old is not None:
            self._update_indices(key, old, None)
        return old

    def replace(self, objs: Iterable[dict]) -> None:
        self._objects = {}
        self._indices = {n: {} for n in self._indexers}
        for obj in objs:
            self.upsert(obj)


def namespace_index(obj: Mapping) -> list[str]:
    """The default "namespace" indexer (cache.MetaNamespaceIndexFunc)."""
    ns = obj.get("metadata", {}).get("namespace", "")
    return [ns] if ns else []


class ResourceEventHandler:
    """Handler triple; any of the three may be None."""

    def __init__(self, on_add=None, on_update=None, on_delete=None):
        self.on_add = on_add
        self.on_update = on_update
        self.on_delete = on_delete


class SharedInformer:
    """One reflector + indexer + N handlers for a single resource."""

    def __init__(
        self,
        store: MVCCStore,
        resource: str,
        selector: Selector | None = None,
        indexers: Mapping[str, Callable] | None = None,
    ):
        self.store = store
        self.resource = resource
        self.selector = selector
        idx = {"namespace": namespace_index}
        idx.update(indexers or {})
        self.indexer = Indexer(idx)
        self.handlers: list[ResourceEventHandler] = []
        self._task: asyncio.Task | None = None
        self._synced = asyncio.Event()
        self.last_rv = 0
        #: cumulative host seconds of `_apply` (the indexer update and
        #: the handlers).
        self.timings = {"apply_s": 0.0}
        #: watch lag per event: from the store's record of it
        #: (`Event.recorded_at`) until this informer's handlers returned.
        self.lag = WindowedLatencyRecorder()

    def add_event_handler(self, handler: ResourceEventHandler) -> None:
        self.handlers.append(handler)
        # Late joiners get synthetic adds for existing state, as the
        # reference's AddEventHandler does.
        if self._synced.is_set():
            for obj in self.indexer.list():
                self._call(handler.on_add, obj)

    @staticmethod
    def _call(fn, *args) -> None:
        if fn is None:
            return
        try:
            res = fn(*args)
            if asyncio.iscoroutine(res):
                asyncio.ensure_future(res)
        except Exception:  # handler errors must not kill the informer
            logger.exception("informer handler error")

    def has_synced(self) -> bool:
        return self._synced.is_set()

    async def wait_for_sync(self, timeout: float = 10.0) -> None:
        await asyncio.wait_for(self._synced.wait(), timeout)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    def stop(self) -> None:
        if self._task:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        """Reflector.ListAndWatch with relist-on-410 and bookmark-driven
        resume: a watch error that is NOT a 410 re-watches from the last
        bookmark/event RV instead of unconditionally relisting — the
        watch cache's ring replays the gap, so a transport hiccup across
        N informers costs N backfills of a shared ring, not N store
        LISTs (the client half of the relist-storm fix). Only Expired —
        the server saying the gap is unservable — forces the full LIST."""
        relist = True
        while True:
            try:
                if relist or not self.last_rv:
                    lst = await self.store.list(
                        self.resource, selector=self.selector)
                    self._replace(lst.items)
                    self.last_rv = lst.resource_version
                    self._synced.set()
                    relist = False
                watch = await self.store.watch(
                    self.resource, resource_version=self.last_rv,
                    selector=self.selector,
                )
                async for ev in watch:
                    if ev.type == "BOOKMARK":
                        self.last_rv = max(self.last_rv, ev.rv)
                        continue
                    self._apply(ev.type, ev.object,
                                getattr(ev, "recorded_at", 0.0))
                    self.last_rv = ev.rv
            except Expired:
                logger.info("informer %s: watch expired, relisting", self.resource)
                relist = True
                continue
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception(
                    "informer %s: reflector error, resuming from rv %d",
                    self.resource, self.last_rv)
                await asyncio.sleep(0.2)

    def _replace(self, objs: list[dict], key_filter=None) -> None:
        """Relist reconciliation. `key_filter` scopes the deletion sweep
        to a subset of the key space (a sharded informer relisting ONE
        shard must not delete the other shards' objects)."""
        old_keys = set(self.indexer.keys())
        if key_filter is not None:
            old_keys = {k for k in old_keys if key_filter(k)}
        new_keys = {namespaced_name(o) for o in objs}
        for obj in objs:
            self._apply("MODIFIED" if namespaced_name(obj) in old_keys else "ADDED", obj)
        for key in old_keys - new_keys:
            gone = self.indexer.get(key)
            if gone is not None:
                self._apply("DELETED", gone)

    def _apply(self, ev_type: str, obj: dict,
               recorded_at: float = 0.0) -> None:
        """Apply one object to the indexer and call the handlers, timed into
        `timings["apply_s"]`; a watch event recorded by a store in this
        process (`recorded_at`, a wire's events carry none) also gives its
        watch lag, from the store's record of it until the handlers
        returned."""
        rng = range_start("informer.apply")
        t0 = time.perf_counter()
        try:
            if ev_type == "DELETED":
                old = self.indexer.delete(obj)
                for h in self.handlers:
                    self._call(h.on_delete, old if old is not None else obj)
                return
            old = self.indexer.upsert(obj)
            if old is None:
                for h in self.handlers:
                    self._call(h.on_add, obj)
            else:
                if resource_version_of(old) == resource_version_of(obj):
                    return  # relist echo of known state
                for h in self.handlers:
                    self._call(h.on_update, old, obj)
        finally:
            t1 = time.perf_counter()
            self.timings["apply_s"] += t1 - t0
            if recorded_at:
                self.lag.observe(t1 - recorded_at)
            range_end(rng)


class ShardedInformer(SharedInformer):
    """Per-shard reflectors behind one indexer + handler set.

    Against a sharded control plane (store/sharded.ShardedNodeStore, or
    a wire client whose server advertises shards via `control_topology`)
    a partitioned resource is consumed as S independent LIST+WATCH
    loops — one per shard — so watch establishment, backfill, and
    Expired relists stay SHARD-LOCAL: a relist storm re-reads one
    shard's snapshot, not the cluster's. The initial sync is ONE merged
    LIST (the facade merge-sorts by key — the same order a single
    store's sorted scan yields, which is what keeps sharded-vs-unsharded
    scheduling assignments bit-identical under the index tie rule).
    Stores without shards (plain MVCCStore, HTTP/gRPC clients) degrade
    to the classic single-reflector path untouched."""

    async def _topology(self) -> tuple[int, tuple[str, ...]]:
        fn = getattr(self.store, "control_topology", None)
        if fn is not None:
            t = await fn()
            return (int(t.get("nodeShards", 1) or 1),
                    tuple(t.get("partitioned") or ()))
        return (int(getattr(self.store, "node_shards", 1) or 1),
                tuple(getattr(self.store, "partitioned_resources", ())))

    async def _run(self) -> None:
        try:
            shards, partitioned = await self._topology()
        except asyncio.CancelledError:
            return
        except Exception:
            logger.exception("informer %s: topology probe failed; "
                             "using the single-stream path", self.resource)
            shards, partitioned = 1, ()
        if shards <= 1 or self.resource not in partitioned:
            return await super()._run()
        self._shard_count = shards
        # ONE merged LIST seeds the cache in global key order; each
        # shard's watch then resumes from the list's (global) RV.
        while True:
            try:
                lst = await self.store.list(
                    self.resource, selector=self.selector)
                break
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception("informer %s: initial sharded LIST "
                                 "failed; retrying", self.resource)
                await asyncio.sleep(0.2)
        self._replace(lst.items)
        self.last_rv = lst.resource_version
        self._synced.set()
        loops = [asyncio.ensure_future(
            self._shard_loop(i, shards, lst.resource_version))
            for i in range(shards)]
        try:
            await asyncio.gather(*loops)
        finally:
            for t in loops:
                t.cancel()

    async def _shard_loop(self, i: int, shards: int, from_rv: int) -> None:
        """One shard's reflector: watch with bookmark-driven resume;
        only Expired forces a relist — and the relist is SHARD-SCOPED
        (list(shard=i) replaces only this shard's keys)."""
        rv = from_rv
        while True:
            try:
                watch = await self.store.watch(
                    self.resource, resource_version=rv,
                    selector=self.selector, shard=i)
                async for ev in watch:
                    if ev.type == "BOOKMARK":
                        rv = max(rv, ev.rv)
                        continue
                    self._apply(ev.type, ev.object,
                                getattr(ev, "recorded_at", 0.0))
                    rv = max(rv, ev.rv)
                    self.last_rv = max(self.last_rv, ev.rv)
            except Expired:
                logger.info("informer %s[shard %d]: watch expired, "
                            "shard-scoped relist", self.resource, i)
                try:
                    lst = await self.store.list(
                        self.resource, selector=self.selector, shard=i)
                except asyncio.CancelledError:
                    return
                except Exception:
                    await asyncio.sleep(0.2)
                    continue
                self._replace_shard(lst.items, i, shards)
                rv = lst.resource_version
            except asyncio.CancelledError:
                return
            except Exception:
                logger.exception(
                    "informer %s[shard %d]: reflector error, resuming "
                    "from rv %d", self.resource, i, rv)
                await asyncio.sleep(0.2)

    def _replace_shard(self, objs: list[dict], i: int, shards: int) -> None:
        """_replace scoped to shard i's key space: other shards' objects
        must survive this shard's relist."""
        from kubernetes_tpu_torch.store.sharded import _name_of_key, shard_of
        self._replace(objs, key_filter=lambda k: shard_of(
            _name_of_key(k), shards) == i)


class InformerFactory:
    """SharedInformerFactory: one informer per resource, shared across
    consumers (controllers + scheduler share pod/node informers).
    Partitionable resources get a ShardedInformer, which degrades to
    the classic reflector when the store advertises no shards."""

    def __init__(self, store: MVCCStore):
        self.store = store
        self._informers: dict[str, SharedInformer] = {}

    def informer(self, resource: str, **kwargs: Any) -> SharedInformer:
        if resource not in self._informers:
            from kubernetes_tpu_torch.store.sharded import (
                PARTITIONED_RESOURCES,
            )
            cls = ShardedInformer if resource in PARTITIONED_RESOURCES \
                else SharedInformer
            self._informers[resource] = cls(self.store, resource, **kwargs)
        return self._informers[resource]

    def start(self) -> None:
        for inf in self._informers.values():
            inf.start()

    async def wait_for_sync(self, timeout: float = 10.0) -> None:
        for inf in self._informers.values():
            await inf.wait_for_sync(timeout)

    def stop(self) -> None:
        for inf in self._informers.values():
            inf.stop()
