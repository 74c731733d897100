"""Cross-process sharded store facade.

`ProcessShardedStore` is the multi-process twin of
store/sharded.py's `ShardedNodeStore`: the same MVCCStore-shaped
surface and the same routing table (node-keyed resources hash to
shard `crc32(name) % S`, everything else lives on the meta shard),
but each shard is a `WireStore` client to a separate apiserver
PROCESS (multiproc/shardproc.py) instead of an in-process MVCCStore.
Informers, the scheduler, controllers, and the bench harness consume
it unchanged — `ShardedInformer` sees the same
`control_topology()` / `list(shard=)` / `watch(shard=)` seams.

One contract is deliberately weaker than the in-process facade's:
a merged LIST here fans out over real sockets, so the per-shard
snapshots are NOT taken in one event-loop tick. Each shard's page is
individually consistent and the merged RV is the max across shards —
a watcher resuming from it can never miss an event (every shard's
snapshot is at-or-before that RV), but the merged page is not a
single global point-in-time cut. The in-process facade keeps the
bit-identical-to-single-store guarantee (its differential test is
unchanged); the cross-process differential
(tests/test_torch_multiproc.py) asserts equality against a quiesced
store, where the distinction vanishes.

Copy of `kubernetes_tpu/multiproc/client.py`.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Callable, Mapping

from kubernetes_tpu_torch.api.labels import Selector
from kubernetes_tpu_torch.metrics.registry import WatchMetrics
from kubernetes_tpu_torch.store.mvcc import Event, ListResult
from kubernetes_tpu_torch.store.sharded import (
    PARTITIONED_RESOURCES,
    _name_of_key,
    _sort_key,
    multiplex_watches,
    shard_of,
)

import asyncio


class ProcessShardedStore:
    """S `WireStore` clients behind the MVCCStore public surface."""

    def __init__(self, targets: list[str], *, enc: str = "msgpack",
                 token: str | None = None,
                 user_agent: str = "kubernetes-tpu-multiproc"):
        from kubernetes_tpu_torch.apiserver.wire import WireStore
        if not targets:
            raise ValueError("ProcessShardedStore needs >= 1 shard target")
        self.targets = list(targets)
        self.node_shards = len(self.targets)
        self.wires: list = [
            WireStore(t, enc=enc, token=token, user_agent=user_agent)
            for t in self.targets]
        self.meta = self.wires[0]
        self.partitioned_resources = PARTITIONED_RESOURCES
        #: client-side watch accounting (the server-side counters live
        #: in each shard process; pull them via control_stats()).
        self.watch_metrics = WatchMetrics()
        #: no client-side cache tier — getattr(backing, "cacher", None)
        #: consumers read None, same as a cacher-disabled store.
        self.cacher = None

    # -- routing (identical table to ShardedNodeStore) ---------------------

    def shard_index(self, resource: str, name: str) -> int:
        if resource not in self.partitioned_resources:
            return 0
        return shard_of(name, self.node_shards)

    def _wire_for(self, resource: str, name: str):
        return self.wires[self.shard_index(resource, name)]

    def _wire_for_key(self, resource: str, key: str):
        return self._wire_for(resource, _name_of_key(key))

    def _wire_for_obj(self, resource: str, obj: Mapping):
        name = (obj.get("metadata") or {}).get("name", "")
        return self._wire_for(resource, name)

    # -- CRUD (routed) -----------------------------------------------------

    async def create(self, resource: str, obj: Mapping, **kw) -> dict:
        return await self._wire_for_obj(resource, obj).create(
            resource, obj, **kw)

    async def get(self, resource: str, key: str) -> dict:
        return await self._wire_for_key(resource, key).get(resource, key)

    async def update(self, resource: str, obj: Mapping, **kw) -> dict:
        return await self._wire_for_obj(resource, obj).update(
            resource, obj, **kw)

    async def delete(self, resource: str, key: str, *,
                     uid: str | None = None) -> dict:
        return await self._wire_for_key(resource, key).delete(
            resource, key, uid=uid)

    async def apply(self, resource: str, obj: Mapping, *,
                    field_manager: str, force: bool = False) -> dict:
        return await self._wire_for_obj(resource, obj).apply(
            resource, obj, field_manager=field_manager, force=force)

    async def subresource(self, resource: str, key: str, sub: str,
                          body: Mapping) -> dict:
        return await self._wire_for_key(resource, key).subresource(
            resource, key, sub, body)

    async def guaranteed_update(self, resource: str, key: str,
                                mutate: Callable[[dict], dict | None],
                                max_retries: int = 16,
                                return_copy: bool = True):
        return await self._wire_for_key(resource, key).guaranteed_update(
            resource, key, mutate, max_retries=max_retries,
            return_copy=return_copy)

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
        shard: int | None = None,
        **_kw,
    ) -> ListResult:
        kw: dict[str, Any] = dict(
            resource_version=resource_version,
            resource_version_match=resource_version_match)
        if resource not in self.partitioned_resources:
            return await self.meta.list(
                resource, namespace, selector, limit, continue_key,
                fields, **kw)
        if shard is not None:
            return await self.wires[self._check_shard(shard)].list(
                resource, namespace, selector, limit, continue_key,
                fields, **kw)
        # Concurrent fan-out over real sockets: each shard's page is
        # individually consistent; the merged RV is the max, so a
        # watch resumed from it can't miss an event (see module doc).
        results = await asyncio.gather(*(
            w.list(resource, namespace, selector, limit, continue_key,
                   fields, **kw)
            for w in self.wires))
        items = [it for lst in results for it in lst.items]
        items.sort(key=_sort_key)
        rv = max(r.resource_version for r in results)
        cont = None
        if limit and len(items) >= limit:
            items = items[:limit]
            from kubernetes_tpu_torch.store.cacher import make_continue
            cont = make_continue(rv, _sort_key(items[-1]))
        return ListResult(items=items, resource_version=rv, cont=cont)

    def _check_shard(self, shard: int) -> int:
        from kubernetes_tpu_torch.store.mvcc import Invalid
        s = int(shard)
        if not 0 <= s < self.node_shards:
            raise Invalid(
                f"shard {s} out of range (store has {self.node_shards})")
        return s

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
        **_kw,
    ) -> AsyncIterator[Event]:
        if resource not in self.partitioned_resources:
            return await self.meta.watch(
                resource, resource_version, namespace, selector,
                fields=fields)
        if shard is not None:
            return await self.wires[self._check_shard(shard)].watch(
                resource, resource_version, namespace, selector,
                fields=fields)
        watches = [await w.watch(resource, resource_version, namespace,
                                 selector, fields=fields)
                   for w in self.wires]
        return multiplex_watches(watches, bookmarks)

    # -- discovery ---------------------------------------------------------

    async def control_topology(self) -> dict:
        """The facade IS the topology: clients of a ProcessShardedStore
        are already talking to every shard process, so this answers
        locally instead of probing (each shard server is a plain
        unsharded store and would report nodeShards=1)."""
        return {"nodeShards": self.node_shards,
                "partitioned": list(self.partitioned_resources)}

    async def control_stats(self) -> dict:
        """Per-shard server-side counters (WAL appends/replays, RV),
        merged: sums under "total", the raw rows under "shards"."""
        rows = await asyncio.gather(
            *(w.control_stats() for w in self.wires))
        total: dict[str, float] = {}
        for row in rows:
            for k, v in row.items():
                if k != "shard" and isinstance(v, (int, float)):
                    total[k] = total.get(k, 0) + v
        return {"total": total, "shards": list(rows)}

    def is_cluster_scoped(self, resource: str) -> bool:
        return self.meta.is_cluster_scoped(resource)

    def resource_for_kind(self, kind: str) -> str | None:
        return self.meta.resource_for_kind(kind)

    def kind_map(self) -> dict[str, str]:
        return self.meta.kind_map()

    # -- lifecycle ---------------------------------------------------------

    async def close(self) -> None:
        for w in self.wires:
            await w.close()

    def stop(self) -> None:
        for w in self.wires:
            w.stop()
