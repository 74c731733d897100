"""Node-agent behaviors beyond KWOK's lifecycle: probes + node-pressure
eviction (SURVEY §2.5 `prober/`, `eviction/eviction_manager.go`).

The kubelet-less world (KWOK) fakes containers, so probes are staged:
a pod annotated `kwok.x-k8s.io/fail-readiness-after: "<seconds>"` flips
its Ready condition False after that long — consumed by EndpointSlices
(endpoint drops out of rotation) exactly as a real readiness failure
would be. `kwok.x-k8s.io/fail-liveness-after` additionally bumps
`restartCount` and flips Ready back True (the kubelet restarts the
container), the prober → container-restart loop.

Node-pressure eviction mirrors `eviction_manager.go`: when a node's
requested memory exceeds `threshold` × allocatable, the manager taints it
`node.kubernetes.io/memory-pressure:NoSchedule` and evicts pods —
lowest priority first, biggest memory request first within a priority —
until below threshold; the taint lifts when pressure clears.

Copy of `kubernetes_tpu/controllers/nodeagent.py`.
"""

from __future__ import annotations

import asyncio
import logging
import time

from kubernetes_tpu_torch.api.meta import namespaced_name, uid_of
from kubernetes_tpu_torch.api.types import pod_is_terminal, pod_requests
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import StoreError

logger = logging.getLogger(__name__)

READINESS_ANN = "kwok.x-k8s.io/fail-readiness-after"
LIVENESS_ANN = "kwok.x-k8s.io/fail-liveness-after"
PRESSURE_TAINT = "node.kubernetes.io/memory-pressure"


class ProberController(Controller):
    """Staged probe outcomes for KWOK pods."""

    NAME = "prober"
    WORKERS = 2
    RESYNC_PERIOD = 0.5

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")
        #: pod key -> monotonic time it went Running (probe clocks).
        self._running_since: dict[str, float] = {}

        def on_pod(obj):
            key = namespaced_name(obj)
            if obj.get("status", {}).get("phase") == "Running":
                self._running_since.setdefault(key, time.monotonic())
                anns = obj.get("metadata", {}).get("annotations") or {}
                if READINESS_ANN in anns or LIVENESS_ANN in anns:
                    asyncio.ensure_future(self.queue.add(key))
            else:
                self._running_since.pop(key, None)

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=on_pod, on_update=lambda o, n: on_pod(n),
            on_delete=lambda o: self._running_since.pop(
                namespaced_name(o), None)))

    async def resync_keys(self):
        out = []
        for key in self._running_since:
            pod = self.pod_informer.indexer.get(key)
            if pod is None:
                continue
            anns = pod.get("metadata", {}).get("annotations") or {}
            if READINESS_ANN in anns or LIVENESS_ANN in anns:
                out.append(key)
        return out

    async def sync(self, key: str) -> None:
        pod = self.pod_informer.indexer.get(key)
        since = self._running_since.get(key)
        if pod is None or since is None:
            return
        anns = pod.get("metadata", {}).get("annotations") or {}
        elapsed = time.monotonic() - since

        def _after(name: str) -> bool:
            if name not in anns:
                return False
            try:
                return elapsed >= float(anns[name])
            except (TypeError, ValueError):
                return False  # malformed annotation → probe disabled

        fail_ready = _after(READINESS_ANN)
        fail_live = _after(LIVENESS_ANN)
        if not fail_ready and not fail_live:
            return

        def mutate(p):
            st = p.setdefault("status", {})
            conds = st.setdefault("conditions", [])
            ready = next((c for c in conds if c.get("type") == "Ready"),
                         None)
            if ready is None:
                ready = {"type": "Ready", "status": "True"}
                conds.append(ready)
            if fail_live:
                # Liveness failure → kubelet restarts the container:
                # restartCount++ and the pod comes back Ready.
                st["restartCount"] = int(st.get("restartCount", 0)) + 1
                ready["status"] = "True"
                anns2 = p["metadata"].setdefault("annotations", {})
                anns2.pop(LIVENESS_ANN, None)  # one staged failure
            elif fail_ready:
                if ready["status"] == "False":
                    return None
                ready["status"] = "False"
            return p
        try:
            await self.store.guaranteed_update(
                "pods", key, mutate, return_copy=False)
        except StoreError:
            pass
        if fail_live:
            self._running_since[key] = time.monotonic()


class NodePressureEvictionController(Controller):
    """eviction_manager.go analog over requested (not measured) memory."""

    NAME = "node-pressure-eviction"
    WORKERS = 1
    RESYNC_PERIOD = 1.0

    def __init__(self, store, threshold: float = 0.9):
        super().__init__(store)
        self.threshold = threshold

    def setup(self, factory: InformerFactory) -> None:
        self.node_informer = factory.informer("nodes")
        self.pod_informer = factory.informer("pods")
        # nodeName index: _memory_state must not scan every pod per node
        # per second (O(nodes × pods) at 5k/10k scale).
        self.pod_informer.indexer.add_indexer(
            "nodeName", lambda o: [o.get("spec", {}).get("nodeName")]
            if o.get("spec", {}).get("nodeName") else [])
        self.watch_resource(factory, "nodes", key_fn=lambda o: o[
            "metadata"]["name"])

        def pod_changed(obj):
            node = obj.get("spec", {}).get("nodeName")
            if node:
                asyncio.ensure_future(self.queue.add(node))

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=pod_changed, on_update=lambda o, n: pod_changed(n),
            on_delete=pod_changed))

    async def resync_keys(self):
        return [n["metadata"]["name"]
                for n in self.node_informer.indexer.list()]

    def _memory_state(self, node: dict) -> tuple[int, int, list[dict]]:
        from kubernetes_tpu_torch.api.resource import parse_quantity
        alloc = parse_quantity(
            (node.get("status", {}).get("allocatable") or {})
            .get("memory", 0))
        name = node["metadata"]["name"]
        residents = [p for p in self.pod_informer.indexer.by_index(
                         "nodeName", name)
                     if not pod_is_terminal(p)]
        used = sum(pod_requests(p).get("memory", 0) for p in residents)
        return used, alloc, residents

    async def sync(self, key: str) -> None:
        node = self.node_informer.indexer.get(key)
        if node is None:
            return
        used, alloc, residents = self._memory_state(node)
        over = alloc > 0 and used > self.threshold * alloc
        tainted = any(t.get("key") == PRESSURE_TAINT
                      for t in node.get("spec", {}).get("taints") or [])

        if over:
            if not tainted:
                await self._set_taint(key, True)
            # Evict until under threshold: lowest priority first, largest
            # memory request first within a priority (rankMemoryPressure).
            victims = sorted(
                residents,
                key=lambda p: (p.get("spec", {}).get("priority", 0) or 0,
                               -pod_requests(p).get("memory", 0)))
            for victim in victims:
                if used <= self.threshold * alloc:
                    break
                vkey = namespaced_name(victim)
                try:
                    await self.store.delete("pods", vkey,
                                            uid=uid_of(victim))
                    logger.info(
                        "node-pressure eviction: evicted %s from %s",
                        vkey, key)
                except StoreError:
                    pass  # already gone (stale cache) — still freed
                # Count the memory freed either way: a NotFound means the
                # pod is gone regardless, and NOT decrementing would march
                # down the victim list evicting live pods.
                used -= pod_requests(victim).get("memory", 0)
        elif tainted:
            await self._set_taint(key, False)

    async def _set_taint(self, node_name: str, on: bool) -> None:
        def mutate(n):
            taints = n.setdefault("spec", {}).setdefault("taints", [])
            has = any(t.get("key") == PRESSURE_TAINT for t in taints)
            if on and not has:
                taints.append({"key": PRESSURE_TAINT,
                               "effect": "NoSchedule"})
            elif not on and has:
                n["spec"]["taints"] = [
                    t for t in taints if t.get("key") != PRESSURE_TAINT]
            else:
                return None
            return n
        try:
            await self.store.guaranteed_update(
                "nodes", node_name, mutate, return_copy=False)
        except StoreError:
            pass
