"""Node lifecycle controller: heartbeat monitoring → taints → eviction.

Parity target: pkg/controller/nodelifecycle/node_lifecycle_controller.go
(SURVEY §5.3): kubelets renew a coordination Lease every ~10s; if no renewal
for `node_monitor_grace_period` (default 40s) the controller marks
Ready=Unknown and adds the `node.kubernetes.io/unreachable:NoExecute` taint;
the NoExecute taint manager then evicts pods whose tolerationSeconds expire
(admission injects a default 300s toleration; ours is a knob).
Recovery (lease renewed) removes the taint and restores Ready=True.

Copy of `kubernetes_tpu/controllers/nodelifecycle.py`. Host code only:
the injected `clock` times heartbeats, the monitor tick and the
eviction delays run on the event loop.
"""

from __future__ import annotations

import asyncio
import logging
import time

from kubernetes_tpu_torch.api.meta import name_of, namespaced_name
from kubernetes_tpu_torch.api.types import (
    TAINT_NO_EXECUTE,
    TAINT_UNREACHABLE,
    toleration_tolerates_taint,
)
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)


class NodeLifecycleController(Controller):
    NAME = "nodelifecycle"
    WORKERS = 2

    def __init__(self, store, *,
                 node_monitor_period: float = 1.0,
                 node_monitor_grace_period: float = 4.0,
                 default_toleration_seconds: float = 3.0,
                 toleration_seconds_cap: float | None = None,
                 clock=time.monotonic):
        super().__init__(store)
        self.monitor_period = node_monitor_period
        self.grace_period = node_monitor_grace_period
        self.default_toleration_seconds = default_toleration_seconds
        #: upper bound applied to FINITE per-pod tolerationSeconds (the
        #: admission default injects 300s on every pod); fault-injection
        #: harnesses set this to accelerate the eviction clock the same
        #: way they shorten the grace period. None = honor pod values;
        #: tolerate-forever (no seconds) is never overridden.
        self.toleration_seconds_cap = toleration_seconds_cap
        self.clock = clock
        #: node -> monotonic time of last observed lease renewal
        self._last_heartbeat: dict[str, float] = {}
        #: (pod key) -> eviction task
        self._evictions: dict[str, asyncio.Task] = {}

    def setup(self, factory: InformerFactory) -> None:
        self.node_informer = factory.informer("nodes")
        self.pod_informer = factory.informer("pods")
        lease_informer = factory.informer("leases")

        def on_lease(obj):
            node = name_of(obj)
            self._last_heartbeat[node] = self.clock()

        lease_informer.add_event_handler(ResourceEventHandler(
            on_add=on_lease, on_update=lambda o, n: on_lease(n)))

        def on_node_add(obj):
            # A node with no lease yet gets the benefit of the doubt from
            # its creation time.
            self._last_heartbeat.setdefault(name_of(obj), self.clock())

        self.node_informer.add_event_handler(ResourceEventHandler(
            on_add=on_node_add,
            on_delete=lambda obj: self._last_heartbeat.pop(name_of(obj), None),
        ))

    def start(self) -> None:
        super().start()
        self._tasks.append(asyncio.ensure_future(self._monitor_loop()))

    async def _monitor_loop(self) -> None:
        """monitorNodeHealth tick."""
        while not self._stopped:
            await asyncio.sleep(self.monitor_period)
            now = self.clock()
            for node in self.node_informer.indexer.list():
                name = name_of(node)
                last = self._last_heartbeat.get(name, now)
                stale = (now - last) > self.grace_period
                tainted = any(
                    t.get("key") == TAINT_UNREACHABLE
                    for t in node.get("spec", {}).get("taints") or [])
                if stale and not tainted:
                    await self._mark_unreachable(name)
                elif not stale and tainted:
                    await self._mark_reachable(name)

    async def _mark_unreachable(self, name: str) -> None:
        logger.warning("node %s missed heartbeats; tainting unreachable", name)

        def mutate(node):
            taints = node.setdefault("spec", {}).setdefault("taints", [])
            if any(t.get("key") == TAINT_UNREACHABLE for t in taints):
                return None
            taints.append({"key": TAINT_UNREACHABLE,
                           "effect": TAINT_NO_EXECUTE})
            self._set_ready(node, "Unknown")
            return node
        try:
            await self.store.guaranteed_update("nodes", name, mutate)
        except NotFound:
            return
        # NoExecute taint manager: schedule eviction for every pod on the
        # node after its effective tolerationSeconds.
        for pod in self.pod_informer.indexer.list():
            if pod.get("spec", {}).get("nodeName") != name:
                continue
            key = namespaced_name(pod)
            if key in self._evictions:
                continue
            delay = self._toleration_seconds(pod)
            if delay is None:
                continue  # tolerates forever
            self._evictions[key] = asyncio.ensure_future(
                self._evict_after(key, name, delay))

    async def _mark_reachable(self, name: str) -> None:
        logger.info("node %s heartbeats resumed; removing taint", name)

        def mutate(node):
            taints = node.get("spec", {}).get("taints") or []
            kept = [t for t in taints if t.get("key") != TAINT_UNREACHABLE]
            if len(kept) == len(taints):
                return None
            node["spec"]["taints"] = kept
            self._set_ready(node, "True")
            return node
        try:
            await self.store.guaranteed_update("nodes", name, mutate)
        except NotFound:
            pass
        # Cancel pending evictions for pods on the recovered node.
        for key, task in list(self._evictions.items()):
            pod = self.pod_informer.indexer.get(key)
            if pod is not None and pod.get("spec", {}).get("nodeName") == name:
                task.cancel()
                del self._evictions[key]

    def _toleration_seconds(self, pod: dict) -> float | None:
        """Effective tolerationSeconds for the unreachable taint: the pod's
        matching toleration wins; absent one, the injected default applies
        (defaulttolerationseconds admission plugin)."""
        taint = {"key": TAINT_UNREACHABLE, "effect": TAINT_NO_EXECUTE}
        cap = self.toleration_seconds_cap
        for tol in pod.get("spec", {}).get("tolerations") or []:
            if toleration_tolerates_taint(tol, taint):
                secs = tol.get("tolerationSeconds")
                if secs is None:
                    return None  # tolerates forever; the cap never applies
                return float(secs) if cap is None \
                    else min(float(secs), cap)
        return self.default_toleration_seconds if cap is None \
            else min(self.default_toleration_seconds, cap)

    async def _evict_after(self, key: str, node: str, delay: float) -> None:
        try:
            await asyncio.sleep(delay)
            pod = self.pod_informer.indexer.get(key)
            if pod is None or pod.get("spec", {}).get("nodeName") != node:
                return
            logger.warning("evicting %s from unreachable node %s", key, node)
            try:
                await self.store.delete("pods", key)
            except StoreError:
                pass
        except asyncio.CancelledError:
            pass
        finally:
            self._evictions.pop(key, None)

    @staticmethod
    def _set_ready(node: dict, status: str) -> None:
        conds = node.setdefault("status", {}).setdefault("conditions", [])
        for c in conds:
            if c.get("type") == "Ready":
                c["status"] = status
                return
        conds.append({"type": "Ready", "status": status})

    async def sync(self, key: str) -> None:  # all work happens in the loops
        return

    async def stop(self) -> None:
        for t in self._evictions.values():
            t.cancel()
        await super().stop()
