"""Pod garbage collector.

Parity target: pkg/controller/podgc/gc_controller.go: periodically deletes
(a) pods bound to nodes that no longer exist ("orphaned"), (b) terminated
pods beyond a threshold, (c) unscheduled terminating pods.

Copy of `kubernetes_tpu/controllers/podgc.py`.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.api.types import pod_is_terminal
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import StoreError

logger = logging.getLogger(__name__)


class PodGCController(Controller):
    NAME = "podgc"
    WORKERS = 1

    def __init__(self, store, *, gc_period: float = 2.0,
                 terminated_pod_threshold: int = 0):
        super().__init__(store)
        self.gc_period = gc_period
        self.terminated_pod_threshold = terminated_pod_threshold

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")
        self.node_informer = factory.informer("nodes")

    def start(self) -> None:
        super().start()
        self._tasks.append(asyncio.ensure_future(self._gc_loop()))

    async def _gc_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.gc_period)
            try:
                await self.gc_once()
            except Exception:
                logger.exception("podgc pass failed")

    async def gc_once(self) -> int:
        nodes = {n["metadata"]["name"]
                 for n in self.node_informer.indexer.list()}
        deleted = 0
        terminated: list[dict] = []
        for pod in self.pod_informer.indexer.list():
            node = pod.get("spec", {}).get("nodeName")
            if node and node not in nodes:
                # gcOrphaned: bound to a vanished node.
                deleted += await self._delete(pod)
            elif pod_is_terminal(pod):
                terminated.append(pod)
        if self.terminated_pod_threshold > 0 and \
                len(terminated) > self.terminated_pod_threshold:
            terminated.sort(
                key=lambda p: p["metadata"].get("creationTimestamp", ""))
            excess = len(terminated) - self.terminated_pod_threshold
            for pod in terminated[:excess]:
                deleted += await self._delete(pod)
        return deleted

    async def _delete(self, pod: dict) -> int:
        try:
            await self.store.delete("pods", namespaced_name(pod))
            return 1
        except StoreError:
            return 0

    async def sync(self, key: str) -> None:
        return
