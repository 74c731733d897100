"""Queue-order, gating and binding plugins.

Parity targets: pkg/scheduler/framework/plugins/{queuesort/priority_sort.go,
schedulinggates/scheduling_gates.go, defaultbinder/default_binder.go}. Copy
of `kubernetes_tpu/scheduler/plugins/core.py` without ImageLocality, a
Score plugin the batched backend does not model yet.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.types import make_binding
from kubernetes_tpu_torch.scheduler.framework import (
    CycleState,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import PodInfo


class PrioritySort(Plugin):
    """QueueSort: priority desc, then queue-entry time (FIFO)."""

    NAME = "PrioritySort"
    EXTENSION_POINTS = ("QueueSort",)

    def less(self, a: PodInfo, b: PodInfo) -> bool:
        if a.priority != b.priority:
            return a.priority > b.priority
        return a.queued_at < b.queued_at

    def key(self, pi: PodInfo) -> tuple:
        """Heap key equivalent of less() for the queue's heap."""
        return (-pi.priority, pi.queued_at)


class SchedulingGates(Plugin):
    """PreEnqueue: pods with non-empty spec.schedulingGates stay out of the
    queue until the gates are removed."""

    NAME = "SchedulingGates"
    EXTENSION_POINTS = ("PreEnqueue",)
    EVENTS = ["Pod/Update"]

    def pre_enqueue(self, pod: PodInfo) -> Status:
        if pod.scheduling_gates:
            return Status.unschedulable(
                f"waiting for scheduling gates: {pod.scheduling_gates}",
                resolvable=False)
        return Status.success()


class DefaultBinder(Plugin):
    """Bind: POST the Binding subresource (defaultbinder/default_binder.go:
    `b.handle.ClientSet().CoreV1().Pods(ns).Bind(...)`)."""

    NAME = "DefaultBinder"
    EXTENSION_POINTS = ("Bind",)

    def __init__(self, args=None, store=None):
        super().__init__(args)
        self.store = store

    async def bind(self, state: CycleState, pod: PodInfo, node_name: str) -> Status:
        if self.store is None:
            return Status.error("DefaultBinder has no store client")
        from kubernetes_tpu_torch.store.mvcc import StoreError
        try:
            await self.store.subresource(
                "pods", pod.key, "binding", make_binding(pod.pod, node_name))
        except StoreError as e:
            return Status.error(f"binding rejected: {e}")
        return Status.success()
