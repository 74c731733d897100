"""The scheduler: framework extension points, 3-tier queue, assume/expire
cache, plugins, and the loop that drives the batched backend.
Counterpart of `kubernetes_tpu/scheduler/`."""

from kubernetes_tpu_torch.scheduler.framework import (
    CycleState,
    Framework,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.queue import ClusterEvent, SchedulingQueue
from kubernetes_tpu_torch.scheduler.scheduler import FitError, Scheduler
from kubernetes_tpu_torch.scheduler.types import (
    NodeInfo, PodInfo, Resource, Snapshot)

__all__ = [
    "CycleState",
    "Framework",
    "Plugin",
    "Status",
    "SchedulerCache",
    "ClusterEvent",
    "SchedulingQueue",
    "FitError",
    "Scheduler",
    "NodeInfo",
    "PodInfo",
    "Resource",
    "Snapshot",
]
