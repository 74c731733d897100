"""Scheduler snapshot records: PodInfo / NodeInfo / Resource.

Parity target: pkg/scheduler/framework/types.go (`NodeInfo` — Requested,
NonZeroRequested, Allocatable, Pods, PodsWithAffinity, PodsWithRequiredAntiAffinity,
UsedPorts, ImageStates, Generation; `PodInfo` — cached affinity terms;
`Resource` — MilliCPU/Memory/EphemeralStorage/AllowedPodNumber/ScalarResources).

These are the *host-side* compiled records; ops/tensorize.py compiles them
further into dense arrays. Copy of `kubernetes_tpu/scheduler/types.py`, cut to
what the batch cycle, the scheduler cache, the serving fast path and the
scheduler loop read (PodInfo carries the queue's bookkeeping).
"""

from __future__ import annotations

from typing import Any, Mapping

from kubernetes_tpu_torch.api.meta import name_of, namespaced_name, uid_of
from kubernetes_tpu_torch.api.types import (
    PODS,
    node_allocatable,
    pod_host_ports,
    pod_priority,
    pod_requests,
)

#: Default max pods when status.allocatable omits "pods" (kubelet default).
DEFAULT_MAX_PODS = 110


def _alloc_pods(alloc: Mapping[str, int]) -> int:
    """Allocatable pod count; an explicit "0" means zero, only absence
    falls back to the default."""
    v = alloc.get(PODS)
    return DEFAULT_MAX_PODS if v is None else v // 1000


class Resource:
    """Aggregate resource vector in milli-units + pod count."""

    __slots__ = ("res", "pods")

    def __init__(self, res: Mapping[str, int] | None = None, pods: int = 0):
        self.res: dict[str, int] = dict(res or {})
        self.pods = pods

    def add(self, other: Mapping[str, int]) -> None:
        for k, v in other.items():
            if k == PODS:
                continue
            self.res[k] = self.res.get(k, 0) + v

    def sub(self, other: Mapping[str, int]) -> None:
        for k, v in other.items():
            if k == PODS:
                continue
            self.res[k] = self.res.get(k, 0) - v

    def get(self, name: str) -> int:
        return self.res.get(name, 0)

    def clone(self) -> "Resource":
        return Resource(self.res, self.pods)

    def __repr__(self) -> str:
        return f"Resource({self.res}, pods={self.pods})"


class PodInfo:
    """Parsed pod with scheduling-relevant fields precomputed
    (framework.PodInfo caches affinity terms for the same reason)."""

    __slots__ = (
        "pod", "key", "uid", "name", "namespace", "labels",
        "requests", "nonzero_requests", "priority",
        "node_name", "scheduler_name",
        "node_selector", "affinity", "tolerations",
        "topology_spread_constraints", "scheduling_gates",
        "host_ports", "pvc_names", "resource_claims",
        "required_affinity_terms", "required_anti_affinity_terms",
        "preferred_affinity_terms", "preferred_anti_affinity_terms",
        "attempts", "last_failure", "unschedulable_plugins", "queued_at",
        "enqueued_at", "dequeued_at", "nominated_node",
    )

    def __init__(self, pod: Mapping):
        self.pod = pod
        self.key = namespaced_name(pod)
        self.uid = uid_of(pod)
        self.name = name_of(pod)
        self.namespace = pod.get("metadata", {}).get("namespace", "")
        self.labels = pod.get("metadata", {}).get("labels") or {}
        self.requests = pod_requests(pod)
        self.nonzero_requests = pod_requests(pod, non_zero=True)
        self.priority = pod_priority(pod)
        spec = pod.get("spec", {})
        self.node_name = spec.get("nodeName", "")
        self.scheduler_name = spec.get("schedulerName", "default-scheduler")
        self.node_selector = spec.get("nodeSelector") or {}
        self.affinity = spec.get("affinity") or {}
        self.tolerations = spec.get("tolerations") or []
        self.topology_spread_constraints = spec.get("topologySpreadConstraints") or []
        self.scheduling_gates = [g.get("name") for g in spec.get("schedulingGates") or []]
        self.host_ports = pod_host_ports(pod)
        self.pvc_names = [
            v["persistentVolumeClaim"]["claimName"]
            for v in spec.get("volumes") or []
            if v.get("persistentVolumeClaim", {}).get("claimName")]
        #: spec.resourceClaims entries (DRA): [{"name", and one of
        #: "resourceClaimName" | "resourceClaimTemplateName"}].
        self.resource_claims = spec.get("resourceClaims") or []
        pod_aff = self.affinity.get("podAffinity") or {}
        pod_anti = self.affinity.get("podAntiAffinity") or {}
        self.required_affinity_terms = list(
            pod_aff.get("requiredDuringSchedulingIgnoredDuringExecution") or [])
        self.required_anti_affinity_terms = list(
            pod_anti.get("requiredDuringSchedulingIgnoredDuringExecution") or [])
        self.preferred_affinity_terms = list(
            pod_aff.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
        self.preferred_anti_affinity_terms = list(
            pod_anti.get("preferredDuringSchedulingIgnoredDuringExecution") or [])
        # Queue bookkeeping (queuedPodInfo in the reference).
        self.attempts = 0
        self.last_failure = ""
        self.unschedulable_plugins: set[str] = set()
        self.queued_at = 0.0
        #: endpoints of the retroactive queue-wait span, same clock as
        #: queued_at: enqueued_at is re-stamped on every activeQ entry
        #: (so a retry's span covers only THIS attempt's wait, not prior
        #: cycles/backoff), dequeued_at when pop_batch hands it out.
        self.enqueued_at = 0.0
        self.dequeued_at = 0.0
        #: the node a preemption nominated for this pod ("" = none).
        self.nominated_node = ""

    @property
    def has_required_anti_affinity(self) -> bool:
        return bool(self.required_anti_affinity_terms)

    @property
    def has_affinity_constraints(self) -> bool:
        return bool(
            self.required_affinity_terms
            or self.required_anti_affinity_terms
            or self.preferred_affinity_terms
            or self.preferred_anti_affinity_terms
        )

    def __repr__(self) -> str:
        return f"PodInfo({self.key})"


class NodeInfo:
    """Per-node aggregate the Filter/Score plugins read.

    Mirrors framework.NodeInfo: the node object + resident pods + running
    resource sums + used host ports, with a generation for incremental
    snapshotting.
    """

    __slots__ = (
        "node", "name", "labels", "allocatable", "taints", "unschedulable",
        "requested", "nonzero_requested", "pods", "pods_with_affinity",
        "pods_with_required_anti_affinity", "used_ports", "image_names",
        "generation", "spec_epoch",
    )

    def __init__(self, node: Mapping | None = None):
        self.node = node
        self.name = name_of(node) if node else ""
        self.labels: dict[str, str] = (
            node.get("metadata", {}).get("labels") or {} if node else {}
        )
        alloc = node_allocatable(node) if node else {}
        self.allocatable = Resource(
            {k: v for k, v in alloc.items() if k != PODS},
            pods=_alloc_pods(alloc),
        )
        self.taints = list(node.get("spec", {}).get("taints") or []) if node else []
        self.unschedulable = bool(node.get("spec", {}).get("unschedulable")) if node else False
        self.requested = Resource()
        self.nonzero_requested = Resource()
        self.pods: list[PodInfo] = []
        self.pods_with_affinity: list[PodInfo] = []
        self.pods_with_required_anti_affinity: list[PodInfo] = []
        self.used_ports: set[tuple[str, str, int]] = set()
        self.image_names: set[str] = set()
        if node:
            for img in node.get("status", {}).get("images") or []:
                for tag in img.get("names") or []:
                    self.image_names.add(tag)
        self.generation = 0
        # Monotonic count of node-object (spec/labels/taints) changes —
        # unlike `generation` it does NOT move on pod add/remove, so
        # consumers keyed on static node state (the TPU backend's taint
        # interning and signature-cached rows) can reuse work across
        # pod-churn cycles without the id()-recycling hazard.
        self.spec_epoch = 1 if node else 0

    def set_node(self, node: Mapping) -> None:
        self.node = node
        self.name = name_of(node)
        self.labels = node.get("metadata", {}).get("labels") or {}
        alloc = node_allocatable(node)
        self.allocatable = Resource(
            {k: v for k, v in alloc.items() if k != PODS},
            pods=_alloc_pods(alloc),
        )
        self.taints = list(node.get("spec", {}).get("taints") or [])
        self.unschedulable = bool(node.get("spec", {}).get("unschedulable"))
        self.image_names = set()
        for img in node.get("status", {}).get("images") or []:
            for tag in img.get("names") or []:
                self.image_names.add(tag)
        self.spec_epoch += 1

    def add_pod(self, pi: PodInfo) -> None:
        self.pods.append(pi)
        self.requested.add(pi.requests)
        self.nonzero_requested.add(pi.nonzero_requests)
        self.requested.pods += 1
        if pi.has_affinity_constraints:
            self.pods_with_affinity.append(pi)
        if pi.has_required_anti_affinity:
            self.pods_with_required_anti_affinity.append(pi)
        self.used_ports.update(pi.host_ports)

    def remove_pod(self, pod_key: str) -> bool:
        for lst in (self.pods, self.pods_with_affinity,
                    self.pods_with_required_anti_affinity):
            for i, pi in enumerate(lst):
                if pi.key == pod_key:
                    if lst is self.pods:
                        self.requested.sub(pi.requests)
                        self.nonzero_requested.sub(pi.nonzero_requests)
                        self.requested.pods -= 1
                        self.used_ports.difference_update(pi.host_ports)
                    del lst[i]
                    break
        return True

    def clone(self) -> "NodeInfo":
        ni = NodeInfo.__new__(NodeInfo)
        ni.node = self.node
        ni.name = self.name
        ni.labels = self.labels
        ni.allocatable = self.allocatable.clone()
        ni.taints = self.taints
        ni.unschedulable = self.unschedulable
        ni.requested = self.requested.clone()
        ni.nonzero_requested = self.nonzero_requested.clone()
        ni.pods = list(self.pods)
        ni.pods_with_affinity = list(self.pods_with_affinity)
        ni.pods_with_required_anti_affinity = list(self.pods_with_required_anti_affinity)
        ni.used_ports = set(self.used_ports)
        ni.image_names = set(self.image_names)
        ni.generation = self.generation
        ni.spec_epoch = self.spec_epoch
        return ni

    def __repr__(self) -> str:
        return f"NodeInfo({self.name}, pods={len(self.pods)})"


class Snapshot:
    """Immutable-by-convention view handed to a scheduling cycle
    (internal/cache/snapshot.go `Snapshot`)."""

    def __init__(self, nodes: list[NodeInfo] | None = None, generation: int = 0,
                 *, by_name: dict | None = None,
                 have_affinity: list | None = None,
                 have_anti_affinity: list | None = None):
        self.nodes = nodes or []
        self.generation = generation
        # The incremental cache passes its maintained structures (already
        # consistent with `nodes`) so snapshot construction is O(changed),
        # not three O(N) scans per cycle.
        self._by_name = by_name if by_name is not None \
            else {n.name: n for n in self.nodes}
        self.have_pods_with_affinity = have_affinity \
            if have_affinity is not None \
            else [n for n in self.nodes if n.pods_with_affinity]
        self.have_pods_with_required_anti_affinity = have_anti_affinity \
            if have_anti_affinity is not None else [
                n for n in self.nodes if n.pods_with_required_anti_affinity]
        #: Incremental host-prep handles (set by SchedulerCache; the
        #: defaults mean "unknown — do the full walk"): `set_epoch`
        #: changes when the node SET/order changes, `spec_seq` when any
        #: node object's spec changed, and `changed_since(gen)` returns
        #: the snapshot-order indices of nodes whose generation advanced
        #: past `gen` (None = outside the retained window).
        self.set_epoch = -1
        self.spec_seq = -1
        self.changed_since = None

    def get(self, name: str) -> NodeInfo | None:
        return self._by_name.get(name)

    def __len__(self) -> int:
        return len(self.nodes)

    def __iter__(self):
        return iter(self.nodes)
