"""Core API object constructors + typed accessors for Pod / Node / Binding.

Parity target: staging/src/k8s.io/api/core/v1/types.go (`Pod`, `PodSpec`,
`Node`, `NodeSpec.taints`, `NodeStatus.allocatable`, `Binding`) and the pod
resource-request helpers in pkg/api/v1/resource/helpers.go (`PodRequests`).
Copy of `kubernetes_tpu/api/types.py`, cut to the pod, node and binding
constructors, the accessors the scheduler compiles its tensors from and the
predicates its informers read.
"""

from __future__ import annotations

from typing import Any, Mapping

from kubernetes_tpu_torch.api.meta import new_object
from kubernetes_tpu_torch.api.resource import parse_resource_list

# Canonical resource names (core/v1 const ResourceCPU etc.)
CPU = "cpu"
MEMORY = "memory"
PODS = "pods"

DEFAULT_SCHEDULER_NAME = "default-scheduler"

# Implicit non-zero request applied when a container specifies no request, so
# that scoring spreads pods sensibly (the reference applies the same defaults in
# scheduler scoring only: pkg/scheduler/util/pod_resources.go
# `DefaultMilliCPURequest`=100m, `DefaultMemoryRequest`=200Mi).
DEFAULT_MILLI_CPU_REQUEST = 100
DEFAULT_MEMORY_REQUEST_MILLI = 200 * 1024 * 1024 * 1000


def make_pod(
    name: str,
    namespace: str = "default",
    labels: Mapping[str, str] | None = None,
    requests: Mapping[str, Any] | None = None,
    limits: Mapping[str, Any] | None = None,
    node_name: str | None = None,
    priority: int | None = None,
    scheduler_name: str = DEFAULT_SCHEDULER_NAME,
    affinity: Mapping | None = None,
    tolerations: list | None = None,
    node_selector: Mapping[str, str] | None = None,
    topology_spread_constraints: list | None = None,
    scheduling_gates: list | None = None,
    host_ports: list[int] | None = None,
    phase: str = "Pending",
    uid: str | None = None,
    resource_claims: list | None = None,
) -> dict:
    container: dict[str, Any] = {"name": "main", "image": "app"}
    res: dict[str, Any] = {}
    if requests:
        res["requests"] = dict(requests)
    if limits:
        res["limits"] = dict(limits)
    if res:
        container["resources"] = res
    if host_ports:
        container["ports"] = [{"hostPort": p, "protocol": "TCP"} for p in host_ports]
    spec: dict[str, Any] = {"containers": [container], "schedulerName": scheduler_name}
    if node_name:
        spec["nodeName"] = node_name
    if priority is not None:
        spec["priority"] = priority
    if affinity:
        spec["affinity"] = dict(affinity)
    if tolerations:
        spec["tolerations"] = list(tolerations)
    if node_selector:
        spec["nodeSelector"] = dict(node_selector)
    if topology_spread_constraints:
        spec["topologySpreadConstraints"] = list(topology_spread_constraints)
    if scheduling_gates:
        spec["schedulingGates"] = [{"name": g} for g in scheduling_gates]
    if resource_claims:
        # DRA claim references: [{"name": ..., "resourceClaimName": ...}]
        # or {"resourceClaimTemplateName": ...} entries.
        spec["resourceClaims"] = list(resource_claims)
    pod = new_object("Pod", name, namespace, labels=labels, spec=spec,
                     status={"phase": phase})
    if uid:
        pod["metadata"]["uid"] = uid
    return pod


def make_node(
    name: str,
    labels: Mapping[str, str] | None = None,
    allocatable: Mapping[str, Any] | None = None,
    capacity: Mapping[str, Any] | None = None,
    taints: list | None = None,
    unschedulable: bool = False,
    images: list | None = None,
) -> dict:
    alloc = dict(allocatable or {"cpu": "8", "memory": "32Gi", "pods": "110"})
    cap = dict(capacity or alloc)
    all_labels = {"kubernetes.io/hostname": name}
    if labels:
        all_labels.update(labels)
    spec: dict[str, Any] = {}
    if taints:
        spec["taints"] = list(taints)
    if unschedulable:
        spec["unschedulable"] = True
    status: dict[str, Any] = {
        "allocatable": alloc,
        "capacity": cap,
        "conditions": [{"type": "Ready", "status": "True"}],
    }
    if images:
        status["images"] = images
    node = new_object("Node", name, namespace=None, labels=all_labels,
                      spec=spec, status=status)
    return node


# ---------------------------------------------------------------------------
# Pod resource accounting
# ---------------------------------------------------------------------------

def make_binding(pod: Mapping, node_name: str) -> dict:
    """core/v1 Binding: target node for a pod; POSTed to the pod's /binding
    subresource (pkg/registry/core/pod/storage `BindingREST.Create`)."""
    return {
        "apiVersion": "v1",
        "kind": "Binding",
        "metadata": {
            "name": pod["metadata"]["name"],
            "namespace": pod["metadata"].get("namespace", "default"),
            "uid": pod["metadata"].get("uid", ""),
        },
        "target": {"kind": "Node", "name": node_name},
    }


def container_requests(container: Mapping) -> dict[str, int]:
    return parse_resource_list((container.get("resources") or {}).get("requests"))


def pod_requests(pod: Mapping, *, non_zero: bool = False) -> dict[str, int]:
    """Effective pod resource requests in milli-units.

    PodRequests semantics (pkg/api/v1/resource/helpers.go): elementwise
    sum over containers, folded with elementwise max over initContainers
    (init containers run serially before the main ones), plus spec.overhead.

    With non_zero=True, cpu/memory get the scheduler's implicit defaults when
    absent (used for Score only, never Filter — matching
    pkg/scheduler/util/pod_resources.go `GetNonzeroRequests`).
    """
    spec = pod.get("spec", {})
    total: dict[str, int] = {}
    for c in spec.get("containers") or []:
        for r, v in container_requests(c).items():
            total[r] = total.get(r, 0) + v
    for c in spec.get("initContainers") or []:
        for r, v in container_requests(c).items():
            if v > total.get(r, 0):
                total[r] = v
    for r, v in parse_resource_list(spec.get("overhead")).items():
        total[r] = total.get(r, 0) + v
    if non_zero:
        if total.get(CPU, 0) == 0:
            total[CPU] = DEFAULT_MILLI_CPU_REQUEST
        if total.get(MEMORY, 0) == 0:
            total[MEMORY] = DEFAULT_MEMORY_REQUEST_MILLI
    return total


def pod_host_ports(pod: Mapping) -> list[tuple[str, str, int]]:
    """(ip, protocol, port) triples claimed by the pod's containers."""
    out = []
    for c in pod.get("spec", {}).get("containers") or []:
        for p in c.get("ports") or []:
            hp = p.get("hostPort")
            if hp:
                out.append((p.get("hostIP", "0.0.0.0"), p.get("protocol", "TCP"), hp))
    return out


def node_allocatable(node: Mapping) -> dict[str, int]:
    return parse_resource_list(node.get("status", {}).get("allocatable"))


def pod_priority(pod: Mapping) -> int:
    return pod.get("spec", {}).get("priority") or 0


def node_is_unschedulable(node: Mapping) -> bool:
    return bool(node.get("spec", {}).get("unschedulable"))


def pod_is_terminal(pod: Mapping) -> bool:
    return pod.get("status", {}).get("phase") in ("Succeeded", "Failed")


# ---------------------------------------------------------------------------
# Taints & tolerations (pkg/apis/core/v1/helper + component-helpers
# scheduling/corev1/nodeaffinity; plugin: tainttoleration)
# ---------------------------------------------------------------------------

TAINT_NO_SCHEDULE = "NoSchedule"
TAINT_PREFER_NO_SCHEDULE = "PreferNoSchedule"
TAINT_NO_EXECUTE = "NoExecute"


def toleration_tolerates_taint(tol: Mapping, taint: Mapping) -> bool:
    """v1helper.TolerationsTolerateTaint single-pair check.

    operator Exists (empty key ⇒ tolerate everything) or Equal (default);
    empty effect tolerates all effects.
    """
    if tol.get("effect") and tol["effect"] != taint.get("effect"):
        return False
    op = tol.get("operator", "Equal")
    if op == "Exists":
        return not tol.get("key") or tol["key"] == taint.get("key")
    return tol.get("key") == taint.get("key") and tol.get("value", "") == taint.get("value", "")


def find_untolerated_taint(
    taints: list, tolerations: list, effects: tuple[str, ...]
) -> Mapping | None:
    """First taint with effect in `effects` not tolerated by any toleration
    (v1helper.FindMatchingUntoleratedTaint)."""
    for taint in taints or []:
        if taint.get("effect") not in effects:
            continue
        if not any(toleration_tolerates_taint(t, taint) for t in tolerations or []):
            return taint
    return None
