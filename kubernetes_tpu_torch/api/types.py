"""Core API object constructors + typed accessors for Pod / Node / Binding.

Parity target: staging/src/k8s.io/api/core/v1/types.go (`Pod`, `PodSpec`,
`Node`, `NodeSpec.taints`, `NodeStatus.allocatable`, `Binding`) and the pod
resource-request helpers in pkg/api/v1/resource/helpers.go (`PodRequests`).
Copy of `kubernetes_tpu/api/types.py`, cut to the pod, node and binding
constructors, the volume objects (PersistentVolume, PersistentVolumeClaim,
StorageClass), the device-topology objects (DeviceClass, ResourceSlice,
ResourceClaim and its template, NodeResourceTopology), the device list a
node agent publishes (`template_devices`), the admission-policy objects
(Namespace, ValidatingAdmissionPolicy and its binding, ConfigMap), the
accessors the
scheduler compiles its tensors from and the predicates its informers read.
"""

from __future__ import annotations

from typing import Any, Mapping

from kubernetes_tpu_torch.api.meta import new_object
from kubernetes_tpu_torch.api.resource import (
    format_quantity,
    parse_quantity,
    parse_resource_list,
)

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


def make_pv(name: str, capacity: str = "10Gi", *,
            storage_class: str = "", access_modes: list | None = None,
            node_affinity: Mapping | None = None,
            labels: Mapping[str, str] | None = None,
            reclaim_policy: str = "Retain") -> dict:
    """core/v1 PersistentVolume (cluster-scoped). `node_affinity` is the
    PV's `spec.nodeAffinity.required` nodeSelectorTerms mapping (topology
    pinning — local/zonal volumes)."""
    spec = {
        "capacity": {"storage": capacity},
        "accessModes": access_modes or ["ReadWriteOnce"],
        "storageClassName": storage_class,
        "persistentVolumeReclaimPolicy": reclaim_policy,
    }
    if node_affinity:
        spec["nodeAffinity"] = {"required": dict(node_affinity)}
    pv = new_object("PersistentVolume", name, None, spec=spec,
                    status={"phase": "Available"})
    if labels:
        pv["metadata"]["labels"] = dict(labels)
    return pv


def make_pvc(name: str, namespace: str = "default", request: str = "1Gi", *,
             storage_class: str | None = None,
             access_modes: list | None = None) -> dict:
    spec = {
        "resources": {"requests": {"storage": request}},
        "accessModes": access_modes or ["ReadWriteOnce"],
    }
    if storage_class is not None:
        spec["storageClassName"] = storage_class
    return new_object("PersistentVolumeClaim", name, namespace, spec=spec,
                      status={"phase": "Pending"})


def make_storage_class(name: str, *,
                       binding_mode: str = "Immediate",
                       provisioner: str = "ktpu.dev/simulated",
                       allowed_topologies: list | None = None,
                       is_default: bool = False) -> dict:
    """storage.k8s.io/v1 StorageClass; `binding_mode` is
    Immediate | WaitForFirstConsumer. `is_default` sets the
    storageclass.kubernetes.io/is-default-class annotation the
    DefaultStorageClass admission mutator looks for."""
    sc = new_object("StorageClass", name, None)
    sc["volumeBindingMode"] = binding_mode
    sc["provisioner"] = provisioner
    if allowed_topologies:
        sc["allowedTopologies"] = allowed_topologies
    if is_default:
        sc["metadata"].setdefault("annotations", {})[
            "storageclass.kubernetes.io/is-default-class"] = "true"
    return sc


def make_device_class(name: str,
                      selectors: Mapping[str, str] | None = None) -> dict:
    """resource.k8s.io DeviceClass (structured parameters). `selectors`
    are attribute equality matchers, the tractable core of the
    reference's CEL selectors: a device belongs to the class iff every
    (attr, value) pair matches."""
    dc = new_object("DeviceClass", name, None,
                    api_version="resource.k8s.io/v1")
    dc["spec"] = {"selectors": dict(selectors or {})}
    return dc


def make_resource_slice(node_name: str, driver: str,
                        devices: list[dict],
                        name: str | None = None) -> dict:
    """resource.k8s.io ResourceSlice: the per-node device inventory a DRA
    driver publishes. `devices` entries:
    {"name": "tpu-0", "attributes": {"type": "tpu", "numa": "0"}}."""
    rs = new_object("ResourceSlice", name or f"{node_name}-{driver}", None,
                    api_version="resource.k8s.io/v1")
    rs["spec"] = {"nodeName": node_name, "driver": driver,
                  "devices": list(devices)}
    return rs


def template_devices(allocatable: Mapping | None,
                     zones: int = 2) -> list[dict]:
    """Derive a node's DRA device list from its allocatable extended
    resources (names containing '/'), the convention kwok nodes and the
    hollow-kubelet agent share: '/' maps to '--' (dots kept) so two
    vendors' same-suffix resources can't collide in the consumed-device
    set, and devices split into contiguous NUMA-zone blocks (devices
    0..n/z-1 in zone 0, etc. — the alignment MatchAttribute needs)."""
    zones = max(1, zones)
    devices: list[dict] = []
    for res, count in (allocatable or {}).items():
        if "/" not in res:
            continue  # core resources are not devices
        try:
            n = int(str(count))
        except ValueError:
            continue
        prefix = res.replace("/", "--")
        short = res.rsplit("/", 1)[1]
        for k in range(n):
            devices.append({
                "name": f"{prefix}-{k}",
                "attributes": {"type": short,
                               "numa": str(k * zones // n)}})
    return devices


def make_resource_claim(name: str, namespace: str = "default",
                        requests: list[dict] | None = None,
                        constraints: list[dict] | None = None) -> dict:
    """resource.k8s.io ResourceClaim. `requests` entries:
    {"name": "tpus", "deviceClassName": "tpu", "count": 4}; `constraints`
    entries: {"matchAttribute": "numa"} — all allocated devices must agree
    on that attribute (single-NUMA alignment the DRA way)."""
    rc = new_object("ResourceClaim", name, namespace,
                    api_version="resource.k8s.io/v1")
    rc["spec"] = {"devices": {"requests": list(requests or []),
                              "constraints": list(constraints or [])}}
    return rc


def make_resource_claim_template(name: str, namespace: str = "default",
                                 requests: list[dict] | None = None,
                                 constraints: list[dict] | None = None
                                 ) -> dict:
    """ResourceClaimTemplate: per-pod claims stamped out for pods
    referencing the template."""
    t = new_object("ResourceClaimTemplate", name, namespace,
                   api_version="resource.k8s.io/v1")
    t["spec"] = {"devices": {"requests": list(requests or []),
                             "constraints": list(constraints or [])}}
    return t


def make_node_resource_topology(
        node_name: str,
        zones: list[dict],
        policies: list[str] | None = None) -> dict:
    """topology.node.k8s.io/v1alpha2 NodeResourceTopology (the scheduler-
    plugins NUMA CRD; see plugins/noderesourcetopology.py). `zones` entries:
    {"name": ..., "resources": [{"name": ..., "capacity": ...}, ...]}."""
    nrt = new_object("NodeResourceTopology", node_name, None,
                     api_version="topology.node.k8s.io/v1alpha2")
    nrt["topologyPolicies"] = list(
        policies or ["SingleNUMANodeContainerLevel"])
    nrt["zones"] = zones
    return nrt


def split_node_topology(node_name: str, allocatable: Mapping[str, str],
                        num_zones: int = 2,
                        zoned: tuple[str, ...] = ("cpu",),
                        devices: Mapping[str, int] | None = None) -> dict:
    """Split a node's allocatable evenly into `num_zones` NUMA zones (cpu +
    extended device resources), the shape a device-manager node agent
    would report."""
    zones = []
    for z in range(num_zones):
        res = []
        for r in zoned:
            if r in allocatable:
                res.append({"name": r, "capacity": format_quantity(
                    parse_quantity(allocatable[r]) // num_zones)})
        for r, per_zone in (devices or {}).items():
            res.append({"name": r, "capacity": str(per_zone)})
        zones.append({"name": f"{node_name}-numa-{z}", "type": "Node",
                      "resources": res})
    return make_node_resource_topology(node_name, zones)


def make_namespace(name: str) -> dict:
    """core/v1 Namespace (deletion fans out via NamespaceController)."""
    return new_object("Namespace", name, None, status={"phase": "Active"})


def make_validating_admission_policy(
        name: str,
        validations: list[Mapping],
        *,
        failure_policy: str = "Fail",
        param_kind: str | None = None,
        match_constraints: Mapping | None = None) -> dict:
    """admissionregistration.k8s.io/v1 ValidatingAdmissionPolicy
    (policy/vap.py). `validations` entries: {"expression": ...,
    "message": ...}; `match_constraints` carries resourceRules /
    namespaceSelector. Inert until a binding references it."""
    spec: dict[str, Any] = {
        "failurePolicy": failure_policy,
        "validations": [dict(v) for v in validations],
    }
    if param_kind:
        spec["paramKind"] = {"kind": param_kind}
    if match_constraints is not None:
        spec["matchConstraints"] = dict(match_constraints)
    return new_object("ValidatingAdmissionPolicy", name, None,
                      api_version="admissionregistration.k8s.io/v1",
                      spec=spec)


def make_vap_binding(name: str, policy_name: str, *,
                     param_ref: Mapping | None = None) -> dict:
    """ValidatingAdmissionPolicyBinding: activates a policy; `param_ref`
    ({"name": ..., "namespace": ...}) resolves against the policy's
    paramKind."""
    spec: dict[str, Any] = {"policyName": policy_name}
    if param_ref is not None:
        spec["paramRef"] = dict(param_ref)
    return new_object("ValidatingAdmissionPolicyBinding", name, None,
                      api_version="admissionregistration.k8s.io/v1",
                      spec=spec)


def make_config_map(name: str, namespace: str = "default",
                    data: Mapping[str, Any] | None = None) -> dict:
    """core/v1 ConfigMap — the usual VAP paramKind."""
    return new_object("ConfigMap", name, namespace,
                      data=dict(data or {}))


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

TAINT_UNREACHABLE = "node.kubernetes.io/unreachable"


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
