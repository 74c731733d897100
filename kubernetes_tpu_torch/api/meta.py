"""Object metadata helpers over wire-shape dicts.

Parity target: staging/src/k8s.io/apimachinery/pkg/apis/meta/v1/types.go
(`ObjectMeta`: name/namespace/uid/resourceVersion/labels/annotations/
ownerReferences/creationTimestamp/deletionTimestamp/finalizers).

API objects are their wire form: plain nested dicts with camelCase keys.
Copy of `kubernetes_tpu/api/meta.py`.
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Any, Mapping

# uuid4() costs an os.urandom syscall per call — at scheduler_perf scale
# (every pod + every Event records a uid) it was >50% of the measured-phase
# wall on one core. One random 64-bit boot epoch + a process-local counter
# keeps uids unique across restarts at ~30ns each.
_UID_EPOCH = os.urandom(8).hex()
_UID_SEQ = itertools.count(1)


def new_uid() -> str:
    return f"{_UID_EPOCH}-{next(_UID_SEQ):x}"


def new_object(
    kind: str,
    name: str,
    namespace: str | None = "default",
    labels: Mapping[str, str] | None = None,
    annotations: Mapping[str, str] | None = None,
    api_version: str = "v1",
    **spec_fields: Any,
) -> dict:
    """Build a minimal API object dict with populated metadata."""
    meta: dict[str, Any] = {"name": name, "uid": new_uid()}
    if namespace is not None:
        meta["namespace"] = namespace
    if labels:
        meta["labels"] = dict(labels)
    if annotations:
        meta["annotations"] = dict(annotations)
    obj: dict[str, Any] = {"apiVersion": api_version, "kind": kind, "metadata": meta}
    obj.update(spec_fields)
    return obj


def name_of(obj: Mapping) -> str:
    return obj.get("metadata", {}).get("name", "")


def namespace_of(obj: Mapping) -> str:
    return obj.get("metadata", {}).get("namespace", "")


def uid_of(obj: Mapping) -> str:
    return obj.get("metadata", {}).get("uid", "")


def labels_of(obj: Mapping) -> dict:
    return obj.get("metadata", {}).get("labels") or {}


def annotations_of(obj: Mapping) -> dict:
    return obj.get("metadata", {}).get("annotations") or {}


def resource_version_of(obj: Mapping) -> int:
    rv = obj.get("metadata", {}).get("resourceVersion", "0")
    return int(rv) if rv else 0


def namespaced_name(obj: Mapping) -> str:
    """"ns/name" key, or bare name for cluster-scoped objects (e.g. Node)."""
    ns = namespace_of(obj)
    return f"{ns}/{name_of(obj)}" if ns else name_of(obj)


def owner_references_of(obj: Mapping) -> list:
    return obj.get("metadata", {}).get("ownerReferences") or []


def controller_ref_of(obj: Mapping) -> dict | None:
    """The single controller=true ownerReference, if any
    (metav1.GetControllerOf)."""
    for ref in owner_references_of(obj):
        if ref.get("controller"):
            return ref
    return None


def new_controller_ref(owner: Mapping, kind: str | None = None) -> dict:
    """metav1.NewControllerRef equivalent."""
    return {
        "apiVersion": owner.get("apiVersion", "v1"),
        "kind": kind or owner.get("kind", ""),
        "name": name_of(owner),
        "uid": uid_of(owner),
        "controller": True,
        "blockOwnerDeletion": True,
    }


def now_iso() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


def set_creation_timestamp(obj: dict) -> None:
    obj.setdefault("metadata", {}).setdefault("creationTimestamp", now_iso())


def deep_copy(obj: Any) -> Any:
    """Structure-aware deep copy for wire objects (dicts/lists/scalars only).

    Much faster than copy.deepcopy for this shape; the store hands copies out so
    callers can't mutate cached state (the reference relies on Go value
    semantics + informer "never mutate cache objects" convention instead).
    """
    if isinstance(obj, dict):
        return {k: deep_copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [deep_copy(v) for v in obj]
    return obj


#: kind → store resource, the one shared mapping (CLI apply/delete, the
#: garbage collector's owner lookup, and the API server all key off it).
KIND_TO_RESOURCE = {
    "Pod": "pods", "Node": "nodes", "Namespace": "namespaces",
    "Deployment": "deployments", "ReplicaSet": "replicasets",
    "StatefulSet": "statefulsets", "DaemonSet": "daemonsets",
    "Job": "jobs", "PodGroup": "podgroups",
    "PersistentVolume": "persistentvolumes",
    "PersistentVolumeClaim": "persistentvolumeclaims",
    "StorageClass": "storageclasses",
    "NodeResourceTopology": "noderesourcetopologies",
    "Service": "services", "Event": "events", "Lease": "leases",
    "EndpointSlice": "endpointslices",
    "ResourceQuota": "resourcequotas",
    "PodDisruptionBudget": "poddisruptionbudgets",
    "HorizontalPodAutoscaler": "horizontalpodautoscalers",
    # DRA (resource.k8s.io structured parameters — SURVEY §2.3
    # dynamicresources/, §2.5 devicemanager): the modern device path.
    "ResourceClaim": "resourceclaims",
    "ResourceClaimTemplate": "resourceclaimtemplates",
    "DeviceClass": "deviceclasses",
    "ResourceSlice": "resourceslices",
    "CronJob": "cronjobs",
    "ServiceAccount": "serviceaccounts",
    "Secret": "secrets",
    "VolumeAttachment": "volumeattachments",
    "ConfigMap": "configmaps",
    # admissionregistration.k8s.io expression policies (policy/vap.py).
    "ValidatingAdmissionPolicy": "validatingadmissionpolicies",
    "ValidatingAdmissionPolicyBinding": "validatingadmissionpolicybindings",
}

#: resources without a namespace segment in their keys/URLs.
CLUSTER_SCOPED_RESOURCES = {
    "nodes", "namespaces", "persistentvolumes", "storageclasses",
    "noderesourcetopologies", "deviceclasses", "resourceslices",
    "volumeattachments", "validatingadmissionpolicies",
    "validatingadmissionpolicybindings",
}
