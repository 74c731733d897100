"""Object validation — the admission-time subset that scheduling correctness
depends on.

Parity target: pkg/apis/core/validation/validation.go (`ValidatePod`,
`ValidatePodSpec`, `ValidateNode`) — trimmed to the invariants the rest of this
framework relies on (full field-by-field validation is cosmetic for a
scheduler-centric control plane; extend as controllers grow).

Copy of `kubernetes_tpu/store/validation.py`.
"""

from __future__ import annotations

import re

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.store.mvcc import Invalid

_DNS1123 = re.compile(r"^[a-z0-9]([-a-z0-9]*[a-z0-9])?$")


def _validate_meta(obj: dict, kind: str, namespaced: bool) -> None:
    meta = obj.get("metadata") or {}
    name = meta.get("name", "")
    if not name or len(name) > 253 or not _DNS1123.match(name.replace(".", "-")):
        raise Invalid(f"{kind}: invalid metadata.name {name!r}")
    if namespaced and not meta.get("namespace"):
        raise Invalid(f"{kind}: metadata.namespace is required")


def validate_pod(pod: dict) -> None:
    _validate_meta(pod, "Pod", namespaced=True)
    spec = pod.get("spec") or {}
    containers = spec.get("containers") or []
    if not containers:
        raise Invalid("Pod: spec.containers must be non-empty")
    names = set()
    for c in containers:
        cname = c.get("name", "")
        if not cname:
            raise Invalid("Pod: container name is required")
        if cname in names:
            raise Invalid(f"Pod: duplicate container name {cname!r}")
        names.add(cname)
        res = c.get("resources") or {}
        req = res.get("requests") or {}
        lim = res.get("limits") or {}
        for rl in (req, lim):
            for rname, v in rl.items():
                try:
                    q = parse_quantity(v)
                except ValueError as e:
                    raise Invalid(f"Pod: bad quantity for {rname}: {e}") from e
                if q < 0:
                    raise Invalid(f"Pod: negative quantity for {rname}")
        for rname, v in req.items():
            if rname in lim and parse_quantity(v) > parse_quantity(lim[rname]):
                raise Invalid(f"Pod: request for {rname} exceeds limit")
    for gate in spec.get("schedulingGates") or []:
        if not gate.get("name"):
            raise Invalid("Pod: schedulingGates[].name is required")
    prio = spec.get("priority")
    if prio is not None and not isinstance(prio, int):
        raise Invalid("Pod: spec.priority must be an integer")


def validate_node(node: dict) -> None:
    _validate_meta(node, "Node", namespaced=False)
    for taint in node.get("spec", {}).get("taints") or []:
        if not taint.get("key"):
            raise Invalid("Node: taint key is required")
        if taint.get("effect") not in ("NoSchedule", "PreferNoSchedule", "NoExecute"):
            raise Invalid(f"Node: invalid taint effect {taint.get('effect')!r}")
    for rname, v in node.get("status", {}).get("allocatable", {}).items():
        try:
            parse_quantity(v)
        except ValueError as e:
            raise Invalid(f"Node: bad allocatable {rname}: {e}") from e


def default_pod(pod: dict) -> None:
    """Defaulting (pkg/apis/core/v1/defaults.go subset): schedulerName,
    restartPolicy, phase, toleration defaults for not-ready/unreachable are
    added by admission in the reference (defaulttolerationseconds plugin)."""
    spec = pod.setdefault("spec", {})
    spec.setdefault("schedulerName", "default-scheduler")
    spec.setdefault("restartPolicy", "Always")
    pod.setdefault("status", {}).setdefault("phase", "Pending")
    tolerations = spec.setdefault("tolerations", [])
    have = {t.get("key") for t in tolerations}
    for key in ("node.kubernetes.io/not-ready", "node.kubernetes.io/unreachable"):
        if key not in have:
            tolerations.append({
                "key": key, "operator": "Exists", "effect": "NoExecute",
                "tolerationSeconds": 300,
            })


DEFAULT_CLASS_ANN = "storageclass.kubernetes.io/is-default-class"


def validate_admission_policy(policy: dict) -> None:
    """ValidatingAdmissionPolicy: every expression must COMPILE inside
    the sandbox grammar at write time (the reference typechecks CEL at
    admission of the policy object, not at first use)."""
    _validate_meta(policy, "ValidatingAdmissionPolicy", namespaced=False)
    spec = policy.get("spec") or {}
    if spec.get("failurePolicy") not in (None, "Fail", "Ignore"):
        raise Invalid("ValidatingAdmissionPolicy: failurePolicy must be "
                      "Fail or Ignore")
    validations = spec.get("validations")
    if not validations:
        raise Invalid("ValidatingAdmissionPolicy: spec.validations must "
                      "be non-empty")
    from kubernetes_tpu_torch.policy.expr import (
        ExpressionError,
        compile_expression,
    )

    def check(source: str, where: str) -> None:
        try:
            compile_expression(source)
        except ExpressionError as e:
            raise Invalid(
                f"ValidatingAdmissionPolicy: {where}: {e}") from e

    for i, v in enumerate(validations):
        check(v.get("expression", ""), f"spec.validations[{i}]")
        if v.get("messageExpression"):
            check(v["messageExpression"],
                  f"spec.validations[{i}].messageExpression")
    for i, c in enumerate(spec.get("matchConditions") or []):
        if not c.get("name"):
            raise Invalid(f"ValidatingAdmissionPolicy: "
                          f"spec.matchConditions[{i}].name is required")
        check(c.get("expression", ""), f"spec.matchConditions[{i}]")
    for i, var in enumerate(spec.get("variables") or []):
        if not var.get("name"):
            raise Invalid(f"ValidatingAdmissionPolicy: "
                          f"spec.variables[{i}].name is required")
        check(var.get("expression", ""), f"spec.variables[{i}]")
    for i, a in enumerate(spec.get("auditAnnotations") or []):
        if not a.get("key"):
            raise Invalid(f"ValidatingAdmissionPolicy: "
                          f"spec.auditAnnotations[{i}].key is required")
        check(a.get("valueExpression", ""),
              f"spec.auditAnnotations[{i}].valueExpression")


def validate_vap_binding(binding: dict) -> None:
    _validate_meta(binding, "ValidatingAdmissionPolicyBinding",
                   namespaced=False)
    if not (binding.get("spec") or {}).get("policyName"):
        raise Invalid("ValidatingAdmissionPolicyBinding: spec.policyName "
                      "is required")


def install_core_validation(store) -> None:
    store.register_mutator("pods", default_pod)
    store.register_validator("pods", validate_pod)
    store.register_validator("nodes", validate_node)
    store.register_validator("validatingadmissionpolicies",
                             validate_admission_policy)
    store.register_validator("validatingadmissionpolicybindings",
                             validate_vap_binding)

    def default_storage_class(pvc: dict) -> None:
        """DefaultStorageClass admission (plugin/pkg/admission/storage/
        storageclass/setdefault): PVCs with a nil class get the cluster's
        default StorageClass at create time. An explicit "" means "no
        class" and disables defaulting; ties between multiple defaults go
        to the newest by creationTimestamp."""
        spec = pvc.setdefault("spec", {})
        if spec.get("storageClassName") is not None:
            return
        defaults = [
            sc for sc in store._table("storageclasses").values()
            if (sc.get("metadata", {}).get("annotations") or {})
            .get(DEFAULT_CLASS_ANN) == "true"
        ]
        if not defaults:
            return
        # Newest creationTimestamp wins; ties break on smallest name
        # (the reference sorts newest-first, then Name ascending).
        latest = max(sc["metadata"].get("creationTimestamp") or ""
                     for sc in defaults)
        newest = min(
            (sc for sc in defaults
             if (sc["metadata"].get("creationTimestamp") or "") == latest),
            key=lambda sc: sc["metadata"]["name"])
        spec["storageClassName"] = newest["metadata"]["name"]

    store.register_mutator("persistentvolumeclaims", default_storage_class,
                           on=("create",))
