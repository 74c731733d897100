"""Node-predicate plugins: NodeAffinity, NodeName, NodeUnschedulable,
TaintToleration, NodePorts.

Parity targets: pkg/scheduler/framework/plugins/{nodeaffinity,nodename,
nodeunschedulable,tainttoleration,nodeports} — Filter semantics documented
per class. Copy of `kubernetes_tpu/scheduler/plugins/nodeaffinity.py`.
"""

from __future__ import annotations

from kubernetes_tpu_torch.api.labels import Requirement, match_node_selector_terms
from kubernetes_tpu_torch.api.types import (
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    find_untolerated_taint,
    toleration_tolerates_taint,
)
from kubernetes_tpu_torch.scheduler.framework import (
    MAX_NODE_SCORE,
    CycleState,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot


class NodeName(Plugin):
    """Filter: spec.nodeName, when set, must equal the node's name
    (nodename/node_name.go `Fits`)."""

    NAME = "NodeName"
    EXTENSION_POINTS = ("Filter",)

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        if pod.node_name and pod.node_name != node.name:
            return Status.unschedulable(
                "node didn't match the requested node name", resolvable=False)
        return Status.success()


class NodeUnschedulable(Plugin):
    """Filter: node.spec.unschedulable blocks pods unless they tolerate the
    unschedulable taint (nodeunschedulable/node_unschedulable.go)."""

    NAME = "NodeUnschedulable"
    EXTENSION_POINTS = ("Filter",)
    EVENTS = ["Node/Add", "Node/Update"]

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        if not node.unschedulable:
            return Status.success()
        tolerated = any(
            t.get("key") == "node.kubernetes.io/unschedulable"
            or (t.get("operator") == "Exists" and not t.get("key"))
            for t in pod.tolerations
        )
        if tolerated:
            return Status.success()
        return Status.unschedulable("node(s) were unschedulable", resolvable=False)


class NodeAffinity(Plugin):
    """Filter: nodeSelector AND requiredDuringSchedulingIgnoredDuringExecution.
    Score: preferredDuringScheduling weighted terms.
    (nodeaffinity/node_affinity.go `isSchedulableAfterNodeChange`, `Filter`,
    `Score`; addedAffinity from args for profile-level defaults.)"""

    NAME = "NodeAffinity"
    EXTENSION_POINTS = ("PreFilter", "Filter", "Score")
    EVENTS = ["Node/Add", "Node/Update"]

    def pre_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot) -> Status:
        if not pod.node_selector and not (pod.affinity.get("nodeAffinity") or {}):
            return Status.skip()
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        if pod.node_selector:
            for k, v in pod.node_selector.items():
                if node.labels.get(k) != v:
                    return Status.unschedulable(
                        "node(s) didn't match Pod's node affinity/selector",
                        resolvable=False)
        na = pod.affinity.get("nodeAffinity") or {}
        required = na.get("requiredDuringSchedulingIgnoredDuringExecution")
        if required:
            terms = required.get("nodeSelectorTerms") or []
            if not match_node_selector_terms(terms, node.labels, node.name):
                return Status.unschedulable(
                    "node(s) didn't match Pod's node affinity/selector",
                    resolvable=False)
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        na = pod.affinity.get("nodeAffinity") or {}
        preferred = na.get("preferredDuringSchedulingIgnoredDuringExecution") or []
        if not preferred:
            return 0.0
        total = 0
        got = 0
        for term in preferred:
            w = term.get("weight", 1)
            total += w
            sel = term.get("preference") or {}
            ok = True
            for expr in sel.get("matchExpressions") or []:
                r = Requirement(expr["key"], expr["operator"], expr.get("values") or [])
                if not r.matches(node.labels):
                    ok = False
                    break
            if ok:
                got += w
        return MAX_NODE_SCORE * got / total if total else 0.0


class TaintToleration(Plugin):
    """Filter: NoSchedule/NoExecute taints must be tolerated.
    Score: fewer untolerated PreferNoSchedule taints → higher
    (tainttoleration/taint_toleration.go: normalized (1 - count/max))."""

    NAME = "TaintToleration"
    EXTENSION_POINTS = ("Filter", "PreScore", "Score")
    EVENTS = ["Node/Add", "Node/Update"]

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        taint = find_untolerated_taint(
            node.taints, pod.tolerations, (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE))
        if taint is not None:
            return Status.unschedulable(
                f"node(s) had untolerated taint {{{taint.get('key')}: "
                f"{taint.get('value', '')}}}", resolvable=False)
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        # Raw score = count of untolerated PreferNoSchedule taints (lower is
        # better); normalize flips it.
        count = 0
        for taint in node.taints:
            if taint.get("effect") != TAINT_PREFER_NO_SCHEDULE:
                continue
            if not any(toleration_tolerates_taint(t, taint) for t in pod.tolerations):
                count += 1
        return float(count)

    def normalize_scores(self, state: CycleState, pod: PodInfo,
                         scores: dict[str, float]) -> None:
        if not scores:
            return
        mx = max(scores.values())
        for k, v in scores.items():
            scores[k] = MAX_NODE_SCORE * (mx - v) / mx if mx > 0 else float(MAX_NODE_SCORE)


class NodePorts(Plugin):
    """Filter: requested hostPorts must be free on the node
    (nodeports/node_ports.go `Fits`: conflict on (ip, protocol, port) with
    0.0.0.0 overlapping any ip)."""

    NAME = "NodePorts"
    EXTENSION_POINTS = ("PreFilter", "Filter")
    EVENTS = ["Pod/Delete"]

    def pre_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot) -> Status:
        if not pod.host_ports:
            return Status.skip()
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        for (ip, proto, port) in pod.host_ports:
            for (uip, uproto, uport) in node.used_ports:
                if port != uport or proto != uproto:
                    continue
                if ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip:
                    return Status.unschedulable(
                        "node(s) didn't have free ports for the requested pod ports")
        return Status.success()
