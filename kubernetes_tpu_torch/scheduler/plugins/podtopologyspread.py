"""PodTopologySpread: maxSkew constraints over topology domains.

Parity target: pkg/scheduler/framework/plugins/podtopologyspread/
{plugin.go,filtering.go,scoring.go}:

- Filter (whenUnsatisfiable=DoNotSchedule): placing the pod on a node must
  keep `count(domain_of(node)) + selfMatch - min(count over eligible
  domains) <= maxSkew` for every constraint (selfMatch = 1 iff the
  constraint's selector + namespace set match the pod itself).
- minDomains: when fewer eligible domains exist than minDomains, the
  global minimum is treated as 0 (k8s MinDomainsInPodTopologySpread).
- namespaceSelector (extension beyond the reference's spread API): a
  constraint may widen counting beyond the pod's own namespace, resolved
  exactly like an affinity term's namespaceSelector
  (interpodaffinity.resolve_term_namespaces; {} = every namespace).
- Score (whenUnsatisfiable=ScheduleAnyway): lower resulting skew → higher.
- Default constraints (SystemDefaulting): maxSkew=3 on hostname /
  maxSkew=5 on zone, ScheduleAnyway — applied when the pod has none.

Domains: nodes missing the topologyKey are ignored entirely (not eligible).
nodeAffinityPolicy/nodeTaintsPolicy default to Honor: domains are counted
only over nodes the pod could run on per nodeSelector/affinity and taints.

Copy of `kubernetes_tpu/scheduler/plugins/podtopologyspread.py`. The
batched backend runs hard constraints in the spread scan
(ops/solver.greedy_assign_rescoring_spread) and soft ones as dense score
rows (ops/affinity.py); this plugin answers one-pod host dispatches.
"""

from __future__ import annotations

from collections import defaultdict

from kubernetes_tpu_torch.api.labels import (
    from_label_selector,
    match_node_selector_terms,
    ns_contains,
)
from kubernetes_tpu_torch.api.types import (
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    find_untolerated_taint,
)
from kubernetes_tpu_torch.scheduler.framework import (
    MAX_NODE_SCORE,
    CycleState,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

_STATE_KEY = "PreFilterPodTopologySpread"

HOSTNAME = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"

DEFAULT_CONSTRAINTS = [
    {"maxSkew": 3, "topologyKey": HOSTNAME, "whenUnsatisfiable": "ScheduleAnyway"},
    {"maxSkew": 5, "topologyKey": ZONE, "whenUnsatisfiable": "ScheduleAnyway"},
]


def _node_eligible(pod: PodInfo, node: NodeInfo) -> bool:
    """Honor nodeAffinity + taints when counting domains (filtering.go
    `pl.filterNodesWithTaintsAndAffinity` equivalent)."""
    if not node.node:
        return False
    for k, v in pod.node_selector.items():
        if node.labels.get(k) != v:
            return False
    na = pod.affinity.get("nodeAffinity") or {}
    required = na.get("requiredDuringSchedulingIgnoredDuringExecution")
    if required:
        if not match_node_selector_terms(
                required.get("nodeSelectorTerms") or [], node.labels, node.name):
            return False
    if find_untolerated_taint(node.taints, pod.tolerations,
                              (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE)) is not None:
        return False
    return True


class _SpreadState:
    __slots__ = ("constraints", "counts", "mins", "self_match")

    def __init__(self):
        self.constraints: list[dict] = []
        # per-constraint-index: {topologyValue: matching pod count}
        self.counts: list[dict[str, int]] = []
        self.mins: list[int] = []
        # per-constraint-index: 1 if the constraint's selector matches the
        # incoming pod's own labels (filtering.go selfMatchNum), else 0
        self.self_match: list[int] = []


class PodTopologySpread(Plugin):
    NAME = "PodTopologySpread"
    EXTENSION_POINTS = ("PreFilter", "Filter", "PreScore", "Score")
    EVENTS = ["Pod/Add", "Pod/Delete", "Node/Add", "Node/Update"]

    def __init__(self, args=None):
        super().__init__(args)
        self.default_constraints = self.args.get("defaultConstraints")
        if self.default_constraints is None and self.args.get(
                "defaultingType", "System") == "System":
            self.default_constraints = DEFAULT_CONSTRAINTS
        # namespaceSelector constraints resolve like affinity terms
        # (shared NamespaceResolver; informer-less it still gives the
        # static {}-is-everything semantics).
        from kubernetes_tpu_torch.scheduler.plugins.interpodaffinity import (
            NamespaceResolver,
        )
        self.ns_resolver = NamespaceResolver()

    def set_informers(self, factory) -> None:
        self.ns_resolver.wire(factory)

    def constraint_namespaces(self, c: dict, pod_ns: str) -> tuple:
        """A constraint's effective namespace set (ALL_NAMESPACES-aware);
        plain constraints count within the pod's own namespace."""
        from kubernetes_tpu_torch.scheduler.plugins.interpodaffinity import (
            resolve_term_namespaces,
        )
        return resolve_term_namespaces(c, pod_ns, self.ns_resolver)

    def _constraints_for(self, pod: PodInfo, action: str) -> list[dict]:
        cons = pod.topology_spread_constraints
        if not cons and self.default_constraints:
            # Default constraints adopt the pod's own labels as selector (the
            # reference builds the selector from the pod's owning service/RS;
            # we use pod labels — same effect for replicated workloads).
            cons = [
                {**c, "labelSelector": {"matchLabels": pod.labels}}
                for c in self.default_constraints
            ] if pod.labels else []
        return [c for c in cons if c.get("whenUnsatisfiable", "DoNotSchedule") == action]

    def _build_state(self, pod: PodInfo, nodes, action: str) -> _SpreadState:
        s = _SpreadState()
        s.constraints = self._constraints_for(pod, action)
        for c in s.constraints:
            tk = c["topologyKey"]
            sel = from_label_selector(c.get("labelSelector"))
            nses = self.constraint_namespaces(c, pod.namespace)
            counts: dict[str, int] = defaultdict(int)
            for node in nodes:
                tv = node.labels.get(tk)
                if tv is None or not _node_eligible(pod, node):
                    continue
                counts.setdefault(tv, 0)
                for existing in node.pods:
                    if ns_contains(nses, existing.namespace) \
                            and sel.matches(existing.labels):
                        counts[tv] += 1
            s.counts.append(dict(counts))
            # minDomains (DoNotSchedule only in the API; harmless on the
            # score path, which never reads mins): fewer eligible domains
            # than minDomains → global minimum is 0.
            md = int(c.get("minDomains") or 0)
            if md and len(counts) < md:
                s.mins.append(0)
            else:
                s.mins.append(min(counts.values()) if counts else 0)
            s.self_match.append(
                1 if ns_contains(nses, pod.namespace)
                and sel.matches(pod.labels) else 0)
        return s

    # -- Filter path -------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot) -> Status:
        s = self._build_state(pod, snapshot, "DoNotSchedule")
        if not s.constraints:
            return Status.skip()
        state.write(_STATE_KEY, s)
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        s: _SpreadState | None = state.read(_STATE_KEY)
        if s is None:
            return Status.success()
        for i, c in enumerate(s.constraints):
            tk = c["topologyKey"]
            tv = node.labels.get(tk)
            if tv is None:
                return Status.unschedulable(
                    "node(s) didn't have the requested topology key",
                    resolvable=False)
            count = s.counts[i].get(tv)
            if count is None:
                continue  # node domain not eligible — treated as fresh
            if count + s.self_match[i] - s.mins[i] > c.get("maxSkew", 1):
                return Status.unschedulable(
                    "node(s) didn't match pod topology spread constraints")
        return Status.success()

    # -- Score path --------------------------------------------------------

    def pre_score(self, state: CycleState, pod: PodInfo, nodes: list[NodeInfo]) -> Status:
        s = self._build_state(pod, nodes, "ScheduleAnyway")
        if not s.constraints:
            return Status.skip()
        state.write(_STATE_KEY + "/score", s)
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        s: _SpreadState | None = state.read(_STATE_KEY + "/score")
        if s is None:
            return 0.0
        total = 0.0
        for i, c in enumerate(s.constraints):
            tv = node.labels.get(c["topologyKey"])
            if tv is None:
                continue
            total += s.counts[i].get(tv, 0)
        return total  # raw: matching-pod count in this node's domains

    def normalize_scores(self, state: CycleState, pod: PodInfo,
                         scores: dict[str, float]) -> None:
        """Lower count → higher score (scoring.go NormalizeScore)."""
        if not scores:
            return
        mx = max(scores.values())
        mn = min(scores.values())
        spread = mx - mn
        for k, v in scores.items():
            scores[k] = MAX_NODE_SCORE * (mx - v) / spread if spread else float(MAX_NODE_SCORE)
