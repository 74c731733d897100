"""NodeResourceTopologyMatch: NUMA-aware filtering + scoring for pods
requesting device/extended resources (BASELINE config #4).

Parity target: kubernetes-sigs/scheduler-plugins `pkg/noderesourcetopology`
(out-of-tree, like Coscheduling) over the NodeResourceTopology CRD
(`topology.node.k8s.io/v1alpha2`), which mirrors the kubelet's
topologymanager + devicemanager NUMA accounting (SURVEY §2.5 `cm/`).

Object shape (one per node, name == node name):

    apiVersion: topology.node.k8s.io/v1alpha2
    kind: NodeResourceTopology
    metadata: {name: node-0}
    topologyPolicies: [SingleNUMANodeContainerLevel]
    zones:
    - name: node-0            # NUMA node 0
      type: Node
      resources:
      - {name: google.com/tpu, capacity: "4"}
      - {name: cpu, capacity: "4"}

Divergence from the reference plugin, by design: the reference trusts the
CRD's per-zone `available` column, refreshed by a node agent (RTE). This
framework's nodes are KWOK-simulated — there is no agent — so zone usage is
recomputed scheduler-side by deterministically packing the node's resident
pods (sorted by pod key, first-fit in zone order) into zones. That keeps
Filter/Score exact under the batched backend too: the backend's working
snapshot already carries same-batch placements, so the zone accounting sees
them (ops/backend.py `_verify`, the full re-check of stateful pods).

Filter (single-NUMA policies): some zone must fit ALL of the pod's
zone-tracked requests — resources no zone lists are unconstrained.
Score: LeastAllocated over the best-fitting zone (scoringStrategy arg
accepts LeastAllocated | MostAllocated | BalancedAllocation).

Copy of `kubernetes_tpu/scheduler/plugins/noderesourcetopology.py`.
"""

from __future__ import annotations

import statistics

from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.scheduler.framework import CycleState, Plugin, Status
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

#: Policies that require single-NUMA alignment (the CRD's values).
SINGLE_NUMA_POLICIES = {
    "SingleNUMANodeContainerLevel",
    "SingleNUMANodePodLevel",
    "single-numa-node",
}

_STATE_KEY = "NodeResourceTopologyMatch/requests"


def _zone_caps(nrt: dict) -> list[tuple[str, dict[str, int]]]:
    """[(zone name, {resource: capacity milli})] in declared order."""
    out = []
    for z in nrt.get("zones") or []:
        caps = {}
        for r in z.get("resources") or []:
            name = r.get("name")
            if name:
                caps[name] = parse_quantity(
                    r.get("allocatable", r.get("capacity", 0)))
        out.append((z.get("name", ""), caps))
    return out


def pack_zones(nrt: dict, node: NodeInfo) -> list[dict[str, int]]:
    """Free capacity per zone after first-fit packing the node's resident
    pods (sorted by key for determinism across host/backend paths)."""
    zones = _zone_caps(nrt)
    free = [dict(caps) for _, caps in zones]
    if not free:
        return free
    tracked = set()
    for caps in free:
        tracked.update(caps)
    for pi in sorted(node.pods, key=lambda p: p.key):
        reqs = {r: v for r, v in pi.requests.items()
                if v > 0 and r in tracked}
        if not reqs:
            continue
        for zf in free:
            if all(zf.get(r, 0) >= v for r, v in reqs.items()):
                for r, v in reqs.items():
                    zf[r] -= v
                break
        # No zone fits → the pod predates topology constraints (or another
        # policy placed it); its usage is already counted node-level by
        # NodeResourcesFit, so it is not charged to any single zone here.
    return free


class NodeResourceTopologyMatch(Plugin):
    NAME = "NodeResourceTopologyMatch"
    EXTENSION_POINTS = ("PreFilter", "Filter", "Score")
    # NRT churn (agent raises a zone's capacity) must requeue pods parked
    # on "cannot align" — EventsToRegister parity with scheduler-plugins.
    EVENTS = ["Pod/Delete", "Node/Add", "Node/Update",
              "NodeResourceTopology/Add", "NodeResourceTopology/Update"]

    def __init__(self, args=None):
        super().__init__(args)
        self.strategy = (self.args.get("scoringStrategy") or {}).get(
            "type", "LeastAllocated")
        self._nrt_informer = None
        #: resources appearing in any zone of any NRT object — the cheap
        #: activity gate the batched backend consults per pod.
        self._zone_resources: set[str] = set()
        #: bumped on every NRT add/update — cache-invalidation handle for
        #: the batched backend's zone tensors (NRT writes don't move the
        #: node snapshot generation).
        self.nrt_seq = 0

    def set_informers(self, factory) -> None:
        self._nrt_informer = factory.informer("noderesourcetopologies")

        def track(obj):
            self.nrt_seq += 1
            for z in obj.get("zones") or []:
                for r in z.get("resources") or []:
                    if r.get("name"):
                        self._zone_resources.add(r["name"])

        from kubernetes_tpu_torch.client import ResourceEventHandler
        self._nrt_informer.add_event_handler(ResourceEventHandler(
            on_add=track, on_update=lambda old, new: track(new)))

    def active_for(self, pi: PodInfo) -> bool:
        if self._nrt_informer is None:
            return False
        return any(v > 0 and r in self._zone_resources
                   for r, v in pi.requests.items())

    def _nrt(self, node_name: str) -> dict | None:
        if self._nrt_informer is None:
            return None
        return self._nrt_informer.indexer.get(node_name)

    # -- PreFilter ---------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not self.active_for(pod):
            return Status.skip()
        state.write(_STATE_KEY, dict(pod.requests))
        return Status.success()

    # -- Filter: single-NUMA alignment ------------------------------------

    def _fit_zones(self, pod: PodInfo, node: NodeInfo
                   ) -> tuple[list[dict[str, int]], list[int]] | None:
        """(zone free list, indexes of zones that fit the pod), or None
        when the node is unconstrained (no NRT / non-single-NUMA policy)."""
        nrt = self._nrt(node.name)
        if nrt is None:
            return None
        policies = set(nrt.get("topologyPolicies") or [])
        if not policies & SINGLE_NUMA_POLICIES:
            return None
        free = pack_zones(nrt, node)
        tracked = set()
        for zf in free:
            tracked.update(zf)
        reqs = {r: v for r, v in pod.requests.items()
                if v > 0 and r in tracked}
        if not reqs:
            return None
        fits = [i for i, zf in enumerate(free)
                if all(zf.get(r, 0) >= v for r, v in reqs.items())]
        return free, fits

    def filter(self, state: CycleState, pod: PodInfo,
               node: NodeInfo) -> Status:
        res = self._fit_zones(pod, node)
        if res is None:
            return Status.success()
        _, fits = res
        if not fits:
            return Status.unschedulable(
                "node(s) cannot align the pod in a single NUMA zone")
        return Status.success()

    # -- Score: zone-level resource strategy -------------------------------

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        res = self._fit_zones(pod, node)
        if res is None:
            return 0.0
        free, fits = res
        if not fits:
            return 0.0
        nrt = self._nrt(node.name)
        caps = _zone_caps(nrt)
        best = 0.0
        for i in fits:
            fracs = []
            for r, v in pod.requests.items():
                cap = caps[i][1].get(r, 0)
                if v > 0 and cap > 0:
                    fracs.append((free[i].get(r, 0) - v) / cap)
            if not fracs:
                continue
            if self.strategy == "MostAllocated":
                s = 100.0 * (1.0 - sum(fracs) / len(fracs))
            elif self.strategy == "BalancedAllocation":
                sd = statistics.pstdev(fracs) if len(fracs) > 1 else 0.0
                s = 100.0 * (1.0 - sd)
            else:  # LeastAllocated
                s = 100.0 * sum(fracs) / len(fracs)
            best = max(best, s)
        return best
