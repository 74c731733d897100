"""TopologySlice: contiguous sub-mesh placement for slice-shaped gangs.

The topology half of shaped gang scheduling (the Coscheduling Permit
barrier is the other half): a PodGroup whose spec carries `sliceShape`
(e.g. [2, 4]) asks for its members to land on a CONTIGUOUS 2x4
sub-mesh of the interconnect (any rotation/reflection, torus
wraparound included), not just any `minMember` nodes.

How the pieces compose (all riding existing machinery, no new solver
entry):

- The first member of a group to reach PreFilter triggers the PLAN:
  the free-cell mask (nodes whose capacity fits the member request,
  minus nodes claimed by other in-flight plans) goes through the
  device scan (topology/device.py), the winning placement's cells
  map back to node names, and each member pod is pinned to one planned
  node in arrival order.
- Filter then admits exactly the pinned node — on the batched TPU
  path that is an nnz==1 host row, which ops/backend's interning
  routes into the solver's sparse EXCEPTION COLUMNS (`pod_pin`, the
  r14 DRA pin path): the member→coordinate assignment is enforced
  INSIDE the fused solve, conflicts come back infeasible, and
  topology-free pods never see the plugin (`active_for` gate — the
  flat-capacity call graph is untouched).
- Reserve/Unreserve keep the plan ledger honest: any member failing
  downstream drops the whole plan (Coscheduling rejects the siblings,
  all-or-nothing), releasing the claimed nodes for the next attempt.
- `scheduler_slice_fragmentation_pct` is set from each plan's coverage
  scan: the free cells NO feasible placement of the requested shape
  covers — the mesh analog of the flat fragmentation headline.

Everything is inert unless KTPU_TOPOLOGY is on AND the pod belongs to
a group with a sliceShape.

Copy of `kubernetes_tpu/scheduler/plugins/topologyslice.py`. The plan's
scan (`topology/device.device_scan`) and its sharded winner (`best_key`)
run as PyTorch ops on `device`: the scheduler sets it to its backend's
device, and with none it is cuda:0 (pass device="cpu" to run on the CPU).
A failure of the scan propagates; the host oracle answers only where the
scan declines by contract (no orientation fits, or the int32 key would
overflow), as in the reference. `paths` counts which route made each
plan (the reference keeps no such count).
"""

from __future__ import annotations

import logging

import numpy as np

from kubernetes_tpu_torch.scheduler.framework import CycleState, Plugin, Status
from kubernetes_tpu_torch.scheduler.plugins.coscheduling import POD_GROUP_LABEL
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot
from kubernetes_tpu_torch.topology import device as topo_device
from kubernetes_tpu_torch.topology.mesh import (
    MeshSpec,
    node_cell,
    normalize_shape,
    parse_mesh_shape,
)
from kubernetes_tpu_torch.topology.slices import (
    best_placement,
    coverage,
    oracle_scan,
    placement_members,
)
from kubernetes_tpu_torch.utils import flags

logger = logging.getLogger(__name__)

_STATE_KEY = "TopologySlice/node"


def group_slice_shape(pg: dict | None) -> tuple[int, int, int] | None:
    """The group's padded sliceShape, or None for count-only gangs."""
    if pg is None:
        return None
    raw = (pg.get("spec") or {}).get("sliceShape")
    if not raw:
        return None
    try:
        return normalize_shape(raw)
    except (ValueError, TypeError):
        logger.warning("PodGroup %s: bad sliceShape %r ignored",
                       (pg.get("metadata") or {}).get("name"), raw)
        return None


class _Plan:
    """One gang's committed placement: planned node names (placement
    member order) and the pod→node pins handed out so far."""

    __slots__ = ("nodes", "assigned", "bound", "frag")

    def __init__(self, nodes: list[str], frag: int):
        self.nodes = nodes
        self.assigned: dict[str, str] = {}   # pod key -> node name
        self.bound = 0
        self.frag = frag

    def pin_for(self, pod_key: str) -> str | None:
        node = self.assigned.get(pod_key)
        if node is None:
            taken = set(self.assigned.values())
            for n in self.nodes:
                if n not in taken:
                    node = n
                    break
            if node is None:
                return None  # more members than cells: mis-sized gang
            self.assigned[pod_key] = node
        return node


class TopologySlice(Plugin):
    NAME = "TopologySlice"
    EXTENSION_POINTS = ("PreFilter", "Filter", "Reserve", "PostBind")
    #: node churn and slice-gang membership churn both re-open plans.
    EVENTS = ["Node/Add", "Node/Update", "Pod/Delete"]

    def __init__(self, args=None, device=None):
        super().__init__(args)
        #: where the plan's scan runs; None = cuda:0 (the scheduler sets
        #: its backend's device).
        self.device = device
        #: plans made per route: "device" (the scan) or "oracle" (the
        #: scan's size contract declined).
        self.paths = {"device": 0, "oracle": 0}
        #: cross-shard reduction width for the winner selection (the
        #: sharded-argmax parity contract; 1 = plain host max).
        self.shards = int(self.args.get("shards", 1))
        self.scheduler = None
        self.pg_informer = None
        self.pod_informer = None
        #: group key -> live plan (in-flight or partially bound).
        self._plans: dict[str, _Plan] = {}
        #: node name -> group key holding it (two planning gangs must
        #: never pick the same node before capacity reflects either).
        self._claims: dict[str, str] = {}

    def set_scheduler(self, scheduler) -> None:
        self.scheduler = scheduler

    def set_informers(self, factory) -> None:
        from kubernetes_tpu_torch.client import ResourceEventHandler

        self.pg_informer = factory.informer("podgroups")
        self.pod_informer = factory.informer("pods")

        def on_pod_delete(obj):
            # A planned member vanishing (gang torn down mid-flight)
            # must free the claimed nodes, or the cells leak forever.
            name = (obj.get("metadata", {}).get("labels") or {}) \
                .get(POD_GROUP_LABEL)
            if not name:
                return
            ns = obj["metadata"].get("namespace", "default")
            gk = f"{ns}/{name}"
            plan = self._plans.get(gk)
            if plan is not None \
                    and f"{ns}/{obj['metadata']['name']}" in plan.assigned:
                self._drop_plan(gk)

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_delete=on_pod_delete))

    # -- activity gate (the backend's _FILTER_ACTIVE contract) -------------

    def _group_shape(self, pod: PodInfo):
        name = pod.labels.get(POD_GROUP_LABEL)
        if not name or self.pg_informer is None:
            return None, None
        gk = f"{pod.namespace}/{name}"
        return gk, group_slice_shape(self.pg_informer.indexer.get(gk))

    def active_for(self, pi: PodInfo) -> bool:
        """Only slice-shaped gang members under KTPU_TOPOLOGY pay; every
        other pod keeps the exact flat-capacity call graph."""
        if not flags.get("KTPU_TOPOLOGY"):
            return False
        return self._group_shape(pi)[1] is not None

    # -- planning ----------------------------------------------------------

    def _node_fits(self, ni: NodeInfo, pi: PodInfo) -> bool:
        if ni.unschedulable:
            return False
        for r, v in pi.requests.items():
            if v and ni.requested.get(r) + v > ni.allocatable.get(r):
                return False
        return ni.requested.pods + 1 <= ni.allocatable.pods

    def _drop_plan(self, gk: str) -> None:
        if self._plans.pop(gk, None) is not None:
            self._claims = {n: g for n, g in self._claims.items()
                            if g != gk}

    def _make_plan(self, gk: str, shape, pod: PodInfo,
                   snapshot: Snapshot) -> "_Plan | None":
        nodes = snapshot.nodes
        spec: MeshSpec = parse_mesh_shape(
            flags.get("KTPU_MESH_SHAPE"), len(nodes))
        cell_node: dict[int, str] = {}
        free = np.zeros((spec.cells,), dtype=np.bool_)
        for ni in nodes:
            cell = node_cell(ni.name, ni.labels, spec)
            if cell is None or cell in cell_node:
                continue
            cell_node[cell] = ni.name
            other = self._claims.get(ni.name)
            free[cell] = (other is None or other == gk) \
                and self._node_fits(ni, pod)
        scan = topo_device.device_scan(free, spec, shape, self.device)
        if scan is not None:
            self.paths["device"] += 1
            key, _feas, _frag, covered = scan
            pid, frag = topo_device.decode_key(
                topo_device.best_key(key, self.shards, self.device),
                spec, shape)
        else:  # no orientation fits / key overflow: host oracle answers
            self.paths["oracle"] += 1
            feas, fragv = oracle_scan(free, spec, shape)
            covered = coverage(feas, spec, shape)
            pid = best_placement(feas, fragv)
            frag = int(fragv[pid]) if pid >= 0 else 0
        if self.scheduler is not None \
                and getattr(self.scheduler, "metrics", None) is not None:
            self.scheduler.metrics.slice_fragmentation_pct.set(
                topo_device.fragmentation_pct(free, covered))
        if pid < 0:
            return None
        members = [cell_node[c] for c in placement_members(pid, spec, shape)]
        plan = _Plan(members, frag)
        self._plans[gk] = plan
        for n in members:
            self._claims[n] = gk
        logger.info("slice plan %s: shape %s on %s (frag=%d)",
                    gk, tuple(shape), members, frag)
        return plan

    # -- extension points --------------------------------------------------

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not flags.get("KTPU_TOPOLOGY"):
            return Status.skip()
        gk, shape = self._group_shape(pod)
        if shape is None:
            return Status.skip()
        plan = self._plans.get(gk)
        if plan is None:
            plan = self._make_plan(gk, shape, pod, snapshot)
            if plan is None:
                return Status.unschedulable(
                    f"no contiguous {'x'.join(map(str, shape))} "
                    "sub-mesh is free")
        node = plan.pin_for(pod.key)
        if node is None:
            return Status.unschedulable(
                f"gang {gk} has more members than slice cells",
                resolvable=False)
        state.write(_STATE_KEY, node)
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo,
               node: NodeInfo) -> Status:
        planned = state.read(_STATE_KEY)
        if planned is None or node.name == planned:
            return Status.success()
        return Status.unschedulable(
            "node is not the planned slice cell")

    def reserve(self, state: CycleState, pod: PodInfo,
                node_name: str) -> Status:
        if not self.active_for(pod):
            return Status.success()
        gk, _shape = self._group_shape(pod)
        plan = self._plans.get(gk)
        if plan is None:
            return Status.success()  # plan dropped: Permit will reject
        if plan.assigned.get(pod.key) != node_name:
            # The solve landed a member off its planned cell (drifted
            # snapshot): tear the plan down rather than bind a bent slice.
            self._drop_plan(gk)
            return Status.unschedulable(
                f"gang {gk}: {node_name} is not the planned cell")
        return Status.success()

    def unreserve(self, state: CycleState, pod: PodInfo,
                  node_name: str) -> None:
        """Any member failing downstream kills the whole plan —
        all-or-nothing, same shape as Coscheduling's gang rejection."""
        gk, _ = self._group_shape(pod)
        if gk is not None and gk in self._plans:
            self._drop_plan(gk)

    def post_bind(self, state: CycleState, pod: PodInfo,
                  node_name: str) -> None:
        gk, _ = self._group_shape(pod)
        plan = self._plans.get(gk) if gk else None
        if plan is None:
            return
        plan.bound += 1
        if plan.bound >= len(plan.nodes):
            # Fully bound: capacity now charges the nodes, the claim
            # ledger's job is done.
            self._drop_plan(gk)
