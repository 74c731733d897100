"""Coscheduling: PodGroup gang scheduling via the Permit barrier.

Parity target: sigs.k8s.io/scheduler-plugins coscheduling (SURVEY §2.3
"out-of-tree but in-scope"): pods labeled with a PodGroup wait at Permit
until `minMember` siblings have reserved; then the whole gang is released
to bind. A gang that can't assemble before `scheduleTimeoutSeconds` is
rejected wholesale (each waiter times out and requeues — all-or-nothing).

PodGroup objects live in the store as a `podgroups` resource:
    {"metadata": {...}, "spec": {"minMember": N, "scheduleTimeoutSeconds": S}}
Pods join via the `scheduling.x-k8s.io/pod-group` label.

PreEnqueue additionally gates pods of groups that don't yet have minMember
pods created (the plugin's own PreEnqueue behavior) — avoids burning cycles
scheduling a gang that cannot possibly assemble.

The batched path composes naturally: the solver assigns the whole batch
with the gang's all-or-nothing mask (ops/backend.py fills the gang
arrays), then each pod's Permit runs — a complete gang in one batch sails
through the barrier in one cycle.

Slice-shaped gangs (`spec.sliceShape`) must also land on one contiguous
sub-mesh: TopologySlice plans it, and Permit re-checks the assembled
gang's reserved nodes (`_slice_misaligned`) and rejects a bent gang whole.

Copy of `kubernetes_tpu/scheduler/plugins/coscheduling.py`.
"""

from __future__ import annotations

import logging
from collections import defaultdict

from kubernetes_tpu_torch.scheduler.framework import CycleState, Plugin, Status
from kubernetes_tpu_torch.scheduler.types import PodInfo

logger = logging.getLogger(__name__)

POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"
DEFAULT_SCHEDULE_TIMEOUT = 10.0


def _pod_group_index(obj: dict) -> list[str]:
    name = (obj.get("metadata", {}).get("labels") or {}).get(POD_GROUP_LABEL)
    if not name:
        return []
    ns = obj.get("metadata", {}).get("namespace", "default")
    return [f"{ns}/{name}"]


def make_pod_group(name: str, min_member: int, namespace: str = "default",
                   schedule_timeout_seconds: float | None = None,
                   slice_shape: list | tuple | None = None) -> dict:
    from kubernetes_tpu_torch.api.meta import new_object
    spec = {"minMember": min_member}
    if schedule_timeout_seconds is not None:
        spec["scheduleTimeoutSeconds"] = schedule_timeout_seconds
    if slice_shape is not None:
        # Slice-shaped gang (topology/): members must land on one
        # contiguous sub-mesh of this shape (TopologySlice plans it,
        # Permit here enforces it before release).
        spec["sliceShape"] = [int(s) for s in slice_shape]
    return new_object("PodGroup", name, namespace, spec=spec)


class Coscheduling(Plugin):
    NAME = "Coscheduling"
    EXTENSION_POINTS = ("PreEnqueue", "Permit", "PostBind", "Reserve")
    EVENTS = ["Pod/Add", "Pod/Delete"]

    def __init__(self, args=None):
        super().__init__(args)
        #: group key -> pod keys currently parked at Permit
        self._waiting: dict[str, set[str]] = defaultdict(set)
        #: group key -> pod keys bound (left the barrier)
        self._bound: dict[str, set[str]] = defaultdict(set)
        #: group key -> {pod key -> reserved node} — the membership the
        #: sliceShape contiguity check at Permit verifies.
        self._nodes: dict[str, dict[str, str]] = defaultdict(dict)
        self.scheduler = None      # wired by Scheduler (allow/reject handles)
        self.pg_informer = None    # wired via set_informers
        self.pod_informer = None
        self.node_informer = None  # node labels for the coordinate map

    def set_scheduler(self, scheduler) -> None:
        self.scheduler = scheduler

    def set_informers(self, factory) -> None:
        import asyncio

        from kubernetes_tpu_torch.client import ResourceEventHandler

        self.pg_informer = factory.informer("podgroups")
        self.pod_informer = factory.informer("pods")
        self.node_informer = factory.informer("nodes")
        # O(1) sibling counts for pre_enqueue (vs scanning every pod).
        self.pod_informer.indexer.add_indexer("podgroup", _pod_group_index)

        def on_pod_delete(obj):
            # Gang membership must not survive pod deletion: stale _bound
            # entries would let a reused group name bypass the barrier.
            name = (obj.get("metadata", {}).get("labels") or {}) \
                .get(POD_GROUP_LABEL)
            if not name:
                return
            ns = obj["metadata"].get("namespace", "default")
            key = (f"{ns}/{obj['metadata']['name']}")
            self._bound[f"{ns}/{name}"].discard(key)
            self._waiting[f"{ns}/{name}"].discard(key)
            self._nodes[f"{ns}/{name}"].pop(key, None)

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_delete=on_pod_delete))

        def on_pg_change(obj):
            # A PodGroup arriving/changing can lift gates of already-parked
            # pods — surface it to the queue as a cluster event.
            if self.scheduler is not None:
                from kubernetes_tpu_torch.scheduler.queue import ClusterEvent
                asyncio.ensure_future(self.scheduler.queue.move_all(
                    ClusterEvent("PodGroup", "Add")))

        self.pg_informer.add_event_handler(ResourceEventHandler(
            on_add=on_pg_change, on_update=lambda o, n: on_pg_change(n)))

    # -- helpers -----------------------------------------------------------

    @staticmethod
    def group_key(pod: PodInfo) -> str | None:
        name = pod.labels.get(POD_GROUP_LABEL)
        return f"{pod.namespace}/{name}" if name else None

    def _pod_group(self, group_key: str) -> dict | None:
        if self.pg_informer is None:
            return None
        return self.pg_informer.indexer.get(group_key)

    def _group_pod_count(self, group_key: str) -> int:
        if self.pod_informer is None:
            return 0
        return len(self.pod_informer.indexer.by_index("podgroup", group_key))

    # -- extension points --------------------------------------------------

    def pre_enqueue(self, pod: PodInfo) -> Status:
        gk = self.group_key(pod)
        if gk is None:
            return Status.success()
        pg = self._pod_group(gk)
        if pg is None:
            return Status.unschedulable(
                f"PodGroup {gk} not found", resolvable=False)
        min_member = int(pg["spec"].get("minMember", 1))
        if self._group_pod_count(gk) < min_member:
            return Status.unschedulable(
                f"gang {gk}: fewer than minMember={min_member} pods exist")
        return Status.success()

    def _slice_misaligned(self, gk: str, pg: dict) -> str | None:
        """Reason the assembled gang's reserved nodes do NOT form one
        contiguous sub-mesh of the group's sliceShape; None = aligned
        (or not a slice-shaped gang / topology off — count-only gangs
        keep the pre-topology barrier exactly)."""
        from kubernetes_tpu_torch.topology.mesh import (
            node_cell, normalize_shape, parse_mesh_shape)
        from kubernetes_tpu_torch.topology.slices import is_contiguous_slice
        from kubernetes_tpu_torch.utils import flags

        raw = pg["spec"].get("sliceShape")
        if not raw or not flags.get("KTPU_TOPOLOGY"):
            return None
        try:
            shape = normalize_shape(raw)
        except (ValueError, TypeError):
            return None  # malformed shape: count-only semantics
        if self.node_informer is None:
            return "no node informer for the slice contiguity check"
        members = self._nodes.get(gk, {})
        node_names = set(members.values())
        if len(node_names) < len(members):
            return "two slice members reserved the same node"
        all_nodes = self.node_informer.indexer.list()
        spec = parse_mesh_shape(
            flags.get("KTPU_MESH_SHAPE"), len(all_nodes))
        cells = []
        for name in node_names:
            obj = self.node_informer.indexer.get(name)
            labels = (obj or {}).get("metadata", {}).get("labels") or {}
            cell = node_cell(name, labels, spec)
            if cell is None:
                return f"member node {name} is off-mesh"
            cells.append(cell)
        if not is_contiguous_slice(cells, spec, shape):
            return ("reserved nodes do not form a contiguous "
                    f"{'x'.join(str(s) for s in raw)} sub-mesh")
        return None

    def reserve(self, state: CycleState, pod: PodInfo,
                node_name: str) -> Status:
        gk = self.group_key(pod)
        if gk is not None:
            self._nodes[gk][pod.key] = node_name
        return Status.success()

    def permit(self, state: CycleState, pod: PodInfo,
               node_name: str) -> tuple[Status, float]:
        gk = self.group_key(pod)
        if gk is None:
            return Status.success(), 0.0
        pg = self._pod_group(gk)
        if pg is None:
            return Status.unschedulable(f"PodGroup {gk} vanished"), 0.0
        min_member = int(pg["spec"].get("minMember", 1))
        assembled = (len(self._waiting[gk]) + len(self._bound[gk]) + 1)
        if assembled >= min_member:
            misaligned = self._slice_misaligned(gk, pg)
            if misaligned is not None:
                # A complete but BENT gang must not bind: reject the
                # whole membership (all-or-nothing) so the next attempt
                # replans from a fresh TopologySlice placement.
                waiting = self._waiting.pop(gk, set())
                if self.scheduler is not None:
                    for key in waiting:
                        self.scheduler.reject_waiting_pod(key)
                logger.info("gang %s: %s; rejecting %d waiters",
                            gk, misaligned, len(waiting))
                return Status.unschedulable(
                    f"gang {gk}: {misaligned}"), 0.0
            # Gang complete: release every parked sibling.
            waiting = self._waiting.pop(gk, set())
            if self.scheduler is not None:
                for key in waiting:
                    self.scheduler.allow_waiting_pod(key)
            self._bound[gk].update(waiting)
            self._bound[gk].add(pod.key)
            if pg["spec"].get("sliceShape") and self.scheduler is not None \
                    and getattr(self.scheduler, "metrics", None) is not None:
                self.scheduler.metrics.slice_gangs_bound.inc()
            return Status.success(), 0.0
        self._waiting[gk].add(pod.key)
        timeout = float(pg["spec"].get("scheduleTimeoutSeconds",
                                       DEFAULT_SCHEDULE_TIMEOUT))
        return Status.wait(), timeout

    def unreserve(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        """A gang member failed downstream (or timed out at Permit):
        reject the rest of the gang — all-or-nothing."""
        gk = self.group_key(pod)
        if gk is None:
            return
        self._waiting[gk].discard(pod.key)
        self._bound[gk].discard(pod.key)
        self._nodes[gk].pop(pod.key, None)
        waiting = self._waiting.pop(gk, set())
        if waiting and self.scheduler is not None:
            logger.info("gang %s: member %s failed; rejecting %d waiters",
                        gk, pod.key, len(waiting))
            for key in waiting:
                self.scheduler.reject_waiting_pod(key)

    def post_bind(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        gk = self.group_key(pod)
        if gk is not None:
            self._bound[gk].add(pod.key)
