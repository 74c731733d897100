"""Volume plugin family: VolumeBinding, VolumeZone, NodeVolumeLimits.

Parity target: pkg/scheduler/framework/plugins/volumebinding/ (SURVEY §2.3:
"PVC↔PV topology feasibility; PreBind blocks on actual provisioning"),
volumezone/, nodevolumelimits/. VolumeBinding is the one in-tree plugin
exercising the full Reserve/Unreserve seam and a genuinely blocking
PreBind: at Reserve it stakes the claim→node choice (selected-node
annotation plan), at PreBind it writes the annotation and BLOCKS until the
PV controller has bound/provisioned every claim (WaitForFirstConsumer).

Copy of `kubernetes_tpu/scheduler/plugins/volumebinding.py`; the PV
binder is the port's own (`controllers/pvbinder.py`). One change of cost,
none of result: the reference's Filter scans every PV for an unbound
WaitForFirstConsumer claim at every node; here PreFilter keeps the PVs
that match the claim apart from the node (`_matching_pvs`), and Filter
checks only their node affinity, in the same order. The two agree while
the PV informer holds still between a pod's PreFilter and its Filters.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.controllers.pvbinder import SELECTED_NODE_ANN
from kubernetes_tpu_torch.scheduler.framework import CycleState, Plugin, Status
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot
from kubernetes_tpu_torch.store.mvcc import StoreError

logger = logging.getLogger(__name__)

_STATE_KEY = "VolumeBinding/claims"
ZONE_LABELS = ("topology.kubernetes.io/zone", "topology.kubernetes.io/region")


class _PodVolumeClaims:
    """PreFilter result: the pod's claims, partitioned (PodVolumes in the
    reference)."""

    __slots__ = ("bound", "unbound_wffc", "unbound_immediate", "candidates")

    def __init__(self):
        self.bound: list[dict] = []           # PVC objects with volumeName
        self.unbound_wffc: list[dict] = []    # wait-for-first-consumer
        self.unbound_immediate: list[dict] = []
        #: per unbound WaitForFirstConsumer claim (by position), the PVs
        #: that match it apart from the node, in the informer's order.
        self.candidates: list[list[dict]] = []


class VolumeBinding(Plugin):
    NAME = "VolumeBinding"
    EXTENSION_POINTS = ("PreFilter", "Filter", "Reserve", "PreBind")
    # EventsToRegister parity: PVC/PV/StorageClass changes can make a pod
    # rejected for volume reasons schedulable again.
    EVENTS = ["Pod/Delete", "Node/Add", "Node/Update",
              "PersistentVolumeClaim/Add", "PersistentVolumeClaim/Update",
              "PersistentVolume/Add", "PersistentVolume/Update",
              "StorageClass/Add"]

    def __init__(self, args=None):
        super().__init__(args)
        #: PreBind provisioning wait (volumebinding bindTimeout, 600s
        #: upstream; short here — simulated provisioners are fast).
        self.bind_timeout = float(self.args.get("bindTimeoutSeconds", 30.0))
        self.store = None
        self._pvc_informer = None
        self._pv_informer = None
        self._sc_informer = None

    def set_informers(self, factory) -> None:
        self._pvc_informer = factory.informer("persistentvolumeclaims")
        self._pv_informer = factory.informer("persistentvolumes")
        self._sc_informer = factory.informer("storageclasses")

    def set_scheduler(self, sched) -> None:
        self.store = sched.store

    # -- PreFilter: load + partition the pod's claims ----------------------

    def _get_pvc(self, namespace: str, name: str) -> dict | None:
        if self._pvc_informer is None:
            return None
        return self._pvc_informer.indexer.get(f"{namespace}/{name}")

    def _binding_mode(self, pvc: dict) -> str:
        sc_name = pvc.get("spec", {}).get("storageClassName")
        if sc_name and self._sc_informer is not None:
            sc = self._sc_informer.indexer.get(sc_name)
            if sc is not None:
                return sc.get("volumeBindingMode", "Immediate")
        return "Immediate"

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not pod.pvc_names:
            return Status.skip()
        if self._pvc_informer is None:
            # No informer wiring (pure unit harnesses): nothing to check.
            return Status.skip()
        claims = _PodVolumeClaims()
        for name in pod.pvc_names:
            pvc = self._get_pvc(pod.namespace, name)
            if pvc is None:
                return Status.unschedulable(
                    f'persistentvolumeclaim "{name}" not found',
                    resolvable=False)
            if pvc.get("spec", {}).get("volumeName"):
                claims.bound.append(pvc)
            elif self._binding_mode(pvc) == "WaitForFirstConsumer":
                claims.unbound_wffc.append(pvc)
                claims.candidates.append(self._matching_pvs(pvc))
            else:
                claims.unbound_immediate.append(pvc)
        state.write(_STATE_KEY, claims)
        return Status.success()

    # -- Filter: topology feasibility per node -----------------------------

    def _pv_of(self, pvc: dict) -> dict | None:
        vol = pvc.get("spec", {}).get("volumeName")
        if vol and self._pv_informer is not None:
            return self._pv_informer.indexer.get(vol)
        return None

    def _matching_pvs(self, pvc: dict) -> list[dict]:
        """The PVs that match `pvc` (class, phase, capacity, access modes),
        in the informer's order: the node-independent half of the
        reference's per-node `_find_matching_pv` scan, taken once per
        PreFilter instead of once per node."""
        from kubernetes_tpu_torch.controllers.pvbinder import pv_matches_claim
        if self._pv_informer is None:
            return []
        return [pv for pv in self._pv_informer.indexer.list()
                if pv_matches_claim(pv, pvc)]

    @staticmethod
    def _find_matching_pv(candidates: list[dict],
                          node: NodeInfo) -> dict | None:
        """The first of a claim's `_matching_pvs` whose node affinity
        admits `node` (the reference's first PV matching claim and node)."""
        from kubernetes_tpu_torch.controllers.pvbinder import pv_node_ok
        node_obj = {"metadata": {"name": node.name, "labels": node.labels}}
        for pv in candidates:
            if pv_node_ok(pv, node_obj):
                return pv
        return None

    def _provisionable(self, pvc: dict, node: NodeInfo) -> bool:
        """Dynamic-provisioning feasibility: provisioner exists and the
        class's allowedTopologies admit the node."""
        from kubernetes_tpu_torch.controllers.pvbinder import NO_PROVISIONER
        sc_name = pvc.get("spec", {}).get("storageClassName")
        if not sc_name or self._sc_informer is None:
            return False
        sc = self._sc_informer.indexer.get(sc_name)
        if sc is None or sc.get("provisioner") == NO_PROVISIONER:
            return False
        allowed = sc.get("allowedTopologies")
        if not allowed:
            return True
        for topo in allowed:
            ok = True
            for expr in topo.get("matchLabelExpressions") or []:
                if node.labels.get(expr.get("key")) not in \
                        (expr.get("values") or []):
                    ok = False
                    break
            if ok:
                return True
        return False

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        from kubernetes_tpu_torch.controllers.pvbinder import pv_node_ok
        claims: _PodVolumeClaims | None = state.read(_STATE_KEY)
        if claims is None:
            return Status.success()
        node_obj = {"metadata": {"name": node.name, "labels": node.labels}}
        for pvc in claims.bound:
            pv = self._pv_of(pvc)
            if pv is not None and not pv_node_ok(pv, node_obj):
                return Status.unschedulable(
                    "node(s) had volume node affinity conflict",
                    resolvable=False)
        if claims.unbound_immediate:
            # Immediate-mode claims are the PV controller's job; an unbound
            # one means binding hasn't happened yet (volume_binding.go
            # ErrReasonBindConflict path).
            return Status.unschedulable(
                "pod has unbound immediate PersistentVolumeClaims")
        for pvc, candidates in zip(claims.unbound_wffc, claims.candidates):
            if self._find_matching_pv(candidates, node) is None \
                    and not self._provisionable(pvc, node):
                return Status.unschedulable(
                    "node(s) didn't find available persistent volumes to "
                    "bind")
        return Status.success()

    # -- Reserve / Unreserve: stake the claim → node plan ------------------

    def reserve(self, state: CycleState, pod: PodInfo,
                node_name: str) -> Status:
        # AssumePodVolumes equivalent: nothing to stage host-side (the
        # binding plan is just the node choice, which pre_bind/unreserve
        # receive directly); Reserve registration exists so Unreserve runs
        # the annotation rollback on a failed cycle.
        return Status.success()

    def unreserve(self, state: CycleState, pod: PodInfo,
                  node_name: str) -> None:
        claims: _PodVolumeClaims | None = state.read(_STATE_KEY)
        if claims is None or self.store is None:
            return
        # Roll back the selected-node annotation so the claims return to
        # the waiting-for-consumer state (volume_binding.go RevertAssumed).
        for pvc in claims.unbound_wffc:
            key = namespaced_name(pvc)

            def clear(obj):
                anns = obj["metadata"].get("annotations") or {}
                if SELECTED_NODE_ANN not in anns or \
                        obj.get("spec", {}).get("volumeName"):
                    return None
                del anns[SELECTED_NODE_ANN]
                return obj
            asyncio.ensure_future(self._safe_update(key, clear))

    async def _safe_update(self, key: str, mutate) -> None:
        try:
            await self.store.guaranteed_update(
                "persistentvolumeclaims", key, mutate, return_copy=False)
        except StoreError:
            pass

    # -- PreBind: write the plan and BLOCK on real binding -----------------

    async def pre_bind(self, state: CycleState, pod: PodInfo,
                       node_name: str) -> Status:
        claims: _PodVolumeClaims | None = state.read(_STATE_KEY)
        if claims is None or not claims.unbound_wffc or self.store is None:
            return Status.success()
        keys = [namespaced_name(pvc) for pvc in claims.unbound_wffc]
        for key in keys:
            def set_node(obj):
                if obj.get("spec", {}).get("volumeName"):
                    return None
                anns = obj["metadata"].setdefault("annotations", {})
                if anns.get(SELECTED_NODE_ANN) == node_name:
                    return None
                anns[SELECTED_NODE_ANN] = node_name
                return obj
            try:
                await self.store.guaranteed_update(
                    "persistentvolumeclaims", key, set_node,
                    return_copy=False)
            except StoreError as e:
                return Status.error(f"writing selected-node: {e}")
        # BindPodVolumes: wait until the PV controller binds every claim.
        deadline = asyncio.get_event_loop().time() + self.bind_timeout
        while True:
            pending = []
            for key in keys:
                try:
                    pvc = await self.store.get("persistentvolumeclaims", key)
                except StoreError:
                    return Status.error(f"claim {key} vanished during bind")
                if not pvc.get("spec", {}).get("volumeName"):
                    pending.append(key)
            if not pending:
                return Status.success()
            if asyncio.get_event_loop().time() > deadline:
                return Status.unschedulable(
                    f"timed out waiting for PVC(s) {pending} to bind")
            await asyncio.sleep(0.02)


class VolumeZone(Plugin):
    """Filter: a bound PV labeled with a zone/region must match the node's
    topology labels (volumezone/volume_zone.go)."""

    NAME = "VolumeZone"
    EXTENSION_POINTS = ("PreFilter", "Filter")
    EVENTS = ["Node/Add", "Node/Update",
              "PersistentVolumeClaim/Update", "PersistentVolume/Add"]

    def __init__(self, args=None):
        super().__init__(args)
        self._pvc_informer = None
        self._pv_informer = None

    def set_informers(self, factory) -> None:
        self._pvc_informer = factory.informer("persistentvolumeclaims")
        self._pv_informer = factory.informer("persistentvolumes")

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not pod.pvc_names or self._pvc_informer is None:
            return Status.skip()
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        for name in pod.pvc_names:
            pvc = self._pvc_informer.indexer.get(f"{pod.namespace}/{name}")
            if pvc is None:
                continue
            vol = pvc.get("spec", {}).get("volumeName")
            pv = self._pv_informer.indexer.get(vol) if vol else None
            if pv is None:
                continue
            for label in ZONE_LABELS:
                want = (pv["metadata"].get("labels") or {}).get(label)
                if want is not None and \
                        node.labels.get(label) not in want.split("__"):
                    return Status.unschedulable(
                        "node(s) had no available volume zone",
                        resolvable=False)
        return Status.success()


class NodeVolumeLimits(Plugin):
    """Filter: cap PV-backed volumes per node (nodevolumelimits/csi.go —
    the CSI attach-limit check; the cap comes from the node's
    `attachable-volumes-*` allocatable or the plugin arg)."""

    NAME = "NodeVolumeLimits"
    EXTENSION_POINTS = ("PreFilter", "Filter")
    EVENTS = ["Pod/Delete"]

    DEFAULT_MAX = 256

    def __init__(self, args=None):
        super().__init__(args)
        self.max_volumes = int(self.args.get("maxVolumesPerNode",
                                             self.DEFAULT_MAX))

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not pod.pvc_names:
            return Status.skip()
        return Status.success()

    def _node_limit(self, node: NodeInfo) -> int:
        for rname, v in node.allocatable.res.items():
            if rname.startswith("attachable-volumes"):
                return int(v) // 1000  # quantities are milli-scaled
        return self.max_volumes

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        # Unique volumes, not PVC references: pods sharing a claim share one
        # attachment (csi.go dedupes by volume unique-name).
        in_use = {f"{pi.namespace}/{name}"
                  for pi in node.pods for name in pi.pvc_names}
        new = {f"{pod.namespace}/{name}" for name in pod.pvc_names} - in_use
        if len(in_use) + len(new) > self._node_limit(node):
            return Status.unschedulable(
                "node(s) exceed max volume count", resolvable=True)
        return Status.success()


class VolumeRestrictions(Plugin):
    """Volume access-mode conflicts.

    Parity target: plugins/volumerestrictions/ (SURVEY §2.3):
    - ReadWriteOncePod: a PVC with the ReadWriteOncePod access mode
      admits exactly ONE consumer pod cluster-wide; a second pod is
      unschedulable everywhere while the first exists (the reference's
      conflict count over the PreFilter-computed user set).
    - ReadWriteOnce: the volume attaches to one NODE at a time; a pod
      reusing an RWO claim already consumed by a resident pod must land
      on that pod's node (co-location allowed, cross-node attach not).
    """

    NAME = "VolumeRestrictions"
    EXTENSION_POINTS = ("PreFilter", "Filter")
    EVENTS = ["Pod/Delete", "PersistentVolumeClaim/Add",
              "PersistentVolumeClaim/Update"]

    _STATE = "VolumeRestrictions/state"

    def __init__(self, args=None):
        super().__init__(args)
        self._pvc_informer = None

    def set_informers(self, factory) -> None:
        self._pvc_informer = factory.informer("persistentvolumeclaims")

    def _access_modes(self, namespace: str, claim: str) -> list[str]:
        if self._pvc_informer is None:
            return []
        pvc = self._pvc_informer.indexer.get(f"{namespace}/{claim}")
        if pvc is None:
            return []
        return (pvc.get("spec") or {}).get("accessModes") or []

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot) -> Status:
        if not pod.pvc_names:
            return Status.skip()
        rwop: list[str] = []
        rwo: list[str] = []
        for claim in pod.pvc_names:
            modes = self._access_modes(pod.namespace, claim)
            if "ReadWriteOncePod" in modes:
                rwop.append(claim)
            elif "ReadWriteOnce" in modes:
                rwo.append(claim)
        if not rwop and not rwo:
            return Status.skip()
        #: claim -> node names of resident pods already using it.
        users: dict[str, set[str]] = {}
        watched = set(rwop) | set(rwo)
        for ni in snapshot:
            for resident in ni.pods:
                if resident.namespace != pod.namespace \
                        or resident.key == pod.key:
                    continue
                for claim in resident.pvc_names:
                    if claim in watched:
                        users.setdefault(claim, set()).add(ni.name)
        for claim in rwop:
            if users.get(claim):
                return Status.unschedulable(
                    f"PVC {claim!r} has ReadWriteOncePod access mode and "
                    "is already used by another pod", resolvable=True)
        # RWO: intersect the allowed node sets of every in-use claim.
        allowed: set[str] | None = None
        for claim in rwo:
            nodes = users.get(claim)
            if not nodes:
                continue
            allowed = nodes if allowed is None else (allowed & nodes)
        state.write(self._STATE, allowed)
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node) -> Status:
        allowed = state.read(self._STATE)
        if allowed is None:
            return Status.success()
        if node.name in allowed:
            return Status.success()
        return Status.unschedulable(
            "node(s) unavailable: ReadWriteOnce volume is attached to "
            "another node")
