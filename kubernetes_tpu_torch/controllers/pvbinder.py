"""PersistentVolume binder controller: the PVC ↔ PV state machine.

Parity target: pkg/controller/volume/persistentvolume/pv_controller.go
(`syncClaim` / `syncVolume`): Pending PVCs are matched to Available PVs
(capacity, accessModes, storageClassName, selector) and bound both ways
(pv.spec.claimRef ↔ pvc.spec.volumeName); WaitForFirstConsumer claims wait
for the scheduler's `volume.kubernetes.io/selected-node` annotation
(VolumeBinding plugin sets it at Reserve); claims with no matching PV are
dynamically provisioned (simulated provisioner honoring the selected node's
topology); deleting a PVC releases its PV per reclaim policy.

Copy of `kubernetes_tpu/controllers/pvbinder.py`.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, uid_of
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import make_pv
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)

SELECTED_NODE_ANN = "volume.kubernetes.io/selected-node"
#: provisioner value that disables dynamic provisioning (the reference's
#: kubernetes.io/no-provisioner convention for local volumes).
NO_PROVISIONER = "kubernetes.io/no-provisioner"


def pv_matches_claim(pv: dict, pvc: dict) -> bool:
    """findMatchingVolume subset: class, phase, capacity, accessModes."""
    if (pv.get("status") or {}).get("phase") != "Available":
        return False
    if pv.get("spec", {}).get("claimRef"):
        return False
    want_class = pvc.get("spec", {}).get("storageClassName") or ""
    if (pv.get("spec", {}).get("storageClassName") or "") != want_class:
        return False
    want = parse_quantity((pvc["spec"].get("resources") or {})
                          .get("requests", {}).get("storage", 0))
    have = parse_quantity((pv["spec"].get("capacity") or {})
                          .get("storage", 0))
    if have < want:
        return False
    pv_modes = set(pv["spec"].get("accessModes") or [])
    return set(pvc["spec"].get("accessModes") or []).issubset(pv_modes)


def pv_node_ok(pv: dict, node: dict) -> bool:
    """CheckVolumeNodeAffinity: PV nodeAffinity.required terms vs node."""
    from kubernetes_tpu_torch.api.labels import match_node_selector_terms
    req = ((pv.get("spec") or {}).get("nodeAffinity") or {}).get("required")
    if not req:
        return True
    return match_node_selector_terms(
        req.get("nodeSelectorTerms") or [],
        node.get("metadata", {}).get("labels") or {},
        node["metadata"]["name"])


class PVBinderController(Controller):
    NAME = "pv-binder"
    WORKERS = 2
    RESYNC_PERIOD = 2.0

    def __init__(self, store, *, provision_delay: float = 0.05):
        super().__init__(store)
        self.provision_delay = provision_delay
        self._seq = 0

    def setup(self, factory: InformerFactory) -> None:
        self.pvc_informer = factory.informer("persistentvolumeclaims")
        self.pv_informer = factory.informer("persistentvolumes")
        self.sc_informer = factory.informer("storageclasses")
        self.node_informer = factory.informer("nodes")
        self.watch_resource(factory, "persistentvolumeclaims")

        # PVC deletion → release its PV (syncVolume's released path).
        def on_pvc_delete(obj):
            vol = obj.get("spec", {}).get("volumeName")
            if vol:
                asyncio.ensure_future(self._release_pv(vol, uid_of(obj)))

        self.pvc_informer.add_event_handler(ResourceEventHandler(
            on_delete=on_pvc_delete))
        # New PVs can satisfy pending claims.
        self.pv_informer.add_event_handler(ResourceEventHandler(
            on_add=lambda obj: asyncio.ensure_future(self._poke_pending())))

    async def _poke_pending(self) -> None:
        for pvc in self.pvc_informer.indexer.list():
            if (pvc.get("status") or {}).get("phase") == "Pending":
                await self.queue.add(namespaced_name(pvc))

    async def resync_keys(self):
        return [namespaced_name(c)
                for c in self.pvc_informer.indexer.list()
                if (c.get("status") or {}).get("phase") != "Bound"]

    def _storage_class(self, pvc: dict) -> dict | None:
        name = pvc.get("spec", {}).get("storageClassName")
        if not name:
            return None
        return self.sc_informer.indexer.get(name)

    async def sync(self, key: str) -> None:
        pvc = self.pvc_informer.indexer.get(key)
        if pvc is None or (pvc.get("status") or {}).get("phase") == "Bound":
            return
        sc = self._storage_class(pvc)
        selected = (pvc["metadata"].get("annotations") or {}) \
            .get(SELECTED_NODE_ANN)
        wffc = bool(sc) and sc.get("volumeBindingMode") == "WaitForFirstConsumer"
        if wffc and not selected:
            return  # syncUnboundClaim: wait for the scheduler to pick a node

        node = self.node_informer.indexer.get(selected) if selected else None
        # Static match first (findMatchingVolume), topology-checked when a
        # node was selected.
        for pv in self.pv_informer.indexer.list():
            if pv_matches_claim(pv, pvc) and \
                    (node is None or pv_node_ok(pv, node)):
                await self._bind(pvc, pv)
                return
        # Dynamic provisioning (simulated provisioner).
        if sc is not None and sc.get("provisioner") != NO_PROVISIONER:
            await self._provision(pvc, sc, selected)

    async def _bind(self, pvc: dict, pv: dict) -> None:
        key = namespaced_name(pvc)
        pv_name = pv["metadata"]["name"]

        def claim_pv(obj):
            if obj.get("spec", {}).get("claimRef"):
                return None  # raced with another claim; sync retries
            obj["spec"]["claimRef"] = {
                "kind": "PersistentVolumeClaim",
                "namespace": pvc["metadata"].get("namespace", "default"),
                "name": pvc["metadata"]["name"],
                "uid": uid_of(pvc),
            }
            obj.setdefault("status", {})["phase"] = "Bound"
            return obj
        try:
            bound = await self.store.guaranteed_update(
                "persistentvolumes", pv_name, claim_pv)
        except NotFound:
            return
        if not (bound.get("spec", {}).get("claimRef") or {}).get("uid") \
                == uid_of(pvc):
            return  # lost the race

        def bind_claim(obj):
            obj["spec"]["volumeName"] = pv_name
            obj.setdefault("status", {})["phase"] = "Bound"
            return obj
        try:
            await self.store.guaranteed_update(
                "persistentvolumeclaims", key, bind_claim)
        except NotFound:
            await self._release_pv(pv_name, uid_of(pvc))

    async def _provision(self, pvc: dict, sc: dict, selected: str | None) -> None:
        """Simulated external provisioner: a real one takes time — the
        VolumeBinding plugin's PreBind genuinely blocks on this."""
        await asyncio.sleep(self.provision_delay)
        self._seq += 1
        request = (pvc["spec"].get("resources") or {}) \
            .get("requests", {}).get("storage", "1Gi")
        node_affinity = None
        if selected:
            node_affinity = {"nodeSelectorTerms": [{"matchFields": [
                {"key": "metadata.name", "operator": "In",
                 "values": [selected]}]}]}
        pv = make_pv(f"pvc-{uid_of(pvc) or self._seq}",
                     capacity=str(request),
                     storage_class=sc["metadata"]["name"],
                     access_modes=list(pvc["spec"].get("accessModes") or []),
                     node_affinity=node_affinity,
                     reclaim_policy="Delete")
        try:
            await self.store.create("persistentvolumes", pv)
        except StoreError as e:
            logger.warning("provision for %s failed: %s",
                           namespaced_name(pvc), e)
            return
        await self._bind(pvc, pv)

    async def _release_pv(self, pv_name: str, claim_uid: str | None) -> None:
        def release(obj):
            ref = obj.get("spec", {}).get("claimRef")
            if not ref or (claim_uid and ref.get("uid") != claim_uid):
                return None
            if obj["spec"].get("persistentVolumeReclaimPolicy") == "Delete":
                obj.setdefault("status", {})["phase"] = "Released"  # then deleted below
            else:
                obj["spec"].pop("claimRef", None)
                obj.setdefault("status", {})["phase"] = "Available"
            return obj
        try:
            out = await self.store.guaranteed_update(
                "persistentvolumes", pv_name, release)
            if (out.get("status") or {}).get("phase") == "Released":
                await self.store.delete("persistentvolumes", pv_name)
        except StoreError:
            pass
