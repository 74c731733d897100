"""Attach/detach controller: VolumeAttachment lifecycle.

Parity target: pkg/controller/volume/attachdetach (SURVEY §2.4 "PV binder
/ attach-detach"): reconcile the desired state (pods scheduled to nodes
referencing PV-backed PVCs) against the actual state (VolumeAttachment
objects), attaching volumes to the pods' nodes and detaching them when no
pod on the node uses the volume any more.

VolumeAttachment (storage.k8s.io, cluster-scoped) shape:
    spec: {attacher, nodeName, source: {persistentVolumeName}}
    status: {attached: bool}

There is no real CSI driver here — "attach" completes immediately (the
external-attacher analog is the controller itself), but the object
lifecycle, naming (`va-<pv>-<node>`), and multi-pod refcount semantics
match the reference so schedulers/kubelets-analogs can observe it.

Copy of `kubernetes_tpu/controllers/attachdetach.py`.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)

DEFAULT_ATTACHER = "attach.ktpu.dev"


def attachment_name(pv: str, node: str) -> str:
    return f"va-{pv}-{node}"


class AttachDetachController(Controller):
    NAME = "attachdetach"
    WORKERS = 2
    RESYNC_PERIOD = 2.0

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")
        self.pvc_informer = factory.informer("persistentvolumeclaims")
        self.pv_informer = factory.informer("persistentvolumes")
        self.va_informer = factory.informer("volumeattachments")
        # Any pod/PVC/attachment movement re-reconciles the world; the
        # desired state is small enough to diff whole (the reference
        # keeps a DesiredStateOfWorld cache for the same diff).
        self.watch_resource(factory, "pods", key_fn=lambda o: "~all")
        self.watch_resource(factory, "persistentvolumeclaims",
                            key_fn=lambda o: "~all")
        self.watch_resource(factory, "volumeattachments",
                            key_fn=lambda o: "~all")

    async def resync_keys(self):
        return ["~all"]

    def _desired(self) -> dict[str, tuple[str, str]]:
        """attachment name -> (pv, node) for every (PV, node) pair some
        scheduled pod references through a bound PVC."""
        from kubernetes_tpu_torch.api.types import pod_is_terminal
        want: dict[str, tuple[str, str]] = {}
        for pod in self.pod_informer.indexer.list():
            node = (pod.get("spec") or {}).get("nodeName")
            if not node or pod_is_terminal(pod):
                # Terminated pods release their volumes (the reference's
                # DesiredStateOfWorld excludes them).
                continue
            ns = pod["metadata"].get("namespace", "default")
            for vol in (pod.get("spec") or {}).get("volumes") or []:
                claim = (vol.get("persistentVolumeClaim") or {}) \
                    .get("claimName")
                if not claim:
                    continue
                pvc = self.pvc_informer.indexer.get(f"{ns}/{claim}")
                if pvc is None:
                    continue
                pv = (pvc.get("spec") or {}).get("volumeName")
                if not pv:
                    continue
                want[attachment_name(pv, node)] = (pv, node)
        return want

    async def sync(self, key: str) -> None:
        want = self._desired()
        have = {va["metadata"]["name"]: va
                for va in self.va_informer.indexer.list()}
        # Attach: desired but absent.
        for name, (pv, node) in want.items():
            if name in have:
                continue
            va = new_object(
                "VolumeAttachment", name, None,
                api_version="storage.k8s.io/v1",
                spec={"attacher": DEFAULT_ATTACHER, "nodeName": node,
                      "source": {"persistentVolumeName": pv}},
                status={"attached": False})
            try:
                await self.store.create("volumeattachments", va,
                                        return_copy=False)
            except AlreadyExists:
                pass
            except StoreError:
                logger.exception("attach %s failed", name)
                continue
            await self._mark_attached(name)
        # Mark attached any pending ones (controller restart).
        for name, va in have.items():
            if name in want and not (va.get("status") or {}) \
                    .get("attached"):
                await self._mark_attached(name)
        # Detach: attached but no longer desired.
        for name in set(have) - set(want):
            try:
                await self.store.delete("volumeattachments", name)
            except StoreError:
                pass

    async def _mark_attached(self, name: str) -> None:
        def mark(obj):
            status = obj.setdefault("status", {})
            if status.get("attached"):
                return None
            status["attached"] = True
            return obj
        try:
            await self.store.guaranteed_update(
                "volumeattachments", name, mark, return_copy=False)
        except NotFound:
            pass
