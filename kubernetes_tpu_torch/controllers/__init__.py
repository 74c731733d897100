"""Controllers: reconcile loops over the store. Counterpart of
`kubernetes_tpu/controllers/`, cut to what the volume plugins need: the
controller base and the PV binder (the PVC <-> PV state machine)."""

from kubernetes_tpu_torch.controllers.base import Controller, ControllerManager
from kubernetes_tpu_torch.controllers.pvbinder import PVBinderController

__all__ = ["Controller", "ControllerManager", "PVBinderController"]
