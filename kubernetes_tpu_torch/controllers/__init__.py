"""Controllers: reconcile loops over the store. Counterpart of
`kubernetes_tpu/controllers/`, cut to what the port's paths run: the
controller base, the PV binder (the PVC <-> PV state machine the volume
plugins need), the node lifecycle controller (lease expiry, the
unreachable taint and NoExecute eviction) and the rebalance descheduler
(its consolidation scores on the device)."""

from kubernetes_tpu_torch.controllers.base import Controller, ControllerManager
from kubernetes_tpu_torch.controllers.descheduler import DeschedulerController
from kubernetes_tpu_torch.controllers.nodelifecycle import (
    NodeLifecycleController,
)
from kubernetes_tpu_torch.controllers.pvbinder import PVBinderController

__all__ = ["Controller", "ControllerManager", "DeschedulerController",
           "NodeLifecycleController", "PVBinderController"]
