"""Controllers tier: reconcile loops over the store (SURVEY §2.4/§3.4).

Counterpart of `kubernetes_tpu/controllers/`, with the same modules and
exports. Host code throughout: the one controller that computes on a
device (the descheduler's consolidation scores) imports torch only when
it scores, so `python -m kubernetes_tpu_torch.controllers` loads no torch
unless it runs the descheduler (which the registry does not name)."""

from kubernetes_tpu_torch.controllers.attachdetach import AttachDetachController
from kubernetes_tpu_torch.controllers.base import Controller, ControllerManager
from kubernetes_tpu_torch.controllers.cronjob import (
    CronJobController,
    CronSchedule,
    make_cronjob,
)
from kubernetes_tpu_torch.controllers.daemonset import (
    DaemonSetController,
    make_daemonset,
)
from kubernetes_tpu_torch.controllers.deployment import (
    DeploymentController,
    make_deployment,
)
from kubernetes_tpu_torch.controllers.descheduler import DeschedulerController
from kubernetes_tpu_torch.controllers.garbagecollector import (
    GarbageCollectorController,
    NamespaceController,
)
from kubernetes_tpu_torch.controllers.job import JobController, make_job
from kubernetes_tpu_torch.controllers.longtail import (
    DisruptionController,
    EndpointSliceController,
    HorizontalPodAutoscalerController,
    ResourceQuotaController,
    TTLAfterFinishedController,
    install_eviction_subresource,
    install_quota_admission,
    make_hpa,
    make_pdb,
    make_resource_quota,
    make_service,
)
from kubernetes_tpu_torch.controllers.kubeproxy import (
    KubeProxyController,
    install_service_ip_allocator,
)
from kubernetes_tpu_torch.controllers.nodeagent import (
    NodePressureEvictionController,
    ProberController,
)
from kubernetes_tpu_torch.controllers.kwok import KwokController
from kubernetes_tpu_torch.controllers.nodelifecycle import NodeLifecycleController
from kubernetes_tpu_torch.controllers.podgc import PodGCController
from kubernetes_tpu_torch.controllers.pvbinder import PVBinderController
from kubernetes_tpu_torch.controllers.replicaset import (
    ReplicaSetController,
    make_replicaset,
)
from kubernetes_tpu_torch.controllers.resourceclaim import ResourceClaimController
from kubernetes_tpu_torch.controllers.serviceaccount import (
    ServiceAccountAuthenticator,
    ServiceAccountController,
    TokenController,
)
from kubernetes_tpu_torch.controllers.statefulset import (
    StatefulSetController,
    make_statefulset,
)

__all__ = [
    "NodePressureEvictionController",
    "ProberController",
    "KubeProxyController",
    "install_service_ip_allocator",
    "DisruptionController",
    "EndpointSliceController",
    "HorizontalPodAutoscalerController",
    "ResourceQuotaController",
    "TTLAfterFinishedController",
    "install_eviction_subresource",
    "install_quota_admission",
    "make_hpa", "make_pdb", "make_resource_quota", "make_service",
    "GarbageCollectorController",
    "NamespaceController",
    "Controller", "ControllerManager",
    "DaemonSetController", "make_daemonset",
    "DeschedulerController",
    "DeploymentController", "make_deployment",
    "JobController", "make_job",
    "KwokController", "NodeLifecycleController", "PodGCController",
    "PVBinderController",
    "ReplicaSetController", "make_replicaset",
    "ResourceClaimController",
    "AttachDetachController",
    "CronJobController", "CronSchedule", "make_cronjob",
    "ServiceAccountAuthenticator", "ServiceAccountController",
    "TokenController",
    "StatefulSetController", "make_statefulset",
]
