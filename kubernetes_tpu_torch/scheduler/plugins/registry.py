"""Plugin registry (plugins/registry.go `NewInTreeRegistry`), cut to the
plugins this package models: the Filter/Score plugins the batched backend
computes (the node plugins with NodePorts and ImageLocality, the four
volume plugins, the two constraint families, InterPodAffinity and
PodTopologySpread, and the device-topology plugins, DynamicResources and
NodeResourceTopologyMatch), the queue-sort, gating and binding plugins the
scheduler loop runs on the host, Coscheduling and NodeResourceTopologyMatch
(registered, not default-enabled, as in the reference) and
DefaultPreemption (the PostFilter, with its batched device victim
proposal). The default profile is the reference's."""

from __future__ import annotations

from typing import Callable, Mapping

from kubernetes_tpu_torch.scheduler.plugins.core import (
    DefaultBinder,
    ImageLocality,
    PrioritySort,
    SchedulingGates,
)
from kubernetes_tpu_torch.scheduler.plugins.coscheduling import Coscheduling
from kubernetes_tpu_torch.scheduler.plugins.defaultpreemption import (
    DefaultPreemption,
)
from kubernetes_tpu_torch.scheduler.plugins.dynamicresources import (
    DynamicResources,
)
from kubernetes_tpu_torch.scheduler.plugins.interpodaffinity import (
    InterPodAffinity,
)
from kubernetes_tpu_torch.scheduler.plugins.nodeaffinity import (
    NodeAffinity,
    NodeName,
    NodePorts,
    NodeUnschedulable,
    TaintToleration,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
    BalancedAllocation,
    NodeResourcesFit,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesourcetopology import (
    NodeResourceTopologyMatch,
)
from kubernetes_tpu_torch.scheduler.plugins.podtopologyspread import (
    PodTopologySpread,
)
from kubernetes_tpu_torch.scheduler.plugins.volumebinding import (
    NodeVolumeLimits,
    VolumeBinding,
    VolumeRestrictions,
    VolumeZone,
)

#: name -> factory(args) (framework/runtime Registry). Coscheduling and
#: NodeResourceTopologyMatch are registered but not default-enabled
#: (out-of-tree in the reference).
IN_TREE: dict[str, Callable] = {
    "Coscheduling": Coscheduling,
    "DynamicResources": DynamicResources,
    "NodeResourceTopologyMatch": NodeResourceTopologyMatch,
    "PrioritySort": PrioritySort,
    "SchedulingGates": SchedulingGates,
    "NodeResourcesFit": NodeResourcesFit,
    "NodeResourcesBalancedAllocation": BalancedAllocation,
    "NodeAffinity": NodeAffinity,
    "NodeName": NodeName,
    "NodeUnschedulable": NodeUnschedulable,
    "TaintToleration": TaintToleration,
    "NodePorts": NodePorts,
    "VolumeBinding": VolumeBinding,
    "VolumeRestrictions": VolumeRestrictions,
    "VolumeZone": VolumeZone,
    "NodeVolumeLimits": NodeVolumeLimits,
    "InterPodAffinity": InterPodAffinity,
    "PodTopologySpread": PodTopologySpread,
    "ImageLocality": ImageLocality,
    "DefaultPreemption": DefaultPreemption,
    "DefaultBinder": DefaultBinder,
}

#: The default profile: the reference's default plugins, in its order.
DEFAULT_PLUGINS = [
    "PrioritySort",
    "SchedulingGates",
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodePorts",
    "VolumeBinding",
    "VolumeRestrictions",
    "VolumeZone",
    "NodeVolumeLimits",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "InterPodAffinity",
    "PodTopologySpread",
    "ImageLocality",
    "DynamicResources",
    "DefaultPreemption",
    "DefaultBinder",
]

#: Default score weights (defaults.go), for the plugins of this profile.
DEFAULT_SCORE_WEIGHTS = {
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "NodeAffinity": 2,
    "InterPodAffinity": 2,
    "PodTopologySpread": 2,
    "TaintToleration": 3,
    "ImageLocality": 1,
}


def build_plugins(
    enabled: list[str] | None = None,
    plugin_config: Mapping[str, Mapping] | None = None,
    store=None,
) -> list:
    """Instantiate plugins by name with per-plugin args
    (KubeSchedulerConfiguration pluginConfig)."""
    enabled = enabled or DEFAULT_PLUGINS
    plugin_config = plugin_config or {}
    out = []
    for name in enabled:
        factory = IN_TREE.get(name)
        if factory is None:
            raise KeyError(f"unknown plugin {name!r}")
        args = plugin_config.get(name)
        if name == "DefaultBinder":
            out.append(factory(args, store=store))
        else:
            out.append(factory(args))
    return out
