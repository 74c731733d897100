"""Plugin registry (plugins/registry.go `NewInTreeRegistry`), cut to the
plugins this package models: the six Filter/Score plugins the batched
backend computes on the device, and the queue-sort, gating and binding
plugins the scheduler loop runs on the host."""

from __future__ import annotations

from typing import Callable, Mapping

from kubernetes_tpu_torch.scheduler.plugins.core import (
    DefaultBinder,
    PrioritySort,
    SchedulingGates,
)
from kubernetes_tpu_torch.scheduler.plugins.nodeaffinity import (
    NodeAffinity,
    NodeName,
    NodeUnschedulable,
    TaintToleration,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
    BalancedAllocation,
    NodeResourcesFit,
)

#: name -> factory(args) (framework/runtime Registry).
IN_TREE: dict[str, Callable] = {
    "PrioritySort": PrioritySort,
    "SchedulingGates": SchedulingGates,
    "NodeResourcesFit": NodeResourcesFit,
    "NodeResourcesBalancedAllocation": BalancedAllocation,
    "NodeAffinity": NodeAffinity,
    "NodeName": NodeName,
    "NodeUnschedulable": NodeUnschedulable,
    "TaintToleration": TaintToleration,
    "DefaultBinder": DefaultBinder,
}

#: The default profile: the reference's default plugins this package has,
#: in the reference's order.
DEFAULT_PLUGINS = [
    "PrioritySort",
    "SchedulingGates",
    "NodeUnschedulable",
    "NodeName",
    "TaintToleration",
    "NodeAffinity",
    "NodeResourcesFit",
    "NodeResourcesBalancedAllocation",
    "DefaultBinder",
]

#: Default score weights (defaults.go), for the plugins of this profile.
DEFAULT_SCORE_WEIGHTS = {
    "NodeResourcesFit": 1,
    "NodeResourcesBalancedAllocation": 1,
    "NodeAffinity": 2,
    "TaintToleration": 3,
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
