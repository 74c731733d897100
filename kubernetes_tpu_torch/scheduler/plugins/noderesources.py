"""NodeResourcesFit + NodeResourcesBalancedAllocation.

Parity targets:
- pkg/scheduler/framework/plugins/noderesources/fit.go (`Fit`:
  PreFilter precomputes the pod's request; Filter checks
  requested + podRequest <= allocatable per resource, plus max-pods;
  `fitsRequest` returns InsufficientResource list for explainability)
- resource_allocation.go + least_allocated.go / most_allocated.go /
  requested_to_capacity_ratio.go (ScoringStrategy)
- balanced_allocation.go (score = 100 × (1 − stddev of requested fractions))

Copy of `kubernetes_tpu/scheduler/plugins/noderesources.py`. The device
kernels in ops/kernels.py compute the same Filter and Score over tensors; the
host methods here answer the verify and diagnostics paths.
"""

from __future__ import annotations

import math

from kubernetes_tpu_torch.api.types import CPU, MEMORY
from kubernetes_tpu_torch.scheduler.framework import (
    MAX_NODE_SCORE,
    CycleState,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

_STATE_KEY = "PreFilterNodeResourcesFit"


class NodeResourcesFit(Plugin):
    NAME = "NodeResourcesFit"
    EXTENSION_POINTS = ("PreFilter", "Filter", "Score")
    EVENTS = ["Node/Add", "Node/Update", "Pod/Delete"]

    def __init__(self, args=None):
        super().__init__(args)
        strategy = self.args.get("scoringStrategy") or {}
        self.strategy_type = strategy.get("type", "LeastAllocated")
        # resources to score over: [{"name": "cpu", "weight": 1}, ...]
        self.score_resources = strategy.get("resources") or [
            {"name": CPU, "weight": 1}, {"name": MEMORY, "weight": 1},
        ]
        # RequestedToCapacityRatio shape points [{utilization, score}]
        self.shape = (strategy.get("requestedToCapacityRatio") or {}).get("shape") or [
            {"utilization": 0, "score": 0},
            {"utilization": 100, "score": 10},
        ]
        self.ignored_resources = set(self.args.get("ignoredResources") or [])

    def pre_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot) -> Status:
        # Max-pods applies even to a pod that requests nothing, so this
        # never Skips.
        state.write(_STATE_KEY, pod.requests)
        return Status.success()

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        reasons = insufficient_resources(pod, node, self.ignored_resources)
        if reasons:
            return Status.unschedulable(*reasons)
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        requested = node.nonzero_requested
        pod_req = pod.nonzero_requests
        total_w = 0
        acc = 0.0
        for spec in self.score_resources:
            rname, w = spec["name"], spec.get("weight", 1)
            alloc = node.allocatable.get(rname)
            if alloc <= 0:
                continue
            req = requested.get(rname) + pod_req.get(rname, 0)
            acc += w * self._score_one(req, alloc)
            total_w += w
        return acc / total_w if total_w else 0.0

    def _score_one(self, requested: int, allocatable: int) -> float:
        if requested > allocatable:
            return 0.0
        if self.strategy_type == "MostAllocated":
            return MAX_NODE_SCORE * requested / allocatable
        if self.strategy_type == "RequestedToCapacityRatio":
            return self._shape_score(100.0 * requested / allocatable)
        # LeastAllocated (default)
        return MAX_NODE_SCORE * (allocatable - requested) / allocatable

    def _shape_score(self, utilization: float) -> float:
        """Piecewise-linear over shape points; reference scores are 0..10
        scaled to 0..100 (requested_to_capacity_ratio maxUtilization handling)."""
        pts = self.shape
        if utilization <= pts[0]["utilization"]:
            raw = pts[0]["score"]
        elif utilization >= pts[-1]["utilization"]:
            raw = pts[-1]["score"]
        else:
            raw = pts[-1]["score"]
            for i in range(1, len(pts)):
                if utilization <= pts[i]["utilization"]:
                    u0, s0 = pts[i - 1]["utilization"], pts[i - 1]["score"]
                    u1, s1 = pts[i]["utilization"], pts[i]["score"]
                    raw = s0 + (s1 - s0) * (utilization - u0) / (u1 - u0)
                    break
        return raw * MAX_NODE_SCORE / 10.0


def insufficient_resources(
    pod: PodInfo, node: NodeInfo, ignored: set[str] = frozenset()
) -> list[str]:
    """fitsRequest: list of human-readable insufficiency reasons (empty = fits)."""
    reasons: list[str] = []
    if node.requested.pods + 1 > node.allocatable.pods:
        reasons.append("Too many pods")
    if not pod.requests:
        return reasons
    for rname, req in pod.requests.items():
        if req == 0 or rname in ignored:
            continue
        free = node.allocatable.get(rname) - node.requested.get(rname)
        if req > free:
            reasons.append(f"Insufficient {rname}")
    return reasons


class BalancedAllocation(Plugin):
    """NodeResourcesBalancedAllocation: prefer nodes whose per-resource
    utilization fractions are close to each other (penalize cpu-90%/mem-10%)."""

    NAME = "NodeResourcesBalancedAllocation"
    EXTENSION_POINTS = ("PreScore", "Score")

    def __init__(self, args=None):
        super().__init__(args)
        self.resources = [
            r["name"] if isinstance(r, dict) else r
            for r in self.args.get("resources") or [CPU, MEMORY]
        ]

    def pre_score(self, state: CycleState, pod: PodInfo, nodes) -> Status:
        if not pod.nonzero_requests:
            return Status.skip()
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        fractions = []
        for rname in self.resources:
            alloc = node.allocatable.get(rname)
            if alloc <= 0:
                continue
            req = node.nonzero_requested.get(rname) + pod.nonzero_requests.get(rname, 0)
            fractions.append(min(req / alloc, 1.0))
        if len(fractions) < 2:
            return 0.0
        mean = sum(fractions) / len(fractions)
        var = sum((f - mean) ** 2 for f in fractions) / len(fractions)
        return (1.0 - math.sqrt(var)) * MAX_NODE_SCORE
