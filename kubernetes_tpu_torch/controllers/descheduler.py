"""Rebalance descheduler: evict-and-replace consolidation under a budget.

Parity target: the descheduler's HighNodeUtilization/LowNodeUtilization
strategies (kubernetes-sigs/descheduler) folded into the controller-manager
pattern of SURVEY §2.4 — a resync-driven reconcile loop, not a one-shot
CLI. The scheduler's optimal solve mode (r20, ops/solver.sinkhorn_plan)
packs each BATCH tightly, but a long-lived cluster fragments anyway:
completions and node churn strand capacity on half-empty nodes that
arrival-order placement can never repair. This controller closes that
loop the way production clusters do — propose moves, bound disruption,
let the scheduler re-place:

1. Snapshot nodes + bound pods from the shared informers and score every
   node with `ops/solver.consolidation_scores` — the same free/alloc
   planes the solver consumes, scored on device: occupied nodes whose
   mean free fraction clears the threshold are drain candidates,
   emptiest first (least to move, frees a whole node soonest).
2. A candidate drains only if its displaced pods AGGREGATE-FIT into the
   remaining cluster headroom (candidate excluded) — an admission check,
   not a placement: the scheduler owns placement, so the controller only
   guarantees it isn't evicting into a full cluster.
3. Evict-and-replace: delete the bound pod and create an unbound
   replacement (same spec, nodeName stripped, fresh name/uid) for the
   scheduler to place — there is no kubelet to restart containers, so
   eviction IS delete+recreate here, matching how the perf harness
   models every disruption.
4. The DISRUPTION BUDGET (`KTPU_DESCHEDULER_BUDGET`, ctor-overridable)
   caps evictions PER SYNC CYCLE; the resync period is the rate limiter
   between cycles. `descheduler_evictions_total` counts actual moves.

The ChurnDay rebalance family (perf/config/performance-config.yaml)
drives this controller against fragmenting churn and reports the
fragmentation-over-time curve with the descheduler on vs off.

Copy of `kubernetes_tpu/controllers/descheduler.py`. The scores are
computed on an explicit `device` (cuda:0 by default; the perf runner
passes its backend's), or the controller raises: there is no host
fallback. The candidate order stays the reference's host
`np.argsort(-scores)` on the fetched scores, whose tie order
`torch.argsort` does not share (uniform nodes tie all the time).
"""

from __future__ import annotations

import logging
from typing import Iterable

import numpy as np
import torch

from kubernetes_tpu_torch.api.meta import deep_copy, namespaced_name, new_uid
from kubernetes_tpu_torch.api.types import (
    node_allocatable,
    node_is_unschedulable,
    pod_is_terminal,
    pod_requests,
)
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.metrics.registry import DeschedulerMetrics
from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.store.mvcc import StoreError
from kubernetes_tpu_torch.utils import flags

logger = logging.getLogger(__name__)

#: resources excluded from the free/alloc quantity planes (pod COUNT is
#: capacity, not a packable quantity — it rides the used_pods vector).
_NON_QUANTITY = frozenset(("pods",))


class DeschedulerController(Controller):
    NAME = "descheduler"
    WORKERS = 1

    def __init__(self, store, *, period: float = 0.5,
                 budget: int | None = None, threshold: float = 0.5,
                 metrics: DeschedulerMetrics | None = None, device=None):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "DeschedulerController scores on a CUDA device; pass "
                    "device='cpu' to run the plain PyTorch ops")
            device = "cuda:0"
        super().__init__(store)
        #: where `consolidation_scores` runs.
        self.device = torch.device(device)
        self.RESYNC_PERIOD = period
        self._budget = budget
        self.threshold = threshold
        self.metrics = metrics or DeschedulerMetrics()
        #: lifetime evict-and-replace moves (the phase-delta the perf
        #: harness reads without touching the registry render).
        self.evictions = 0
        self._seq = 0

    @property
    def budget(self) -> int:
        if self._budget is not None:
            return self._budget
        return flags.get("KTPU_DESCHEDULER_BUDGET")

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")
        self.node_informer = factory.informer("nodes")

    async def resync_keys(self) -> Iterable[str]:
        return ["rebalance"]

    async def sync(self, key: str) -> None:
        if key == "rebalance":
            await self.rebalance_once()

    # -- one consolidation cycle -------------------------------------------

    async def rebalance_once(self) -> int:
        """One bounded consolidation pass; returns evictions issued."""
        nodes = [n for n in self.node_informer.indexer.list()
                 if not node_is_unschedulable(n)]
        if not nodes:
            return 0
        names = [n["metadata"]["name"] for n in nodes]
        index = {name: i for i, name in enumerate(names)}
        allocs = [node_allocatable(n) for n in nodes]
        resources = sorted({r for a in allocs for r in a
                            if r not in _NON_QUANTITY})
        if not resources:
            return 0

        n_nodes, n_res = len(nodes), len(resources)
        alloc_q = np.zeros((n_nodes, n_res), np.float32)
        for i, a in enumerate(allocs):
            for j, r in enumerate(resources):
                alloc_q[i, j] = a.get(r, 0)
        free_q = alloc_q.copy()
        used_pods = np.zeros((n_nodes,), np.int32)
        victims_by_node: dict[int, list[dict]] = {}
        for pod in self.pod_informer.indexer.list():
            if pod_is_terminal(pod):
                continue
            i = index.get(pod.get("spec", {}).get("nodeName") or "")
            if i is None:
                continue
            used_pods[i] += 1
            req = pod_requests(pod)
            for j, r in enumerate(resources):
                free_q[i, j] -= req.get(r, 0)
            victims_by_node.setdefault(i, []).append(pod)

        def put(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        scores = solver.consolidation_scores(
            put(free_q), put(alloc_q), put(used_pods),
            put(np.ones((n_nodes,), bool)),
            np.float32(self.threshold)).cpu().numpy()

        # Cluster headroom EXCLUDING each candidate: displaced pods must
        # aggregate-fit into what the rest of the cluster has free.
        total_free = np.maximum(free_q, 0.0).sum(axis=0)
        budget = max(0, int(self.budget))
        evicted = 0
        for i in np.argsort(-scores):
            if evicted >= budget or not np.isfinite(scores[i]):
                break
            victims = victims_by_node.get(int(i), [])
            if not victims or len(victims) > budget - evicted:
                continue
            need = np.zeros((n_res,), np.float32)
            for pod in victims:
                req = pod_requests(pod)
                for j, r in enumerate(resources):
                    need[j] += req.get(r, 0)
            headroom = total_free - np.maximum(free_q[i], 0.0)
            if np.any(need > headroom):
                continue
            moved = 0
            for pod in victims:
                if await self._evict(pod):
                    moved += 1
            evicted += moved
            if moved:
                # Replacements will land somewhere else: debit the
                # headroom so later candidates see the tighter cluster.
                total_free = headroom - need + np.maximum(free_q[i], 0.0)
        return evicted

    async def _evict(self, pod: dict) -> bool:
        """Evict-and-replace: delete the bound pod, create an unbound
        twin (fresh name/uid, nodeName and status stripped) for the
        scheduler to re-place."""
        repl = deep_copy(pod)
        meta = repl.setdefault("metadata", {})
        self._seq += 1
        meta["name"] = f"{meta.get('name', 'pod')}-reb{self._seq}"
        meta["uid"] = new_uid()
        for k in ("resourceVersion", "creationTimestamp",
                  "deletionTimestamp", "finalizers"):
            meta.pop(k, None)
        repl.get("spec", {}).pop("nodeName", None)
        repl["status"] = {"phase": "Pending"}
        try:
            await self.store.delete("pods", namespaced_name(pod))
        except StoreError:
            return False  # raced a completion/GC: not a move
        await self.store.create("pods", repl)
        self.evictions += 1
        self.metrics.evictions.inc()
        return True
