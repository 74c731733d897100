"""Snapshot → dense device tensors (the scheduler's "input pipeline").

This is the tensorization point called out in SURVEY §3.1 at
`cache.UpdateSnapshot` (pkg/scheduler/internal/cache/cache.go): the host-side
`Snapshot` of `NodeInfo` records is compiled into flat arrays the batched
filter/score kernels (ops/kernels.py) and the assignment solver (ops/solver.py)
consume.

Quantization design (sound-by-construction feasibility):

Resource quantities are tracked host-side in integer milli-units
(pkg/api/resource Quantity semantics). Memory in milli-bytes overflows the
float32 mantissa (256Gi ≈ 2.7e14), so device arrays use **per-resource
power-of-two quantization into int32**:

    scale_r  = 2^k, minimal k with  max_allocatable_r / 2^k < 2^20
    alloc_q  = floor(allocatable / scale)     (node capacity rounded DOWN)
    used_q   = ceil(requested   / scale)      (resident usage rounded UP)
    podreq_q = ceil(pod request / scale)      (incoming request rounded UP)

The rounding directions make the device-side fit predicate
`used_q + podreq_q <= alloc_q` *conservative*: it can never admit a placement
the exact host predicate (plugins/noderesources.insufficient_resources) would
reject, at the cost of rejecting placements within one quantum
(≈ allocatable × 2^-20) of full — negligible, and differential-tested.

Node counts (max-pods) are small ints and carried exactly.

Shapes are padded (nodes to a multiple of `NODE_PAD`, pods to the batch size)
so node add/remove churn keeps the device buffers' shapes stable.

Copy of `kubernetes_tpu/ops/tensorize.py` with the same quantization and the
same incremental builds (the full build's copy of the previous arrays, and
the O(changed) `_init_delta` off a `SchedulerCache` snapshot). Left out: the
topology coordinate planes and the control-plane shard accounting (ROADMAP
queue 1, items 6 and 7), and the caller-pinned resource prefix.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence

import numpy as np

from kubernetes_tpu_torch.api.types import (
    CPU,
    MEMORY,
    TAINT_NO_EXECUTE,
    TAINT_NO_SCHEDULE,
    TAINT_PREFER_NO_SCHEDULE,
    toleration_tolerates_taint,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

#: Node axis is padded to a multiple of this so node add/remove churn keeps
#: the device shapes stable.
NODE_PAD = 256

#: Quantized allocatable targets < 2^20 quanta → ~1e-6 relative precision.
_QUANT_BITS = 20


def _scale_for(max_value: int) -> int:
    """Smallest power-of-two scale with max_value/scale < 2^_QUANT_BITS."""
    if max_value < (1 << _QUANT_BITS):
        return 1
    return 1 << (max(0, max_value.bit_length() - _QUANT_BITS))


def _quant_floor(v: int, scale: int) -> int:
    return v // scale


def _quant_ceil(v: int, scale: int) -> int:
    return -((-v) // scale)


class TaintTable:
    """Interned (key, value, effect) taint triples split by filtering effect.

    TaintToleration's Filter only looks at NoSchedule/NoExecute; its Score
    counts untolerated PreferNoSchedule taints
    (plugins/tainttoleration — see scheduler/plugins/nodeaffinity.py).
    Node membership becomes two dense bool matrices; each pod's toleration
    list compiles to an "untolerated" bool vector host-side (tiny: pods come
    from templates, so vectors are cached by toleration signature upstream).
    """

    def __init__(self, nodes: Sequence[NodeInfo]):
        filt: dict[tuple, int] = {}
        pref: dict[tuple, int] = {}
        for ni in nodes:
            for t in ni.taints:
                trip = (t.get("key", ""), t.get("value", ""), t.get("effect", ""))
                if trip[2] in (TAINT_NO_SCHEDULE, TAINT_NO_EXECUTE):
                    filt.setdefault(trip, len(filt))
                elif trip[2] == TAINT_PREFER_NO_SCHEDULE:
                    pref.setdefault(trip, len(pref))
        self.filter_taints = [dict(key=k, value=v, effect=e) for (k, v, e) in filt]
        self.prefer_taints = [dict(key=k, value=v, effect=e) for (k, v, e) in pref]
        self._filt_idx = filt
        self._pref_idx = pref

    def node_rows(self, nodes: Sequence[NodeInfo], n_pad: int):
        nf, npf = max(1, len(self.filter_taints)), max(1, len(self.prefer_taints))
        filt = np.zeros((n_pad, nf), dtype=np.bool_)
        pref = np.zeros((n_pad, npf), dtype=np.bool_)
        for i, ni in enumerate(nodes):
            for t in ni.taints:
                trip = (t.get("key", ""), t.get("value", ""), t.get("effect", ""))
                j = self._filt_idx.get(trip)
                if j is not None:
                    filt[i, j] = True
                j = self._pref_idx.get(trip)
                if j is not None:
                    pref[i, j] = True
        return filt, pref

    def untolerated(self, tolerations: list, which: str) -> np.ndarray:
        """Bool vector over the interned taints this pod does NOT tolerate."""
        taints = self.filter_taints if which == "filter" else self.prefer_taints
        out = np.zeros((max(1, len(taints)),), dtype=np.bool_)
        for j, taint in enumerate(taints):
            if not any(toleration_tolerates_taint(t, taint) for t in tolerations):
                out[j] = True
        return out


class ClusterTensors:
    """Dense, device-ready view of one Snapshot.

    Rebuilt when the snapshot generation moves. Given the previous view
    (`prev`), a build re-quantizes only the rows of nodes whose generation
    moved, and reuses the taint interning while the node set and node
    objects are unchanged.
    """

    def __init__(self, snapshot: Snapshot,
                 prev: "ClusterTensors | None" = None):
        nodes = snapshot.nodes
        self.generation = snapshot.generation
        #: incremental-prep handles (SchedulerCache stamps them on its
        #: snapshots; -1 = unknown, the full-walk path).
        self.set_epoch = getattr(snapshot, "set_epoch", -1)
        self.spec_seq = getattr(snapshot, "spec_seq", -1)
        if self._init_delta(snapshot, prev):
            return
        self.node_names = [ni.name for ni in nodes]
        self.name_to_idx = {n: i for i, n in enumerate(self.node_names)}
        self.n_real = len(nodes)
        self.n_pad = max(NODE_PAD, math.ceil(max(1, self.n_real) / NODE_PAD) * NODE_PAD)

        # Resource columns: cpu, memory, then every other resource
        # allocatable on any node. A resource absent from *all* nodes stays
        # untracked: the host path would reject such a pod on every node
        # anyway ("Insufficient <r>"), which is exactly what the backend
        # reports for it.
        seen = {CPU: None, MEMORY: None}
        for ni in nodes:
            for r in ni.allocatable.res:
                seen.setdefault(r, None)
        self.resources = list(seen)
        self.r_index = {r: j for j, r in enumerate(self.resources)}
        R = len(self.resources)

        # Per-resource power-of-two scales (see module docstring).
        max_alloc = [1] * R
        for ni in nodes:
            for j, r in enumerate(self.resources):
                a = ni.allocatable.get(r)
                if a > max_alloc[j]:
                    max_alloc[j] = a
        self.scales = [_scale_for(m) for m in max_alloc]

        N, sc = self.n_pad, self.scales
        self.node_gens = [ni.generation for ni in nodes]

        # Incremental path: when the node set and columns are unchanged vs
        # the previous tensors, copy the previous arrays and re-quantize
        # only nodes whose generation advanced. Fresh copies, never in
        # place: a CPU tensor made with torch.from_numpy shares the
        # array's memory.
        incremental = (
            prev is not None and prev.node_names == self.node_names
            and prev.resources == self.resources and prev.n_pad == N
            and prev.scales == self.scales)
        if incremental:
            self.alloc_q = prev.alloc_q.copy()
            self.used_q = prev.used_q.copy()
            self.used_nz_q = prev.used_nz_q.copy()
            self.alloc_pods = prev.alloc_pods.copy()
            self.used_pods = prev.used_pods.copy()
            changed = [i for i, g in enumerate(self.node_gens)
                       if prev.node_gens[i] != g]
        else:
            self.alloc_q = np.zeros((N, R), dtype=np.int32)
            self.used_q = np.zeros((N, R), dtype=np.int32)
            self.used_nz_q = np.zeros((N, R), dtype=np.int32)
            self.alloc_pods = np.zeros((N,), dtype=np.int32)
            self.used_pods = np.zeros((N,), dtype=np.int32)
            changed = range(len(nodes))
        for i in changed:
            ni = nodes[i]
            for j, r in enumerate(self.resources):
                self.alloc_q[i, j] = _quant_floor(ni.allocatable.get(r), sc[j])
                self.used_q[i, j] = _quant_ceil(ni.requested.get(r), sc[j])
                self.used_nz_q[i, j] = _quant_ceil(ni.nonzero_requested.get(r), sc[j])
            self.alloc_pods[i] = ni.allocatable.pods
            self.used_pods[i] = ni.requested.pods

        # Padding rows have zero capacity → never feasible.
        # Taints: reuse the interning when the static fingerprint matches.
        # Keyed on the monotonic spec_epoch (NOT id(node): a recycled dict
        # address could falsely match and serve stale taint matrices).
        #: node-static fingerprint: also keys the host filter/score row
        #: cache and the fast path's device caches.
        fp = tuple((ni.name, ni.spec_epoch) for ni in nodes)
        if prev is not None and prev._static_fp == fp and prev.n_pad == N:
            self.taints = prev.taints
            self.taint_filter_mat = prev.taint_filter_mat
            self.taint_prefer_mat = prev.taint_prefer_mat
        else:
            self.taints = TaintTable(nodes)
            self.taint_filter_mat, self.taint_prefer_mat = \
                self.taints.node_rows(nodes, N)
        self._static_fp = fp

    def _init_delta(self, snapshot: Snapshot,
                    prev: "ClusterTensors | None") -> bool:
        """Incremental build off the cache's event stream.

        When the node SET and every node OBJECT are unchanged since
        `prev` (set_epoch / spec_seq match) and the cache's changed-log
        still covers prev.generation, every O(N) walk of the full build
        is skipped: the static pieces (names, resource columns, scales,
        allocatable, taints) are SHARED with prev — spec_seq pins them
        identical — while the used-state arrays are copied and only the
        rows of nodes whose generation advanced are re-quantized.
        O(changed) per generation instead of O(N). Node order is
        untouched, so assignments (and the index tie rule) stay
        identical to the full build."""
        if prev is None or self.set_epoch < 0 \
                or self.set_epoch != getattr(prev, "set_epoch", -2) \
                or self.spec_seq != getattr(prev, "spec_seq", -2):
            return False
        changed_fn = getattr(snapshot, "changed_since", None)
        if changed_fn is None:
            return False
        changed = changed_fn(prev.generation)
        if changed is None:
            return False
        nodes = snapshot.nodes
        if len(nodes) != prev.n_real:
            return False  # stale epoch counters: take the full walk
        self.node_names = prev.node_names
        self.name_to_idx = prev.name_to_idx
        self.n_real = prev.n_real
        self.n_pad = prev.n_pad
        self.resources = prev.resources
        self.r_index = prev.r_index
        self.scales = prev.scales
        self.alloc_q = prev.alloc_q
        self.alloc_pods = prev.alloc_pods
        self.taints = prev.taints
        self.taint_filter_mat = prev.taint_filter_mat
        self.taint_prefer_mat = prev.taint_prefer_mat
        self._static_fp = prev._static_fp
        self.node_gens = list(prev.node_gens)
        self.used_q = prev.used_q.copy()
        self.used_nz_q = prev.used_nz_q.copy()
        self.used_pods = prev.used_pods.copy()
        sc = self.scales
        for i in changed:
            ni = nodes[i]
            self.node_gens[i] = ni.generation
            for j, r in enumerate(self.resources):
                self.used_q[i, j] = _quant_ceil(ni.requested.get(r), sc[j])
                self.used_nz_q[i, j] = _quant_ceil(
                    ni.nonzero_requested.get(r), sc[j])
            self.used_pods[i] = ni.requested.pods
        return True

    # -- per-pod compilation -------------------------------------------------

    def quantize_requests(self, requests: Mapping[str, int],
                          nonzero: Mapping[str, int]) -> tuple[np.ndarray, np.ndarray]:
        R = len(self.resources)
        q = np.zeros((R,), dtype=np.int32)
        qnz = np.zeros((R,), dtype=np.int32)
        for r, v in requests.items():
            j = self.r_index.get(r)
            if j is not None:
                q[j] = _quant_ceil(v, self.scales[j])
        for r, v in nonzero.items():
            j = self.r_index.get(r)
            if j is not None:
                qnz[j] = _quant_ceil(v, self.scales[j])
        return q, qnz

    def has_unknown_resource(self, requests: Mapping[str, int]) -> bool:
        """A pod requesting a resource no column tracks. Columns cover every
        resource allocatable on any node, so this means the resource exists
        nowhere in the cluster — infeasible on every node, same verdict the
        host path reaches ("Insufficient <r>"). The backend masks the pod
        out rather than silently dropping the constraint."""
        return any(r not in self.r_index for r, v in requests.items() if v)


class PodBatch:
    """Device-ready view of one batch of pending pods (padded to `p_pad`)."""

    def __init__(self, pods: Sequence[PodInfo], ct: ClusterTensors, p_pad: int):
        self.pods = list(pods)
        P = p_pad
        R = len(ct.resources)
        self.req_q = np.zeros((P, R), dtype=np.int32)
        self.req_nz_q = np.zeros((P, R), dtype=np.int32)
        tf = ct.taint_filter_mat.shape[1]
        tp = ct.taint_prefer_mat.shape[1]
        self.untol_filter = np.zeros((P, tf), dtype=np.bool_)
        self.untol_prefer = np.zeros((P, tp), dtype=np.bool_)
        # Row vectors cached by signature: workload pods come from
        # templates (the reference's equivalence-class observation), so
        # distinct request shapes / toleration lists are few per batch.
        tol_cache: dict[str, tuple[int, np.ndarray, np.ndarray]] = {}
        req_cache: dict[str, tuple[int, np.ndarray, np.ndarray]] = {}
        #: per-pod equivalence-class ids (index into the unique-row
        #: lists). These are the first two components of the backend's
        #: CLASS-DICTIONARY plane key (ops/backend._prep_chunk): the
        #: device ships (C,N) class planes + a (P,) index built on top
        #: of them, and the host score memos key their per-class
        #: normalization on the same ids — so the per-(P,N) broadcasts
        #: AND the per-pod plane uploads both collapse to per-class.
        self.req_class = np.zeros((P,), dtype=np.int32)
        self.untol_class = np.zeros((P,), dtype=np.int32)
        self.req_rows: list[np.ndarray] = []
        self.untol_rows: list[np.ndarray] = []
        for i, pi in enumerate(pods):
            rsig = repr(pi.requests) + "|" + repr(pi.nonzero_requests)
            rows = req_cache.get(rsig)
            if rows is None:
                q, qnz = ct.quantize_requests(
                    pi.requests, pi.nonzero_requests)
                rows = req_cache[rsig] = (len(self.req_rows), q, qnz)
                self.req_rows.append(q)
            cls, self.req_q[i], self.req_nz_q[i] = rows
            self.req_class[i] = cls
            sig = repr(pi.tolerations)
            cached = tol_cache.get(sig)
            if cached is None:
                uf = ct.taints.untolerated(pi.tolerations, "filter")
                up = ct.taints.untolerated(pi.tolerations, "prefer")
                cached = tol_cache[sig] = (len(self.untol_rows), uf, up)
                self.untol_rows.append(uf)
            tcls, self.untol_filter[i], self.untol_prefer[i] = cached
            self.untol_class[i] = tcls
        # Padding pods: no requests, all-false masks are applied by the
        # backend (their base mask row is zero), so they never get assigned.
        self.p_real = len(pods)
