"""Pinned single-pod fast path: one fixed-shape C=1 solve per placement.

The batch cycle's per-pod cost is amortization — chunk build, class
interning, multistart permutations — none of which a lone pod can use. This
path is the third route: the pod's equivalence-class row solves against the
RESIDENT device planes through `ops/solver.solve_one` — the exact kernel
composition of the chunk program's first scan step (same kernels, same
order, same dtypes, same argmax tie rule), so a placement equals the batch
path's by construction (tests/test_torch_serving.py pins it with a
randomized differential against the JAX package and against
`TorchBackend.assign`).

Eligibility: a pod takes the fast path only when every plugin influence on
its placement is representable in the resident planes —

- requests covered by the tracked resource columns;
- no nominated node (preemptor retries keep their nominee-first check);
- static-row plugins (NodeAffinity/NodeName/NodeUnschedulable) allowed:
  their signature-cached rows AND into the pod's base mask (a NodeName pin
  is just a one-column mask here — a lone pod's argmax over ≤1 column
  cannot be moved by score normalization, so the batch path's
  exception-column form is assignment-identical);
- no live stateful plugin: InterPodAffinity, PodTopologySpread,
  NodePorts, the four volume plugins, NodeResourceTopologyMatch and
  DynamicResources take the pod only when their activity gates (the
  backend's `_FILTER_ACTIVE` / `_SCORE_ACTIVE`, each the plugin's own Skip
  condition) say inactive, as in the reference — a plain pod against a
  term-free cluster stays eligible, while a pod with affinity terms, a
  labeled pod under the default profile (whose default spread constraints
  score it), a pod with host ports, PersistentVolumeClaims or resource
  claims, or a pod with a zone-tracked request under
  NodeResourceTopologyMatch does not;
- not a gang member under Coscheduling: a pod with a PodGroup label is
  ineligible when the profile holds Coscheduling (its quota is the batch
  solve's all-or-nothing mask), as in the reference; without
  Coscheduling the label means nothing and the pod places like any
  other;
- no nonzero host score rows (preferred node affinity, ImageLocality on a
  node holding one of the pod's images) — score normalization is
  feasible-set relative and belongs to the chunk prep.

Anything else falls through (None) to the normal path, which also owns
diagnostics and preemption for no-fit pods. A framework holding a plugin
at PreFilter, Filter, PreScore or Score that is not one of the sixteen the
backend models (`MODELLED_PLUGINS`) raises NotImplementedError, as
`TorchBackend.assign` does; plugins at none of those points (PrioritySort,
SchedulingGates, DefaultBinder) pass. A host verify (exact
integer re-check) backstops the quantized device fit exactly like the
batch verify.

The solve runs on the backend's device: cuda:0 unless the backend was made
with device="cpu". A placement reads one value back from the device, the
node index.

Copy of `kubernetes_tpu/serving/fastpath.py`.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from kubernetes_tpu_torch.ops import solver
from kubernetes_tpu_torch.ops.backend import (
    _FILTER_ACTIVE,
    _SCORE_ACTIVE,
    DEVICE_FILTER_PLUGINS,
    DEVICE_SCORE_PLUGINS,
    STATIC_ROW_PLUGINS,
    STATIC_SCORE_PLUGINS,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
    insufficient_resources,
)
from kubernetes_tpu_torch.utils.locking import check_dispatch_seam

logger = logging.getLogger(__name__)

#: Largest refresh delta the solve fuses (solve_one_fresh). Between
#: consecutive lone-pod placements exactly one node changes (the previous
#: assume, plus its bind confirmation on the same row), occasionally two;
#: bigger deltas (the first solve after a batch dirtied a chunk's worth of
#: rows) apply through the standalone scatter and solve un-fused, as in the
#: reference.
FUSE_MAX_ROWS = 2


class SinglePodFastPath:
    def __init__(self, backend, resident, metrics=None):
        """`metrics`: a metrics/registry.SchedulerMetrics, or None; each
        recorded placement counts in `serving_fast_path_pods_total`."""
        self.backend = backend
        self.resident = resident
        self.metrics = metrics
        #: (scales, resources, req/tol signature) -> device
        #: (2R+tf+tp,) int32 class row (the solve_one req_pack).
        self._req_cache: dict[tuple, torch.Tensor] = {}
        #: (row ids, n_pad) -> device bit-packed base mask; invalidated
        #: with the backend row cache (same static fingerprint).
        self._mask_cache: dict[tuple, torch.Tensor] = {}
        self._mask_fp: tuple | None = None
        #: resident all-true mask / zero score rows per plane shape.
        self._alltrue: dict[tuple, torch.Tensor] = {}
        self._zero_scores: dict[int, torch.Tensor] = {}
        #: introspection counters (the serving tier also mirrors the
        #: success count into the metrics registry).
        self.placed = 0
        self.ineligible = 0
        self.no_fit = 0
        #: every program variant ran once (warm() completed).
        self.warmed = False
        #: cumulative host-clock seconds of try_schedule's stages: the
        #: ClusterTensors build, eligibility and cached inputs, the
        #: resident refresh with its delta upload, the solve's enqueue,
        #: and the index fetch (which waits for the device).
        self.timings = {"tensors_s": 0.0, "prep_s": 0.0, "refresh_s": 0.0,
                        "solve_s": 0.0, "fetch_s": 0.0}

    # -- eligibility --------------------------------------------------------

    def _base_rows(self, pi, snapshot, fwk, ct) -> list | None:
        """The pod's host filter rows (static plugins only), or None when
        any influence outside the fast path's vocabulary is live for it."""
        rows = []
        for plugin in fwk.filter_plugins:
            name = plugin.NAME
            if name in DEVICE_FILTER_PLUGINS:
                continue
            if name in STATIC_ROW_PLUGINS:
                row, all_true = self.backend._static_filter_row(
                    plugin, pi, snapshot, ct)
                if not all_true:
                    rows.append(row)
                continue
            gate = _FILTER_ACTIVE.get(name)
            if gate is None or gate(plugin, pi, snapshot):
                return None
        for plugin in fwk.score_plugins:
            name = plugin.NAME
            if name in DEVICE_SCORE_PLUGINS:
                continue
            if name in STATIC_SCORE_PLUGINS:
                if name == "NodeAffinity":
                    if ((pi.affinity.get("nodeAffinity") or {}).get(
                            "preferredDuringSchedulingIgnoredDuringExecution")):
                        return None
                    continue
                _, any_nonzero = self.backend._static_score_row(
                    plugin, pi, snapshot, ct)
                if any_nonzero:
                    return None
                continue
            gate = _SCORE_ACTIVE.get(name)
            if gate is None or gate(plugin, pi, snapshot):
                return None
        cosched = next(
            (pl for pl in fwk.plugins if pl.NAME == "Coscheduling"), None)
        if cosched is not None and cosched.group_key(pi):
            return None
        return rows

    # -- device inputs ------------------------------------------------------

    def _req_pack(self, pi, ct) -> torch.Tensor:
        """DEVICE-cached (2R+tf+tp,) class row for the pod's request /
        toleration signature — template pods hit this every solve, so the
        upload happens once per signature, not per placement. The cache is
        cleared with the static fingerprint (in _base_mask): the taint
        table rebuilds exactly when the fingerprint moves."""
        key = (tuple(ct.scales), tuple(ct.resources),
               repr(pi.requests), repr(pi.nonzero_requests),
               repr(pi.tolerations))
        pack = self._req_cache.get(key)
        if pack is None:
            if len(self._req_cache) > 4096:
                self._req_cache.clear()
            q, qnz = ct.quantize_requests(pi.requests, pi.nonzero_requests)
            uf = ct.taints.untolerated(pi.tolerations, "filter")
            up = ct.taints.untolerated(pi.tolerations, "prefer")
            pack = self.backend._put(np.concatenate(
                [q, qnz, uf.astype(np.int32), up.astype(np.int32)]))
            self._req_cache[key] = pack
        return pack

    def _base_mask(self, rows, ct) -> torch.Tensor:
        """Device bit-packed base mask for the pod's host-row set: the
        resident all-true plane for the (overwhelmingly common) empty set,
        one cached upload per distinct row set otherwise."""
        if self._mask_fp != ct._static_fp:
            # Static fingerprint moved (cordon, taint edit, node churn):
            # the backend row cache just reset, and row identities with
            # it — the masks derived from them are stale too, as are the
            # req packs (their untolerated vectors were built against the
            # previous taint table).
            self._mask_cache.clear()
            self._alltrue.clear()
            self._req_cache.clear()
            self._mask_fp = ct._static_fp
        if not rows:
            key = (ct.n_pad, ct.n_real)
            dev = self._alltrue.get(key)
            if dev is None:
                m = np.zeros((ct.n_pad,), dtype=np.bool_)
                m[: ct.n_real] = True
                dev = self._alltrue[key] = self.backend._put(np.packbits(m))
            return dev
        key = tuple(id(r) for r in rows) + (ct.n_pad,)
        dev = self._mask_cache.get(key)
        if dev is None:
            if len(self._mask_cache) > 1024:
                self._mask_cache.clear()
            m = np.zeros((ct.n_pad,), dtype=np.bool_)
            m[: ct.n_real] = True
            for r in rows:
                m[: ct.n_real] &= r
            dev = self._mask_cache[key] = self.backend._put(np.packbits(m))
        return dev

    def _zero_score_row(self, ct) -> torch.Tensor:
        dev = self._zero_scores.get(ct.n_pad)
        if dev is None:
            # f16 like the batch path's clean score plane (cast to f32 on
            # the device in both paths — zeros are exact either way).
            dev = self._zero_scores[ct.n_pad] = torch.zeros(
                (ct.n_pad,), dtype=torch.float16, device=self.backend.device)
        return dev

    def _tail(self, pi, fwk, ct, rows) -> tuple:
        params = self.backend._fwk_params(fwk, ct)
        return (self._base_mask(rows, ct), self._zero_score_row(ct),
                self._req_pack(pi, ct),
                params["fit_col_w"], params["bal_col_mask"],
                params["shape_u"], params["shape_s"],
                params["w_fit"], params["w_bal"], params["w_taint"],
                params["taint_filter_on"], params["strategy"])

    # -- the solve ----------------------------------------------------------

    def try_schedule(self, pi, snapshot, fwk,
                     record: bool = True) -> str | None:
        """One placement attempt. Returns the node name, or None when the
        pod is ineligible / nothing fits (the caller routes it through the
        normal path, which owns diagnostics and preemption).
        record=False is the warm-up form: full solve, nothing counted (the
        caller discards the result without assuming)."""
        backend = self.backend
        backend._check_supported([], fwk)
        tm = self.timings
        t0 = time.perf_counter()
        ct = backend._tensors(snapshot)
        t1 = time.perf_counter()
        tm["tensors_s"] += t1 - t0
        if pi.nominated_node or ct.has_unknown_resource(pi.requests):
            self.ineligible += 1
            return None
        rows = self._base_rows(pi, snapshot, fwk, ct)
        if rows is None:
            self.ineligible += 1
            return None
        static = backend.ensure_static(ct)
        tail = self._tail(pi, fwk, ct, rows)
        t2 = time.perf_counter()
        delta = self.resident.refresh(ct, snapshot)
        if delta is not None and len(delta[0]) > FUSE_MAX_ROWS:
            self.resident.apply_delta(delta)
            delta = None
        if delta is not None:
            delta = (backend._put(delta[0]), backend._put(delta[1]))
        t3 = time.perf_counter()
        if delta is None:
            idx_d = solver.solve_one(
                static["alloc_q"], self.resident._dev,
                static["alloc_pods"], static["taint_f"],
                static["taint_p"], *tail)
        else:
            # Fused refresh+solve: the dirty rows are set in a new pack and
            # the solve reads it; the refreshed pack becomes the resident
            # base.
            idx_d, pack = solver.solve_one_fresh(
                static["alloc_q"], self.resident._dev,
                delta[0], delta[1], static["alloc_pods"],
                static["taint_f"], static["taint_p"], *tail)
            self.resident.adopt(pack)
        t4 = time.perf_counter()
        check_dispatch_seam("serving.fastpath.fetch")
        idx = int(idx_d)
        t5 = time.perf_counter()
        tm["prep_s"] += t2 - t1
        tm["refresh_s"] += t3 - t2
        tm["solve_s"] += t4 - t3
        tm["fetch_s"] += t5 - t4
        if idx < 0 or idx >= ct.n_real:
            self.no_fit += 1
            return None
        name = ct.node_names[idx]
        ni = snapshot.get(name)
        if ni is None or insufficient_resources(pi, ni):
            # Quantized fit is conservative, so this is belt-and-braces:
            # route the pod through the exact batch verify instead.
            logger.warning(
                "fast path verify rejected %s on %s; rerouting", pi.key,
                name)
            self.no_fit += 1
            return None
        if record:
            self.placed += 1
            if self.metrics is not None:
                self.metrics.serving_fast_path_pods.inc()
        return name

    def warm(self, pi, snapshot, fwk) -> None:
        """Run every serve-path variant once OFF the serve path: the plain
        solve and both fused refresh buckets (idempotent deltas — row 0
        set to its current value), so the first measured placement pays no
        first-call cost (lazy device initialization, allocator growth).
        Runs even when the warm pod itself has no fit."""
        backend = self.backend
        backend._check_supported([], fwk)
        ct = backend._tensors(snapshot)
        if ct.n_real < 1 or ct.has_unknown_resource(pi.requests):
            return
        rows = self._base_rows(pi, snapshot, fwk, ct)
        if rows is None:
            return
        static = backend.ensure_static(ct)
        res = self.resident
        res.used_pack(ct, snapshot)  # ensure base + drain any pending
        tail = self._tail(pi, fwk, ct, rows)
        idx_d = solver.solve_one(
            static["alloc_q"], res._dev, static["alloc_pods"],
            static["taint_f"], static["taint_p"], *tail)
        int(idx_d)  # wait: the warm-up finishes inside warm()
        for b in range(1, FUSE_MAX_ROWS + 1):
            idx_rows = np.zeros((b,), np.int32)
            vals = np.repeat(res._pack_np[:1], b, axis=0)
            _idx, pack = solver.solve_one_fresh(
                static["alloc_q"], res._dev, backend._put(idx_rows),
                backend._put(vals), static["alloc_pods"],
                static["taint_f"], static["taint_p"], *tail)
            res.adopt(pack)
        int(_idx)
        self.warmed = True
