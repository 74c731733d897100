"""TorchBackend: the batched scheduling backend on one CUDA device.

Counterpart of `kubernetes_tpu/ops/backend.py`'s `TPUBackend`, cut to the
greedy wavefront route and the Sinkhorn optimal route of its batch cycle:
`assign(pods, snapshot, fwk)` compiles the snapshot to dense tensors
(ops/tensorize.py), dedupes each chunk's pods into equivalence classes with
(C, N) class planes (the host filter and score rows of the plugins without
device kernels), and runs one device pass per chunk — `mask_solve_update`:
plugin masks → scores → the solve → the used-state update. The reference's
solve-mode policy (`AdaptiveTuner.solve_mode`, `KTPU_SOLVE_MODE`) picks
the solve per chunk:

- greedy: the multistart wavefront solve through the hand-written kernel
  (ops/wave_kernel.py) at the tuner's width W;
- optimal (flagless, every chunk of 64 or more real pods with class
  planes below 32768 nodes): the chunk-start scores are the cost of
  `solver.sinkhorn_plan` over the class planes, and its log-plan, with
  the live weights zeroed, is rounded by the W=1 multistart scan — one
  launch of the same kernel at W=1.

The (N, 2R+1) used-state pack stays on the device and chains from chunk to
chunk with no host round trip. It is seeded at each assign() from the
snapshot, or, when the serving tier's resident planes are attached
(`resident`, serving/resident.py), from a copy of their refreshed pack.
Assignments are then verified on the host with exact integer arithmetic,
and unassigned pods get per-plugin diagnostics. Lone pods have a route of
their own beside this one: the serving fast path (serving/fastpath.py,
`solver.solve_one`), which places a pod where this cycle's first scan step
would.

Not covered by this slice, and refused with NotImplementedError rather than
scheduled on a partial model: inter-pod affinity, topology spread, resource
claims, volumes, host ports, gangs, and any plugin at a PreFilter, Filter,
PreScore or Score point beyond the six of `MODELLED_PLUGINS`
(NodeResourceTopologyMatch among them). Plugins at none of those points
(queue sort, gates, bind) are the scheduler loop's and pass.

When the scheduler attaches its metrics (`metrics`, `tracer`), each chunk
observes `scheduler_tpu_solve_seconds` (dispatch to fetched) and the
solver_* counters the reference's chunk finalization updates, for the
counters this backend keeps. The shortlist and block index and
multi-device sharding are later slices; the greedy route is the
reference's configuration with the shortlist off.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel
from kubernetes_tpu_torch.ops.tensorize import ClusterTensors, PodBatch
from kubernetes_tpu_torch.scheduler.framework import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    CycleState,
    Framework,
    Status,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
    insufficient_resources,
)
from kubernetes_tpu_torch.scheduler.plugins.registry import IN_TREE
from kubernetes_tpu_torch.scheduler.types import PodInfo, Snapshot
from kubernetes_tpu_torch.utils import flags
from kubernetes_tpu_torch.utils.locking import check_dispatch_seam

logger = logging.getLogger(__name__)

#: The Filter/Score plugins the backend models, on the device or as host
#: rows; a plugin at any of `_MODELLED_POINTS` must be one of them.
MODELLED_PLUGINS = frozenset((
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
    "NodeName", "NodeUnschedulable", "TaintToleration"))
_MODELLED_POINTS = frozenset(("PreFilter", "Filter", "PreScore", "Score"))

#: Plugins with full device kernels.
DEVICE_FILTER_PLUGINS = {"NodeResourcesFit", "TaintToleration"}
DEVICE_SCORE_PLUGINS = {
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration"}

#: Static node-predicate plugins whose (pod-spec → node row) is cacheable by
#: spec signature while the node set is unchanged.
STATIC_ROW_PLUGINS = {"NodeAffinity", "NodeName", "NodeUnschedulable"}
STATIC_SCORE_PLUGINS = {"NodeAffinity", "ImageLocality"}

#: Solve chunk when the caller does not pin one.
_DEFAULT_CHUNK = 1024

#: Gang slots per chunk in the solver's all-or-nothing masking; gangs are
#: refused by this slice, so the arrays are all zeros.
_GANG_PAD = 16

#: Pod-group label of the Coscheduling plugin (gangs).
POD_GROUP_LABEL = "scheduling.x-k8s.io/pod-group"

_HOST_REASONS = {
    "NodeAffinity": "node(s) didn't match Pod's node affinity/selector",
    "NodeName": "node didn't match the requested node name",
    "NodeUnschedulable": "node(s) were unschedulable",
}
_UNRESOLVABLE = {"NodeAffinity", "NodeName", "NodeUnschedulable"}


def class_pad() -> int:
    """Effective class cap: 0 = class planes off (per-pod fallback).
    Read per assign() so callers can flip the env knobs live."""
    if not flags.get("KTPU_CLASS_PLANES"):
        return 0
    return max(0, flags.get("KTPU_CLASS_PAD"))


def _class_rows_bucket(n_classes: int) -> int:
    """Plane row count for n_classes real classes + the reserved empty
    row 0, bucketed to a power of two (≥ 2) so plane shapes repeat."""
    rows = 2
    while rows < n_classes + 1:
        rows <<= 1
    return rows


def compress_score_wire(host_scores: np.ndarray) -> np.ndarray:
    """Wire dtype for a dirty host-score plane: f16 only while it is
    faithful (|score| ≤ 1024), else f32; non-finite scores raise."""
    import math
    if host_scores.size:
        lo, hi = float(host_scores.min()), float(host_scores.max())
        if not (math.isfinite(lo) and math.isfinite(hi)):
            raise ValueError("host score plane contains non-finite values")
        amax = max(-lo, hi)
    else:
        amax = 0.0
    return host_scores.astype(np.float16 if amax <= 1024.0 else np.float32)


def unsupported_feature(pi: PodInfo) -> str | None:
    """The first feature of this pod the slice does not model, or None."""
    if pi.has_affinity_constraints:
        return "inter-pod affinity"
    if pi.topology_spread_constraints:
        return "topology spread constraints"
    if pi.resource_claims:
        return "resource claims (dynamic resource allocation)"
    if pi.pvc_names:
        return "volumes (PersistentVolumeClaims)"
    if pi.host_ports:
        return "host ports"
    if pi.labels.get(POD_GROUP_LABEL):
        return "gang scheduling (pod groups with minMember)"
    return None


class AdaptiveTuner:
    """The policy rows of the reference's `AdaptiveTuner` that this
    package runs:

    - the wavefront width (`wave_width` and its replay-ratio shrink): W
      pods per wave, WAVE_WIDTH_SMALL below LARGE_N nodes and
      WAVE_WIDTH_LARGE above, halved at assign() boundaries while the
      measured replay fraction exceeds the ratio; KTPU_WAVE_WIDTH
      overrides it;
    - the solve mode (`solve_mode`, the KTPU_SOLVE_MODE row), with its
      OPTIMAL_MIN_PODS threshold;
    - the serving rows: the admission window (`admission_window`), the
      fast-path dispatch cap (`fast_path_cap`) and rate limit
      (`fast_path_rate_limit`), pure host policy over measured walls;
    - the block-index width (BLOCK_WIDTH), which the resident planes'
      block aggregates use."""

    LARGE_N = 32768
    #: a device round trip at or above this is relay-attached.
    LATENCY_BOUND_S = 5e-3
    #: node columns per aggregate block of the block index.
    BLOCK_WIDTH = 128
    WAVE_WIDTH_SMALL = 32
    WAVE_WIDTH_LARGE = 64
    WAVE_REPLAY_RATIO = 0.25
    WAVE_MIN_SAMPLE = 512
    #: Under `auto`, a non-gang chunk of fewer real pods keeps the greedy
    #: scan (the reference's value).
    OPTIMAL_MIN_PODS = 64
    #: Admission-window row (serving/admission.py): at or below the idle
    #: rate every pod dispatches immediately; above it the window is sized
    #: to coalesce ADMISSION_TARGET_PODS at the estimated offered rate,
    #: capped at ADMISSION_MAX_WINDOW_S (4x that on a relay-attached
    #: device). The reference's values, seeded from its 5k-node churn
    #: knee sweep.
    ADMISSION_IDLE_RATE = 300.0
    ADMISSION_TARGET_PODS = 8.0
    ADMISSION_MAX_WINDOW_S = 4e-3
    #: Fast-path dispatch cap: the largest popped dispatch worth draining
    #: pod by pod through the single-pod solve instead of one padded
    #: chunk — the ratio of the measured chunk wall to the measured
    #: fast-path wall, clamped; these seed both before any measurement.
    FAST_PATH_SEED_CHUNK_S = 0.25
    FAST_PATH_SEED_SOLVE_S = 1e-3
    #: node count the solve seed stands for; an unmeasured fast wall seeds
    #: at SEED_SOLVE_S x (n / CALIB_N), because solve_one is a full-N scan.
    FAST_PATH_SEED_CALIB_N = 5000
    FAST_PATH_CAP_MIN = 8
    FAST_PATH_CAP_MAX = 512
    #: highest share of the fast path's serial capacity (1 / fast wall)
    #: the offered rate may take before the batch path takes over.
    FAST_PATH_UTILIZATION = 0.5

    def __init__(self):
        #: the device's put+fetch round trip, seconds. The reference
        #: measures it with a probe transfer; this package has no probe
        #: yet, so the admission window reads None as a local device (0).
        self.latency_s: float | None = None
        self.n_nodes = 0
        self.wave_shrink = 1
        self.wave_commits = 0
        self.wave_replays = 0

    def solve_mode(self, p_real: int, has_gang: bool, spread: bool,
                   class_mode: bool) -> tuple[str, bool]:
        """('greedy' | 'optimal', structural_fallback) for one chunk, row
        for row the reference's policy: `greedy` pins greedy; optimal needs
        class planes and no spread; under `auto` a non-gang chunk below
        OPTIMAL_MIN_PODS real pods, or at n_nodes >= LARGE_N, stays greedy;
        a chunk the policy wants optimal but that is not eligible becomes
        greedy with the structural-fallback bit set."""
        raw = flags.get("KTPU_SOLVE_MODE")
        if raw == "greedy":
            return "greedy", False
        eligible = class_mode and not spread
        if raw == "optimal":
            return ("optimal", False) if eligible else ("greedy", True)
        if not (has_gang or p_real >= self.OPTIMAL_MIN_PODS):
            return "greedy", False
        if not has_gang and self.n_nodes >= self.LARGE_N:
            return "greedy", False
        return ("optimal", False) if eligible else ("greedy", True)

    def observe_wave(self, commits: int, replays: int) -> None:
        """Wavefront commit/replay sample from one finalized chunk."""
        self.wave_commits += commits
        self.wave_replays += replays

    def wave_width(self, chunk: int) -> int:
        override = flags.get("KTPU_WAVE_WIDTH")
        if override is not None:
            return max(1, min(override, chunk))
        w = self.WAVE_WIDTH_LARGE if self.n_nodes >= self.LARGE_N \
            else self.WAVE_WIDTH_SMALL
        return max(1, min(w // self.wave_shrink, chunk))

    @classmethod
    def _fast_wall_seed(cls, n_nodes: int) -> float:
        """Unmeasured-wall seed for the fast-path gates: SEED_SOLVE_S at
        the calibration node count, scaled linearly above it (the solve
        is a full-N scan)."""
        return cls.FAST_PATH_SEED_SOLVE_S \
            * max(1, n_nodes / cls.FAST_PATH_SEED_CALIB_N)

    @classmethod
    def fast_path_cap(cls, chunk_wall_s: float, fast_wall_s: float,
                      n_nodes: int = 0) -> int:
        """Largest dispatch the serving tier drains pod by pod through the
        fast path — pure policy over the two measured walls (the node
        count only shapes the seed while the fast wall is unmeasured)."""
        if fast_wall_s <= 0:
            fast_wall_s = cls._fast_wall_seed(n_nodes)
        if chunk_wall_s <= 0:
            chunk_wall_s = cls.FAST_PATH_SEED_CHUNK_S
        return int(min(max(chunk_wall_s / fast_wall_s,
                           cls.FAST_PATH_CAP_MIN), cls.FAST_PATH_CAP_MAX))

    @classmethod
    def fast_path_rate_limit(cls, fast_wall_s: float,
                             n_nodes: int = 0) -> float:
        """Highest estimated offered rate (pods/s) the serving tier still
        drains serially — pure policy over the measured wall."""
        if fast_wall_s <= 0:
            fast_wall_s = cls._fast_wall_seed(n_nodes)
        return cls.FAST_PATH_UTILIZATION / fast_wall_s

    @classmethod
    def admission_window(cls, latency_s: float, rate_est: float) -> float:
        """Coalesce window (seconds) for the serving admission tier — pure
        policy. 0.0 = dispatch immediately."""
        if rate_est <= cls.ADMISSION_IDLE_RATE:
            return 0.0
        cap = cls.ADMISSION_MAX_WINDOW_S
        if latency_s >= cls.LATENCY_BOUND_S:
            cap = 4.0 * cls.ADMISSION_MAX_WINDOW_S
        return min(cls.ADMISSION_TARGET_PODS / rate_est, cap)

    def decide(self) -> None:
        """Apply the replay feedback once enough pods were observed."""
        total = self.wave_commits + self.wave_replays
        if total >= self.WAVE_MIN_SAMPLE:
            if self.wave_replays > self.WAVE_REPLAY_RATIO * total \
                    and self.wave_shrink < self.WAVE_WIDTH_LARGE:
                self.wave_shrink *= 2
                logger.info("wavefront replay fraction %.0f%% -> shrink x%d",
                            100.0 * self.wave_replays / total,
                            self.wave_shrink)
            self.wave_commits = self.wave_replays = 0


def _signature(plugin_name: str, pi: PodInfo) -> str:
    if plugin_name == "NodeName":
        return pi.node_name
    if plugin_name == "NodeUnschedulable":
        return repr(sorted(
            (t.get("key", ""), t.get("operator", ""))
            for t in pi.tolerations))
    if plugin_name == "NodeAffinity":
        return repr((pi.node_selector, pi.affinity.get("nodeAffinity")))
    raise KeyError(plugin_name)


def chunk_planes(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                 taint_f_mat, taint_p_mat, class_mask, class_scores,
                 w_taint, taint_filter_on) -> dict:
    """The first half of a chunk's device pass: plugin masks and
    capacity-independent scores over (C, N) class planes, and the solver's
    inputs (per-pod request rows, free capacity, the gated class mask, the
    static score plane). Argument meanings as in `mask_solve_update`."""
    dev = alloc_q.device
    n = alloc_q.shape[0]
    # Wire decompression: masks arrive bit-packed uint8 (C, N/8)
    # big-endian, scores float16 or float32.
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    cmask = ((class_mask[:, :, None] >> shifts) & 1).reshape(
        class_mask.shape[0], -1).to(torch.bool)[:, :n]
    host_scores = class_scores.to(torch.float32)

    r = alloc_q.shape[1]
    tf = taint_f_mat.shape[1]
    used_q = used_pack[:, :r]
    used_pods = used_pack[:, 2 * r]
    c_req_q = class_pack[:, :r]
    c_untol_f = class_pack[:, 2 * r:2 * r + tf].to(torch.bool)
    c_untol_p = class_pack[:, 2 * r + tf:].to(torch.bool)
    # Per-pod request rows are class gathers; every plane stays (C, N).
    cls_long = cls_idx.long()

    fit0 = kernels.fit_filter_mask(
        alloc_q, used_q, used_pods, alloc_pods, c_req_q)         # (C,N)
    taint_ok = kernels.taint_filter_mask(taint_f_mat, c_untol_f)
    if not taint_filter_on:
        taint_ok = torch.ones_like(taint_ok)
    mask = cmask & taint_ok
    # Capacity-independent score components; fit/balanced are re-scored
    # live inside the solve. Taint normalization runs over the CLASS
    # feasible set.
    static_scores = host_scores + w_taint * kernels.taint_toleration_score(
        taint_p_mat, c_untol_p, mask & fit0)
    return dict(
        req_q=c_req_q[cls_long], req_nz_q=class_pack[:, r:2 * r][cls_long],
        free_q=alloc_q - used_q, free_pods=alloc_pods - used_pods,
        used_nz_q=used_pack[:, r:2 * r].contiguous(), mask=mask,
        static_scores=static_scores, fit0=fit0, taint_ok=taint_ok)


def plan_inputs(pl: dict, alloc_q, class_pack, cls_idx, fit_col_w,
                bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                strategy: str):
    """The optimal mode's transport problem over a chunk's class planes
    (`pl` from `chunk_planes`): (feasible (C,N) = mask ∧ chunk-start fit,
    cost (C,N) = the chunk-start live scores, row_counts (C,) f32 = pods
    per class row, padding pods counted into the empty row 0 as in the
    reference, col_cap (N,) = remaining pod slots, at least 0)."""
    r = alloc_q.shape[1]
    dev = alloc_q.device
    cost = kernels.chunk_start_scores(
        alloc_q, pl["used_nz_q"], class_pack[:, r:2 * r],
        pl["static_scores"], fit_col_w, bal_col_mask, shape_u, shape_s,
        w_fit, w_bal, strategy)
    row_counts = torch.zeros((class_pack.shape[0],), dtype=torch.float32,
                             device=dev).index_add_(
        0, cls_idx.long(),
        torch.ones(cls_idx.shape, dtype=torch.float32, device=dev))
    return (pl["mask"] & pl["fit0"], cost, row_counts,
            torch.clamp_min(pl["free_pods"], 0))


def mask_solve_update(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                      exc_col, taint_f_mat, taint_p_mat, class_mask,
                      class_scores, fit_col_w, bal_col_mask, shape_u,
                      shape_s, w_fit, w_bal, w_taint, taint_filter_on,
                      perms, gang_onehot, gang_required, strategy: str,
                      wave_w: int, solve_mode: str, sink_iters: int,
                      sink_temp: float):
    """One device pass per chunk: plugin masks → scores → assignment →
    state (the reference's `_mask_solve_update`, its greedy wavefront,
    W=1 and optimal branches).

    class_mask: (C, N/8) uint8 bit-packed host filter rows per class (row
    0 = the reserved empty class); class_scores: (C, N) f16/f32 host score
    rows; class_pack: (C, 2R+tf+tp) int32 — req_q ‖ req_nz_q ‖ untol_f ‖
    untol_p of each class's representative pod; cls_idx: (P,) pod → class
    row; exc_col: (P,) exception column (-1 = none). used_pack is the
    chained (N, 2R+1) int32 used_q ‖ used_nz_q ‖ used_pods.

    solve_mode "optimal": the Sinkhorn plan (`sink_iters` iterations, final
    temperature `sink_temp`) over the class planes, costed by the
    chunk-start scores, becomes the static scores, and the W=1 multistart
    scan rounds it with w_fit = w_bal = 0. wave_w < 2 (and every optimal
    chunk) solves with the W=1 multistart scan, wider waves with the
    wavefront scan. Nothing here reads a value back from the device.

    Returns (assign (P+5,) — the tail is [shortlist fallbacks (0), wave
    commits, wave replays, blocks scanned (0), blocks pruned (0)] —
    used_pack', fit0 (C,N), taint_ok (C,N)); the diagnostic planes are
    class-level.
    """
    pl = chunk_planes(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                      taint_f_mat, taint_p_mat, class_mask, class_scores,
                      w_taint, taint_filter_on)
    static_scores = pl["static_scores"]
    dev = alloc_q.device
    if solve_mode == "optimal":
        # Batch-optimal mode: the transport plan over the class planes,
        # then the W=1 scan rounds it against live capacity with the
        # re-scoring weights zeroed.
        static_scores, _ = solver.sinkhorn_plan(
            *plan_inputs(pl, alloc_q, class_pack, cls_idx, fit_col_w,
                         bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                         strategy), sink_iters, sink_temp)
        w_fit = w_bal = 0.0
        wave_w = 0
    solve_args = (pl["req_q"], pl["req_nz_q"], pl["free_q"], pl["free_pods"],
                  pl["used_nz_q"], alloc_q, pl["mask"], static_scores,
                  fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy)
    if wave_w > 1:
        assign, wave_com, wave_rep = \
            solver.multistart_greedy_assign_wave_kernel(
                *solve_args, wave_w, perms, gang_onehot, gang_required,
                rows=cls_idx, exc=exc_col)
    else:
        assign = solver.multistart_greedy_assign_kernel(
            *solve_args, perms, gang_onehot, gang_required, rows=cls_idx,
            exc=exc_col)
        wave_com = wave_rep = 0

    # Post-assignment state update (scatter-add of assigned requests);
    # unassigned rows scatter to a dummy row N, dropped.
    n = alloc_q.shape[0]
    hit = assign >= 0
    tgt = torch.where(hit, assign, n).long()
    inc = torch.cat([pl["req_q"], pl["req_nz_q"],
                     hit.to(torch.int32)[:, None]], dim=1)
    delta = torch.zeros((n + 1, used_pack.shape[1]), dtype=used_pack.dtype,
                        device=dev).index_add_(
        0, tgt, torch.where(hit[:, None], inc, 0))
    used_pack2 = used_pack + delta[:n]
    # Filled on the device: a tensor built from a host list is a copy that
    # waits for the card.
    tail = torch.zeros((5,), dtype=torch.int32, device=dev)
    tail[1].fill_(wave_com)
    tail[2].fill_(wave_rep)
    return (torch.cat([assign, tail]), used_pack2, pl["fit0"],
            pl["taint_ok"])


class UsedStateChain(torch.nn.Module):
    """The device-resident (N, 2R+1) int32 used-state pack (used_q ‖
    used_nz_q ‖ used_pods): seeded from the snapshot at each assign()
    entry, replaced by each chunk's post-solve pack, and corrected in
    place when the host verify rejects a placement."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.register_buffer(
            "pack", torch.zeros((0, 0), dtype=torch.int32, device=device))

    def seed(self, pack_np: np.ndarray) -> None:
        self.pack = torch.from_numpy(pack_np).to(self.pack.device)

    def advance(self, pack: torch.Tensor) -> None:
        self.pack = pack

    def fold_back(self, idx: np.ndarray, rows: np.ndarray) -> None:
        """Subtract rejected placements' (2R+1) rows at node indices."""
        self.pack.index_add_(
            0, torch.from_numpy(idx).to(self.pack.device),
            torch.from_numpy(-rows).to(self.pack.device))


class TorchBackend:
    """Batched backend: `assign(pods, snapshot, fwk)` →
    ({pod_key: node_name|None}, {pod_key: {node_name: Status}}).

    device=None means cuda:0 and raises RuntimeError when CUDA is
    unavailable; pass device="cpu" to run the kernels' plain versions."""

    def __init__(self, device=None, max_batch: int | None = None,
                 multistart: int = 4):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend needs a CUDA device; pass device='cpu' to "
                    "run the plain PyTorch versions of its kernels")
            device = "cuda:0"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # The probe-kernel gate in front of the real kernel: builds the
            # kernel library if this process has not, then checks x + 1.
            wave_kernel.probe_check()
        self.max_batch = max_batch if max_batch is not None \
            else _DEFAULT_CHUNK
        #: parallel permuted-order solves per chunk (1 = queue order only).
        self.multistart = max(1, int(multistart))
        self._tuner = AdaptiveTuner()
        self._ct: ClusterTensors | None = None
        # (plugin, sig) -> host row; valid while _row_fp matches.
        self._row_cache: dict[tuple[str, str], tuple[np.ndarray, bool]] = {}
        self._row_fp: tuple | None = None
        # Device-resident constants: clean class planes per shape, node
        # statics per snapshot, framework params, permutations, zero gangs.
        self._dev_base_mask: dict[tuple, torch.Tensor] = {}
        self._dev_zero_scores: dict[tuple, torch.Tensor] = {}
        self._dev_static: dict[str, object] = {}
        self._dev_static_fp: tuple | None = None
        self._fwk_params_cache: dict[tuple, tuple] = {}
        self._dev_perms_cache: dict[tuple, torch.Tensor] = {}
        self._dev_zero_gang: dict[int, tuple] = {}
        self.used = UsedStateChain(self.device)
        #: serving/resident.ResidentPlanes, attached by the caller that
        #: serves lone pods: assign() then seeds the chain from a copy of
        #: its refreshed pack instead of a full upload.
        self.resident = None
        #: cumulative solve counters: chunks solved, wavefront commits and
        #: replays (a poisoned chunk counts all its pods as replays);
        #: chunks solved in the optimal mode (the reference's
        #: solver_optimal_solves_total) and chunks the solve-mode policy
        #: wanted optimal but that were not eligible (no class planes) and
        #: ran greedy (solver_optimal_fallbacks_total); and the Sinkhorn
        #: iterations of the latest optimal chunk, a gauge
        #: (solver_sinkhorn_iterations).
        self.counters = {"chunks": 0, "wave_commits": 0, "wave_replays": 0,
                         "optimal_solves": 0, "optimal_fallbacks": 0,
                         "sinkhorn_iterations": 0}
        #: cumulative host-clock seconds of assign() and of its per-chunk
        #: phases: host prep, the device pass up to the assignment fetch
        #: (which waits for the device), and host verify + diagnostics.
        self.timings = {"assign_s": 0.0, "prep_s": 0.0, "device_s": 0.0,
                        "verify_s": 0.0}
        #: metrics/registry.SchedulerMetrics and utils/tracing.Tracer,
        #: attached by Scheduler.attach_backend (None: nothing observed).
        self.metrics = None
        self.tracer = None

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _tensors(self, snapshot: Snapshot) -> ClusterTensors:
        if self._ct is None or self._ct.generation != snapshot.generation:
            self._ct = ClusterTensors(snapshot, prev=self._ct)
        if self._row_fp != self._ct._static_fp:
            self._row_cache.clear()
            self._row_fp = self._ct._static_fp
        return self._ct

    # -- host rows -----------------------------------------------------------

    def _static_filter_row(self, plugin, pi: PodInfo, snapshot: Snapshot,
                           ct: ClusterTensors) -> tuple[np.ndarray, bool]:
        """(row, all_true), cached per (plugin, pod signature)."""
        key = (plugin.NAME, _signature(plugin.NAME, pi))
        hit = self._row_cache.get(key)
        if hit is None:
            state = CycleState()
            st = plugin.pre_filter(state, pi, snapshot)
            if st.is_skip() or st.is_success():
                row = np.fromiter(
                    (plugin.filter(state, pi, ni).is_success()
                     for ni in snapshot.nodes),
                    dtype=np.bool_, count=ct.n_real)
            else:
                row = np.zeros((ct.n_real,), dtype=np.bool_)
            hit = self._row_cache[key] = (row, bool(row.all()))
        return hit

    def _static_score_row(self, plugin, pi: PodInfo, snapshot: Snapshot,
                          ct: ClusterTensors) -> tuple[np.ndarray, bool]:
        """(row, any_nonzero); see _static_filter_row on caching."""
        key = (plugin.NAME + "/score", _signature(plugin.NAME, pi))
        hit = self._row_cache.get(key)
        if hit is None:
            state = CycleState()
            row = np.fromiter(
                (plugin.score(state, pi, ni) for ni in snapshot.nodes),
                dtype=np.float32, count=ct.n_real)
            hit = self._row_cache[key] = (row, bool(row.any()))
        return hit

    # -- main entry ----------------------------------------------------------

    def assign(self, pods: Sequence[PodInfo], snapshot: Snapshot,
               fwk: Framework):
        """Schedule `pods` in chunks of max_batch; each chunk's solve reads
        the used state the previous chunk left on the device."""
        pods = list(pods)
        self._check_supported(pods, fwk)
        t0 = time.perf_counter()
        ctx = self._start(pods, snapshot, fwk)
        tm = self.timings
        for k, chunk in enumerate(ctx.chunks):
            t1 = time.perf_counter()
            prep = self._prep_chunk(chunk, ctx)
            t2 = time.perf_counter()
            run = self._dispatch_chunk(prep, ctx)
            assign_np = self._fetch_assign(run, k)
            t3 = time.perf_counter()
            if self.metrics is not None:
                self.metrics.solve_duration.observe(t3 - t2)
            self._finalize_chunk(run, assign_np, ctx)
            tm["prep_s"] += t2 - t1
            tm["device_s"] += t3 - t2
            tm["verify_s"] += time.perf_counter() - t3
        tm["assign_s"] += time.perf_counter() - t0
        return ctx.assignments, ctx.diagnostics

    def _fetch_assign(self, run: dict, chunk_idx: int) -> np.ndarray:
        """Blocking device→host fetch of a chunk's assignments (it waits
        for the device pass), under a `solver.solve` span when tracing is
        on. The dispatch seam raises under KTPU_LOCK_CHECK when a lock is
        held across it."""
        check_dispatch_seam("backend.fetch_assign")
        tr = self.tracer
        span = tr.span("solver.solve", chunk=chunk_idx,
                       pods=run["batch"].p_real) \
            if tr is not None and tr.enabled else contextlib.nullcontext()
        with span:
            return run["assign_d"].cpu().numpy()

    @staticmethod
    def _check_supported(pods: list[PodInfo], fwk: Framework) -> None:
        for p in fwk.plugins:
            if _MODELLED_POINTS.isdisjoint(p.EXTENSION_POINTS):
                continue
            if p.NAME not in MODELLED_PLUGINS \
                    or IN_TREE.get(p.NAME) is not type(p):
                raise NotImplementedError(
                    f"plugin {p.NAME!r}: this slice models only "
                    f"{sorted(MODELLED_PLUGINS)} at "
                    f"{sorted(_MODELLED_POINTS)}")
        for pi in pods:
            feature = unsupported_feature(pi)
            if feature is not None:
                raise NotImplementedError(
                    f"pod {pi.key}: {feature} is not covered by this slice")

    def _start(self, pods: list[PodInfo], snapshot: Snapshot,
               fwk: Framework) -> "_AssignCtx":
        self._tuner.n_nodes = len(snapshot.nodes)
        self._tuner.decide()
        ct = self._tensors(snapshot)
        ctx = _AssignCtx()
        ctx.snapshot, ctx.fwk, ctx.ct = snapshot, fwk, ct
        ctx.class_pad = class_pad()
        ctx.chunks = [pods[lo:lo + self.max_batch]
                      for lo in range(0, len(pods), self.max_batch)]
        ctx.assignments, ctx.diagnostics = {}, {}
        ctx.working = {}
        ctx.params = self._fwk_params(fwk, ct)
        if self.resident is not None:
            # The chain is corrected in place (fold_back), so it takes a
            # copy: a batch never writes the resident planes the fast path
            # reads.
            self.used.advance(self.resident.used_pack(ct, snapshot).clone())
        else:
            self.used.seed(np.concatenate(
                [ct.used_q, ct.used_nz_q,
                 ct.used_pods.astype(np.int32)[:, None]], axis=1))
        return ctx

    def _fwk_params(self, fwk: Framework, ct: ClusterTensors) -> dict:
        """Score-plugin parameters as device tensors and float32-valued
        weights, cached per (framework, resource columns)."""
        key = (id(fwk), tuple(ct.resources))
        cached = self._fwk_params_cache.get(key)
        if cached is not None and cached[0] is fwk:
            return cached[1]
        if len(self._fwk_params_cache) > 64:
            self._fwk_params_cache.clear()
        score_plugins = {p.NAME: p for p in fwk.score_plugins}
        fit_plugin = score_plugins.get("NodeResourcesFit")
        strategy = getattr(fit_plugin, "strategy_type", "LeastAllocated")
        fit_col_w = np.zeros((len(ct.resources),), dtype=np.float32)
        if fit_plugin is not None:
            for spec in fit_plugin.score_resources:
                j = ct.r_index.get(spec["name"])
                if j is not None:
                    fit_col_w[j] = spec.get("weight", 1)
        bal_plugin = score_plugins.get("NodeResourcesBalancedAllocation")
        bal_col_mask = np.zeros((len(ct.resources),), dtype=np.bool_)
        if bal_plugin is not None:
            for r in bal_plugin.resources:
                j = ct.r_index.get(r)
                if j is not None:
                    bal_col_mask[j] = True
        shape_pts = getattr(fit_plugin, "shape", None) or [
            {"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
        w = fwk.score_weights
        filter_names = {p.NAME for p in fwk.filter_plugins}

        def f32(x) -> float:
            return float(np.float32(x))

        params = {
            "strategy": strategy,
            "fit_col_w": self._put(fit_col_w),
            "bal_col_mask": self._put(bal_col_mask),
            "shape_u": self._put(
                np.array([p["utilization"] for p in shape_pts], np.float32)),
            "shape_s": self._put(
                np.array([p["score"] for p in shape_pts], np.float32)),
            "w_fit": f32(w.get("NodeResourcesFit", 1) if fit_plugin else 0),
            "w_bal": f32(w.get("NodeResourcesBalancedAllocation", 1)
                         if bal_plugin else 0),
            "w_taint": f32(w.get("TaintToleration", 3)
                           if "TaintToleration" in score_plugins else 0),
            "taint_filter_on": "TaintToleration" in filter_names,
            "filter_names": filter_names,
        }
        self._fwk_params_cache[key] = (fwk, params)
        return params

    def _prep_chunk(self, pods: list[PodInfo], ctx: "_AssignCtx") -> dict:
        """Host side of one chunk: the class dictionary and its planes,
        the multistart permutations, the solve mode and the wavefront
        width."""
        ct, snapshot, fwk = ctx.ct, ctx.snapshot, ctx.fwk
        P = self.max_batch
        batch = PodBatch(pods, ct, P)
        N = ct.n_pad
        filter_names = {p.NAME for p in fwk.filter_plugins}
        score_plugins = {p.NAME: p for p in fwk.score_plugins}

        # Host filter rows accumulate as INTERNED references, never a (P,N)
        # plane: each applied row is content-interned once, each pod
        # carries the list of its row ids, and the class build materializes
        # ONE AND-folded row per distinct row-set. Rows with exactly one
        # allowed column (NodeName) become the pod's sparse EXCEPTION
        # column instead of splitting every pinned pod into its own class.
        row_store: dict[int, np.ndarray] = {}      # cid -> ok row (n_real,)
        _row_bytes: dict[bytes, int] = {}
        _row_memo: dict[int, tuple] = {}           # id(row) -> (cid,nnz,col)
        _row_refs: list = []                       # pin ids against reuse
        pod_rows: dict[int, list[int]] = {}        # pod -> ordered cids
        pod_pin: dict[int, int] = {}               # pod -> exception column
        infeasible: set[int] = set()               # empty mask (class 0)

        def _intern_row(row: np.ndarray) -> tuple:
            got = _row_memo.get(id(row))
            if got is None:
                b = row.tobytes()
                cid = _row_bytes.get(b)
                if cid is None:
                    cid = _row_bytes[b] = len(_row_bytes)
                    row_store[cid] = row
                nnz = int(row.sum())
                col = int(np.argmax(row)) if nnz == 1 else -1
                got = _row_memo[id(row)] = (cid, nnz, col)
                _row_refs.append(row)
            return got

        # Pods requesting resources no tracked column covers are infeasible
        # everywhere.
        unknown_res: set[int] = set()
        for i, pi in enumerate(pods):
            if ct.has_unknown_resource(pi.requests):
                infeasible.add(i)
                unknown_res.add(i)

        #: plugin -> {pod -> its (n_real,) ok row} for the diagnostics.
        host_filter_fail: dict[str, dict[int, np.ndarray]] = {}

        def _apply_interned(i: int, cid: int, nnz: int, col: int) -> None:
            if nnz == 0:
                infeasible.add(i)
            elif col >= 0:
                prev = pod_pin.get(i)
                if prev is None:
                    pod_pin[i] = col
                elif prev != col:    # two pins disagree: no node survives
                    infeasible.add(i)
            else:
                lst = pod_rows.setdefault(i, [])
                if cid not in lst:
                    lst.append(cid)

        def apply_row(pname: str, i: int, row: np.ndarray) -> None:
            if row.all():
                return
            fmap = host_filter_fail.setdefault(pname, {})
            prev = fmap.get(i)
            fmap[i] = row if prev is None else (prev & row)
            _apply_interned(i, *_intern_row(row))

        for plugin in fwk.filter_plugins:
            if plugin.NAME in DEVICE_FILTER_PLUGINS:
                continue
            for i, pi in enumerate(pods):
                if i in unknown_res:
                    continue
                row, all_true = self._static_filter_row(
                    plugin, pi, snapshot, ct)
                if not all_true:
                    apply_row(plugin.NAME, i, row)

        # Host score rows: computed over each pod's *feasible* node set only
        # (static rows ∧ taints ∧ exact fit), then the plugin's own
        # NormalizeScore, then the profile weight — interned as parts.
        score_store: dict[int, np.ndarray] = {}    # sid -> weighted row
        _score_bytes: dict[bytes, int] = {}
        pod_parts: dict[int, list[int]] = {}       # pod -> ordered sids
        fit_np: np.ndarray | None = None
        taint_np: np.ndarray | None = None
        feas_memo: dict[tuple, np.ndarray] = {}

        def _intern_score(row: np.ndarray) -> int:
            b = row.tobytes()
            sid = _score_bytes.get(b)
            if sid is None:
                sid = _score_bytes[b] = len(_score_bytes)
                score_store[sid] = row
            return sid

        def feasible_idx(i: int) -> np.ndarray:
            nonlocal fit_np, taint_np
            pk = (batch.req_class[i], batch.untol_class[i],
                  tuple(pod_rows.get(i, ())), pod_pin.get(i, -1),
                  i in infeasible)
            got = feas_memo.get(pk)
            if got is not None:
                return got
            if i in infeasible:
                got = feas_memo[pk] = np.zeros((0,), dtype=np.intp)
                return got
            if fit_np is None:
                uq = np.stack(batch.req_rows)  # (n_classes, R)
                fit_np = np.all(
                    ct.used_q[None, :, :] + uq[:, None, :]
                    <= ct.alloc_q[None, :, :], axis=-1)
                fit_np &= (ct.used_pods + 1 <= ct.alloc_pods)[None, :]
                if "TaintToleration" in filter_names:
                    ut = np.stack(batch.untol_rows)
                    taint_np = (ut.astype(np.int32)
                                @ ct.taint_filter_mat.T.astype(np.int32)) == 0
                else:
                    taint_np = np.ones(
                        (len(batch.untol_rows),
                         ct.taint_filter_mat.shape[0]), dtype=np.bool_)
            feas = fit_np[batch.req_class[i], : ct.n_real] \
                & taint_np[batch.untol_class[i], : ct.n_real]
            rows_i = pod_rows.get(i)
            if rows_i:
                feas = feas.copy()
                for cid in rows_i:
                    feas &= row_store[cid]
            pin = pod_pin.get(i)
            if pin is not None:
                keep = bool(feas[pin])
                feas = np.zeros_like(feas)
                feas[pin] = keep
            got = feas_memo[pk] = np.nonzero(feas)[0]
            return got

        for name, plugin in score_plugins.items():
            if name in DEVICE_SCORE_PLUGINS:
                continue
            w = fwk.score_weights.get(name, 1)
            for i, pi in enumerate(pods):
                if i in unknown_res:
                    continue
                if name == "NodeAffinity" and not (
                        (pi.affinity.get("nodeAffinity") or {})
                        .get("preferredDuringSchedulingIgnoredDuringExecution")):
                    continue
                row, any_nonzero = self._static_score_row(
                    plugin, pi, snapshot, ct)
                if not any_nonzero:
                    continue
                raw = {ct.node_names[j]: float(row[j])
                       for j in feasible_idx(i)}
                plugin.normalize_scores(CycleState(), pi, raw)
                if raw:
                    srow = np.zeros((ct.n_real,), dtype=np.float32)
                    for nname, s in raw.items():
                        srow[ct.name_to_idx[nname]] += w * s
                    pod_parts.setdefault(i, []).append(_intern_score(srow))

        # ---- class-dictionary plane build ----------------------------------
        # Pods dedupe into equivalence classes keyed by (request row,
        # toleration row, filter-row ids, ordered score-part ids) —
        # exception pins ride the sparse exc vector. Class 0 is the reserved
        # EMPTY class (padding pods, unknown resources, conflicting pins).
        # Overflowing the cap — or KTPU_CLASS_PLANES=0 — falls back to
        # per-pod planes (C == P, identity index), identical assignments.
        cap = ctx.class_pad
        mask_dirty = bool(pod_rows or pod_pin or infeasible)
        scores_dirty = bool(pod_parts)
        R = len(ct.resources)
        class_reps: list[int] | None = None
        class_parts: list[tuple] = []
        cls_np = exc_np = None
        if cap:
            cls_map: dict[tuple, int] = {}
            class_reps = []
            cls_np = np.zeros((P,), dtype=np.int32)
            exc_np = np.full((P,), -1, dtype=np.int32)
            for i in range(batch.p_real):
                if i in infeasible:
                    continue                                   # class 0
                pin = pod_pin.get(i)
                # A pinned pod's argmax ranges over at most one column, so
                # its score row cannot change its assignment.
                eff_parts = () if pin is not None \
                    else tuple(pod_parts.get(i, ()))
                ckey = (batch.req_class[i], batch.untol_class[i],
                        tuple(pod_rows.get(i, ())), eff_parts)
                c = cls_map.get(ckey)
                if c is None:
                    if len(class_reps) >= cap:
                        class_reps = None
                        break
                    c = cls_map[ckey] = len(class_reps) + 1
                    class_reps.append(i)
                    class_parts.append(eff_parts)
                cls_np[i] = c
                if pin is not None:
                    exc_np[i] = pin

        # The solve-mode policy row: an optimal chunk rounds its plan with
        # the W=1 scan (wave_w 0, as in the reference). Gangs and spread
        # are refused by _check_supported.
        mode, fallback = self._tuner.solve_mode(
            batch.p_real, has_gang=False, spread=False,
            class_mode=class_reps is not None)
        self.counters["optimal_fallbacks"] += int(fallback)

        if class_reps is not None:
            crows = _class_rows_bucket(len(class_reps))
            n_cls = len(class_reps)
            pack_np = np.zeros(
                (crows, 2 * R + batch.untol_filter.shape[1]
                 + batch.untol_prefer.shape[1]), dtype=np.int32)
            if n_cls:
                ridx = np.asarray(class_reps, dtype=np.intp)
                pack_np[1: n_cls + 1] = np.concatenate(
                    [batch.req_q[ridx], batch.req_nz_q[ridx],
                     batch.untol_filter[ridx].astype(np.int32),
                     batch.untol_prefer[ridx].astype(np.int32)], axis=1)
            if mask_dirty:
                mask_np = np.zeros((crows, N), dtype=np.bool_)
                rowset_memo: dict[tuple, np.ndarray] = {}
                for c, rep in enumerate(class_reps, start=1):
                    rs = tuple(pod_rows.get(rep, ()))
                    row = rowset_memo.get(rs)
                    if row is None:
                        row = np.ones((ct.n_real,), dtype=np.bool_)
                        for cid in rs:
                            row = row & row_store[cid]
                        rowset_memo[rs] = row
                    mask_np[c, : ct.n_real] = row
                dev_mask = self._put(np.packbits(mask_np, axis=1))
            else:
                mkey = ("cls", crows, n_cls, N, ct.n_real)
                dev_mask = self._dev_base_mask.get(mkey)
                if dev_mask is None:
                    mask_np = np.zeros((crows, N), dtype=np.bool_)
                    mask_np[1: n_cls + 1, : ct.n_real] = True
                    dev_mask = self._dev_base_mask[mkey] = self._put(
                        np.packbits(mask_np, axis=1))
            if scores_dirty:
                scores_np = np.zeros((crows, N), dtype=np.float32)
                for c, parts in enumerate(class_parts, start=1):
                    for sid in parts:
                        scores_np[c, : ct.n_real] += score_store[sid]
                dev_scores = self._put(compress_score_wire(scores_np))
            else:
                dev_scores = self._zero_scores(crows, N)
        else:
            # Per-pod fallback (kill switch / class overflow): C == P,
            # identity index.
            cls_np = np.arange(P, dtype=np.int32)
            exc_np = np.full((P,), -1, dtype=np.int32)
            pack_np = np.concatenate(
                [batch.req_q, batch.req_nz_q,
                 batch.untol_filter.astype(np.int32),
                 batch.untol_prefer.astype(np.int32)], axis=1)
            mask_np = np.zeros((P, N), dtype=np.bool_)
            mask_np[: batch.p_real, : ct.n_real] = True
            for i, lst in pod_rows.items():
                for cid in lst:
                    mask_np[i, : ct.n_real] &= row_store[cid]
            for i, pin in pod_pin.items():
                keep = mask_np[i, pin]
                mask_np[i, :] = False
                mask_np[i, pin] = keep
            for i in infeasible:
                mask_np[i, :] = False
            dev_mask = self._put(np.packbits(mask_np, axis=1))
            if scores_dirty:
                scores_np = np.zeros((P, N), dtype=np.float32)
                for i, parts in pod_parts.items():
                    for sid in parts:
                        scores_np[i, : ct.n_real] += score_store[sid]
                dev_scores = self._put(compress_score_wire(scores_np))
            else:
                dev_scores = self._zero_scores(P, N)

        wave_w = 0 if mode == "optimal" else self._tuner.wave_width(P)
        return {
            "pods": pods, "batch": batch,
            "dev_mask": dev_mask, "dev_scores": dev_scores,
            "dev_cls": self._put(cls_np),
            "dev_exc": self._put(exc_np),
            "dev_pack": self._put(pack_np),
            "cls_np": cls_np,
            "host_filter_fail": host_filter_fail,
            "unknown_res": unknown_res,
            "dev_perms": self._perms(pods, batch, P),
            "wave_w": wave_w,
            "solve_mode": mode,
            "optimal_fallback": fallback,
        }

    def _zero_scores(self, rows: int, n: int) -> torch.Tensor:
        z = self._dev_zero_scores.get((rows, n))
        if z is None:
            z = self._dev_zero_scores[(rows, n)] = torch.zeros(
                (rows, n), dtype=torch.float16, device=self.device)
        return z

    def _perms(self, pods: list[PodInfo], batch: PodBatch,
               P: int) -> torch.Tensor:
        """Multistart orders: identity first (ties → the queue order), then
        size-desc / size-asc / seeded shuffles, each PRIORITY-BLOCK-STABLE
        (pods move only within runs of equal priority). Padding stays in
        place. Built with numpy from a fixed seed, as the reference does."""
        K = self.multistart
        pr = batch.p_real
        if K > 1 and pr > 1:
            sizes = batch.req_q[:pr].sum(axis=1)
            prios = np.fromiter((p.priority for p in pods), dtype=np.int64,
                                count=pr)
            perms_key = (K, P, pr, sizes.tobytes(), prios.tobytes())
        else:
            perms_key = (K, P)
        dev_perms = self._dev_perms_cache.get(perms_key)
        if dev_perms is not None:
            return dev_perms
        perms = np.tile(np.arange(P, dtype=np.int32), (K, 1))
        if K > 1 and pr > 1:
            blocks = []
            lo = 0
            for hi in range(1, pr + 1):
                if hi == pr or prios[hi] != prios[lo]:
                    blocks.append((lo, hi))
                    lo = hi
            rng = np.random.default_rng(0xC0FFEE + pr)

            def fill(k, order_of):
                for lo, hi in blocks:
                    perms[k, lo:hi] = lo + order_of(lo, hi)
            fill(1, lambda lo, hi: np.argsort(
                -sizes[lo:hi], kind="stable").astype(np.int32))
            if K > 2:
                fill(2, lambda lo, hi: np.argsort(
                    sizes[lo:hi], kind="stable").astype(np.int32))
            for k in range(3, K):
                fill(k, lambda lo, hi: rng.permutation(
                    hi - lo).astype(np.int32))
        dev_perms = self._put(perms)
        if len(self._dev_perms_cache) > 64:
            self._dev_perms_cache.clear()
        self._dev_perms_cache[perms_key] = dev_perms
        return dev_perms

    def _gang_zeros(self, P: int) -> tuple:
        z = self._dev_zero_gang.get(P)
        if z is None:
            z = self._dev_zero_gang[P] = (
                torch.zeros((P, _GANG_PAD), dtype=torch.float32,
                            device=self.device),
                torch.zeros((_GANG_PAD,), dtype=torch.float32,
                            device=self.device))
        return z

    def ensure_static(self, ct: ClusterTensors) -> dict:
        """Device-resident node-static arrays (alloc, taints), refreshed
        only when the static fingerprint moves."""
        if self._dev_static_fp != ct._static_fp or \
                self._dev_static.get("alloc_shape") != ct.alloc_q.shape:
            self._dev_static = {
                "alloc_q": self._put(ct.alloc_q),
                "alloc_pods": self._put(ct.alloc_pods),
                "taint_f": self._put(ct.taint_filter_mat),
                "taint_p": self._put(ct.taint_prefer_mat),
                "alloc_shape": ct.alloc_q.shape,
            }
            self._dev_static_fp = ct._static_fp
        return self._dev_static

    def _dispatch_chunk(self, prep: dict, ctx: "_AssignCtx") -> dict:
        """Run the chunk's device pass; the used state chains on device.
        The Sinkhorn knobs are read here, per chunk, as live flags."""
        p, st = ctx.params, self.ensure_static(ctx.ct)
        prep["sink_iters"] = max(1, flags.get("KTPU_SINKHORN_ITERS"))
        assign_d, used_pack2, fit0_d, taint_ok_d = mask_solve_update(
            st["alloc_q"], self.used.pack, st["alloc_pods"],
            prep["dev_pack"], prep["dev_cls"], prep["dev_exc"],
            st["taint_f"], st["taint_p"], prep["dev_mask"],
            prep["dev_scores"], p["fit_col_w"], p["bal_col_mask"],
            p["shape_u"], p["shape_s"], p["w_fit"], p["w_bal"],
            p["w_taint"], p["taint_filter_on"], prep["dev_perms"],
            *self._gang_zeros(prep["batch"].req_q.shape[0]),
            p["strategy"], prep["wave_w"], prep["solve_mode"],
            prep["sink_iters"],
            float(np.float32(flags.get("KTPU_SINKHORN_TEMP"))))
        self.used.advance(used_pack2)
        prep["assign_d"] = assign_d
        prep["fit0_d"] = fit0_d
        prep["taint_ok_d"] = taint_ok_d
        return prep

    def _finalize_chunk(self, run: dict, assign_np: np.ndarray,
                        ctx: "_AssignCtx") -> None:
        pods, batch = run["pods"], run["batch"]
        assign = assign_np[: batch.p_real]
        # The device pass appends [shortlist fallbacks, wave commits, wave
        # replays, blocks scanned, blocks pruned]; a poisoned chunk reports
        # the padded width, clamped to the real pods here.
        wave_com = min(int(assign_np[-4]), batch.p_real)
        wave_rep = min(int(assign_np[-3]), batch.p_real)
        if run["wave_w"] > 1:
            self._tuner.observe_wave(wave_com, wave_rep)
        self.counters["chunks"] += 1
        self.counters["wave_commits"] += wave_com
        self.counters["wave_replays"] += wave_rep
        if run["solve_mode"] == "optimal":
            self.counters["optimal_solves"] += 1
            self.counters["sinkhorn_iterations"] = run["sink_iters"]
        m = self.metrics
        if m is not None:
            m.solver_scan_width.set(ctx.ct.n_real)
            m.solver_wave_width.set(max(1, run["wave_w"]))
            if wave_com:
                m.solver_wave_commits.inc(wave_com)
            if wave_rep:
                m.solver_wave_replays.inc(wave_rep)
            if run["solve_mode"] == "optimal":
                m.solver_optimal_solves.inc()
                m.solver_sinkhorn_iterations.set(run["sink_iters"])
            elif run["optimal_fallback"]:
                m.solver_optimal_fallbacks.inc()

        rejects = self._verify(pods, assign, ctx)
        # Fold verify rejections back into the device-chained used state so
        # later chunks don't see the rejected pods' resources as consumed.
        if rejects:
            r = batch.req_q.shape[1]
            idx = np.array([j for _, j in rejects], dtype=np.int64)
            rows = np.zeros((len(rejects), 2 * r + 1), dtype=np.int32)
            for k, (i, _) in enumerate(rejects):
                rows[k, :r] = batch.req_q[i]
                rows[k, r:2 * r] = batch.req_nz_q[i]
                rows[k, 2 * r] = 1
            self.used.fold_back(idx, rows)

        need_diag = [i for i, pi in enumerate(pods)
                     if ctx.assignments.get(pi.key) is None
                     and pi.key not in ctx.diagnostics]
        if need_diag:
            self._build_diagnostics(
                need_diag, pods, ctx.ct, batch,
                run["fit0_d"].cpu().numpy(), run["taint_ok_d"].cpu().numpy(),
                run["cls_np"], run["host_filter_fail"],
                ctx.params["filter_names"], ctx.diagnostics,
                run["unknown_res"])

    # -- verification --------------------------------------------------------

    def _verify(self, pods, assign, ctx: "_AssignCtx"
                ) -> list[tuple[int, int]]:
        """Exact host re-check of every solver placement against a working
        copy of its node that accumulates this assign()'s earlier
        placements. Returns [(chunk index, node index)] for rejected
        placements (the caller folds them out of the device state)."""
        snapshot, ct = ctx.snapshot, ctx.ct
        working = ctx.working
        contention = Status.unschedulable(
            "node(s) exhausted by earlier pods in the batch"
        ).with_plugin("NodeResourcesFit")
        rejects: list[tuple[int, int]] = []
        for i, pi in enumerate(pods):
            idx = int(assign[i])
            if idx < 0:
                ctx.assignments[pi.key] = None
                continue
            name = ct.node_names[idx]
            ni = working.get(name)
            if ni is None:
                ni = working[name] = snapshot.get(name).clone()
            if insufficient_resources(pi, ni):
                ctx.assignments[pi.key] = None
                ctx.diagnostics[pi.key] = {ni.name: contention}
                rejects.append((i, idx))
                continue
            ctx.assignments[pi.key] = ni.name
            ni.add_pod(pi)
        return rejects

    # -- explainability ------------------------------------------------------

    def _build_diagnostics(self, idxs, pods, ct, batch, fit0, taint_ok,
                           cls_np, host_filter_fail, filter_names,
                           diagnostics, unknown_res):
        """Per-node, per-plugin failure reasons from the class-level unsat
        planes (each pod reads its class row through cls_np) and the host
        rows the prep recorded — FitError's "0/N nodes are available"."""
        taint_st = Status.unschedulable(
            "node(s) had untolerated taint", resolvable=False
        ).with_plugin("TaintToleration")
        contention = Status.unschedulable(
            "node(s) exhausted by earlier pods in the batch"
        ).with_plugin("NodeResourcesFit")
        host_statuses = {
            name: Status.unschedulable(
                _HOST_REASONS.get(name, "node(s) filtered"),
                resolvable=name not in _UNRESOLVABLE).with_plugin(name)
            for name in host_filter_fail
        }
        n_real = ct.n_real
        names = list(ct.node_names[:n_real])
        names_hash = hash(tuple(names))
        R = ct.alloc_q.shape[1]
        weights = 1 << np.arange(R, dtype=np.int64)
        too_many = (ct.used_pods + 1 > ct.alloc_pods)[:n_real]
        res_status_cache: dict[int, Status] = {}
        taint_on = "TaintToleration" in filter_names
        for i in idxs:
            pi = pods[i]
            if i in unknown_res:
                st = Status.unschedulable(
                    "Insufficient " + ", ".join(
                        r for r in pi.requests if r not in ct.r_index),
                    resolvable=True).with_plugin("NodeResourcesFit")
                dm = DiagMap((n, st) for n in ct.node_names)
                dm.reason_counts = {r: len(ct.node_names)
                                    for r in st.reasons}
                dm.plugins = {st.plugin}
                dm.resolvable = True
                dm.banned_mask = np.zeros((n_real,), dtype=bool)
                dm.banned_nodes_hash = names_hash
                diagnostics[pi.key] = dm
                continue
            statuses = np.empty((n_real,), dtype=object)
            assigned = np.zeros((n_real,), dtype=bool)
            banned = np.zeros((n_real,), dtype=bool)
            agg: list[tuple[Status, int]] = []
            ci = int(cls_np[i])
            if taint_on:
                m = ~taint_ok[ci, :n_real]
                statuses[m] = taint_st
                assigned |= m
                banned |= m
                c = int(m.sum())
                if c:
                    agg.append((taint_st, c))
            for pname, okmap in host_filter_fail.items():
                ok_row = okmap.get(i)
                if ok_row is None:
                    continue
                m = ~ok_row[:n_real] & ~assigned
                statuses[m] = host_statuses[pname]
                assigned |= m
                if host_statuses[pname].code == \
                        UNSCHEDULABLE_AND_UNRESOLVABLE:
                    banned |= m
                c = int(m.sum())
                if c:
                    agg.append((host_statuses[pname], c))
            short = (ct.used_q + batch.req_q[i][None, :]
                     > ct.alloc_q)[:n_real]
            bits = (short @ weights) + (too_many.astype(np.int64) << R)
            bits[assigned] = -1
            for b in np.unique(bits):
                if b < 0:
                    continue
                m = bits == b
                if b == 0:
                    # Feasible at batch start but taken by earlier pods.
                    statuses[m] = contention
                    agg.append((contention, int(m.sum())))
                    continue
                st = res_status_cache.get(int(b))
                if st is None:
                    msgs = [f"Insufficient {ct.resources[r]}"
                            for r in range(R) if b & (1 << r)]
                    if b >> R:
                        msgs = ["Too many pods"] + msgs
                    st = Status.unschedulable(*msgs).with_plugin(
                        "NodeResourcesFit")
                    res_status_cache[int(b)] = st
                statuses[m] = st
                agg.append((st, int(m.sum())))
            dm = DiagMap(zip(names, statuses))
            for st, c in agg:
                for r in st.reasons:
                    dm.reason_counts[r] = dm.reason_counts.get(r, 0) + c
                if st.plugin:
                    dm.plugins.add(st.plugin)
                if st.code != UNSCHEDULABLE_AND_UNRESOLVABLE:
                    dm.resolvable = True
            dm.banned_mask = banned
            dm.banned_nodes_hash = names_hash
            diagnostics[pi.key] = dm


class DiagMap(dict):
    """Per-pod {node: Status} map with FitError's reason counts and the
    plugin set precomputed from the vectorized masks."""

    __slots__ = ("reason_counts", "plugins", "resolvable", "banned_mask",
                 "banned_nodes_hash")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.reason_counts: dict[str, int] = {}
        self.plugins: set[str] = set()
        #: any node failed with a preemption-resolvable status
        self.resolvable: bool = False
        #: (n_real,) bool — nodes rejected UnschedulableAndUnresolvable
        self.banned_mask = None
        #: hash of the node-name tuple the mask indexes
        self.banned_nodes_hash = 0


class _AssignCtx:
    """Per-assign()-call state: the chunk list, framework params,
    accumulated results, and the cross-chunk verify working nodes."""

    __slots__ = ("snapshot", "fwk", "ct", "chunks", "params",
                 "assignments", "diagnostics", "working", "class_pad")
