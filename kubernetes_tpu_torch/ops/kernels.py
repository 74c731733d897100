"""Batched (P pods × N nodes) filter-mask and score functions in PyTorch.

Counterpart of `kubernetes_tpu/ops/kernels.py`: each function is the
tensorized twin of one in-tree plugin's Filter/Score (NodeResourcesFit,
NodeResourcesBalancedAllocation, TaintToleration). They are plain tensor
ops here, as they are XLA ops in the reference; the hand-written CUDA
kernel (csrc/wave_solve.cu) repeats the score arithmetic per element.

Float association follows the reference op by op, so the CUDA kernel, this
module and the JAX functions agree to the last bit wherever the reference
does not reassociate: sums over the resource axis run in index order (an
explicit loop — R is a handful of columns), `100 * (alloc - req) /
safe_alloc`, `acc / tot_w` and `(1 - sqrt(var)) * 100`.
"""

from __future__ import annotations

import torch

MAX_NODE_SCORE = 100.0

#: Absolute slack folded into every block score upper bound (the
#: reference's value): the bound evaluates the score formulas at per-block
#: interval corners, and the slack absorbs the f32 rounding between that
#: corner evaluation and the per-column ones. A bound padded up can only
#: lose pruning, never exactness.
BLOCK_UB_EPS = 0.125

#: Sentinel for masked-out columns in per-block minima: never a real
#: minimum, and +req never overflows int32.
_BLOCK_BIG = 2 ** 30


def _sum_last(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in index order (x[..., 0] + x[..., 1] + ...)."""
    if x.shape[-1] == 0:
        return x.new_zeros(x.shape[:-1])
    acc = x[..., 0]
    for r in range(1, x.shape[-1]):
        acc = acc + x[..., r]
    return acc


# --- NodeResourcesFit: Filter ------------------------------------------------

def fit_filter_mask(alloc_q, used_q, used_pods, alloc_pods, req_q):
    """(noderesources/fit.go `fitsRequest`) feasibility of every (pod, node):
    per-resource `used + req <= alloc` AND pod-count headroom.

    alloc_q/used_q: (N,R) int32; used_pods/alloc_pods: (N,) int32;
    req_q: (P,R) int32 → (P,N) bool.
    """
    res_ok = torch.all(
        used_q[None, :, :] + req_q[:, None, :] <= alloc_q[None, :, :], dim=-1)
    pods_ok = (used_pods + 1 <= alloc_pods)[None, :]
    return res_ok & pods_ok


# --- TaintToleration: Filter -------------------------------------------------

def taint_filter_mask(node_taints, untolerated):
    """(tainttoleration `Filter`) node is infeasible iff it carries any
    NoSchedule/NoExecute taint the pod does not tolerate.

    node_taints: (N,T) bool membership; untolerated: (P,T) bool → (P,N) bool.
    """
    conflicts = torch.any(untolerated[:, None, :] & node_taints[None, :, :],
                          dim=-1)
    return ~conflicts


# --- NodeResourcesFit: Score -------------------------------------------------

def fit_score(alloc_q, used_nz_q, req_nz_q, col_weights, strategy: str,
              shape_u=None, shape_s=None):
    """(resource_allocation.go score loop) weighted mean over scoring
    resources of the per-resource strategy score; columns with zero
    allocatable are excluded from the mean (host `_score_one` skip).

    alloc_q/used_nz_q: (N,R); req_nz_q: (P,R); col_weights: (R,) float32 with
    0 for non-scored columns → (P,N) float32 in [0, 100].
    """
    alloc = alloc_q.to(torch.float32)[None, :, :]              # (1,N,R)
    req = (used_nz_q[None, :, :] + req_nz_q[:, None, :]).to(torch.float32)
    valid = (alloc > 0) & (col_weights[None, None, :] > 0)
    safe_alloc = torch.where(alloc > 0, alloc, 1.0)
    if strategy == "MostAllocated":
        s = MAX_NODE_SCORE * req / safe_alloc
    elif strategy == "RequestedToCapacityRatio":
        util = MAX_NODE_SCORE * req / safe_alloc
        s = _piecewise(util, shape_u, shape_s) * (MAX_NODE_SCORE / 10.0)
    else:  # LeastAllocated
        s = MAX_NODE_SCORE * (alloc - req) / safe_alloc
    s = torch.where(req > alloc, 0.0, s)
    w = torch.where(valid, col_weights[None, None, :], 0.0)
    tot_w = _sum_last(w)
    acc = _sum_last(s * w)
    return torch.where(tot_w > 0, acc / torch.where(tot_w > 0, tot_w, 1.0),
                       0.0)


def _piecewise(util, shape_u, shape_s):
    """Piecewise-linear shape evaluation (requested_to_capacity_ratio.go);
    shape_u/shape_s are small 1-D point arrays, util broadcasts over them."""
    u = util[..., None]                                      # (...,1)
    below = u <= shape_u[0]
    above = u >= shape_u[-1]
    # Segment interpolation: for each interval i, value if u lands in it.
    u0, u1 = shape_u[:-1], shape_u[1:]
    s0, s1 = shape_s[:-1], shape_s[1:]
    t = (u - u0) / torch.where(u1 - u0 > 0, u1 - u0, 1.0)
    seg_val = s0 + (s1 - s0) * t
    in_seg = (u > u0) & (u <= u1)
    mid = _sum_last(torch.where(in_seg, seg_val, 0.0))
    return torch.where(below[..., 0], shape_s[0],
                       torch.where(above[..., 0], shape_s[-1], mid))


# --- NodeResourcesBalancedAllocation: Score ---------------------------------

def balanced_allocation_score(alloc_q, used_nz_q, req_nz_q, col_mask):
    """(balanced_allocation.go) 100 × (1 − stddev of per-resource requested
    fractions); fractions clamped to 1; nodes with <2 scorable resources → 0.

    col_mask: (R,) bool — which columns the plugin scores over.
    """
    alloc = alloc_q.to(torch.float32)[None, :, :]
    req = (used_nz_q[None, :, :] + req_nz_q[:, None, :]).to(torch.float32)
    valid = (alloc > 0) & col_mask[None, None, :]
    frac = torch.clamp_max(req / torch.where(alloc > 0, alloc, 1.0), 1.0)
    frac = torch.where(valid, frac, 0.0)
    cnt = valid.sum(dim=-1).to(torch.float32)
    safe_cnt = torch.where(cnt > 0, cnt, 1.0)
    mean = _sum_last(frac) / safe_cnt
    d = frac - mean[..., None]
    var = _sum_last(torch.where(valid, d * d, 0.0)) / safe_cnt
    score = (1.0 - torch.sqrt(var)) * MAX_NODE_SCORE
    return torch.where(cnt >= 2, score, 0.0)


# --- chunk-start live scores -------------------------------------------------

def chunk_start_scores(alloc_q, used_nz_q, req_nz_q, static_scores,
                       fit_col_w, bal_col_mask, shape_u, shape_s,
                       w_fit, w_bal, strategy: str):
    """The full live score (static + weighted fit + weighted balanced)
    against the used state given, with the reference's association:
    `static + w_fit·fit`, then `+ w_bal·bal`. At the CHUNK-START state it
    is the optimal mode's transport cost (the greedy scorer's own value
    for every (class, node) before any pod of the chunk is placed);
    against the live state it is the scans' per-step re-score (solver).

    alloc_q/used_nz_q: (N,R); req_nz_q: (S,R); static_scores: (S,N)
    → (S,N) float32.
    """
    sc = static_scores + w_fit * fit_score(
        alloc_q, used_nz_q, req_nz_q, fit_col_w, strategy, shape_u, shape_s)
    return sc + w_bal * balanced_allocation_score(
        alloc_q, used_nz_q, req_nz_q, bal_col_mask)


# --- block-sparse node index: aggregates + bounds ---------------------------

def _block_fold(x: torch.Tensor, block_w: int, fill) -> torch.Tensor:
    """Reshape the leading N axis into (B, block_w, ...) blocks, padding the
    tail block with `fill` (the N % block_w != 0 case)."""
    n = x.shape[0]
    b = -(-n // block_w)
    pad = b * block_w - n
    if pad:
        x = torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])
    return x.reshape((b, block_w) + tuple(x.shape[1:]))


def block_capacity_aggregates(alloc_q, used_nz_q, col_real, block_w: int):
    """Per-block capacity interval planes over the REAL node columns:
    (amin_pos, amin, amax, umin, umax), each (B, R) int32.

    amin/amax/umin/umax are the real columns' min/max of allocatable and
    scoring-used; amin_pos is the min over columns with alloc > 0 (the
    denominator corner of the fit bound), while the plain amin serves the
    uniform-block arm of the exactness predicate (amin == amax certifies
    one alloc vector for every real column). Masked-out columns fold in as
    inert sentinels, so a pad-only block has min > max."""
    rmask = col_real[:, None]
    big = _BLOCK_BIG
    amax = torch.amax(_block_fold(
        torch.where(rmask, alloc_q, 0), block_w, 0), dim=1)
    amin = torch.amin(_block_fold(
        torch.where(rmask, alloc_q, big), block_w, big), dim=1)
    amin_pos = torch.amin(_block_fold(
        torch.where(rmask & (alloc_q > 0), alloc_q, big), block_w, big),
        dim=1)
    umax = torch.amax(_block_fold(
        torch.where(rmask, used_nz_q, 0), block_w, 0), dim=1)
    umin = torch.amin(_block_fold(
        torch.where(rmask, used_nz_q, big), block_w, big), dim=1)
    return amin_pos, amin, amax, umin, umax


def block_feasible_stat(feasible, static_scores, block_w: int):
    """Per-(class, block) planes of the capacity-independent score over the
    FEASIBLE columns: (stat_max, stat_min, feas_cnt), each (C, B); a block
    with no feasible column has stat_max -inf. feas_cnt is int32."""
    inf = float("inf")
    masked_max = _block_fold(
        torch.where(feasible, static_scores, -inf).T, block_w, -inf)
    masked_min = _block_fold(
        torch.where(feasible, static_scores, inf).T, block_w, inf)
    cnt = _block_fold(feasible.T.to(torch.int32), block_w, 0)
    return (torch.amax(masked_max, dim=1).T,
            torch.amin(masked_min, dim=1).T,
            cnt.sum(dim=1, dtype=torch.int32).T)


def block_score_upper_bound(stat_max, feas_cnt, amin_pos, amax, umin, umax,
                            req_nz_q, fit_col_w, bal_col_mask, shape_u,
                            shape_s, w_fit, w_bal, strategy: str):
    """(C, B) upper bound on the chunk-start live score of any feasible
    column of each block: the block-bound scan of the two-pass prefilter.

    Per resource the strategy score is evaluated at the interval corner
    that maximizes it (RequestedToCapacityRatio also checks its
    breakpoints inside the utilization interval); the weighted mean over
    scoring resources is bounded by the largest per-resource bound, the
    balanced term by its cap, and BLOCK_UB_EPS absorbs f32 corner
    rounding. Blocks with no feasible column are -inf. The element
    arithmetic is the reference's, op for op."""
    af_min = amin_pos.to(torch.float32)[None, :, :]          # (1,B,R)
    af_max = amax.to(torch.float32)[None, :, :]
    r_lo = (umin[None, :, :] + req_nz_q[:, None, :]).to(torch.float32)
    r_hi = (umax[None, :, :] + req_nz_q[:, None, :]).to(torch.float32)
    safe_max = torch.where(af_max > 0, af_max, 1.0)
    safe_min = torch.where(af_min > 0, af_min, 1.0)
    if strategy == "MostAllocated":
        s_ub = torch.clamp(MAX_NODE_SCORE * r_hi / safe_min,
                           0.0, MAX_NODE_SCORE)
    elif strategy == "RequestedToCapacityRatio":
        # Utilization corners widened a hair so rounding cannot shrink the
        # interval past a column's true utilization; no 100-cap, as
        # fit_score leaves the scaled piecewise value uncapped.
        u_lo = MAX_NODE_SCORE * r_lo / safe_max - 0.01
        u_hi = MAX_NODE_SCORE * r_hi / safe_min + 0.01
        ends = torch.maximum(_piecewise(u_lo, shape_u, shape_s),
                             _piecewise(u_hi, shape_u, shape_s))
        inside = (shape_u >= u_lo[..., None]) & (shape_u <= u_hi[..., None])
        bps = torch.amax(torch.where(inside, shape_s, float("-inf")),
                         dim=-1)
        s_ub = torch.clamp_min(torch.maximum(ends, bps)
                               * (MAX_NODE_SCORE / 10.0), 0.0)
    else:  # LeastAllocated
        s_ub = torch.clamp(MAX_NODE_SCORE * (af_max - r_lo) / safe_max,
                           0.0, MAX_NODE_SCORE)
    scored = (fit_col_w[None, None, :] > 0) & (af_max > 0)
    fit_ub = torch.amax(torch.where(scored, s_ub, 0.0), dim=-1)  # (C,B)
    # A tensor, so that w_bal · bal_ub rounds in f32 as the reference's.
    bal_ub = torch.full_like(fit_ub,
                             MAX_NODE_SCORE if float(w_bal) > 0 else 0.0)
    ub = stat_max + w_fit * fit_ub + w_bal * bal_ub + BLOCK_UB_EPS
    return torch.where(feas_cnt > 0, ub, float("-inf"))


def gathered_start_scores(alloc_g, used_nz_g, req_nz_q, static_g, fit_col_w,
                          bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                          strategy: str):
    """`chunk_start_scores` over per-row GATHERED columns: alloc_g and
    used_nz_g (S, G, R) gathers of the capacity planes, req_nz_q (S, R) and
    static_g (S, G) the matching rows → (S, G) f32. The score functions
    are elementwise over columns with sums only over R, so a gathered
    column's value is the full-width pass's, bit for bit."""
    return chunk_start_scores(alloc_g, used_nz_g, req_nz_q, static_g,
                              fit_col_w, bal_col_mask, shape_u, shape_s,
                              w_fit, w_bal, strategy)[0]


# --- TaintToleration: Score --------------------------------------------------

def taint_toleration_score(node_prefer_taints, untol_prefer, feasible):
    """(taint_toleration.go Score+NormalizeScore) raw = count of untolerated
    PreferNoSchedule taints; normalized per pod over feasible nodes to
    100×(max−count)/max (all-100 when max is 0).

    node_prefer_taints: (N,Tp) bool; untol_prefer: (P,Tp) bool;
    feasible: (P,N) bool → (P,N) float32.
    """
    counts = taint_prefer_counts(node_prefer_taints, untol_prefer)
    mx = torch.amax(torch.where(feasible, counts, float("-inf")), dim=1,
                    keepdim=True)
    return taint_normalize(counts, mx)


def taint_prefer_counts(node_prefer_taints, untol_prefer):
    """The raw TaintToleration score: (P,N) float32 counts of each pod's
    untolerated PreferNoSchedule taints on each node."""
    return torch.sum(untol_prefer[:, None, :] & node_prefer_taints[None],
                     dim=-1).to(torch.float32)


def taint_normalize(counts, row_max):
    """NormalizeScore of raw counts against each pod's largest count over
    its feasible nodes (`row_max` (P,1), -inf where none is feasible)."""
    mx = torch.clamp_min(row_max, 0.0)
    return torch.where(mx > 0, MAX_NODE_SCORE * (mx - counts) / mx,
                       MAX_NODE_SCORE)
