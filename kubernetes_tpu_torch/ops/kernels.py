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
