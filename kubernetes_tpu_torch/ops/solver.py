"""Batched pod→node assignment in PyTorch: the greedy wavefront solve and
the Sinkhorn optimal mode.

Counterpart of `kubernetes_tpu/ops/solver.py`, cut to the greedy
multistart wavefront route, the shortlist-pruned solve and its block
prefilter, the batch-optimal route, the spread scans and the serving fast
path's single-pod solve, with the descheduler's `consolidation_scores`
beside the fragmentation gauges. The reference's
`lax.scan`s become Python loops over device tensors here; on the CUDA
device the main paths do not run them: `multistart_greedy_assign_wave_kernel`
and `multistart_greedy_assign_kernel` hand the whole chunk to the
hand-written kernel (ops/wave_kernel.py), and these loops are its plain
version.

Contract (the reference's, unchanged):

- `greedy_assign_rescoring` — one pod per step in queue order; each step
  masks by remaining capacity, re-scores the capacity-dependent plugins
  against the live used state, picks argmax (ties → lowest node index)
  and debits the node.
- `_rescoring_wave_scan` — W pods per step against the same carry:
  prefix-distinct speculative picks, a pairwise re-score of same-wave
  debits that proves each pick serial-equivalent, and a serial replay of
  a conflicted wave (`poison=False`) or a poison flag (`poison=True`, the
  multistart form). Assignments equal the W=1 scan at every W.
- multistart: K permuted orders, gang all-or-nothing filtering, keep the
  order that places the most pods (then the most request volume); the
  identity order wins ties. Any poisoned order reruns the whole chunk
  one pod per step.
- `sinkhorn_plan` — the optimal mode's entropic transport plan over the
  (C, N) class planes; its sanitized log-plan becomes the static scores
  of the W=1 multistart rounding with the live weights zeroed.
- `solve_one` / `solve_one_fresh` — the serving fast path's lone pod
  against the resident planes: the batch scan's first step, exactly.
- the shortlist-pruned scans (`greedy_assign_rescoring_shortlist`, its
  wave, multistart and spread forms) — the same assignments from each
  class's top-K columns and the nodes debited so far, with a fallback to
  the full row (or a whole-chunk rerun) where a step cannot prove its
  winner; `shortlist_prefilter` / `block_bound_prefilter` build the
  shortlists. PyTorch ops on the card too, one CUDA graph replay per pod
  or wave.
- `greedy_assign_rescoring_spread` and its wave form — the scan with
  PodTopologySpread's hard constraints gating each step and the domain
  counts of a union table (`SpreadTable`) in its carry; identity order.
  These are the card's path too (there is no hand kernel for them, as
  the reference's is an XLA scan): one CUDA graph replay per pod or
  wave.

Class-dictionary planes: `mask`/`static_scores` are (C, N) rows addressed
per pod through `rows`; `exc` is the sparse per-pod exception column
(-1 = none, else the one node the pod is additionally restricted to).
"""

from __future__ import annotations

import numpy as np
import torch

from kubernetes_tpu_torch.ops import kernels

NEG_INF = float("-inf")


def _argmax_low(masked: torch.Tensor, nbig: int) -> torch.Tensor:
    """Index of the max of a 1-D score row, ties to the LOWEST index;
    `nbig` when every entry is -inf (nothing fits)."""
    b = torch.amax(masked)
    iota = torch.arange(masked.shape[0], dtype=torch.int32,
                        device=masked.device)
    y = torch.amin(torch.where(masked == b, iota, nbig))
    return torch.where(b > NEG_INF, y, nbig).to(torch.int32)


def greedy_assign_rescoring(req_q, req_nz_q, free_q, free_pods, used_nz_q,
                            alloc_q, mask, static_scores, fit_col_w,
                            bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                            strategy: str, rows=None, exc=None):
    """Sequential-equivalent greedy with live re-scoring, one pod per step
    (the reference's W=1 `lax.scan`). Returns (P,) int32, -1 = no fit."""
    n = free_q.shape[0]
    p = req_q.shape[0]
    dev = free_q.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if rows is None:
        rows = torch.arange(p, dtype=torch.int32, device=dev)
    rows = rows.long()
    used_nz = used_nz_q
    out = []
    for i in range(p):
        req, req_nz, row = req_q[i], req_nz_q[i], rows[i]
        m = mask[row]
        if exc is not None:
            m = m & ((exc[i] < 0) | (iota == exc[i]))
        fits = m & torch.all(req[None, :] <= free_q, dim=1) & (free_pods >= 1)
        sc = kernels.chunk_start_scores(
            alloc_q, used_nz, req_nz[None, :], static_scores[row][None, :],
            fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
            strategy)[0]
        idx = _argmax_low(torch.where(fits, sc, NEG_INF), n)
        hit = iota == idx
        free_q = free_q - torch.where(hit[:, None], req[None, :], 0)
        free_pods = free_pods - hit.to(torch.int32)
        used_nz = used_nz + torch.where(hit[:, None], req_nz[None, :], 0)
        out.append(torch.where(idx < n, idx, -1))
    return torch.stack(out).to(torch.int32)


def multistart_greedy_assign(req_q, req_nz_q, free_q, free_pods,
                             used_nz_q, alloc_q, mask, static_scores,
                             fit_col_w, bal_col_mask, shape_u, shape_s,
                             w_fit, w_bal, strategy, perms, gang_onehot,
                             gang_required, rows=None, exc=None):
    """K permuted one-pod-per-step scans + gang all-or-nothing + the best
    order (the reference's `multistart_greedy_assign` and its
    `_multistart_body`; perms[0] is the identity and wins ties): the plain
    version of `multistart_greedy_assign_kernel`. Only the small per-pod
    vectors permute; the (C, N) planes are addressed through `rows[perm]`.
    Returns (P,) int32."""
    P = req_q.shape[0]
    if rows is None:
        rows = torch.arange(P, dtype=torch.int32, device=req_q.device)
    assigns = []
    for perm in perms.long():
        a = greedy_assign_rescoring(
            req_q[perm], req_nz_q[perm], free_q, free_pods, used_nz_q,
            alloc_q, mask, static_scores, fit_col_w, bal_col_mask,
            shape_u, shape_s, w_fit, w_bal, strategy, rows=rows[perm],
            exc=None if exc is None else exc[perm])
        assigns.append(_unpermute(a, perm))
    return _select_best(torch.stack(assigns), req_q, gang_onehot,
                        gang_required)


def _unpermute(a, perm):
    """Permuted-order results back to pod order: out[perm[i]] = a[i]."""
    out = torch.empty_like(a)
    out[perm.long()] = a
    return out


def _best_of_orders(assigns_p, perms, req_q, gang_onehot, gang_required):
    """`_select_best` over the (K, P) assignments of the K orders, each in
    its PERMUTED pod coordinates (the kernel's output)."""
    assigns = torch.stack([_unpermute(a, perm)
                           for a, perm in zip(assigns_p, perms)])
    return _select_best(assigns, req_q, gang_onehot, gang_required)


def multistart_greedy_assign_kernel(req_q, req_nz_q, free_q, free_pods,
                                    used_nz_q, alloc_q, mask, static_scores,
                                    fit_col_w, bal_col_mask, shape_u,
                                    shape_s, w_fit, w_bal, strategy: str,
                                    perms, gang_onehot, gang_required,
                                    rows=None, exc=None):
    """`multistart_greedy_assign` with every order's one-pod-per-step scan
    in ONE launch of the hand-written kernel: `wave_kernel.wave_solve` at
    W=1 with poison=False (a one-member wave never conflicts), then
    `_select_best`. The route of the optimal mode's rounding and of W < 2.
    It reads nothing back from the card. Returns (P,) int32."""
    from kubernetes_tpu_torch.ops import wave_kernel  # local: import cycle

    if rows is None:
        rows = torch.arange(req_q.shape[0], dtype=torch.int32,
                            device=req_q.device)
    assigns_p, _, _, _ = wave_kernel.wave_solve(
        req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
        w_bal, strategy, 1, rows, exc, poison=False, perms=perms)
    return _best_of_orders(assigns_p, perms, req_q, gang_onehot,
                           gang_required)


def _select_best(assigns, req_q, gang_onehot, gang_required):
    """Gang-filter K candidate assignments and keep the best order."""
    eff = torch.stack([gang_filter(a, gang_onehot, gang_required)
                       for a in assigns])
    placed = eff >= 0
    n_placed = placed.sum(dim=1).to(torch.float32)
    # Tie-break on total placed request volume: at equal pod count the
    # order that consumes MORE capacity strands less. Full ties → lowest
    # k (identity = oracle).
    sizes = req_q.sum(dim=1).to(torch.float32)                  # (P,)
    vol = torch.where(placed, sizes[None, :], 0.0).sum(dim=1)
    vol_norm = vol / torch.clamp_min(torch.amax(vol), 1.0)
    best = _argmax_low(n_placed + 0.5 * vol_norm, assigns.shape[0])
    # index_select, not eff[best]: a 0-d tensor index is read back to the
    # host, which would wait for the card.
    return eff.index_select(0, best.long().reshape(1))[0]


def gang_filter(assign, gang_onehot, gang_required):
    """Drop placements of gangs below their required member count."""
    placed = (assign >= 0).to(torch.float32)
    counts = (placed[:, None] * gang_onehot).sum(dim=0)        # (G,)
    gang_ok = (counts >= gang_required).to(torch.float32)
    pod_in_gang = gang_onehot.sum(dim=1) > 0
    pod_ok = (gang_onehot * gang_ok[None, :]).sum(dim=1) > 0
    keep = (assign >= 0) & (pod_ok | ~pod_in_gang)
    return torch.where(keep, assign, -1)


# ---------------------------------------------------------------------------
# Speculative wavefront: W pods per step with exact conflict replay.
# ---------------------------------------------------------------------------

def _wave_split(wave_w: int, arrays):
    """Pad the pod axis to a multiple of wave_w and reshape each array to
    (n_waves, wave_w, ...). Returns the reshaped arrays plus the matching
    real-pod mask (padding members never fit, never commit, never
    conflict)."""
    p = arrays[0].shape[0]
    pad = (-p) % wave_w
    out = []
    for a in arrays:
        if pad:
            a = torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
        out.append(a.reshape((-1, wave_w) + tuple(a.shape[1:])))
    dev = arrays[0].device
    real = (torch.arange(p + pad, device=dev) < p).reshape(-1, wave_w)
    return out, real


def _wave_spec_picks(masked, node_of, nbig: int, wave_w: int):
    """Prefix-distinct speculative picks for one wave: member w takes the
    max over slots whose node no earlier member picked, resolved to the
    LOWEST node id among ties — the serial argmax rule over the
    not-yet-debited nodes. Returns (b (W,) f32 scores, y (W,) int32 node
    ids, nbig = no pick)."""
    bs, ys = [], []
    for w in range(wave_w):
        row = masked[w]
        if ys:
            # The earlier picks masked out in one compare, not one per pick.
            taken = torch.any(node_of[w][..., None] == torch.stack(ys),
                              dim=-1)
            row = torch.where(taken, NEG_INF, row)
        b = torch.amax(row)
        y = torch.amin(torch.where(row == b, node_of[w], nbig))
        ys.append(torch.where(b > NEG_INF, y, nbig).to(torch.int32))
        bs.append(b)
    return torch.stack(bs), torch.stack(ys)


def _wave_conflicts(b, y, nbig, req, req_nz, free_q, free_pods, used_nz,
                    alloc_q, m_pair, stat_pair, fit_col_w, bal_col_mask,
                    shape_u, shape_s, w_fit, w_bal, strategy,
                    extra_ok=None):
    """(W,) conflict bits: member w's speculative pick is invalidated by an
    earlier member's commit in the same wave. For each committed node y_j
    (j < w), re-score it FOR POD w after pod j's debit; member w conflicts
    iff some y_j stays feasible for it and beats its pick under the serial
    order (strictly higher score, or equal score at a lower node index).
    `m_pair`/`stat_pair` (W, W): pod w's gated mask / static score at y_j;
    `extra_ok` (W, W) optionally folds a variant's gate (spread) into the
    feasibility.
    """
    W = y.shape[0]
    n = free_q.shape[0]
    hit = y < nbig
    safe = torch.clamp_max(y, n - 1).long()
    fr_j = free_q[safe] - req                                  # (W,R)
    fp_j = free_pods[safe] - 1                                 # (W,)
    unz_j = used_nz[safe] + req_nz                             # (W,R)
    al_j = alloc_q[safe]
    upd = kernels.chunk_start_scores(
        al_j, unz_j, req_nz, stat_pair, fit_col_w, bal_col_mask, shape_u,
        shape_s, w_fit, w_bal, strategy)                       # (W,W)
    cap = torch.all(req[:, None, :] <= fr_j[None, :, :], dim=-1)
    feas = m_pair & cap & (fp_j >= 1)[None, :] & hit[None, :]
    if extra_ok is not None:
        feas = feas & extra_ok
    beats = feas & ((upd > b[:, None])
                    | ((upd == b[:, None]) & (y[None, :] < y[:, None])))
    w_iota = torch.arange(W, device=y.device)
    tri = w_iota[None, :] < w_iota[:, None]                    # j < w
    return torch.any(beats & tri, dim=1)


def _rescoring_wave_scan(req_q, req_nz_q, free_q, free_pods, used_nz_q,
                         alloc_q, mask, static_scores, fit_col_w,
                         bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                         strategy: str, wave_w: int, rows, exc,
                         poison: bool):
    """The wavefront scan of one pod order. poison=False replays a
    conflicted wave serially (exact); poison=True always commits and the
    first conflict poisons the scan. Returns (assign (P,) int32, commits,
    replays, poisoned)."""
    n = free_q.shape[0]
    p = req_q.shape[0]
    dev = free_q.device
    W = max(1, min(wave_w, p))
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    ex = torch.full((p,), -1, dtype=torch.int32, device=dev) \
        if exc is None else exc
    (req_w, req_nz_w, rows_w, ex_w), real_w = _wave_split(
        W, (req_q, req_nz_q, rows, ex))
    used_nz = used_nz_q
    ncom = nrep = 0
    pois = False
    outs = []
    for i, (req, req_nz, row, e, real) in enumerate(zip(
            req_w, req_nz_w, rows_w, ex_w, real_w)):
        rl = row.long()
        m = mask[rl]                                           # (W,N)
        m = m & ((e < 0)[:, None] | (iota_n[None, :] == e[:, None]))
        m = m & real[:, None]
        fits = m & torch.all(req[:, None, :] <= free_q[None, :, :],
                             dim=-1) & (free_pods >= 1)[None, :]
        sc = kernels.chunk_start_scores(
            alloc_q, used_nz, req_nz, static_scores[rl], fit_col_w,
            bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy)
        masked = torch.where(fits, sc, NEG_INF)
        node_of = iota_n[None, :].expand(masked.shape)
        b, y = _wave_spec_picks(masked, node_of, n, W)
        safe = torch.clamp_max(y, n - 1).long()
        nreal = min(W, p - i * W)
        # A one-member wave has no earlier member to conflict with.
        any_conflict = W > 1 and bool(_wave_conflicts(
            b, y, n, req, req_nz, free_q, free_pods, used_nz, alloc_q,
            m[:, safe], static_scores[rl[:, None], safe[None, :]],
            fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
            strategy).any())
        if poison or not any_conflict:
            hit = y < n
            free_q = free_q.index_add(
                0, safe, torch.where(hit[:, None], -req, 0))
            free_pods = free_pods.index_add(
                0, safe, torch.where(hit, -1, 0).to(free_pods.dtype))
            used_nz = used_nz.index_add(
                0, safe, torch.where(hit[:, None], req_nz, 0))
            outs.append(torch.where(hit, y, -1))
            ncom += nreal
            pois = pois or any_conflict
            continue
        out = []
        for w in range(W):
            rq, rnz = req[w], req_nz[w]
            fits_w = m[w] & torch.all(rq[None, :] <= free_q, dim=1) \
                & (free_pods >= 1)
            scw = kernels.chunk_start_scores(
                alloc_q, used_nz, rnz[None, :],
                static_scores[rl[w]][None, :], fit_col_w, bal_col_mask,
                shape_u, shape_s, w_fit, w_bal, strategy)[0]
            idx = _argmax_low(torch.where(fits_w, scw, NEG_INF), n)
            hitw = idx < n
            sf = torch.clamp_max(idx, n - 1).long().reshape(1)
            free_q = free_q.index_add(
                0, sf, torch.where(hitw, -rq, 0)[None, :])
            free_pods = free_pods.index_add(
                0, sf, torch.where(hitw, -1, 0).to(free_pods.dtype)
                .reshape(1))
            used_nz = used_nz.index_add(
                0, sf, torch.where(hitw, rnz, 0)[None, :])
            out.append(torch.where(hitw, idx, -1))
        outs.append(torch.stack(out))
        nrep += nreal
    assign = torch.cat(outs)[:p].to(torch.int32)
    return assign, ncom, nrep, pois


def greedy_assign_rescoring_wave(req_q, req_nz_q, free_q, free_pods,
                                 used_nz_q, alloc_q, mask, static_scores,
                                 fit_col_w, bal_col_mask, shape_u, shape_s,
                                 w_fit, w_bal, strategy: str, wave_w: int,
                                 rows=None, exc=None):
    """greedy_assign_rescoring, W pods per step with exact replay.
    Returns (assign (P,), commits, replays)."""
    if rows is None:
        rows = torch.arange(req_q.shape[0], dtype=torch.int32,
                            device=req_q.device)
    assign, ncom, nrep, _ = _rescoring_wave_scan(
        req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
        w_fit, w_bal, strategy, wave_w, rows, exc, poison=False)
    return assign, ncom, nrep


def multistart_greedy_assign_wave(req_q, req_nz_q, free_q, free_pods,
                                  used_nz_q, alloc_q, mask, static_scores,
                                  fit_col_w, bal_col_mask, shape_u, shape_s,
                                  w_fit, w_bal, strategy: str, wave_w: int,
                                  perms, gang_onehot, gang_required,
                                  rows=None, exc=None):
    """Multistart with speculation-only wavefront scans per order: any
    poisoned order reruns the whole chunk through
    `multistart_greedy_assign`. Returns (assign (P,), commits, replays);
    the counters are P or 0."""
    P = req_q.shape[0]
    if rows is None:
        rows = torch.arange(P, dtype=torch.int32, device=req_q.device)
    assigns, any_pois = [], False
    for perm in perms.long():
        a, _, _, pois = _rescoring_wave_scan(
            req_q[perm], req_nz_q[perm], free_q, free_pods, used_nz_q,
            alloc_q, mask, static_scores, fit_col_w, bal_col_mask,
            shape_u, shape_s, w_fit, w_bal, strategy, wave_w, rows[perm],
            None if exc is None else exc[perm], poison=True)
        assigns.append(_unpermute(a, perm))
        any_pois = any_pois or pois
    if any_pois:
        assign = multistart_greedy_assign(
            req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
            static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
            w_fit, w_bal, strategy, perms, gang_onehot, gang_required,
            rows, exc)
        return assign, 0, P
    return _select_best(torch.stack(assigns), req_q, gang_onehot,
                        gang_required), P, 0


def _any_flag(flags: list[torch.Tensor]) -> bool:
    """The batch solve's host read: whether any of these bool tensors holds
    True (the kernel's or the narrow scans' poison bits, or a block
    prefilter that cannot prove its pruning). At most one per prefilter
    and one per solve of a chunk, never inside a scan."""
    return bool(torch.cat(flags).any())


def multistart_greedy_assign_wave_kernel(req_q, req_nz_q, free_q,
                                         free_pods, used_nz_q, alloc_q,
                                         mask, static_scores, fit_col_w,
                                         bal_col_mask, shape_u, shape_s,
                                         w_fit, w_bal, strategy: str,
                                         wave_w: int, perms, gang_onehot,
                                         gang_required, rows=None,
                                         exc=None):
    """multistart_greedy_assign_wave with every order's wavefront solve in
    ONE launch of the hand-written kernel (ops/wave_kernel.wave_solve;
    one thread-block cluster per order). The poison contract and
    `_select_best` are the reference wrapper's: a poisoned chunk reruns
    through `multistart_greedy_assign_kernel`, the SAME kernel at W=1 with
    poison=False. Returns (assign (P,), commits, replays); the counters
    are P or 0."""
    from kubernetes_tpu_torch.ops import wave_kernel  # local: import cycle

    P = req_q.shape[0]
    if rows is None:
        rows = torch.arange(P, dtype=torch.int32, device=req_q.device)
    args = (req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
            static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
            w_fit, w_bal, strategy)
    assigns_p, _, _, pois = wave_kernel.wave_solve(
        *args, wave_w, rows, exc, poison=True, perms=perms)
    if _any_flag([pois.reshape(-1)]):
        return multistart_greedy_assign_kernel(
            *args, perms, gang_onehot, gang_required, rows, exc), 0, P
    return _best_of_orders(assigns_p, perms, req_q, gang_onehot,
                           gang_required), P, 0


# ---------------------------------------------------------------------------
# PodTopologySpread's hard constraints inside the scan.
# ---------------------------------------------------------------------------

#: min over a constraint's domains when it has none (never read: no domain
#: of that constraint exists to gate).
_NO_MIN = 1 << 30


class SpreadTable:
    """The union spread table of one assign() in the scans' form — the
    reference's one-hot planes as indices, with integer counts:

    node_dom: (N, C) int64 — the eligible domain of node n under
        constraint c, -1 where the node is keyless, ineligible for the
        constraint's template, or in no eligible domain (the reference's
        `dom_onehot @ cid_onehot` row, as an index).
    dom_cid:  (D,) int64 — the constraint owning each domain
        (`cid_onehot`).
    max_skew: (C,) int32; min_ok: (C,) bool — False under a minDomains
        deficit (the global minimum is then 0).
    has_key:  (N, C) bool — the node has the constraint's topology key,
        eligible or not (keyless nodes reject the constraint's pods).

    The domain counts ((D,) int32) ride the scans' carry beside it.
    Counting through gathers and `index_add` keeps every count an exact
    integer on the card, where a float one-hot product may run in TF32."""

    __slots__ = ("node_dom", "dom_cid", "max_skew", "min_ok", "has_key",
                 "in_dom", "node_dom_x", "skew_d")

    def __init__(self, node_dom, dom_cid, max_skew, min_ok, has_key):
        self.node_dom = node_dom
        self.dom_cid = dom_cid
        self.max_skew = max_skew
        self.min_ok = min_ok
        self.has_key = has_key
        d = dom_cid.shape[0]
        self.in_dom = node_dom >= 0
        #: node_dom with "no domain" mapped to the extra column D.
        self.node_dom_x = torch.where(self.in_dom, node_dom, d)
        self.skew_d = max_skew[dom_cid]

    def gate(self, dcounts, contrib, app):
        """(S, N) DoNotSchedule gate of S pods at the counts given: every
        constraint a pod carries (`app` (S, C)) needs the node's topology
        key, and where the node lies in one of the constraint's eligible
        domains, that domain's count plus the pod's selfMatch (`contrib`
        (S, C)) less the constraint's global minimum must stay within
        maxSkew; keyed nodes outside every eligible domain are fresh and
        pass (the reference's `spread_gate`)."""
        c = self.max_skew.shape[0]
        mins = torch.full((c,), _NO_MIN, dtype=dcounts.dtype,
                          device=dcounts.device).scatter_reduce(
            0, self.dom_cid, dcounts, "amin")
        mins = torch.where(self.min_ok, mins, 0)
        allowed = (dcounts[None, :] + contrib[:, self.dom_cid]
                   - mins[self.dom_cid][None, :]) <= self.skew_d[None, :]
        allowed = torch.cat([allowed, allowed.new_zeros(
            (allowed.shape[0], 1))], dim=1)                    # (S, D+1)
        in_allowed = allowed[:, self.node_dom_x]               # (S, N, C)
        node_c_ok = self.has_key[None] & (in_allowed | ~self.in_dom[None])
        return torch.all(node_c_ok | ~app[:, None, :], dim=2)

    def add(self, dcounts, nodes, hit, contrib):
        """Count placed pods (`nodes` (S,) safe indices, `hit` (S,)) in
        the domains of the constraints each matches (`contrib` (S, C))."""
        doms = self.node_dom[nodes]                            # (S, C)
        inc = torch.where(hit[:, None] & (doms >= 0), contrib, 0)
        return dcounts.index_add(0, doms.clamp_min(0).reshape(-1),
                                 inc.reshape(-1).to(dcounts.dtype))


def _spread_step(state, req, req_nz, m, stat, app, con, table, alloc_q,
                 fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                 strategy):
    """One pod of the spread scan: gate, fit, live re-score, argmax (ties
    to the lowest node), debit, count. Returns (state', idx or -1)."""
    free_q, free_pods, used_nz, dc = state
    n = free_q.shape[0]
    fits = m & table.gate(dc, con[None, :], app[None, :])[0] \
        & torch.all(req[None, :] <= free_q, dim=1) & (free_pods >= 1)
    sc = kernels.chunk_start_scores(
        alloc_q, used_nz, req_nz[None, :], stat[None, :], fit_col_w,
        bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy)[0]
    idx = _argmax_low(torch.where(fits, sc, NEG_INF), n)
    hit = idx < n
    sf = torch.clamp_max(idx, n - 1).long().reshape(1)
    free_q = free_q.index_add(0, sf, torch.where(hit, -req, 0)[None, :])
    free_pods = free_pods.index_add(
        0, sf, torch.where(hit, -1, 0).to(free_pods.dtype).reshape(1))
    used_nz = used_nz.index_add(0, sf, torch.where(hit, req_nz, 0)[None, :])
    dc = table.add(dc, sf, hit.reshape(1), con[None, :])
    return (free_q, free_pods, used_nz, dc), torch.where(hit, idx, -1)


def _run_steps(step, n: int, device: torch.device) -> None:
    """Call `step()` n times. On the CPU it runs eagerly. On a CUDA device
    one call is captured in a CUDA graph and the graph is replayed n
    times: every tensor a step reads or writes across calls is allocated
    before the capture and updated in place, and the step reads its own
    index from a device counter it advances, so each replay is the same
    operations on the next pod (or wave) for one launch instead of one
    per operation. Neither form reads a value back from the device."""
    if n <= 0:
        return
    if device.type != "cuda":
        for _ in range(n):
            step()
        return
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        graph.capture_begin()
        step()
        graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(side)
    for _ in range(n):
        graph.replay()


def greedy_assign_rescoring_spread(req_q, req_nz_q, free_q, free_pods,
                                   used_nz_q, alloc_q, mask, static_scores,
                                   fit_col_w, bal_col_mask, shape_u, shape_s,
                                   w_fit, w_bal, strategy: str,
                                   table: SpreadTable, dom_counts, applies,
                                   contributes, rows=None, exc=None,
                                   n_real: int | None = None):
    """greedy_assign_rescoring with PodTopologySpread's hard constraints
    inside the scan (the reference's `greedy_assign_rescoring_spread`):
    the domain counts of the union table (`table`) ride the carry, so a
    tight maxSkew stays sequential-exact. `applies` (P, C) bool: the
    constraints of the pod's own template, which gate it; `contributes`
    (P, C) int32: the constraints whose selector and namespaces match the
    pod, which count it when placed (its selfMatch term too). One pod per
    step, identity order (`_run_steps`: a CUDA graph of one step on the
    card); nothing is read back from the device. `n_real`: pods from
    this index on are padding that fits nowhere (an empty class row), so
    their steps, which would change nothing, are not run.
    Returns (assign (P,) int32, dom_counts' (D,) int32)."""
    p = req_q.shape[0]
    n = free_q.shape[0]
    dev = free_q.device
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    if rows is None:
        rows = torch.arange(p, dtype=torch.int32, device=dev)
    rows = rows.long()
    ex = torch.full((p,), -1, dtype=torch.int32, device=dev) \
        if exc is None else exc
    state = (free_q.clone(), free_pods.clone(), used_nz_q.clone(),
             dom_counts.clone())
    out = torch.full((p,), -1, dtype=torch.int32, device=dev)
    i = torch.zeros((1,), dtype=torch.long, device=dev)

    def step():
        row = rows.index_select(0, i)
        e = ex.index_select(0, i)
        m = mask.index_select(0, row)[0] & ((e < 0) | (iota == e))
        new, idx = _spread_step(
            state, req_q.index_select(0, i)[0],
            req_nz_q.index_select(0, i)[0], m,
            static_scores.index_select(0, row)[0],
            applies.index_select(0, i)[0], contributes.index_select(0, i)[0],
            table, alloc_q, fit_col_w, bal_col_mask, shape_u, shape_s,
            w_fit, w_bal, strategy)
        for buf, val in zip(state, new):
            buf.copy_(val)
        out.index_copy_(0, i, idx.to(torch.int32).reshape(1))
        i.add_(1)

    _run_steps(step, p if n_real is None else min(p, n_real), dev)
    return out, state[3]


def greedy_assign_rescoring_spread_wave(req_q, req_nz_q, free_q, free_pods,
                                        used_nz_q, alloc_q, mask,
                                        static_scores, fit_col_w,
                                        bal_col_mask, shape_u, shape_s,
                                        w_fit, w_bal, strategy: str,
                                        wave_w: int, table: SpreadTable,
                                        dom_counts, applies, contributes,
                                        rows=None, exc=None,
                                        n_real: int | None = None):
    """greedy_assign_rescoring_spread, W pods per wave (the reference's
    `greedy_assign_rescoring_spread_wave`): prefix-distinct speculative
    picks at the wave-start counts, the capacity/score conflict check with
    the spread gate folded in, and the structural rule — spread gating is
    non-monotone (a commit that raises a global minimum can open a domain
    to a later pod), so a gated member replays whenever an earlier member
    of its wave committed a count-moving placement. A conflicted wave
    replays one pod at a time from the wave-start state.

    Nothing is read back from the device: both outcomes of each wave are
    computed and the conflict bit selects one, so the commits, replays,
    counts and the replay predicate stay tensors (the reference's
    `lax.cond`); on the card a wave is one CUDA graph replay
    (`_run_steps`). `n_real` as in the W=1 scan: the waves past it hold
    only padding, which places nothing and commits, so they are counted
    as commits without being run. Returns (assign (P,) int32,
    dom_counts' (D,) int32, commits, replays), the counters 0-d int32
    tensors."""
    n = free_q.shape[0]
    p = req_q.shape[0]
    dev = free_q.device
    W = max(1, min(wave_w, p))
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    if rows is None:
        rows = torch.arange(p, dtype=torch.int32, device=dev)
    ex = torch.full((p,), -1, dtype=torch.int32, device=dev) \
        if exc is None else exc
    waves, real_w = _wave_split(
        W, (req_q, req_nz_q, rows.long(), applies, contributes, ex))
    nreal_w = real_w.sum(dim=1).to(torch.int32)
    n_waves = real_w.shape[0]
    state = (free_q.clone(), free_pods.clone(), used_nz_q.clone(),
             dom_counts.clone())
    out = torch.full((n_waves, W), -1, dtype=torch.int32, device=dev)
    ncom = torch.zeros((1,), dtype=torch.int32, device=dev)
    nrep = torch.zeros((1,), dtype=torch.int32, device=dev)
    k = torch.zeros((1,), dtype=torch.long, device=dev)
    score_args = (alloc_q, fit_col_w, bal_col_mask, shape_u, shape_s,
                  w_fit, w_bal, strategy)

    def wave():
        req, req_nz, row, app, con, e = (
            a.index_select(0, k)[0] for a in waves)
        real = real_w.index_select(0, k)[0]
        nreal = nreal_w.index_select(0, k)
        free_q, free_pods, used_nz, dc = state
        m = mask[row]                                          # (W,N)
        m = m & ((e < 0)[:, None] | (iota_n[None, :] == e[:, None]))
        m = m & real[:, None]
        stat = static_scores[row]
        sp_ok = table.gate(dc, con, app)                       # (W,N)
        fits = m & sp_ok \
            & torch.all(req[:, None, :] <= free_q[None, :, :], dim=-1) \
            & (free_pods >= 1)[None, :]
        sc = kernels.chunk_start_scores(
            alloc_q, used_nz, req_nz, stat, fit_col_w, bal_col_mask,
            shape_u, shape_s, w_fit, w_bal, strategy)
        masked = torch.where(fits, sc, NEG_INF)
        b, y = _wave_spec_picks(masked, iota_n[None, :].expand(masked.shape),
                                n, W)
        safe = torch.clamp_max(y, n - 1).long()
        hit = y < n
        conflict = _wave_conflicts(
            b, y, n, req, req_nz, free_q, free_pods, used_nz, alloc_q,
            m[:, safe], stat[:, safe], fit_col_w, bal_col_mask, shape_u,
            shape_s, w_fit, w_bal, strategy, extra_ok=sp_ok[:, safe])
        movers = (hit & torch.any(con > 0, dim=1)).to(torch.int32)
        earlier_moved = torch.cumsum(movers, dim=0) - movers > 0
        conflict = conflict | (earlier_moved & torch.any(app, dim=1))
        replay = torch.any(conflict)
        # The speculative commit.
        fast = (
            free_q.index_add(0, safe, torch.where(hit[:, None], -req, 0)),
            free_pods.index_add(
                0, safe, torch.where(hit, -1, 0).to(free_pods.dtype)),
            used_nz.index_add(0, safe, torch.where(hit[:, None], req_nz, 0)),
            table.add(dc, safe, hit, con))
        fast_out = torch.where(hit, y, -1)
        # The serial replay from the wave-start state.
        slow, slow_out = state, []
        for w in range(W):
            slow, idx = _spread_step(slow, req[w], req_nz[w], m[w], stat[w],
                                     app[w], con[w], table, *score_args)
            slow_out.append(idx)
        for buf, s_val, f_val in zip(state, slow, fast):
            buf.copy_(torch.where(replay, s_val, f_val))
        out.index_copy_(0, k, torch.where(
            replay, torch.stack(slow_out), fast_out).to(torch.int32)[None])
        ncom.add_(torch.where(replay, 0, nreal))
        nrep.add_(torch.where(replay, nreal, 0))
        k.add_(1)

    n_run = n_waves if n_real is None else min(n_waves, -(-n_real // W))
    _run_steps(wave, n_run, dev)
    ncom.add_(nreal_w[n_run:].sum().to(torch.int32))
    return out.reshape(-1)[:p], state[3], ncom[0], nrep[0]


# ---------------------------------------------------------------------------
# Shortlist-pruned solve: per-class top-K candidate columns with an
# exactness fallback — the O(P·(K+P) + fallbacks·N) form of the scans for
# large N — and its two-pass block-sparse prefilter.
# ---------------------------------------------------------------------------

def _top_desc(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of x, ordered
    value descending, then index ascending among equal values: the tie
    rule of the reference's `lax.top_k`, on which the scans' exactness
    argument and the block selection depend. `torch.topk` promises no
    order among equal values, so this is a stable descending sort."""
    vals, idx = torch.sort(x, dim=1, descending=True, stable=True)
    return vals[:, :k], idx[:, :k]


def shortlist_prefilter(feas0, sc0, k: int):
    """Per-row top-K candidate columns and the exactness threshold.

    feas0: (S, N) bool chunk-start feasibility (static mask ∧ capacity fit:
    capacity only decreases within a chunk; spread gating is not folded in,
    it is non-monotone and checked in the scan); sc0: (S, N) f32
    chunk-start live scores (kernels.chunk_start_scores).

    Returns (cand (S, K) int32, thresh (S,)): the K best columns per row and
    the (K+1)-th value, the most any column outside the shortlist can score
    during the chunk (an untouched node keeps its sc0; a debited one joins
    the scans' candidate set). -inf ⇔ the shortlist holds every feasible
    column. Ties go to the LOWER index (`_top_desc`), so every column
    outside the list that ties the threshold has a higher index than every
    listed column at that value."""
    vals, cand = _top_desc(torch.where(feas0, sc0, NEG_INF), k + 1)
    return cand[:, :k].to(torch.int32), vals[:, k]


def block_selection_fits(n: int, k: int, block_w: int) -> bool:
    """The block prefilter's shape guard: N columns in blocks of block_w
    leave at least one block unselected by its M = 2·⌈(K+1)/block_w⌉
    selection (M + 1 <= B)."""
    return 2 * (-(-(k + 1) // block_w)) + 1 <= -(-n // block_w)


def block_bound_prefilter(alloc_q, used_nz_q, req_nz_q, static_scores,
                          feasible, fit_col_w, bal_col_mask, shape_u,
                          shape_s, w_fit, w_bal, strategy: str, n_real: int,
                          k: int, block_w: int):
    """Two-pass block-sparse form of the shortlist prefilter (the
    reference's `block_bound_prefilter`).

    Pass 1, O(C·B): fold the N columns into B = ⌈N/block_w⌉ blocks, derive
    per-block aggregates from the live capacity planes, bound each (class,
    block) score (kernels.block_score_upper_bound) and select the
    M = 2·⌈(K+1)/block_w⌉ highest-bound blocks per class. Pass 2,
    O(C·M·block_w): gather the selected blocks' columns in ascending order,
    score them (kernels.gathered_start_scores, the full pass's values bit
    for bit) and take the top K and the threshold as `shortlist_prefilter`
    would.

    The result stands only when every non-selected block of every class
    passes one arm: strict (its bound loses to the gathered threshold),
    empty (no feasible column), or uniform (it lies after the last
    selected block, it and that block are capacity-uniform with one
    static score and equal aggregates, and that block's best gathered
    value is at most the threshold: its columns then score that value at
    higher indices, and lose every tie). Otherwise the chunk takes the
    full-width pass. The reference branches with `lax.cond`; here the
    predicate is read back once (`_any_flag`) and the full-width pass runs
    only when it fails, so a pruned block's columns are never scored.

    n_real: the real (unpadded) column count; padding columns join no
    aggregate. Raises ValueError when M + 1 > B (the tuner routes
    block_w = 0 for such shapes).

    Returns (sc0 (C, N): exact chunk-start values at the gathered columns
    and 0.0 elsewhere, read only through the candidate set — or the full
    pass's; cand (C, K) int32; thresh (C,); blocks_scanned, blocks_pruned:
    ints, pruned 0 when the full pass was taken)."""
    n = alloc_q.shape[0]
    c = static_scores.shape[0]
    dev = alloc_q.device
    bw = block_w
    b = -(-n // bw)
    m = 2 * (-(-(k + 1) // bw))
    if not block_selection_fits(n, k, bw):
        raise ValueError(
            f"block prefilter needs M+1={m + 1} <= B={b}; route block_w=0 "
            "for this shape (see AdaptiveTuner.block_width)")
    score_args = (fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy)
    col_real = torch.arange(n, device=dev) < n_real
    amin_pos, amin, amax, umin, umax = kernels.block_capacity_aggregates(
        alloc_q, used_nz_q, col_real, bw)
    stat_max, stat_min, feas_cnt = kernels.block_feasible_stat(
        feasible, static_scores, bw)
    ub = kernels.block_score_upper_bound(
        stat_max, feas_cnt, amin_pos, amax, umin, umax, req_nz_q,
        *score_args)                                             # (C,B)

    _, sel = _top_desc(ub, m + 1)
    sel_ids = torch.sort(sel[:, :m], dim=1).values               # (C,M)
    # The selected blocks' columns in ascending global order, so the tie
    # rule below means what it means full-width.
    cols = (sel_ids[:, :, None] * bw
            + torch.arange(bw, device=dev)[None, None, :]).reshape(c, -1)
    valid = cols < n                     # the tail fold's padding
    safe_cols = torch.clamp_max(cols, n - 1)
    feas_g = torch.gather(feasible, 1, safe_cols) & valid
    stat_g = torch.gather(static_scores, 1, safe_cols)
    sc0_g = kernels.gathered_start_scores(
        alloc_q[safe_cols], used_nz_q[safe_cols], req_nz_q, stat_g,
        *score_args)                                             # (C,G)
    masked_g = torch.where(feas_g, sc0_g, NEG_INF)
    vals, loc = _top_desc(masked_g, k + 1)
    cand = torch.gather(safe_cols, 1, loc[:, :k]).to(torch.int32)
    thresh = vals[:, k]
    # Scatter into an (N+1)-wide buffer: the fold's padding lanes write to
    # the throwaway column N (a clamp to N-1 would clobber the last one).
    tgt = torch.where(valid, cols, n)
    sc0_blk = torch.zeros((c, n + 1), dtype=torch.float32,
                          device=dev).scatter_(1, tgt, sc0_g)[:, :n]

    # The exactness predicate over the non-selected blocks.
    is_sel = torch.zeros((c, b), dtype=torch.bool, device=dev).scatter_(
        1, sel_ids, True)
    strict = ub < thresh[:, None]
    empty = feas_cnt == 0
    ref = sel_ids[:, m - 1:m]                                    # (C,1)
    unif_cap = (torch.all(amin == amax, dim=1)
                & torch.all(umin == umax, dim=1))[None, :]       # (1,B)
    stat_unif = stat_max == stat_min                             # (C,B)
    eq_cap = (torch.all(amax[None] == amax[ref], dim=-1)
              & torch.all(amin[None] == amin[ref], dim=-1)
              & torch.all(umax[None] == umax[ref], dim=-1)
              & torch.all(umin[None] == umin[ref], dim=-1))
    eq_stat = ((stat_max == torch.gather(stat_max, 1, ref))
               & (stat_min == torch.gather(stat_min, 1, ref)))
    after_ref = torch.arange(b, device=dev)[None, :] > ref
    v_ref = torch.amax(masked_g.reshape(c, m, bw)[:, m - 1, :], dim=-1)
    uniform = (after_ref & unif_cap & stat_unif & eq_cap & eq_stat
               & (v_ref <= thresh)[:, None])
    inexact = ~torch.all(is_sel | strict | empty | uniform)
    if not _any_flag([inexact.reshape(1)]):
        return sc0_blk, cand, thresh, c * b, c * (b - m)
    sc0_f = kernels.chunk_start_scores(alloc_q, used_nz_q, req_nz_q,
                                       static_scores, *score_args)
    cand_f, thresh_f = shortlist_prefilter(feasible, sc0_f, k)
    return sc0_f, cand_f, thresh_f, c * b, 0


def _shortlist_scan(req_q, req_nz_q, rows, free_q, free_pods, used_nz_q,
                    alloc_q, mask, static_scores, fit_col_w, bal_col_mask,
                    shape_u, shape_s, w_fit, w_bal, strategy: str, sc0,
                    sl_class, sl_cand, sl_thresh, has_node,
                    inline_fallback: bool, exc=None, spread=None,
                    n_real: int | None = None):
    """The narrow sequential-equivalent scan, one pod per step (the
    reference's `_shortlist_scan`, and with `spread` its
    `greedy_assign_rescoring_spread_shortlist`): per pod, re-score only its
    K shortlist columns and every node debited earlier in the chunk, and
    prove the winner exact against the prefilter threshold.

    Exactness, per step: shortlist candidates and touched nodes are
    re-scored live; an untouched node outside the shortlist still scores
    its sc0 ≤ thresh. So a candidate-set winner that beats the threshold,
    or ties it while untouched, is the full N-wide argmax. Untouched
    candidates read their score from sc0, so `== thresh` never compares
    two evaluations of one quantity. A step that cannot prove its winner
    is a fallback: with `inline_fallback` the full row's winner replaces
    it (the reference's per-step `lax.cond`; here the full row is computed
    every step and `trusted` selects, which is exact and reads nothing
    back), else the scan is poisoned. The single-order forms run the
    poisoning scan first and this one only when that poisoned
    (`_narrow_then_exact`): until a step fails the two are the same
    trajectory, so the full rows are paid only by a chunk that needs
    them.

    sc0 (S, N) class-level chunk-start scores; sl_class (P,) row of sc0 per
    pod; sl_cand (P, K); sl_thresh (P,); has_node (P,) bool: pods whose
    static mask is empty resolve to -1 with no fallback. `rows` (P,) index
    the unpermuted (C, N) planes; `exc` (P,) is the exception column (a
    pinned pod whose column misses the shortlist resolves through the
    fallback). `spread`: None, or (table, dom_counts, applies,
    contributes) — the spread gate applies to candidates and to the full
    row, and the domain counts ride the carry. `n_real`: pods from this
    index on are padding, whose steps (trusted, placing nothing) are not
    run.

    One pod per step through `_run_steps` (a CUDA graph replay per pod on
    the card); nothing is read back. Returns (assign (P,) int32, fallbacks
    (1,) int32, poisoned (1,) bool, dom_counts' or None)."""
    n = free_q.shape[0]
    p = req_q.shape[0]
    dev = free_q.device
    iota_n = torch.arange(n, device=dev)
    ex = torch.full((p,), -1, dtype=torch.int32, device=dev) \
        if exc is None else exc
    rows_l, cls_l, cand_l = rows.long(), sl_class.long(), sl_cand.long()
    state = [free_q.clone(), free_pods.clone(), used_nz_q.clone()]
    if spread is not None:
        table, dom_counts, applies, contributes = spread
        state.append(dom_counts.clone())
    # touched has a throwaway slot n, written when a step places nothing.
    touched = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    tidx = torch.full((p,), n, dtype=torch.long, device=dev)
    nfall = torch.zeros((1,), dtype=torch.int32, device=dev)
    pois = torch.zeros((1,), dtype=torch.bool, device=dev)
    out = torch.full((p,), -1, dtype=torch.int32, device=dev)
    i = torch.zeros((1,), dtype=torch.long, device=dev)
    score_args = (fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy)

    def step():
        fq, fp, unz = state[:3]
        row = rows_l.index_select(0, i)                        # (1,)
        cls = cls_l.index_select(0, i)
        req = req_q.index_select(0, i)[0]
        req_nz = req_nz_q.index_select(0, i)[0]
        e = ex.index_select(0, i)
        t = sl_thresh.index_select(0, i)
        hn = has_node.index_select(0, i)
        if spread is not None:
            con = contributes.index_select(0, i)
            sp_ok = table.gate(state[3], con,
                               applies.index_select(0, i))[0]  # (N,)
        cset = torch.cat([cand_l.index_select(0, i)[0], tidx])  # (K+P,)
        valid = cset < n
        ci = torch.where(valid, cset, 0)
        live = kernels.chunk_start_scores(
            alloc_q[ci], unz[ci], req_nz[None, :],
            static_scores[row, ci][None, :], *score_args)[0]
        live = torch.where(touched[ci], live, sc0[cls, ci])
        fits = mask[row, ci] & valid \
            & torch.all(req[None, :] <= fq[ci], dim=1) & (fp[ci] >= 1) \
            & ((e < 0) | (ci == e))
        if spread is not None:
            fits = fits & sp_ok[ci]
        masked = torch.where(fits, live, NEG_INF)
        best = torch.amax(masked, dim=0, keepdim=True)          # (1,)
        any_fit = best > NEG_INF
        widx = torch.amin(torch.where(masked == best, ci, n), dim=0,
                          keepdim=True)
        trusted = torch.where(
            any_fit, (best > t) | ((best == t) & ~touched[widx]),
            t == NEG_INF) | ~hn
        idx = torch.where(any_fit, widx, -1)
        if inline_fallback:
            fits_n = mask.index_select(0, row)[0] \
                & ((e < 0) | (iota_n == e)) \
                & torch.all(req[None, :] <= fq, dim=1) & (fp >= 1)
            if spread is not None:
                fits_n = fits_n & sp_ok
            sc = kernels.chunk_start_scores(
                alloc_q, unz, req_nz[None, :],
                static_scores.index_select(0, row), *score_args)[0]
            full = _argmax_low(torch.where(fits_n, sc, NEG_INF), n)
            idx = torch.where(trusted, idx, torch.where(full < n, full, -1))
        else:
            pois.logical_or_(~trusted)
        nfall.add_((~trusted).to(torch.int32))
        hit = idx >= 0
        safe = torch.clamp(idx, 0, n - 1)
        fq.index_add_(0, safe, torch.where(hit[:, None], -req[None, :], 0))
        fp.index_add_(0, safe, torch.where(hit, -1, 0).to(fp.dtype))
        unz.index_add_(0, safe,
                       torch.where(hit[:, None], req_nz[None, :], 0))
        if spread is not None:
            state[3].copy_(table.add(state[3], safe, hit, con))
        tgt = torch.where(hit, idx, n)
        touched.index_put_((tgt,), torch.ones_like(hit))
        tidx.index_copy_(0, i, tgt)
        out.index_copy_(0, i, idx.to(torch.int32))
        i.add_(1)

    _run_steps(step, p if n_real is None else min(p, n_real), dev)
    return out, nfall, pois, (state[3] if spread is not None else None)


def greedy_assign_rescoring_shortlist(req_q, req_nz_q, free_q, free_pods,
                                      used_nz_q, alloc_q, mask,
                                      static_scores, fit_col_w, bal_col_mask,
                                      shape_u, shape_s, w_fit, w_bal,
                                      strategy: str, sc0, sl_class, sl_cand,
                                      sl_thresh, has_node, rows=None,
                                      exc=None, n_real: int | None = None):
    """greedy_assign_rescoring, shortlist-pruned: the same assignments at
    O(P·(K+P)), and when a step cannot prove its winner, the scan again
    with the full row at such steps (`_narrow_then_exact`). Returns
    (assign (P,) int32, fallbacks (1,) int32)."""
    if rows is None:
        rows = torch.arange(req_q.shape[0], dtype=torch.int32,
                            device=req_q.device)
    assign, nfall, _, _ = _narrow_then_exact(
        _shortlist_scan, 2, "inline_fallback", False, True,
        req_q, req_nz_q, rows, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
        w_bal, strategy, sc0, sl_class, sl_cand, sl_thresh, has_node,
        exc=exc, n_real=n_real)
    return assign, nfall


def _narrow_then_exact(scan, pois_at: int, switch: str, narrow, exact,
                       *args, **kw):
    """A single-order shortlist scan with its per-step fallback: `scan`
    with `switch=narrow` (re-scores the candidate set only, and poisons
    on a step it cannot prove), the poison bit at `pois_at` of its result
    read once, and only when it is set `scan` again with `switch=exact`
    (the full rows where a step cannot prove its winner). Both start from
    the same state, and the narrow run equals the exact one when no step
    failed, so the result and its counters are the exact form's."""
    out = scan(*args, **{switch: narrow}, **kw)
    if not _any_flag([out[pois_at]]):
        return out
    return scan(*args, **{switch: exact}, **kw)


def _rerun_poisoned(pois, args, perms, gang_onehot, gang_required, rows,
                    exc) -> torch.Tensor | None:
    """The multistart shortlist forms' whole-chunk fallback: the poison
    read (`_any_flag`, the reference's outer `lax.cond`), and when any
    order was poisoned, the chunk again through
    `multistart_greedy_assign_kernel` (the hand-written kernel at W=1 on
    the card, its plain version on the CPU). None when none was."""
    if not _any_flag(pois):
        return None
    return multistart_greedy_assign_kernel(
        *args, perms, gang_onehot, gang_required, rows=rows, exc=exc)


def multistart_greedy_assign_shortlist(req_q, req_nz_q, free_q, free_pods,
                                       used_nz_q, alloc_q, mask,
                                       static_scores, fit_col_w,
                                       bal_col_mask, shape_u, shape_s,
                                       w_fit, w_bal, strategy: str, perms,
                                       gang_onehot, gang_required, sc0,
                                       sl_class, sl_cand, sl_thresh,
                                       has_node, rows=None, exc=None,
                                       n_real: int | None = None):
    """multistart_greedy_assign, shortlist-pruned: each order's narrow scan
    poisons on a step it cannot prove, and a poisoned chunk reruns whole
    (`_rerun_poisoned`). The shortlist is chunk-start state, so only the
    per-pod rows permute. Returns (assign (P,) int32, fallback pods: P on
    a poisoned chunk, else 0)."""
    P = req_q.shape[0]
    if rows is None:
        rows = torch.arange(P, dtype=torch.int32, device=req_q.device)
    args = (req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
            static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
            w_bal, strategy)
    assigns, pois = [], []
    for perm in perms.long():
        a, _, po, _ = _shortlist_scan(
            req_q[perm], req_nz_q[perm], rows[perm], *args[2:], sc0,
            sl_class[perm], sl_cand[perm], sl_thresh[perm], has_node[perm],
            inline_fallback=False, exc=None if exc is None else exc[perm],
            n_real=n_real)
        assigns.append(_unpermute(a, perm))
        pois.append(po)
    rerun = _rerun_poisoned(pois, args, perms, gang_onehot, gang_required,
                            rows, exc)
    if rerun is not None:
        return rerun, P
    return _select_best(torch.stack(assigns), req_q, gang_onehot,
                        gang_required), 0


def greedy_assign_rescoring_spread_shortlist(
        req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
        w_bal, strategy: str, table: SpreadTable, dom_counts, applies,
        contributes, sc0, sl_class, sl_cand, sl_thresh, has_node, rows=None,
        exc=None, n_real: int | None = None):
    """greedy_assign_rescoring_spread, shortlist-pruned (identity order,
    the per-step fallback inline). Spread gating is non-monotone, so it
    plays no part in the prefilter: the in-scan gate applies to the
    candidates, and a pod whose allowed domains all lie outside its score
    head falls back to the full row. The counts use the table's index
    form (integer gathers and `index_add`), equal to the reference's
    one-hot products. Returns (assign (P,) int32, dom_counts' (D,) int32,
    fallbacks (1,) int32)."""
    if rows is None:
        rows = torch.arange(req_q.shape[0], dtype=torch.int32,
                            device=req_q.device)
    assign, nfall, _, counts = _narrow_then_exact(
        _shortlist_scan, 2, "inline_fallback", False, True,
        req_q, req_nz_q, rows, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
        w_bal, strategy, sc0, sl_class, sl_cand, sl_thresh, has_node,
        exc=exc, spread=(table, dom_counts, applies, contributes),
        n_real=n_real)
    return assign, counts, nfall


def _shortlist_wave_scan(req_q, req_nz_q, rows, free_q, free_pods,
                         used_nz_q, alloc_q, mask, static_scores, fit_col_w,
                         bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                         strategy: str, wave_w: int, sc0, sl_class, sl_cand,
                         sl_thresh, has_node, poison: bool, exc=None,
                         n_real: int | None = None):
    """`_shortlist_scan` with W pods per wave (the reference's
    `_shortlist_wave_scan`): each member's candidate set (its shortlist ∪
    every node debited this chunk) is evaluated against the same carry,
    the picks are prefix-distinct, and a pick must clear both the
    shortlist bound check (the W=1 `trusted` rule) and the pairwise wave
    check (`_wave_conflicts`). A failing member sends the wave to the
    serial replay over full N-wide rows, counted as fallbacks (poison=False;
    both outcomes are computed and the conflict bit selects one), or
    poisons the scan (poison=True, the multistart form, which always
    commits).

    One wave per `_run_steps` call (a CUDA graph replay per wave on the
    card); nothing is read back. `n_real`: the waves past it hold only
    padding, which places nothing and commits; they are counted as commits
    without being run. Returns (assign (P,) int32, fallbacks, commits,
    replays: (1,) int32, poisoned (1,) bool)."""
    n = free_q.shape[0]
    p = req_q.shape[0]
    dev = free_q.device
    W = max(1, min(wave_w, p))
    iota_n = torch.arange(n, device=dev)
    ex = torch.full((p,), -1, dtype=torch.int32, device=dev) \
        if exc is None else exc
    waves, real_w = _wave_split(
        W, (req_q, req_nz_q, rows.long(), sl_cand.long(), sl_thresh,
            sl_class.long(), has_node, ex))
    n_waves = real_w.shape[0]
    p_pad = n_waves * W
    nreal_w = real_w.sum(dim=1).to(torch.int32)
    state = (free_q.clone(), free_pods.clone(), used_nz_q.clone())
    touched = torch.zeros((n + 1,), dtype=torch.bool, device=dev)
    tidx = torch.full((p_pad,), n, dtype=torch.long, device=dev)
    nfall, ncom, nrep = (torch.zeros((1,), dtype=torch.int32, device=dev)
                         for _ in range(3))
    pois = torch.zeros((1,), dtype=torch.bool, device=dev)
    out = torch.full((n_waves, W), -1, dtype=torch.int32, device=dev)
    k = torch.zeros((1,), dtype=torch.long, device=dev)
    slots = torch.arange(W, device=dev)
    score_args = (fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy)

    def wave():
        req, req_nz, row, cand, t, cls, hn, e = (
            a.index_select(0, k)[0] for a in waves)
        real = real_w.index_select(0, k)[0]
        nreal = nreal_w.index_select(0, k)
        fq, fp, unz = state
        cset = torch.cat([cand, tidx[None, :].expand(W, p_pad)], dim=1)
        valid = cset < n
        ci = torch.where(valid, cset, 0)                       # (W,M)
        live = kernels.gathered_start_scores(
            alloc_q[ci], unz[ci], req_nz, static_scores[row[:, None], ci],
            *score_args)
        live = torch.where(touched[ci], live, sc0[cls[:, None], ci])
        gate = ((e < 0)[:, None] | (ci == e[:, None])) & real[:, None]
        fits = mask[row[:, None], ci] & valid & gate \
            & torch.all(req[:, None, :] <= fq[ci], dim=-1) & (fp[ci] >= 1)
        masked = torch.where(fits, live, NEG_INF)
        b, y = _wave_spec_picks(masked, ci, n, W)
        safe = torch.clamp_max(y, n - 1).long()
        hit = y < n
        # The W=1 trusted rule on each pick (touched as of the wave start;
        # picks are never same-wave commits).
        trusted = torch.where(
            hit, (b > t) | ((b == t) & ~touched[safe]), t == NEG_INF) | ~hn
        m_pair = mask[row[:, None], safe[None, :]] & (
            (e < 0)[:, None] | (safe[None, :] == e[:, None])) & real[:, None]
        conflict = ~trusted | _wave_conflicts(
            b, y, n, req, req_nz, fq, fp, unz, alloc_q, m_pair,
            static_scores[row[:, None], safe[None, :]], *score_args)
        base = k * W
        fast = (fq.index_add(0, safe, torch.where(hit[:, None], -req, 0)),
                fp.index_add(0, safe,
                             torch.where(hit, -1, 0).to(fp.dtype)),
                unz.index_add(0, safe, torch.where(hit[:, None], req_nz, 0)))
        tgt = torch.where(hit, y.long(), n)
        fast_out = torch.where(hit, y, -1)
        if poison:
            for buf, val in zip(state, fast):
                buf.copy_(val)
            touched.index_put_((tgt,), torch.ones_like(hit))
            tidx.index_copy_(0, base + slots, tgt)
            out.index_copy_(0, k, fast_out.to(torch.int32)[None])
            pois.logical_or_(torch.any(conflict, dim=0, keepdim=True))
            ncom.add_(nreal)
            k.add_(1)
            return
        # The serial replay from the wave-start state, over full rows.
        sq, sp, su = fq, fp, unz
        s_tgt, slow_out = [], []
        m_full = mask[row] & ((e < 0)[:, None] | (iota_n == e[:, None])) \
            & real[:, None]
        stat = static_scores[row]
        for w in range(W):
            fits_n = m_full[w] & torch.all(req[w][None, :] <= sq, dim=1) \
                & (sp >= 1)
            sc = kernels.chunk_start_scores(
                alloc_q, su, req_nz[w][None, :], stat[w][None, :],
                *score_args)[0]
            idx = _argmax_low(torch.where(fits_n, sc, NEG_INF), n)
            hitw = idx < n
            sf = torch.clamp_max(idx, n - 1).long().reshape(1)
            sq = sq.index_add(0, sf, torch.where(hitw, -req[w], 0)[None, :])
            sp = sp.index_add(0, sf, torch.where(hitw, -1, 0).to(sp.dtype)
                              .reshape(1))
            su = su.index_add(0, sf,
                              torch.where(hitw, req_nz[w], 0)[None, :])
            s_tgt.append(torch.where(hitw, idx, n).long())
            slow_out.append(torch.where(hitw, idx, -1))
        replay = torch.any(conflict)
        for buf, s_val, f_val in zip(state, (sq, sp, su), fast):
            buf.copy_(torch.where(replay, s_val, f_val))
        tgt = torch.where(replay, torch.stack(s_tgt), tgt)
        touched.index_put_((tgt,), torch.ones_like(hit))
        tidx.index_copy_(0, base + slots, tgt)
        out.index_copy_(0, k, torch.where(
            replay, torch.stack(slow_out), fast_out).to(torch.int32)[None])
        nfall.add_(torch.where(replay, nreal, 0))
        nrep.add_(torch.where(replay, nreal, 0))
        ncom.add_(torch.where(replay, 0, nreal))
        k.add_(1)

    n_run = n_waves if n_real is None else min(n_waves, -(-n_real // W))
    _run_steps(wave, n_run, dev)
    ncom.add_(nreal_w[n_run:].sum().to(torch.int32))
    return out.reshape(-1)[:p], nfall, ncom, nrep, pois


def greedy_assign_rescoring_shortlist_wave(req_q, req_nz_q, free_q,
                                           free_pods, used_nz_q, alloc_q,
                                           mask, static_scores, fit_col_w,
                                           bal_col_mask, shape_u, shape_s,
                                           w_fit, w_bal, strategy: str,
                                           wave_w: int, sc0, sl_class,
                                           sl_cand, sl_thresh, has_node,
                                           rows=None, exc=None,
                                           n_real: int | None = None):
    """greedy_assign_rescoring_shortlist in waves of W, exact through the
    serial replay (full rows, counted as fallbacks), which runs only when
    the speculative pass poisoned (`_narrow_then_exact`). Returns (assign
    (P,) int32, fallbacks, commits, replays: (1,) int32)."""
    if rows is None:
        rows = torch.arange(req_q.shape[0], dtype=torch.int32,
                            device=req_q.device)
    assign, nfall, ncom, nrep, _ = _narrow_then_exact(
        _shortlist_wave_scan, 4, "poison", True, False,
        req_q, req_nz_q, rows, free_q, free_pods, used_nz_q, alloc_q, mask,
        static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
        w_bal, strategy, wave_w, sc0, sl_class, sl_cand, sl_thresh,
        has_node, exc=exc, n_real=n_real)
    return assign, nfall, ncom, nrep


def multistart_greedy_assign_shortlist_wave(req_q, req_nz_q, free_q,
                                            free_pods, used_nz_q, alloc_q,
                                            mask, static_scores, fit_col_w,
                                            bal_col_mask, shape_u, shape_s,
                                            w_fit, w_bal, strategy: str,
                                            wave_w: int, perms, gang_onehot,
                                            gang_required, sc0, sl_class,
                                            sl_cand, sl_thresh, has_node,
                                            rows=None, exc=None,
                                            n_real: int | None = None):
    """multistart_greedy_assign_shortlist in waves of W: each order runs
    speculation only and poisons on its first wave conflict or failed
    bound check; a poisoned chunk reruns whole (`_rerun_poisoned`).
    Returns (assign (P,) int32, fallback pods, commits, replays): P, 0, P
    on a poisoned chunk, else 0, P, 0."""
    P = req_q.shape[0]
    if rows is None:
        rows = torch.arange(P, dtype=torch.int32, device=req_q.device)
    args = (req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
            static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
            w_bal, strategy)
    assigns, pois = [], []
    for perm in perms.long():
        a, _, _, _, po = _shortlist_wave_scan(
            req_q[perm], req_nz_q[perm], rows[perm], *args[2:], wave_w,
            sc0, sl_class[perm], sl_cand[perm], sl_thresh[perm],
            has_node[perm], poison=True,
            exc=None if exc is None else exc[perm], n_real=n_real)
        assigns.append(_unpermute(a, perm))
        pois.append(po)
    rerun = _rerun_poisoned(pois, args, perms, gang_onehot, gang_required,
                            rows, exc)
    if rerun is not None:
        return rerun, P, 0, P
    return _select_best(torch.stack(assigns), req_q, gang_onehot,
                        gang_required), 0, P, 0


# ---------------------------------------------------------------------------
# Batch-optimal mode: the Sinkhorn transport plan, and the packing metric.
# ---------------------------------------------------------------------------

#: annealing stages of the Sinkhorn temperature schedule (4T → 2T → T).
SINKHORN_STAGES = 3
_EPS = 1e-12
#: The smallest normal float32. XLA on the CPU flushes subnormal results to
#: zero and a TPU has none, but PyTorch keeps them on the CPU and the card
#: alike; `exp` outputs below this are flushed to 0 explicitly (see
#: `_sinkhorn`).
_F32_TINY = float(torch.finfo(torch.float32).tiny)


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """(C, N) → (N,): x[0] + x[1] + ... in row order. Elementwise adds, so
    every column sums in the same order wherever it lies (a reduction
    over dim 0 may vectorize the columns and sum a ragged tail in another
    order, which would split identical columns)."""
    acc = x[0]
    for i in range(1, x.shape[0]):
        acc = acc + x[i]
    return acc


def _reduce_cols(x: torch.Tensor, op: str) -> torch.Tensor:
    """(C, N) → (C,): the sum or max over the node (column) axis."""
    return x.sum(dim=1) if op == "sum" else torch.amax(x, dim=1)


def sinkhorn_plan(feasible, cost, row_counts, col_cap, iters: int,
                  temp: float):
    """Entropic-regularized transport plan over the (C, N) class planes
    (the reference's `sinkhorn_plan`, the batch-optimal solve mode).

    - feasible (C, N) bool; cost (C, N): the chunk-start live scores;
    - row_counts (C,) f32: pods per class this chunk (padding rides the
      empty class row 0, whose all-false feasible row zeros its kernel
      row);
    - col_cap (N,): remaining pod slots per node, an INEQUALITY bound (the
      column step is v = min(1, b / col)).

    Costs are shifted per row by the row's feasible max; the temperature
    anneals over SINKHORN_STAGES stages (4T → 2T → T). `iters` and `temp`
    are host numbers (the live KTPU_SINKHORN_ITERS / KTPU_SINKHORN_TEMP
    knobs); the loop reads nothing back from the device.

    Returns (log_plan (C, N) f32, plan (C, N) f32); log_plan is sanitized
    (-1e30 where infeasible or not finite) so that it drops into the
    rounding scans as `static_scores`. Identical columns get bit-identical
    values, so on uniform workloads the rounding is first-fit.
    """
    return _sinkhorn(feasible, cost, row_counts, col_cap, iters, temp,
                     _reduce_cols)


def _sinkhorn(feasible, cost, row_counts, col_cap, iters: int, temp: float,
              reduce_cols):
    """`sinkhorn_plan`'s body; `reduce_cols(x, "sum" | "max")` reduces a
    (C, N) plane over the node axis (the node-sharded form reduces per
    shard, then across shards: parallel/sharded.sharded_sinkhorn_plan).

    The row marginal and the column sums are elementwise products summed
    with `sum` and `_sum_rows`, never `@`: no float32 product can fall to
    TF32, and every column's sum over C runs in row order, so identical
    columns stay bit-identical."""
    dev = cost.device
    a = row_counts.to(torch.float32)
    b = torch.clamp_min(col_cap.to(torch.float32), 0.0)
    n_iters = max(int(iters), 1)
    cost = cost.to(torch.float32)
    kmask = feasible.to(torch.float32)
    # Row-relative costs: subtract each row's feasible max so exp() is
    # bounded in (0, 1] and `temp` is scale-free.
    rmax = reduce_cols(torch.where(feasible, cost, NEG_INF), "max")
    sc = torch.where(feasible, cost - rmax[:, None], 0.0)
    stage_kernels: dict[int, torch.Tensor] = {}

    def kernel(stage: int) -> torch.Tensor:
        k = stage_kernels.get(stage)
        if k is None:
            t = np.maximum(
                np.float32(temp)
                * np.exp2(np.float32(SINKHORN_STAGES - 1 - stage)),
                np.float32(_EPS))
            # A 0-d tensor on the device, not a Python number: the card
            # divides by a host scalar as a product with its reciprocal.
            e = torch.exp(sc / torch.full((), float(t), dtype=torch.float32,
                                          device=dev))
            k = stage_kernels[stage] = kmask * e.masked_fill_(
                e < _F32_TINY, 0.0)
        return k

    u = torch.ones_like(a)
    v = torch.ones_like(b)
    for i in range(n_iters):
        k = kernel(min(SINKHORN_STAGES * i // n_iters, SINKHORN_STAGES - 1))
        u = a / torch.clamp_min(reduce_cols(k * v[None, :], "sum"), _EPS)
        col = _sum_rows(u[:, None] * k)
        v = torch.clamp_max(b / torch.clamp_min(col, _EPS), 1.0)
    plan = u[:, None] * kernel(SINKHORN_STAGES - 1) * v[None, :]
    log_plan = torch.log(plan + 1e-30)
    log_plan = torch.where(torch.isfinite(log_plan) & feasible, log_plan,
                           -1e30)
    return log_plan, plan


def _free_fraction(free_q, alloc_q):
    """Per node, the mean over resource columns with allocatable > 0 of
    the free/allocatable fraction."""
    alloc = alloc_q.to(torch.float32)
    frac = torch.where(alloc > 0, free_q.to(torch.float32) / alloc, 0.0)
    return kernels._sum_last(frac) / torch.clamp_min(
        (alloc > 0).sum(dim=1), 1)


def fragmentation(free_q, alloc_q, valid):
    """Node fragmentation %: the mean remaining-capacity fraction over the
    valid nodes (lower = tighter packing). 0-d float32 tensor."""
    per_node = _free_fraction(free_q, alloc_q)
    return 100.0 * torch.where(valid, per_node, 0.0).sum() / torch.clamp_min(
        valid.sum(), 1)


def fragmentation_occupied(free_q, alloc_q, used_pods, valid):
    """OCCUPIED-node fragmentation %: the mean free-capacity fraction over
    the nodes hosting at least one pod — the packing metric the optimal
    mode exists to lower (the all-nodes form is placement-invariant once
    every pod places). 0 occupied nodes → 0.0. 0-d float32 tensor."""
    occ = valid & (used_pods > 0)
    per_node = _free_fraction(free_q, alloc_q)
    return 100.0 * torch.where(occ, per_node, 0.0).sum() / torch.clamp_min(
        occ.sum(), 1)


def consolidation_scores(free_q, alloc_q, used_pods, valid, threshold):
    """Per-node consolidation priority for the descheduler
    (controllers/descheduler.py): occupied nodes whose mean free-capacity
    fraction is >= `threshold` are drain candidates, scored by that
    fraction (emptiest first: the node with the least to move frees a
    whole node soonest). Empty nodes, invalid rows and well-packed nodes
    score NEG_INF (never drained).

    free_q, alloc_q (N, R) f32; used_pods (N,) i32; valid (N,) bool;
    threshold an f32 scalar, compared as a host number (exact in f32, and
    no copy to the device). Returns (N,) f32 on the inputs' device. The
    sum over R is the index-order fold of `fragmentation`, so the scores
    are the reference's bit for bit."""
    per_node = _free_fraction(free_q, alloc_q)
    eligible = valid & (used_pods > 0) & (per_node >= float(
        np.float32(threshold)))
    return torch.where(eligible, per_node, NEG_INF)


# ---------------------------------------------------------------------------
# the serving fast path: one pod against the resident cluster planes
# ---------------------------------------------------------------------------

def _solve_one_core(alloc_q, used_pack, alloc_pods, taint_f_mat,
                    taint_p_mat, mask_bits, host_scores, req_pack,
                    fit_col_w, bal_col_mask, shape_u, shape_s,
                    w_fit, w_bal, w_taint, taint_filter_on, strategy):
    """Body shared by solve_one / solve_one_fresh."""
    dev = alloc_q.device
    n = alloc_q.shape[0]
    r = alloc_q.shape[1]
    tf = taint_f_mat.shape[1]
    # Wire decompression, identical to chunk_planes' (big-endian) unpack.
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    cmask = ((mask_bits[:, None] >> shifts) & 1).reshape(-1) \
        .to(torch.bool)[:n]
    used_q = used_pack[:, :r]
    used_nz = used_pack[:, r:2 * r]
    used_pods = used_pack[:, 2 * r]
    req_q = req_pack[None, :r]
    req_nz = req_pack[None, r:2 * r]
    untol_f = req_pack[2 * r:2 * r + tf].to(torch.bool)[None]
    untol_p = req_pack[2 * r + tf:].to(torch.bool)[None]

    fit0 = kernels.fit_filter_mask(
        alloc_q, used_q, used_pods, alloc_pods, req_q)          # (1,N)
    taint_ok = kernels.taint_filter_mask(taint_f_mat, untol_f)
    if not taint_filter_on:
        taint_ok = torch.ones_like(taint_ok)
    mask = cmask[None, :] & taint_ok
    feasible = mask & fit0
    static = host_scores[None, :].to(torch.float32) \
        + w_taint * kernels.taint_toleration_score(
            taint_p_mat, untol_p, feasible)

    # The scan step body for pod 0: chunk-start free state IS the
    # current state for a single-pod "chunk".
    free_q = alloc_q - used_q
    free_pods = alloc_pods - used_pods
    fits = mask[0] & torch.all(req_q[0][None, :] <= free_q, dim=1) \
        & (free_pods >= 1)
    sc = static[0]
    sc = sc + w_fit * kernels.fit_score(
        alloc_q, used_nz, req_nz, fit_col_w, strategy, shape_u, shape_s)[0]
    sc = sc + w_bal * kernels.balanced_allocation_score(
        alloc_q, used_nz, req_nz, bal_col_mask)[0]
    idx = _argmax_low(torch.where(fits, sc, NEG_INF), n)
    return torch.where(torch.any(fits), idx, -1)


def solve_one(alloc_q, used_pack, alloc_pods, taint_f_mat, taint_p_mat,
              mask_bits, host_scores, req_pack,
              fit_col_w, bal_col_mask, shape_u, shape_s,
              w_fit, w_bal, w_taint, taint_filter_on, strategy: str):
    """One pod against the resident cluster planes, identical to the
    batch path's first scan step (the reference's `solve_one`).

    The composition is the one `mask_solve_update` + the greedy scan
    compute for the first pod of a chunk — the same kernels in the same
    order on the same dtypes, with the same association
    (`static = host_scores + w_taint·taint_score`, then `+ w_fit·fit`, then
    `+ w_bal·bal`) and the same tie rule (`_argmax_low`) — so a lone pod
    gets the node the batch path would give it. What is removed is
    everything a lone pod cannot use: the P-step scan, the multistart
    orders, gang masks and the per-chunk plane build.

    mask_bits: (N/8,) uint8 bit-packed host filter row (the pod's AND-
        folded static rows; all-true for the common template pod).
    host_scores: (N,) f16/f32 host score row (zero for the common pod).
    req_pack: (2R+tf+tp,) int32 — req_q ‖ req_nz_q ‖ untol_f ‖ untol_p.
    used_pack: (N, 2R+1) int32 resident used state (used_q ‖ used_nz_q ‖
        used_pods).
    w_fit, w_bal, w_taint: float32-valued host numbers; taint_filter_on:
        a host bool.

    Returns the node index as a 0-d int32 tensor (-1 = no fit). Nothing
    here reads a value back from the device. There is no debit output:
    the placement's assume re-enters through the cache's dirty set and the
    next refresh re-quantizes that row.
    """
    return _solve_one_core(
        alloc_q, used_pack, alloc_pods, taint_f_mat, taint_p_mat,
        mask_bits, host_scores, req_pack, fit_col_w, bal_col_mask,
        shape_u, shape_s, w_fit, w_bal, w_taint, taint_filter_on, strategy)


def solve_one_fresh(alloc_q, used_pack, rows, vals, alloc_pods,
                    taint_f_mat, taint_p_mat, mask_bits, host_scores,
                    req_pack, fit_col_w, bal_col_mask, shape_u, shape_s,
                    w_fit, w_bal, w_taint, taint_filter_on, strategy: str):
    """solve_one with the resident-plane refresh fused in: a NEW pack with
    the dirty rows set (`vals` re-quantized on the host; `rows` padded to
    a bucket by repeating the first row with its values, so duplicate
    writes agree), then the solve against it. `used_pack` is left
    untouched. Returns (idx, refreshed pack): the caller keeps the
    refreshed, pre-debit pack as the new resident base."""
    pack = used_pack.index_put((rows.long(),), vals)
    idx = _solve_one_core(
        alloc_q, pack, alloc_pods, taint_f_mat, taint_p_mat,
        mask_bits, host_scores, req_pack, fit_col_w, bal_col_mask,
        shape_u, shape_s, w_fit, w_bal, w_taint, taint_filter_on, strategy)
    return idx, pack


# ---------------------------------------------------------------------------
# Preemption: the batched victim proposal.
# ---------------------------------------------------------------------------

#: int32 "no victim" priority padding (k8s priorities are int32 by API).
PRIO_INF = 2**31 - 1


def _first_true(ok: torch.Tensor) -> torch.Tensor:
    """Per row of a 2-D bool tensor, the index of its first True, 0 when
    the row has none (`jnp.argmax` over a bool row)."""
    k = ok.shape[1]
    karange = torch.arange(k, dtype=torch.int32, device=ok.device)
    first = torch.where(ok, karange[None, :], k).amin(dim=1)
    return torch.where(first < k, first, 0)


def _min_index(x: torch.Tensor) -> torch.Tensor:
    """Index of the minimum of a 1-D tensor, ties to the lowest index
    (`jnp.argmin`), as a (1,) int64 tensor."""
    iota = torch.arange(x.shape[0], dtype=torch.int64, device=x.device)
    return torch.where(x == x.amin(), iota, x.shape[0]).amin().reshape(1)


def propose_victims(req_q, prio, banned, used, alloc, pods_used, pods_alloc,
                    vreq, vprio, offsets):
    """Batched preemption victim proposal (the reference's
    `propose_victims`): one device program proposes, for every failed
    preemptor of a wave in order, the cost-minimal (node, victim count),
    threading in-wave claims through per-node state.

    Per node, victims are the priority-ASCENDING resident prefix (the order
    `DefaultPreemption`'s wave state builds), so "evict the first k" is the
    cheapest k-victim set and prefix feasibility is a relaxed-capacity
    check. A chosen node's victim prefix is shifted out and the preemptor's
    load charged, so later preemptors of the wave see it.

    req_q:    (P, R) int32 preemptor requests, wave order
    prio:     (P,)   int32 preemptor priorities
    banned:   (P, N) bool — UnschedulableAndUnresolvable nodes per preemptor
    used/alloc:        (N, R) int32 node requested/allocatable
    pods_used/alloc:   (N,)   int32
    vreq:     (N, K, R) int32 per-victim requests (ascending priority; 0 pad)
    vprio:    (N, K)    int32 per-victim priorities (PRIO_INF pad)
    offsets:  (P,) int32 per-preemptor rotation of the equal-cost tiebreak:
        ties pick the node minimizing (index - offset) mod N.

    Cost order: lowest max victim priority, then smallest priority sum (a
    float32 prefix sum, exact below 2^24), then fewest victims. Returns
    (node (P,) int32 [-1 = no candidate], count (P,) int32, used',
    pods_used', vreq', vprio'): the post-claim carry, so a caller chunking
    a wave threads it into the next call.

    One preemptor per step (`_run_steps`: on the card every tensor a step
    touches is allocated before a CUDA graph captures one step, which is
    then replayed per preemptor; eager on the CPU). Nothing is read back
    from the device."""
    p = req_q.shape[0]
    n, k, r = vreq.shape
    dev = used.device
    iota_n = torch.arange(n, dtype=torch.int32, device=dev)
    karange = torch.arange(k, dtype=torch.int32, device=dev)
    big = PRIO_INF
    state = (used.clone(), pods_used.clone(), vreq.clone(), vprio.clone())
    node_out = torch.full((p,), -1, dtype=torch.int32, device=dev)
    count_out = torch.zeros((p,), dtype=torch.int32, device=dev)
    i = torch.zeros((1,), dtype=torch.long, device=dev)

    def step():
        used_s, pused_s, vreq_s, vprio_s = state
        q = req_q.index_select(0, i)[0]                        # (R,)
        pr = prio.index_select(0, i)                           # (1,)
        ban = banned.index_select(0, i)[0]                     # (N,)
        off = offsets.index_select(0, i)                       # (1,)
        valid = vprio_s < PRIO_INF                             # (N, K)
        rel = torch.cumsum(vreq_s, dim=1, dtype=torch.int32)   # (N, K, R)
        prio_m = torch.where(valid, vprio_s, 0)
        # The priority SUM rides float32, as in the reference: an int32
        # sum of near-INT32_MAX priorities over a deep prefix overflows.
        vsum = torch.cumsum(prio_m.to(torch.float32), dim=1)
        vmax = torch.cummax(prio_m, dim=1).values
        # Ascending order: vprio[k] < p implies the whole prefix is below.
        eligible = vprio_s < pr
        fits = torch.all(used_s[:, None, :] - rel + q[None, None, :]
                         <= alloc[:, None, :], dim=-1)
        fits = fits & (pused_s[:, None] - karange[None, :]
                       <= pods_alloc[:, None])
        ok = eligible & fits                                   # (N, K)
        any_ok = torch.any(ok, dim=1) & ~ban
        kmin = _first_true(ok)                                 # (N,)
        cmax = vmax.gather(1, kmin.long()[:, None])[:, 0]
        csum = vsum.gather(1, kmin.long()[:, None])[:, 0]
        # Staged lexicographic argmin (vmax, vsum, count), then rotation.
        k1 = torch.where(any_ok, cmax, big)
        c1 = any_ok & (cmax == k1.amin())
        k2 = torch.where(c1, csum, float("inf"))
        c2 = c1 & (csum == k2.amin())
        k3 = torch.where(c2, kmin, big)
        c3 = c2 & (kmin == k3.amin())
        rot = torch.remainder(iota_n - off, n)
        n_star = _min_index(torch.where(c3, rot, big))         # (1,) long
        found = torch.any(any_ok)
        count = kmin.index_select(0, n_star) + 1               # (1,)
        # Claim: drop the chosen prefix, charge the preemptor, shift the
        # node's victim rows so later preemptors see the truth. Only row
        # n_star changes, and only when a candidate was found.
        freed = rel.index_select(0, n_star)[0].index_select(
            0, (count - 1).long())[0]                          # (R,)
        used_s.index_add_(0, n_star, torch.where(
            found, q - freed, 0)[None, :])
        pused_s.index_add_(0, n_star, torch.where(found, 1 - count, 0))
        src = torch.clamp(karange + count, 0, k - 1).long()
        keep = (karange + count) < k
        old_vreq = vreq_s.index_select(0, n_star)[0]           # (K, R)
        old_vprio = vprio_s.index_select(0, n_star)[0]         # (K,)
        row_vreq = torch.where(keep[:, None], old_vreq.index_select(0, src),
                               0)
        row_vprio = torch.where(keep, old_vprio.index_select(0, src),
                                PRIO_INF)
        vreq_s.index_copy_(0, n_star, torch.where(
            found, row_vreq, old_vreq)[None])
        vprio_s.index_copy_(0, n_star, torch.where(
            found, row_vprio, old_vprio)[None])
        node_out.index_copy_(0, i, torch.where(
            found, n_star.to(torch.int32), -1))
        count_out.index_copy_(0, i, torch.where(found, count, 0))
        i.add_(1)

    _run_steps(step, p, dev)
    return (node_out, count_out) + state
