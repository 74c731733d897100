"""Batched pod→node assignment in PyTorch: the greedy wavefront solve and
the Sinkhorn optimal mode.

Counterpart of `kubernetes_tpu/ops/solver.py`, cut to the greedy
multistart wavefront route, the batch-optimal route, the spread scans and
the serving fast path's single-pod solve. The reference's
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
        for yp in ys:
            row = torch.where(node_of[w] == yp, NEG_INF, row)
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
    if bool(pois.any()):
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
