"""Node-sharded variants of the batched scheduling step.

Counterpart of `kubernetes_tpu/parallel/sharded.py`, with the same two
phases and the same semantics:

1. `sharded_masks_scores` — the (P×N) mask and capacity-independent score
   phase, tile by tile over a (pods × nodes) mesh. Each tile is shard-local;
   the one value that crosses tiles is each pod's largest untolerated-taint
   count over its feasible nodes (the TaintToleration normalization), a max
   over the nodes axis.

2. `sharded_greedy_assign` / `sharded_greedy_assign_multislice` — the
   sequential-equivalent greedy with live re-scoring, node axis sharded. Per
   step each shard finds its local candidate (max score, lowest local index
   among ties), the global winner is the max of the shards' scores, then the
   min of the global indices of the shards holding it (the reference's
   `pmax` → `pmin`, innermost mesh axis first), and the owner shard debits
   its capacity. Ties go to the lowest GLOBAL node index, so assignments
   equal the single-device solver's at every shard count. `wave_w > 1` runs
   the speculative wavefront form (W pods per step with exact replay; see
   `_wave_body`).

How the reference's `shard_map` maps here: every shard of a mesh lies on
one device (`Mesh.device`), so the S shards are a leading axis of the node
state, (S, L, ...) with L = N / S in the flattened shard order (first mesh
axis major, so the shard of node i is i // L and its base is shard · L),
and `pmax`/`pmin` are reductions over that axis. Shard-local work that is
elementwise over nodes (the live re-score) runs over all shards' nodes at
once; every reduction that the reference runs per shard runs per shard
here, including the reference's local index rule on an all-infeasible
shard (see `_Shards.local_best`).

Not ported yet: the shard-local shortlist and block index (`shortlist_k`,
`block_w`; ROADMAP queue 1 item 3) — they raise NotImplementedError;
`sharded_sinkhorn_plan` (with the Sinkhorn slice) and
`resident_row_scatter` (with the serving slice).
"""

from __future__ import annotations

import math

import torch

from kubernetes_tpu_torch.ops import kernels, solver, wave_eval
from kubernetes_tpu_torch.parallel.mesh import (
    NODES_AXIS, PODS_AXIS, SLICE_AXIS, Mesh)

NEG_INF = float("-inf")
#: "no pick" sentinel of the winner reduction, as in the reference.
_INT_MAX = 2**31 - 1


# ---------------------------------------------------------------------------
# phase 1: masks + static scores (2-D pods × nodes mesh)
# ---------------------------------------------------------------------------

def _tiles(total: int, parts: int) -> list[tuple[int, int]]:
    """(lo, hi) ranges of `total` split over `parts` tiles, the larger
    tiles first (np.array_split's split)."""
    q, rem = divmod(total, parts)
    out, lo = [], 0
    for i in range(parts):
        hi = lo + q + (i < rem)
        out.append((lo, hi))
        lo = hi
    return out


def sharded_masks_scores(mesh: Mesh, alloc_q, used_q, used_nz_q,
                         alloc_pods, used_pods, req_q, req_nz_q, untol_f,
                         untol_p, taint_f_mat, taint_p_mat, static_mask,
                         host_scores, w_taint, taint_filter_on: bool,
                         strategy: str):
    """Mask + capacity-independent score phase over a (pods × nodes) mesh.

    Returns (mask (P,N), feasible (P,N), static_scores (P,N)) with mask
    excluding capacity (the solver re-checks capacity live) and
    static_scores = host_scores + w_taint × taint score over the feasible
    set. `used_nz_q`, `req_nz_q` and `strategy` are the reference's
    arguments; this phase does not read them (fit and balanced are scored
    live inside the solver)."""
    dev = mesh.device
    (alloc_q, used_q, alloc_pods, used_pods, req_q, untol_f, untol_p,
     taint_f_mat, taint_p_mat, static_mask, host_scores) = (
        t.to(dev) for t in (alloc_q, used_q, alloc_pods, used_pods, req_q,
                            untol_f, untol_p, taint_f_mat, taint_p_mat,
                            static_mask, host_scores))
    p, n = static_mask.shape
    mask = torch.empty((p, n), dtype=torch.bool, device=dev)
    feasible = torch.empty_like(mask)
    counts = torch.empty((p, n), dtype=torch.float32, device=dev)
    row_max = torch.full((p, 1), NEG_INF, dtype=torch.float32, device=dev)
    for plo, phi in _tiles(p, mesh.shape[PODS_AXIS]):
        for nlo, nhi in _tiles(n, mesh.shape[NODES_AXIS]):
            pods, nodes = slice(plo, phi), slice(nlo, nhi)
            fit0 = kernels.fit_filter_mask(
                alloc_q[nodes], used_q[nodes], used_pods[nodes],
                alloc_pods[nodes], req_q[pods])
            taint_ok = kernels.taint_filter_mask(taint_f_mat[nodes],
                                                 untol_f[pods])
            if not taint_filter_on:
                taint_ok = torch.ones_like(taint_ok)
            m = static_mask[pods, nodes] & taint_ok
            f = m & fit0
            c = kernels.taint_prefer_counts(taint_p_mat[nodes],
                                            untol_p[pods])
            mask[pods, nodes] = m
            feasible[pods, nodes] = f
            counts[pods, nodes] = c
            # The normalization's max over the nodes axis, tile by tile.
            row_max[pods] = torch.maximum(row_max[pods], torch.amax(
                torch.where(f, c, NEG_INF), dim=1, keepdim=True))
    static_scores = host_scores.to(torch.float32) + float(w_taint) \
        * kernels.taint_normalize(counts, row_max)
    return mask, feasible, static_scores


# ---------------------------------------------------------------------------
# phase 2: sequential-equivalent solver (node axis sharded)
# ---------------------------------------------------------------------------

def sharded_greedy_assign(mesh: Mesh, req_q, req_nz_q, free_q, free_pods,
                          used_nz_q, alloc_q, mask, static_scores,
                          fit_col_w, bal_col_mask, shape_u, shape_s,
                          w_fit, w_bal, strategy: str,
                          shortlist_k: int = 0, rows=None, exc=None,
                          row_req_q=None, row_req_nz_q=None,
                          wave_w: int = 0, kernel: bool = True,
                          block_w: int = 0):
    """Sequential-equivalent greedy with live re-scoring, node axis sharded
    over the mesh's `nodes` axis. Returns (P,) int32 global node indices,
    -1 = no fit; the same assignments as ops/solver.greedy_assign_rescoring
    on the unsharded inputs.

    Inputs are global: free_q/used_nz_q/alloc_q (N,R) int32, free_pods
    (N,) int32, mask (C,N) bool and static_scores (C,N) float32 plane rows
    addressed per pod through `rows` ((P,) int32, default: row i for pod
    i), `exc` ((P,) int32 GLOBAL single-allowed-column exception, -1 =
    none). N must divide by the shard count (`mesh.pad_axis` pads it).
    `row_req_q`/`row_req_nz_q` feed only the reference's shard-local
    shortlist prefilter; they are accepted and not read.

    wave_w > 1 runs the speculative wavefront form: W pods per step, each
    wave's evaluation shard-local, the W prefix-distinct picks resolved by
    the same winner reduction, conflicts detected in global coordinates,
    and a conflicted wave replayed serially — assignments identical to the
    serial form at every W and shard count.

    kernel=True (the counterpart of the reference's `pallas=True`) runs
    each wave's shard-local evaluation through `ops/wave_eval.wave_eval`:
    the hand-written CUDA kernel on CUDA tensors, one launch per wave for
    all shards; its plain version on CPU tensors. kernel=False runs the
    inline evaluation (the reference's `pallas=False`). Everything that
    crosses shards is the same either way.

    shortlist_k > 0 and block_w > 0 (the shard-local shortlist and block
    index) are not ported yet and raise NotImplementedError."""
    return _solve(mesh, (NODES_AXIS,), req_q, req_nz_q, free_q, free_pods,
                  used_nz_q, alloc_q, mask, static_scores, fit_col_w,
                  bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy,
                  shortlist_k, rows, exc, wave_w, kernel, block_w)


def sharded_greedy_assign_multislice(mesh: Mesh, req_q, req_nz_q, free_q,
                                     free_pods, used_nz_q, alloc_q, mask,
                                     static_scores, fit_col_w, bal_col_mask,
                                     shape_u, shape_s, w_fit, w_bal,
                                     strategy: str, shortlist_k: int = 0,
                                     rows=None, exc=None,
                                     row_req_q=None, row_req_nz_q=None,
                                     wave_w: int = 0, kernel: bool = True,
                                     block_w: int = 0):
    """`sharded_greedy_assign` over a (slice × nodes) mesh: the node
    dimension shards over BOTH axes (flattened slice-major) and each
    winner reduction runs over `nodes` first, then `slice`. Same arguments
    and result."""
    return _solve(mesh, (SLICE_AXIS, NODES_AXIS), req_q, req_nz_q, free_q,
                  free_pods, used_nz_q, alloc_q, mask, static_scores,
                  fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy, shortlist_k, rows, exc, wave_w, kernel, block_w)


class _Shards:
    """The node state of one solve as S shards of L nodes on one device.

    free_q/used_nz/alloc (S, L, R), free_pods (S, L), mask/static
    (S, C, L); the `*_flat` names are (S·L, ...) views of the same storage.
    The capacity carry is a copy of the caller's state, debited in place.
    """

    def __init__(self, sizes, free_q, free_pods, used_nz, alloc_q, mask,
                 static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
                 w_fit, w_bal, strategy):
        dev = free_q.device
        n, r = free_q.shape
        self.sizes = sizes
        s = self.S = math.prod(sizes)
        L = self.L = n // s
        c = mask.shape[0]
        own = dict(memory_format=torch.contiguous_format)
        self.fq = free_q.reshape(s, L, r).clone(**own)
        self.fp = free_pods.reshape(s, L).clone(**own)
        self.unz = used_nz.reshape(s, L, r).clone(**own)
        self.alloc = alloc_q.reshape(s, L, r).contiguous()
        self.fq_flat = self.fq.view(s * L, r)
        self.fp_flat = self.fp.view(s * L)
        self.unz_flat = self.unz.view(s * L, r)
        self.alloc_flat = self.alloc.view(s * L, r)
        self.mask = mask.reshape(c, s, L).transpose(0, 1).contiguous()
        self.static = static_scores.to(torch.float32).reshape(
            c, s, L).transpose(0, 1).contiguous()
        self.iota = torch.arange(L, dtype=torch.int64, device=dev)
        self.base = torch.arange(s, dtype=torch.int64, device=dev) * L
        self.gid = self.base[:, None] + self.iota[None, :]      # (S, L)
        self.score_args = (fit_col_w, bal_col_mask, shape_u, shape_s,
                           float(w_fit), float(w_bal), strategy)

    def reduce(self, val, op):
        """A per-shard (S, ...) value reduced over the mesh axes, innermost
        first (the reference's `_reduce` over `pmax`/`pmin`)."""
        v = val.reshape(*self.sizes, *val.shape[1:])
        for d in reversed(range(len(self.sizes))):
            v = op(v, dim=d)
        return v

    def winner(self, lbest, lidx):
        """Global (best score, lowest global index holding it) from each
        shard's local (S,) best and local index."""
        gbest = self.reduce(lbest, torch.amax)
        gcand = torch.where((lidx < self.L) & (lbest >= gbest),
                            lidx + self.base, _INT_MAX)
        return gbest, self.reduce(gcand, torch.amin)

    def local_best(self, masked):
        """Per-shard (max, lowest local index holding it) of (S, L) scores.
        On an all-infeasible shard the max is -inf, every entry holds it,
        and the index is 0 — the reference's rule, which `winner` keeps out
        of the global pick by `lbest >= gbest` alone."""
        lbest = masked.amax(dim=1)
        lidx = torch.where(masked == lbest[:, None], self.iota,
                           self.L).amin(dim=1)
        return lbest, lidx

    def live_scores(self, alloc, used, req_nz, static_rows):
        """static + w_fit·fit + w_bal·balanced of (W,R) requests over
        (S, M, R) node rows → (S, W, M); elementwise, so all shards' rows
        score as one flattened node axis."""
        fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy \
            = self.score_args
        s, m, r = alloc.shape
        w = req_nz.shape[0]

        def per_shard(x):                               # (W, S·M)
            return x.reshape(w, s, m).transpose(0, 1)
        alloc, used = alloc.reshape(s * m, r), used.reshape(s * m, r)
        sc = static_rows + w_fit * per_shard(kernels.fit_score(
            alloc, used, req_nz, fit_col_w, strategy, shape_u, shape_s))
        return sc + w_bal * per_shard(kernels.balanced_allocation_score(
            alloc, used, req_nz, bal_col_mask))

    def local_full(self, req, req_nz, m, row):
        """Exact per-shard (best score, local index) of one pod over every
        node of its shard: the reference's `local_full`. req/req_nz (R,),
        m (S, L) gated mask, row (1,) plane row."""
        fits = m & torch.all(req <= self.fq, dim=-1) & (self.fp >= 1)
        static_row = self.static.index_select(1, row)          # (S, 1, L)
        sc = self.live_scores(self.alloc, self.unz, req_nz[None, :],
                              static_row)[:, 0]
        return self.local_best(torch.where(fits, sc, NEG_INF))

    def gate(self, row, e):
        """(S, L) gated mask of one pod: its plane row, and its exception
        column (global `e` (1,), -1 = none) in each shard's coordinates."""
        m = self.mask.index_select(1, row)[:, 0]
        return m & ((e < 0) | (self.iota == e - self.base[:, None]))

    def commit(self, y, req, req_nz):
        """Debit (W,) global picks (any value outside [0, N) = none) of
        requests (W,R) on their owner shards."""
        li = y[None, :] - self.base[:, None]                    # (S, W)
        inb = (li >= 0) & (li < self.L)
        idx = (self.base[:, None] + li.clamp(0, self.L - 1)).reshape(-1)
        self.fq_flat.index_add_(0, idx, torch.where(
            inb[..., None], -req[None], 0).reshape(-1, req.shape[1]))
        self.fp_flat.index_add_(0, idx, torch.where(
            inb, -1, 0).to(self.fp.dtype).reshape(-1))
        self.unz_flat.index_add_(0, idx, torch.where(
            inb[..., None], req_nz[None], 0).reshape(-1, req.shape[1]))

    def serial_step(self, req, req_nz, m, row):
        """One pod: local bests, the winner reduction, the owner's debit.
        Returns the (1,) global node index, -1 = no fit."""
        gbest, gidx = self.winner(*self.local_full(req, req_nz, m, row))
        chosen = torch.where(torch.isfinite(gbest), gidx, -1).reshape(1)
        self.commit(chosen, req[None], req_nz[None])
        return chosen


def _solve(mesh, axes, req_q, req_nz_q, free_q, free_pods, used_nz_q,
           alloc_q, mask, static_scores, fit_col_w, bal_col_mask, shape_u,
           shape_s, w_fit, w_bal, strategy, shortlist_k, rows, exc, wave_w,
           kernel, block_w):
    if shortlist_k > 0 or block_w > 0:
        raise NotImplementedError(
            f"shortlist_k={shortlist_k}, block_w={block_w}: the sharded "
            "shortlist and block-index routes are not ported yet (ROADMAP "
            "queue 1 item 3)")
    dev = mesh.device
    sizes = tuple(mesh.shape[a] for a in axes)
    shards = math.prod(sizes)
    n_total = free_q.shape[0]
    if n_total % shards:
        raise ValueError(f"{n_total} nodes do not divide into {shards} "
                         "shards; pad the node axis (pad_axis)")
    if mask.shape[1] != n_total or static_scores.shape != mask.shape:
        raise ValueError(
            f"plane shapes mask {tuple(mask.shape)}, static_scores "
            f"{tuple(static_scores.shape)} do not cover {n_total} nodes")
    p = req_q.shape[0]
    if rows is None:
        rows = torch.arange(p, dtype=torch.int32, device=dev)
    if exc is None:
        exc = torch.full((p,), -1, dtype=torch.int32, device=dev)
    (req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
     static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, rows,
     exc) = (t.to(dev) for t in (
         req_q, req_nz_q, free_q, free_pods, used_nz_q, alloc_q, mask,
         static_scores, fit_col_w, bal_col_mask, shape_u, shape_s, rows,
         exc))
    if p and (int(rows.min()) < 0 or int(rows.max()) >= mask.shape[0]):
        raise ValueError(f"rows must index the {mask.shape[0]} plane rows")
    if p == 0:
        return torch.empty((0,), dtype=torch.int32, device=dev)
    st = _Shards(sizes, free_q, free_pods, used_nz_q, alloc_q, mask,
                 static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
                 w_fit, w_bal, strategy)
    if wave_w > 1:
        return _wave_body(st, req_q, req_nz_q, rows, exc, wave_w, kernel)
    rows_l = rows.long()
    out = [st.serial_step(req_q[i], req_nz_q[i],
                          st.gate(rows_l[i:i + 1], exc[i:i + 1]),
                          rows_l[i:i + 1])
           for i in range(p)]
    return torch.cat(out).to(torch.int32)


def _wave_body(st: _Shards, req_q, req_nz_q, rows, exc, wave_w: int,
               kernel: bool):
    """The wavefront form of the sharded solver (the reference's
    `_wave_body`). Per wave of W pods:

    - ONE shard-local (S, W, L) evaluation against the carry — gated mask,
      capacity fit, live score — through `wave_eval` (kernel=True) or
      inline (kernel=False);
    - W prefix-distinct global picks: member w takes the winner reduction
      over its scores with the nodes earlier members picked masked out;
    - the conflict check in GLOBAL coordinates: each pick's owner shard
      re-scores it after its debit for every later member, and the (W,)
      conflict bits max-reduce across shards;
    - one decision for all shards, read on the host (the one device sync
      of the wave): commit the picks, or replay the wave one pod at a time.

    Picks and replay share the serial tie rule (lowest global index among
    max scorers), so assignments equal the serial form's."""
    p = req_q.shape[0]
    s, L = st.S, st.L
    W = max(1, min(wave_w, p))
    (req_w, req_nz_w, rows_w, ex_w), real_w = solver._wave_split(
        W, (req_q, req_nz_q, rows, exc))
    w_iota = torch.arange(W, device=req_q.device)
    later = w_iota[None, :] < w_iota[:, None]             # j < w
    shard_ix = torch.arange(s, device=req_q.device)[:, None, None]
    evaluate = wave_eval.wave_eval if kernel \
        else wave_eval.wave_eval_reference
    base32 = st.base.to(torch.int32)
    outs = []
    for req, req_nz, row, e, real in zip(req_w, req_nz_w, rows_w, ex_w,
                                         real_w):
        el = (e[None, :] - base32[:, None]).contiguous()     # local exc
        masked, m = evaluate(st.mask, st.static, st.alloc, st.fq, st.fp,
                             st.unz, req, req_nz, row, e, el, real,
                             *st.score_args)                # (S, W, L)
        # Prefix-distinct global picks.
        taken = torch.zeros((s, L), dtype=torch.bool, device=masked.device)
        bs, ys = [], []
        for w in range(W):
            rv = torch.where(taken, NEG_INF, masked[:, w])
            gbest, gidx = st.winner(*st.local_best(rv))
            y = torch.where(torch.isfinite(gbest), gidx, _INT_MAX)
            if w + 1 < W:
                taken = taken | (st.gid == y)
            ys.append(y)
            bs.append(gbest)
        b = torch.stack(bs)
        y = torch.stack(ys)                                # global ids
        hit = y < _INT_MAX
        li = y[None, :] - st.base[:, None]                 # (S, W)
        own = (li >= 0) & (li < L)
        safe = li.clamp(0, L - 1)
        idx = st.base[:, None] + safe
        # Conflicts: the owner of each pick y_j re-scores it after member
        # j's debit for every later member w; non-owners contribute False.
        fr_j = st.fq_flat[idx] - req                       # (S, W, R)
        fp_j = st.fp_flat[idx] - 1
        unz_j = st.unz_flat[idx] + req_nz
        upd = st.live_scores(
            st.alloc_flat[idx], unz_j, req_nz,
            st.static[shard_ix, row.long()[None, :, None], safe[:, None, :]])
        cap = torch.all(req[None, :, None, :] <= fr_j[:, None, :, :], dim=-1)
        feas = torch.gather(m, 2, safe[:, None, :].expand(s, W, W)) & cap \
            & (fp_j >= 1)[:, None, :] & (hit[None, :] & own)[:, None, :]
        beats = feas & ((upd > b[None, :, None])
                        | ((upd == b[None, :, None])
                           & (y[None, None, :] < y[None, :, None])))
        conflict = st.reduce(torch.any(beats & later, dim=2)
                             .to(torch.int32), torch.amax) > 0
        if not bool(conflict.any()):
            st.commit(y, req, req_nz)
            outs.append(torch.where(hit, y, -1))
            continue
        rl = row.long()
        outs.append(torch.cat([
            st.serial_step(req[w], req_nz[w],
                           st.gate(rl[w:w + 1], e[w:w + 1]) & real[w],
                           rl[w:w + 1])
            for w in range(W)]))
    return torch.cat(outs)[:p].to(torch.int32)
