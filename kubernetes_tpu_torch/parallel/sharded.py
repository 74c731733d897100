"""Node-sharded variants of the batched scheduling step.

Counterpart of `kubernetes_tpu/parallel/sharded.py`, with the same
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
   `_wave_body`), each wave one `ops/wave_eval.wave_step`: on the card two
   kernel launches and no host sync. `shortlist_k > 0` at W <= 1 prunes
   shard-locally before the winner reduction (`_shortlist_body`): each
   shard prefilters its own top-K columns per plane row (`block_w > 0`:
   through the two-pass block prefilter over its own columns) and
   re-scores only those and its debited nodes per step, with the
   shortlist bound check; a solve where some step cannot prove its
   shard's best runs again with the full local row at such steps. W > 1
   keeps the wave form (the reference lets the shortlist win over W; the
   wave step's two kernel launches per wave beat the eager narrow step,
   and the assignments are the same).

How the reference's `shard_map` maps here: every shard of a mesh lies on
one device (`Mesh.device`), so the S shards are a leading axis of the node
state (`ops/wave_eval.Shards`), (S, L, ...) with L = N / S in the flattened
shard order (first mesh axis major, so the shard of node i is i // L and
its base is shard · L), and `pmax`/`pmin` are reductions over that axis.
Shard-local work that is elementwise over nodes (the live re-score) runs
over all shards' nodes at once; every reduction that the reference runs per
shard runs per shard in the plain version, including the reference's local
index rule on an all-infeasible shard (see `Shards.local_best`). max and
min are associative, so the kernels reduce over all S·L nodes at once and
reach the same (score desc, global id asc) winner.

3. `sharded_sinkhorn_plan` — the optimal mode's transport plan with the
   node (column) axis sharded: each shard owns a column block, the row max
   and the row marginal are reduced per shard and then across the shards
   (innermost mesh axis first), and the column step is shard-local.

4. `resident_row_scatter` — the serving tier's out-of-place row scatter
   into the resident used-state pack.

"""

from __future__ import annotations

import math

import torch

from kubernetes_tpu_torch.ops import kernels, solver, wave_eval
from kubernetes_tpu_torch.parallel.mesh import (
    NODES_AXIS, PODS_AXIS, SLICE_AXIS, Mesh)

NEG_INF = float("-inf")


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
    `row_req_q`/`row_req_nz_q` ((C, R), default req_q / req_nz_q: the
    per-pod form) are the plane rows' request vectors, which the
    shard-local shortlist prefilter reads.

    wave_w > 1 runs the speculative wavefront form: W pods per step, each
    wave's evaluation shard-local, the W prefix-distinct picks resolved by
    the same winner reduction, conflicts detected in global coordinates,
    and a conflicted wave replayed serially — assignments identical to the
    serial form at every W and shard count.

    kernel=True (the counterpart of the reference's `pallas=True`) runs
    each wave through `ops/wave_eval.wave_step`: on CUDA tensors two
    hand-written kernel launches for all shards (the evaluation with
    per-block top lists, then the picks, the conflict check and the commit
    or replay), with no host sync until the assignments are read; on CPU
    tensors its plain version. kernel=False runs `wave_step_reference`, the
    inline evaluation and the reductions as torch ops (the reference's
    `pallas=False`). The assignments are the same either way.

    shortlist_k > 0 with wave_w <= 1 runs the shard-local shortlist
    (`_shortlist_body`) with K = min(shortlist_k, L - 1) per shard of L
    columns; a shard of one column keeps the full scan. block_w > 0 routes
    each shard's prefilter through the block prefilter where its column
    count passes the M+1 <= B guard (`_block_w_for`), else the full-width
    local prefilter. wave_w > 1 wins over the shortlist. Assignments equal
    the serial form's."""
    return _solve(mesh, (NODES_AXIS,), req_q, req_nz_q, free_q, free_pods,
                  used_nz_q, alloc_q, mask, static_scores, fit_col_w,
                  bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy,
                  shortlist_k, rows, exc, wave_w, kernel, block_w,
                  row_req_q, row_req_nz_q)


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
                  strategy, shortlist_k, rows, exc, wave_w, kernel, block_w,
                  row_req_q, row_req_nz_q)


def _block_w_for(block_w: int, shortlist_k: int, local_n: int) -> int:
    """A requested block width clamped to what a shard of `local_n`
    columns takes: the block prefilter needs M+1 <= B over the shard's own
    columns; 0 keeps the full-width local prefilter."""
    if not (block_w and shortlist_k):
        return 0
    return block_w if solver.block_selection_fits(local_n, shortlist_k,
                                                  block_w) else 0


def _solve(mesh, axes, req_q, req_nz_q, free_q, free_pods, used_nz_q,
           alloc_q, mask, static_scores, fit_col_w, bal_col_mask, shape_u,
           shape_s, w_fit, w_bal, strategy, shortlist_k, rows, exc, wave_w,
           kernel, block_w, row_req_q=None, row_req_nz_q=None):
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
    rows, exc = rows.to(torch.int32), exc.to(torch.int32)
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
    st = wave_eval.Shards(sizes, free_q, free_pods, used_nz_q, alloc_q, mask,
                          static_scores, fit_col_w, bal_col_mask, shape_u,
                          shape_s, w_fit, w_bal, strategy)
    k = min(shortlist_k, st.L - 1) if shortlist_k > 0 else 0
    if k > 0 and wave_w <= 1:
        row_req_q = req_q if row_req_q is None else row_req_q.to(dev)
        row_req_nz_q = req_nz_q if row_req_nz_q is None \
            else row_req_nz_q.to(dev)
        return _shortlist_body(st, req_q, req_nz_q, rows, exc, row_req_q,
                               row_req_nz_q, k, _block_w_for(block_w, k,
                                                             st.L))
    if wave_w > 1:
        return _wave_body(st, req_q, req_nz_q, rows, exc, wave_w, kernel)[0]
    rows_l = rows.long()
    out = [st.serial_step(req_q[i], req_nz_q[i],
                          st.gate(rows_l[i:i + 1], exc[i:i + 1]),
                          rows_l[i:i + 1])
           for i in range(p)]
    return torch.cat(out).to(torch.int32)


def _shortlist_body(st: wave_eval.Shards, req_q, req_nz_q, rows, exc,
                    row_req_q, row_req_nz_q, k: int, block_w: int):
    """The shard-local shortlist form of the serial solver (the reference's
    `shortlist_k` branch of `_solver_fn`).

    Prefilter, shard by shard over its own L columns: chunk-start
    feasibility of each plane row (its static mask and its request
    vector's capacity fit), chunk-start scores and the top K columns and
    (K+1)-th value per row (`solver.shortlist_prefilter`), or with
    block_w > 0 `solver.block_bound_prefilter` with every local column
    real (a block holding global padding columns gets a looser bound,
    which costs pruning, never exactness). Per pod, each shard re-scores
    its K candidates for the pod's row and the nodes debited on it so far
    and applies the W=1 bound check; the shards' bests then go through the
    winner reduction and the owner debits. A step whose check fails on any
    shard poisons the pass; the poison bit is read once at the end, and a
    poisoned solve runs again from the chunk-start state with the full
    local row where the check fails (computed for every shard and
    selected, as the reference's per-step `lax.cond` picks). Returns (P,)
    int32 global node ids, -1 = none."""
    S, L = st.S, st.L
    fits0 = torch.all(row_req_q[None, :, None, :] <= st.fq[:, None], dim=-1) \
        & (st.fp >= 1)[:, None, :]                              # (S,C,L)
    feas = st.mask & fits0
    sl = []
    for s in range(S):
        if block_w:
            sc0, cand, thresh, _, _ = solver.block_bound_prefilter(
                st.alloc[s], st.unz[s], row_req_nz_q, st.static[s], feas[s],
                *st.score_args, L, k, block_w)
        else:
            sc0 = kernels.chunk_start_scores(
                st.alloc[s], st.unz[s], row_req_nz_q, st.static[s],
                *st.score_args)
            cand, thresh = solver.shortlist_prefilter(feas[s], sc0, k)
        sl.append((sc0, cand.long(), thresh))
    sc0, cand, thresh = (torch.stack(x) for x in zip(*sl))
    start = [t.clone() for t in (st.fq, st.fp, st.unz)]
    out, pois = _shortlist_pass(st, req_q, req_nz_q, rows, exc, sc0, cand,
                                thresh, inline=False)
    if not solver._any_flag([pois]):
        return out
    for buf, val in zip((st.fq, st.fp, st.unz), start):
        buf.copy_(val)
    return _shortlist_pass(st, req_q, req_nz_q, rows, exc, sc0, cand,
                           thresh, inline=True)[0]


def _shortlist_pass(st: wave_eval.Shards, req_q, req_nz_q, rows, exc, sc0,
                    cand, thresh, inline: bool):
    """One pass of `_shortlist_body` over the pods from the current state:
    with `inline` the full local row replaces an unproven shard best, else
    an unproven step sets the poison bit. Returns ((P,) int32 global node
    ids, (1,) bool poisoned)."""
    S, L = st.S, st.L
    p = req_q.shape[0]
    dev = req_q.device
    r = req_q.shape[1]
    # touched has a throwaway slot L, written where a shard debits nothing.
    touched = torch.zeros((S, L + 1), dtype=torch.bool, device=dev)
    tidx = torch.full((S, p), L, dtype=torch.long, device=dev)
    pois = torch.zeros((1,), dtype=torch.bool, device=dev)
    rows_l = rows.long()
    out = []
    for i in range(p):
        row = rows_l[i:i + 1]
        e = exc[i:i + 1]
        req, req_nz = req_q[i], req_nz_q[i]
        cset = torch.cat([cand.index_select(1, row)[:, 0], tidx], dim=1)
        valid = cset < L
        ci = torch.where(valid, cset, 0)                        # (S,M)
        ci_r = ci[..., None].expand(-1, -1, r)
        live = st.live_scores(
            st.alloc.gather(1, ci_r), st.unz.gather(1, ci_r),
            req_nz[None, :],
            st.static.index_select(1, row)[:, 0].gather(1, ci)[:, None])
        live = torch.where(touched.gather(1, ci), live[:, 0],
                           sc0.index_select(1, row)[:, 0].gather(1, ci))
        fits = st.mask.index_select(1, row)[:, 0].gather(1, ci) & valid \
            & torch.all(req <= st.fq.gather(1, ci_r), dim=-1) \
            & (st.fp.gather(1, ci) >= 1) \
            & ((e < 0) | (ci == e - st.base[:, None]))
        masked = torch.where(fits, live, NEG_INF)
        sbest = masked.amax(dim=1)                              # (S,)
        any_l = sbest > NEG_INF
        sidx = torch.where(masked == sbest[:, None], ci, L).amin(dim=1)
        t = thresh.index_select(1, row)[:, 0]
        w_t = touched.gather(1, torch.clamp_max(sidx, L - 1)[:, None])[:, 0]
        trusted = torch.where(any_l, (sbest > t) | ((sbest == t) & ~w_t),
                              t == NEG_INF)
        lbest = sbest
        lidx = torch.where(any_l, sidx, L)
        if inline:
            fb_best, fb_idx = st.local_full(req, req_nz, st.gate(row, e),
                                            row)
            lbest = torch.where(trusted, lbest, fb_best)
            lidx = torch.where(trusted, lidx, fb_idx)
        else:
            pois.logical_or_(~trusted.all().reshape(1))
        gbest, gidx = st.winner(lbest, lidx)
        chosen = torch.where(torch.isfinite(gbest), gidx, -1).reshape(1)
        st.commit(chosen, req[None], req_nz[None])
        li = chosen - st.base                                   # (S,)
        own = torch.where((li >= 0) & (li < L), li, L)
        touched.scatter_(1, own[:, None], True)
        tidx[:, i] = own
        out.append(chosen)
    return torch.cat(out).to(torch.int32), pois


def _wave_body(st: wave_eval.Shards, req_q, req_nz_q, rows, exc,
               wave_w: int, kernel: bool):
    """The wavefront form of the sharded solver (the reference's
    `_wave_body`): the pods in waves of W, each wave one `wave_step` over
    all shards (kernel=True: two kernel launches on CUDA tensors, the plain
    version on CPU tensors) or `wave_step_reference` (kernel=False, the
    reference's `pallas=False`, which reads each wave's commit/replay
    decision on the host). The per-wave inputs are device slices of the
    chunk's `_wave_split` arrays and the assignments land in one device
    tensor, so the kernel route reads nothing back inside the loop.

    Returns ((P,) int32 global node ids, -1 = none; (n_waves,) int32
    replay flags). Picks and replay share the serial tie rule (lowest
    global index among max scorers), so assignments equal the serial
    form's."""
    p = req_q.shape[0]
    W = max(1, min(wave_w, p))
    (req_w, req_nz_w, rows_w, ex_w), real_w = solver._wave_split(
        W, (req_q, req_nz_q, rows, exc))
    step = wave_eval.wave_step if kernel else wave_eval.wave_step_reference
    n_waves = req_w.shape[0]
    out = torch.empty((n_waves, W), dtype=torch.int32, device=req_q.device)
    replays = torch.empty((n_waves,), dtype=torch.int32,
                          device=req_q.device)
    for i in range(n_waves):
        step(st, req_w[i], req_nz_w[i], rows_w[i], ex_w[i], real_w[i],
             out=out[i], replayed=replays[i:i + 1])
    return out.reshape(-1)[:p], replays


# ---------------------------------------------------------------------------
# phase 2a: Sinkhorn transport plan (optimal solve mode, nodes axis sharded)
# ---------------------------------------------------------------------------

def sharded_sinkhorn_plan(mesh: Mesh, feasible, cost, row_counts, col_cap,
                          iters: int, temp: float,
                          axes: tuple[str, ...] = (NODES_AXIS,)):
    """ops/solver.sinkhorn_plan with the NODE (column) axis sharded over
    the mesh axes `axes` (the reference's `sharded_sinkhorn_plan`).

    The (C, N) planes keep C whole; shard s of the flattened `axes` owns
    the column block [s·L, (s+1)·L), L = N / shards, and its slice of the
    column capacities. Per iteration the only value that crosses shards is
    the row marginal `k @ v`: each shard sums its block, then the (C,)
    partial sums are added over the shards, innermost axis first, in shard
    order (the reference's psum order); the row-max shift is a max over the
    shards the same way. The column step is shard-local, `u` being whole.
    Same annealing, inequality column step and sanitized log-plan as the
    single-device plan. Returns (log_plan (C, N), plan (C, N)) on the
    mesh's device; a mesh over several devices raises
    (`Mesh.device`)."""
    dev = mesh.device
    sizes = tuple(mesh.shape[a] for a in axes)
    shards = math.prod(sizes)
    c, n = cost.shape
    if n % shards:
        raise ValueError(f"{n} nodes do not divide into {shards} shards; "
                         "pad the node axis (pad_axis)")
    if feasible.shape != cost.shape or row_counts.shape != (c,) \
            or col_cap.shape != (n,):
        raise ValueError(
            f"plan inputs do not agree: feasible {tuple(feasible.shape)}, "
            f"cost {tuple(cost.shape)}, row_counts "
            f"{tuple(row_counts.shape)}, col_cap {tuple(col_cap.shape)}")

    def reduce_cols(x, op):
        part = x.reshape((c,) + sizes + (n // shards,))
        if op == "sum":
            part = part.sum(dim=-1)
            for _ in sizes:                     # innermost axis first
                part = kernels._sum_last(part)
        else:
            part = torch.amax(part, dim=-1)
            for _ in sizes:
                part = torch.amax(part, dim=-1)
        return part

    return solver._sinkhorn(feasible.to(dev), cost.to(dev),
                            row_counts.to(dev), col_cap.to(dev), iters,
                            temp, reduce_cols)


# ---------------------------------------------------------------------------
# resident-plane row scatter (the serving tier's device-side delta)
# ---------------------------------------------------------------------------

def resident_row_scatter(mesh: Mesh | None = None):
    """The function `(pack, rows, vals) -> pack with rows set to vals`, out
    of place — the serving tier's resident used-state planes
    (serving/resident.py) take their dirty rows this way (the reference's
    `resident_row_scatter`). Rows and vals are tiny (the cache's dirty
    set); the (N, 2R+1) pack is sharded over the node axis of the mesh's
    one device, so the result stays on that device, and a mesh over
    several devices raises (`Mesh.device`). Padded deltas repeat their
    first row with the same values, so duplicate writes agree on any
    device. The reference caches a jitted program per mesh; nothing here
    is compiled, so nothing is cached."""
    dev = None if mesh is None else mesh.device

    def scatter(pack, rows, vals):
        if dev is not None and pack.device != dev:
            raise ValueError(f"resident pack on {pack.device}, mesh on {dev}")
        return pack.index_put((rows.long(),), vals)

    return scatter
