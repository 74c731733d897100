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
   kernel launches and no host sync.

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

Not ported yet: the shard-local shortlist and block index (`shortlist_k`,
`block_w`; ROADMAP queue 1 item 3) — they raise NotImplementedError.
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
    `row_req_q`/`row_req_nz_q` feed only the reference's shard-local
    shortlist prefilter; they are accepted and not read.

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
    if wave_w > 1:
        return _wave_body(st, req_q, req_nz_q, rows, exc, wave_w, kernel)[0]
    rows_l = rows.long()
    out = [st.serial_step(req_q[i], req_nz_q[i],
                          st.gate(rows_l[i:i + 1], exc[i:i + 1]),
                          rows_l[i:i + 1])
           for i in range(p)]
    return torch.cat(out).to(torch.int32)


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
