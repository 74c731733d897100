"""One wave of the node-sharded wavefront solve, as hand-written CUDA.

Counterpart of `kubernetes_tpu/ops/pallas_kernel.py`'s `wave_eval`, the
Pallas kernel that the node-sharded wavefront solve (`parallel/sharded.py`)
launches once per wave on each shard, and of the rest of the reference's
wave step around it (`kubernetes_tpu/parallel/sharded.py` `_wave_body`).
Both kernels are in `csrc/wave_eval.cu`, built into the same library as
`wave_solve` (`ops/wave_kernel.KernelLibrary`). See that source for the
design.

- `wave_eval`: the TPU kernel's counterpart, the shard-local evaluation of
  one wave: (S, W, L) masked scores and gated mask. Every shard-local array
  may carry a leading shard axis (S shards of one mesh on one device
  evaluate in one launch): mask/static_sc (S, C, L), alloc_q/free_q/
  used_nz (S, L, R), free_pods (S, L), el (S, W); without it the shapes are
  the reference's: (C, L), (L, R), (L,), (W,) in and (W, L) out.
- `wave_step`: the whole wave over the S shards of a `Shards` state, in two
  launches and no host sync: the evaluation keeping per-block top lists
  (launch A, counted on `wave_eval.launches`), and `wave_resolve` (launch
  B, counted on `wave_resolve.launches`): the prefix-distinct picks, the
  conflict check, and the commit or the exact replay, debiting the carry
  in place.

Each wrapper launches its kernel for CUDA tensors and runs its plain
PyTorch version (`wave_eval_reference`, `wave_step_reference`) for CPU
tensors. On the card there is no fallback: a build, load or launch failure
raises, and so does a shape or layout the kernel does not take.
"""

from __future__ import annotations

import ctypes
import math

import torch

from kubernetes_tpu_torch.ops import kernels, wave_kernel

NEG_INF = float("-inf")
#: "no pick" sentinel of the winner reduction, as in the reference.
INT_MAX = 2**31 - 1
#: Nodes per block of launch A (csrc/wave_eval.cu kThreads).
EVAL_BLOCK = 256


def wave_eval(mask, static_sc, alloc_q, free_q, free_pods, used_nz, req,
              req_nz, row, e, el, real, fit_col_w, bal_col_mask, shape_u,
              shape_s, w_fit, w_bal, strategy: str):
    """Fused shard-local (W, L) wave evaluation.

    Returns (masked (W, L) f32 scores with -inf = infeasible, m (W, L) bool
    gated class mask), the pair the sharded wave step computes inline; `el`
    is the exception column in LOCAL shard coordinates (e - base), `e` the
    global one (for the -1 gate). A leading shard axis, where given, leads
    the outputs too.
    """
    if free_q.device.type == "cpu":
        return wave_eval_reference(
            mask, static_sc, alloc_q, free_q, free_pods, used_nz, req,
            req_nz, row, e, el, real, fit_col_w, bal_col_mask, shape_u,
            shape_s, w_fit, w_bal, strategy)
    lib = wave_kernel.LIBRARY.build()
    dev = free_q.device
    stacked = free_q.dim() == 3
    if not stacked:
        mask, static_sc, alloc_q, free_q, free_pods, used_nz, el = (
            t[None] for t in (mask, static_sc, alloc_q, free_q, free_pods,
                              used_nz, el))
    s, n, r = free_q.shape
    c = mask.shape[1]
    w = req.shape[0]
    pts = shape_u.shape[0]
    check = wave_kernel._check
    check(dev, torch.bool, (s, c, n), mask=mask)
    check(dev, torch.float32, (s, c, n), static_sc=static_sc)
    check(dev, torch.int32, (s, n, r), alloc_q=alloc_q, free_q=free_q,
          used_nz=used_nz)
    check(dev, torch.int32, (s, n), free_pods=free_pods)
    check(dev, torch.int32, (w, r), req=req, req_nz=req_nz)
    check(dev, torch.int32, (w,), row=row, e=e)
    check(dev, torch.int32, (s, w), el=el)
    check(dev, torch.bool, (w,), real=real)
    check(dev, torch.float32, (r,), fit_col_w=fit_col_w)
    check(dev, torch.bool, (r,), bal_col_mask=bal_col_mask)
    check(dev, torch.float32, (pts,), shape_u=shape_u, shape_s=shape_s)
    if not (1 <= w <= lib.max_eval_w and 1 <= r <= lib.max_r
            and 1 <= pts <= lib.max_s and 1 <= s <= lib.max_eval_shards
            and n >= 1 and c >= 1):
        raise ValueError(
            f"wave_eval kernel does not take this shape: W={w} (max "
            f"{lib.max_eval_w}), R={r} (max {lib.max_r}), shape points="
            f"{pts} (max {lib.max_s}), shards={s} (max "
            f"{lib.max_eval_shards}), L={n}, C={c}")
    if strategy not in wave_kernel.STRATEGIES:
        raise ValueError(f"unknown scoring strategy {strategy!r}")
    masked = torch.empty((s, w, n), dtype=torch.float32, device=dev)
    m = torch.empty((s, w, n), dtype=torch.bool, device=dev)
    rc = lib.wave_eval_fn(
        mask.data_ptr(), static_sc.data_ptr(), alloc_q.data_ptr(),
        free_q.data_ptr(), free_pods.data_ptr(), used_nz.data_ptr(),
        req.data_ptr(), req_nz.data_ptr(), row.data_ptr(), e.data_ptr(),
        el.data_ptr(), real.data_ptr(), fit_col_w.data_ptr(),
        bal_col_mask.data_ptr(), shape_u.data_ptr(), shape_s.data_ptr(),
        pts, float(w_fit), float(w_bal), wave_kernel.STRATEGIES[strategy],
        s, c, n, r, w, masked.data_ptr(), m.data_ptr(),
        wave_kernel._stream(free_q))
    wave_eval.launches += 1
    lib.check(rc, "wave_eval")
    return (masked, m) if stacked else (masked[0], m[0])


wave_eval.launches = 0


def wave_eval_reference(mask, static_sc, alloc_q, free_q, free_pods,
                        used_nz, req, req_nz, row, e, el, real, fit_col_w,
                        bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                        strategy: str):
    """Plain PyTorch version of `wave_eval`: the inline evaluation of the
    reference's sharded wave step, op for op, per shard. The score
    functions are elementwise over (member, node), so the shards' nodes
    are scored together as one flattened node axis."""
    stacked = free_q.dim() == 3
    if not stacked:
        mask, static_sc, alloc_q, free_q, free_pods, used_nz, el = (
            t[None] for t in (mask, static_sc, alloc_q, free_q, free_pods,
                              used_nz, el))
    s, n, r = free_q.shape
    w = req.shape[0]
    rl = row.long()
    iota = torch.arange(n, dtype=el.dtype, device=el.device)
    m = mask[:, rl] \
        & ((e < 0)[None, :, None] | (iota == el[:, :, None])) \
        & real[None, :, None]                               # (S, W, L)
    fits = m & torch.all(req[None, :, None, :] <= free_q[:, None, :, :],
                         dim=-1) & (free_pods >= 1)[:, None, :]

    def per_shard(x):                                       # (W, S*L)
        return x.reshape(w, s, n).transpose(0, 1)
    flat_alloc = alloc_q.reshape(s * n, r)
    flat_used = used_nz.reshape(s * n, r)
    sc = static_sc[:, rl]
    sc = sc + w_fit * per_shard(kernels.fit_score(
        flat_alloc, flat_used, req_nz, fit_col_w, strategy, shape_u,
        shape_s))
    sc = sc + w_bal * per_shard(kernels.balanced_allocation_score(
        flat_alloc, flat_used, req_nz, bal_col_mask))
    masked = torch.where(fits, sc, NEG_INF)
    return (masked, m) if stacked else (masked[0], m[0])


# ---------------------------------------------------------------------------
# the node state of one sharded solve
# ---------------------------------------------------------------------------

class Shards:
    """The node state of one sharded solve as S shards of L nodes on one
    device, with the per-shard reductions of the reference's `shard_map`.

    free_q/used_nz/alloc (S, L, R), free_pods (S, L), mask/static
    (S, C, L); the `*_flat` names are (S·L, ...) views of the same storage,
    whose row i is global node i. The capacity carry (fq, fp, unz) is a
    copy of the caller's state, debited in place. `sizes` are the mesh
    axes the node axis shards over, first axis major.
    """

    def __init__(self, sizes, free_q, free_pods, used_nz, alloc_q, mask,
                 static_scores, fit_col_w, bal_col_mask, shape_u, shape_s,
                 w_fit, w_bal, strategy):
        dev = free_q.device
        n, r = free_q.shape
        self.sizes = tuple(sizes)
        s = self.S = math.prod(self.sizes)
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
        self.base32 = self.base.to(torch.int32)
        self.gid = self.base[:, None] + self.iota[None, :]      # (S, L)
        self.score_args = (fit_col_w, bal_col_mask, shape_u, shape_s,
                           float(w_fit), float(w_bal), strategy)
        #: the kernel's per-W launch plans (`_step_plan`).
        self.plans: dict[int, _StepPlan] = {}

    def carry(self) -> tuple[torch.Tensor, ...]:
        return self.fq, self.fp, self.unz

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
                            lidx + self.base, INT_MAX)
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


# ---------------------------------------------------------------------------
# the wave step: plain version
# ---------------------------------------------------------------------------

def wave_picks(st: Shards, masked):
    """Prefix-distinct global picks of one wave's (S, W, L) masked scores:
    member w takes the winner reduction over its scores with the nodes
    earlier members picked masked out. Returns (b (W,) best scores, y (W,)
    global ids, INT_MAX = no pick)."""
    W = masked.shape[1]
    taken = torch.zeros((st.S, st.L), dtype=torch.bool,
                        device=masked.device)
    bs, ys = [], []
    for w in range(W):
        rv = torch.where(taken, NEG_INF, masked[:, w])
        gbest, gidx = st.winner(*st.local_best(rv))
        y = torch.where(torch.isfinite(gbest), gidx, INT_MAX)
        if w + 1 < W:
            taken = taken | (st.gid == y)
        ys.append(y)
        bs.append(gbest)
    return torch.stack(bs), torch.stack(ys)


def wave_conflicts(st: Shards, m, b, y, req, req_nz, row):
    """(W,) conflict bits in GLOBAL coordinates: the owner of each pick y_j
    re-scores it after member j's debit for every later member w
    (non-owners contribute False), and the bits max-reduce across shards.
    m (S, W, L) gated mask; b, y the picks."""
    s, L = st.S, st.L
    W = y.shape[0]
    w_iota = torch.arange(W, device=y.device)
    later = w_iota[None, :] < w_iota[:, None]             # j < w
    shard_ix = torch.arange(s, device=y.device)[:, None, None]
    hit = y < INT_MAX
    li = y[None, :] - st.base[:, None]                    # (S, W)
    own = (li >= 0) & (li < L)
    safe = li.clamp(0, L - 1)
    idx = st.base[:, None] + safe
    fr_j = st.fq_flat[idx] - req                          # (S, W, R)
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
    return st.reduce(torch.any(beats & later, dim=2).to(torch.int32),
                     torch.amax) > 0


def wave_step_reference(st: Shards, req, req_nz, row, e, real, out=None,
                        replayed=None):
    """Plain PyTorch version of `wave_step`: the reference's sharded wave
    step on tensors. One shard-local evaluation (`wave_eval_reference`),
    the W prefix-distinct picks (`wave_picks`), the conflict check
    (`wave_conflicts`), then one decision for all shards, read on the host:
    commit the picks, or replay the wave one pod at a time from the carry
    (`Shards.serial_step`). Debits `st`'s carry in place.

    req/req_nz (W, R) int32, row/e (W,) int32 (e global, -1 = none), real
    (W,) bool. Returns (assignments (W,) int32 global node ids, -1 = none;
    replayed (1,) int32, 1 if the wave replayed), written into `out` and
    `replayed` where given."""
    el = (e[None, :] - st.base32[:, None]).contiguous()   # local exc
    masked, m = wave_eval_reference(st.mask, st.static, st.alloc, st.fq,
                                    st.fp, st.unz, req, req_nz, row, e, el,
                                    real, *st.score_args)  # (S, W, L)
    b, y = wave_picks(st, masked)
    conflict = wave_conflicts(st, m, b, y, req, req_nz, row)
    if not bool(conflict.any()):
        st.commit(y, req, req_nz)
        got, rep = torch.where(y < INT_MAX, y, -1), 0
    else:
        rl = row.long()
        got = torch.cat([
            st.serial_step(req[w], req_nz[w],
                           st.gate(rl[w:w + 1], e[w:w + 1]) & real[w],
                           rl[w:w + 1])
            for w in range(req.shape[0])])
        rep = 1
    got = got.to(torch.int32)
    rep = torch.tensor([rep], dtype=torch.int32, device=got.device)
    if out is not None:
        out.copy_(got)
        got = out
    if replayed is not None:
        replayed.copy_(rep)
        rep = replayed
    return got, rep


# ---------------------------------------------------------------------------
# the wave step: the kernels
# ---------------------------------------------------------------------------

class _EvalArgs(ctypes.Structure):
    """csrc/wave_eval.cu's EvalArgs, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "mask", "static_sc", "alloc_q", "free_q", "free_pods", "used_nz",
        "fit_col_w", "bal_mask", "shape_u", "shape_s", "cand")] + [
        ("n_shape", ctypes.c_int), ("w_fit", ctypes.c_float),
        ("w_bal", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "strategy", "S", "C", "L", "R", "W", "NB", "smem")] + [
        (name, ctypes.c_void_p) for name in (
            "req", "req_nz", "row", "e", "el", "real", "masked", "m", "out",
            "replayed")]


class _StepPlan:
    """The constant arguments of one solve's wave steps at width W: the
    checked node state, the (W, S·NB, W) top-list scratch, launch B's
    shared memory, and the C struct both launches copy. It lives in
    `Shards.plans`, so the tensors the struct points to outlive it."""

    def __init__(self, st: Shards, W: int):
        lib = wave_kernel.LIBRARY.build()
        dev = st.fq.device
        s, L, r = st.fq.shape
        c = st.mask.shape[1]
        fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal, strategy \
            = st.score_args
        pts = shape_u.shape[0]
        check = wave_kernel._check
        check(dev, torch.bool, (s, c, L), mask=st.mask)
        check(dev, torch.float32, (s, c, L), static=st.static)
        check(dev, torch.int32, (s, L, r), alloc=st.alloc, free_q=st.fq,
              used_nz=st.unz)
        check(dev, torch.int32, (s, L), free_pods=st.fp)
        check(dev, torch.float32, (r,), fit_col_w=fit_col_w)
        check(dev, torch.bool, (r,), bal_col_mask=bal_col_mask)
        check(dev, torch.float32, (pts,), shape_u=shape_u, shape_s=shape_s)
        nb = -(-L // EVAL_BLOCK)
        smem = 4 * -(-(s * L) // 32)         # launch B's taken-node bitmap
        smem_max = wave_kernel.SMEM_PER_BLOCK - lib.resolve_static_smem
        if not (1 <= W <= lib.max_step_w and 1 <= r <= lib.max_r
                and 1 <= pts <= lib.max_s and 1 <= s <= lib.max_eval_shards
                and c >= 1 and smem <= smem_max):
            raise ValueError(
                f"wave step kernels do not take this shape: W={W} (max "
                f"{lib.max_step_w}, the top-list length they are built "
                f"for), R={r} (max {lib.max_r}), shape points={pts} (max "
                f"{lib.max_s}), shards={s} (max {lib.max_eval_shards}), "
                f"{s * L} nodes (a {smem} B taken-node bitmap, max "
                f"{smem_max} B of shared memory), C={c}")
        if strategy not in wave_kernel.STRATEGIES:
            raise ValueError(f"unknown scoring strategy {strategy!r}")
        self.lib, self.W, self.R = lib, W, r
        self.device = dev
        self.cand = torch.empty((W, s * nb, W), dtype=torch.int64,
                                device=dev)
        self.args = _EvalArgs(
            mask=st.mask.data_ptr(), static_sc=st.static.data_ptr(),
            alloc_q=st.alloc.data_ptr(), free_q=st.fq.data_ptr(),
            free_pods=st.fp.data_ptr(), used_nz=st.unz.data_ptr(),
            fit_col_w=fit_col_w.data_ptr(),
            bal_mask=bal_col_mask.data_ptr(), shape_u=shape_u.data_ptr(),
            shape_s=shape_s.data_ptr(), cand=self.cand.data_ptr(),
            n_shape=pts, w_fit=w_fit, w_bal=w_bal,
            strategy=wave_kernel.STRATEGIES[strategy], S=s, C=c, L=L, R=r,
            W=W, NB=nb, smem=smem)
        self.ref = ctypes.byref(self.args)

    def check_wave(self, req, req_nz, row, e, real, out, replayed):
        check, dev, W = wave_kernel._check, self.device, self.W
        check(dev, torch.int32, (W, self.R), req=req, req_nz=req_nz)
        check(dev, torch.int32, (W,), row=row, e=e, out=out)
        check(dev, torch.bool, (W,), real=real)
        check(dev, torch.int32, (1,), replayed=replayed)


def _step_plan(st: Shards, W: int) -> _StepPlan:
    plan = st.plans.get(W)
    if plan is None:
        plan = st.plans[W] = _StepPlan(st, W)
    return plan


def wave_step(st: Shards, req, req_nz, row, e, real, out=None,
              replayed=None):
    """One wave over all S shards of `st` (the reference's sharded wave
    step): two kernel launches on PyTorch's current stream, no host sync.
    Arguments and result as `wave_step_reference`; the (W,) assignments
    and the (1,) replay flag are written on the device, into `out` and
    `replayed` where given, and the carry is debited in place. CPU tensors
    run `wave_step_reference`."""
    if st.fq.device.type == "cpu":
        return wave_step_reference(st, req, req_nz, row, e, real, out,
                                   replayed)
    plan = _step_plan(st, req.shape[0])
    if out is None:
        out = torch.empty((plan.W,), dtype=torch.int32, device=plan.device)
    if replayed is None:
        replayed = torch.empty((1,), dtype=torch.int32, device=plan.device)
    plan.check_wave(req, req_nz, row, e, real, out, replayed)
    ptrs = (req.data_ptr(), req_nz.data_ptr(), row.data_ptr(), e.data_ptr(),
            real.data_ptr())
    stream = wave_kernel._stream(req)
    rc = plan.lib.wave_topk_fn(plan.ref, *ptrs, stream)
    wave_eval.launches += 1
    plan.lib.check(rc, "wave_eval (wave step)")
    wave_resolve(plan, ptrs, out, replayed, stream)
    return out, replayed


def wave_resolve(plan: _StepPlan, ptrs, out, replayed, stream) -> None:
    """Launch B of `wave_step` on the wave's member pointers `ptrs` (req,
    req_nz, row, e, real), after launch A filled `plan.cand`."""
    rc = plan.lib.wave_resolve_fn(plan.ref, *ptrs, out.data_ptr(),
                                  replayed.data_ptr(), stream)
    wave_resolve.launches += 1
    plan.lib.check(rc, "wave_resolve")


wave_resolve.launches = 0
