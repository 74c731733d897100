"""One wave's shard-local evaluation as one hand-written CUDA kernel launch.

Counterpart of `kubernetes_tpu/ops/pallas_kernel.py`'s `wave_eval`, the
Pallas kernel that the node-sharded wavefront solve (`parallel/sharded.py`)
launches once per wave on each shard: here it is `csrc/wave_eval.cu`, built
into the same library as `wave_solve` (`ops/wave_kernel.KernelLibrary`).

`wave_eval` launches the kernel for CUDA tensors and runs its plain PyTorch
version, `wave_eval_reference`, for CPU tensors. On the card there is no
fallback: a build, load or launch failure raises, and so does a shape or
layout the kernel does not take. `wave_eval.launches` counts the launches.

Every shard-local array may carry a leading shard axis (S shards of one
mesh on one device evaluate in one launch): mask/static_sc (S, C, L),
alloc_q/free_q/used_nz (S, L, R), free_pods (S, L), el (S, W); the outputs
are then (S, W, L). Without it the shapes are the reference's: (C, L),
(L, R), (L,), (W,) in and (W, L) out.
"""

from __future__ import annotations

import torch

from kubernetes_tpu_torch.ops import kernels, wave_kernel

NEG_INF = float("-inf")


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
