"""Carry the JAX package's device-program inputs across to this package.

The reference's fused chunk program (`_mask_solve_update` in
`kubernetes_tpu/ops/backend.py`) takes numpy-convertible arrays by name.
`mask_solve_inputs` takes the same arrays, by the same names, and returns
the keyword arguments of this package's `ops.backend.mask_solve_update` as
tensors on a given device — so a test can feed both programs the identical
state and compare every output. `solve_one_inputs` does the same for the
serving fast path's `solver.solve_one` / `solve_one_fresh`.
`masks_scores_inputs` and
`sharded_solver_inputs` do the same for the node-sharded phases
(`parallel.sharded_masks_scores`, `parallel.sharded_greedy_assign`), in the
layout the port's mesh wants. Arrays are read with `np.asarray` only;
nothing of the reference package is imported.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from kubernetes_tpu_torch.parallel.mesh import Mesh, pad_axis


def to_tensor(x: Any, device) -> torch.Tensor:
    """An array-like (numpy, or anything np.array reads) as a contiguous
    tensor of the same dtype on `device`, copied from the source."""
    return torch.from_numpy(np.array(x, copy=True, order="C")).to(device)


def mask_solve_inputs(*, alloc_q, used_pack, alloc_pods, class_pack,
                      cls_idx, exc_col, taint_f_mat, taint_p_mat,
                      class_mask, class_scores, params: Mapping[str, Any],
                      perms, gang_onehot, gang_required, wave_w: int,
                      solve_mode: str, sink_iters, sink_temp,
                      device) -> dict:
    """Keyword arguments of `mask_solve_update` from the reference
    program's inputs. `params` is the reference backend's `_fwk_params`
    dict (strategy, column weights, shape points, plugin weights and the
    taint-filter switch); `sink_iters`/`sink_temp` are the Sinkhorn
    iterations and temperature the reference program was given."""
    arrays = dict(alloc_q=alloc_q, used_pack=used_pack,
                  alloc_pods=alloc_pods, class_pack=class_pack,
                  cls_idx=cls_idx, exc_col=exc_col, taint_f_mat=taint_f_mat,
                  taint_p_mat=taint_p_mat, class_mask=class_mask,
                  class_scores=class_scores, perms=perms,
                  gang_onehot=gang_onehot, gang_required=gang_required)
    out = {k: to_tensor(v, device) for k, v in arrays.items()}
    for k in ("fit_col_w", "bal_col_mask", "shape_u", "shape_s"):
        out[k] = to_tensor(params[k], device)
    for k in ("w_fit", "w_bal", "w_taint"):
        out[k] = float(np.float32(np.asarray(params[k])))
    out["taint_filter_on"] = bool(np.asarray(params["taint_filter_on"]))
    out["strategy"] = str(params["strategy"])
    out["wave_w"] = int(wave_w)
    out["solve_mode"] = str(solve_mode)
    out["sink_iters"] = int(np.asarray(sink_iters))
    out["sink_temp"] = float(np.float32(np.asarray(sink_temp)))
    return out


#: Positional arrays of the reference's `solve_one`, in order (after the
#: resident pack; `solve_one_fresh` puts its `rows`, `vals` there).
_SOLVE_ONE_ARRAYS = ("alloc_q", "used_pack", "alloc_pods", "taint_f_mat",
                     "taint_p_mat", "mask_bits", "host_scores", "req_pack")


def solve_one_inputs(arrays, params: Mapping[str, Any], device) -> tuple:
    """Positional arguments of the port's `solver.solve_one` (8 arrays) or
    `solve_one_fresh` (10: `rows`, `vals` after `used_pack`) from the
    reference call's positional arrays, in the same order, and the
    reference backend's `_fwk_params` dict: the arrays as tensors on
    `device` (copies), then fit_col_w, bal_col_mask, shape_u, shape_s as
    tensors, w_fit, w_bal, w_taint as float32-valued host numbers, the
    taint-filter switch as a host bool and the strategy name."""
    arrays = list(arrays)
    if len(arrays) not in (len(_SOLVE_ONE_ARRAYS), len(_SOLVE_ONE_ARRAYS) + 2):
        raise ValueError(f"{len(arrays)} arrays; solve_one takes "
                         f"{len(_SOLVE_ONE_ARRAYS)}, solve_one_fresh "
                         f"{len(_SOLVE_ONE_ARRAYS) + 2}")
    out = [to_tensor(a, device) for a in arrays]
    out += [to_tensor(params[k], device)
            for k in ("fit_col_w", "bal_col_mask", "shape_u", "shape_s")]
    out += [float(np.float32(np.asarray(params[k])))
            for k in ("w_fit", "w_bal", "w_taint")]
    out.append(bool(np.asarray(params["taint_filter_on"])))
    out.append(str(params["strategy"]))
    return tuple(out)


#: The node axis of each node-indexed input of the sharded solver.
SOLVER_NODE_AXES = {"free_q": 0, "free_pods": 0, "used_nz_q": 0,
                    "alloc_q": 0, "mask": 1, "static_scores": 1}


def _carry(value: Any, device):
    """An array as a tensor on `device`; a 0-d value as a Python scalar."""
    a = np.asarray(value)
    if a.ndim:
        return to_tensor(a, device)
    return bool(a) if a.dtype == np.bool_ else float(np.float32(a))


def masks_scores_inputs(mesh: Mesh, arrays: Mapping[str, Any]) -> dict:
    """Keyword arguments of `parallel.sharded_masks_scores` from the
    reference's inputs of the same names (alloc_q, used_q, ..., w_taint,
    taint_filter_on): tensors on the mesh's device, scalars as Python
    values. Every tile of the mesh reads its rows and columns in place, so
    nothing is padded."""
    return {k: _carry(v, mesh.device) for k, v in arrays.items()}


def sharded_solver_inputs(mesh: Mesh, arrays: Mapping[str, Any]) -> dict:
    """Keyword arguments of `parallel.sharded_greedy_assign` from the
    reference's solver inputs of the same names (the `req_q`, `free_q`,
    `mask`, ..., `w_fit`, `w_bal`, `rows`, `exc` of its argument dicts;
    None values are left out). The node axis is padded to a multiple of the
    mesh's shard count as the reference's callers pad it: capacity, usage
    and scores with 0, the mask with False, so padding nodes never fit."""
    out = {}
    for k, v in arrays.items():
        if v is None:
            continue
        if k in SOLVER_NODE_AXES:
            v = pad_axis(np.asarray(v), mesh.size, SOLVER_NODE_AXES[k])
        out[k] = _carry(v, mesh.device)
    return out
