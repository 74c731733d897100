"""Device-side slice alignment Filter/Score (the host oracle's twin).

Where the host oracle (topology/slices.py) loops per placement, the
scan evaluates EVERY (orientation, anchor) placement of the whole mesh
at once with separable shifted reductions:

- feasibility: a box of shape (s0,s1,s2) anchored at `a` is free iff
  the per-axis window-ANDs of the free grid hold at `a` — s0+s1+s2
  shifts instead of prod(shape) gathers, wraparound via `torch.roll` on
  a torus and zero-filled shifts on a walled mesh (a window crossing a
  wall reads False, which is exactly "infeasible anchor");
- fragmentation: the exposed-free-boundary count is a sum over the 6
  box faces, each face a window-sum of the free grid over the two
  orthogonal axes shifted one past the box along the third — the same
  halo cells the oracle walks;
- selection: score and the lowest-id tie rule pack into ONE int32 key,
  `(FRAG_CAP - frag) * A + (A-1 - pid)` for feasible placements and
  -1 otherwise, so the winner is a plain max — and the sharded
  variant is a shard-local max then a max across shards, associative
  and therefore bit-identical at any shard count.

Bit-identity with the oracle on (feasible, frag·feasible) and on the
selected placement is the differential contract; frag is reported 0
where infeasible on both sides.

Copy of `kubernetes_tpu/topology/device.py`, where the scan is one
`jax.jit` program over `jnp.roll`: here it is PyTorch ops (int32
throughout, no float) on the `device` the caller names, and the scan's
two outputs come back to the host in one copy. `best_key`'s sharded
form runs its S shards on one device (a `(S, -1)` view padded with -1),
the way `parallel/mesh.py` puts S shards on one card, where the
reference spreads them over S JAX devices with `shard_map` and `pmax`.
Any error of the device propagates.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.topology.mesh import MeshSpec, orientations


def frag_cap(shape: Sequence[int]) -> int:
    """Exclusive upper bound on any placement's frag score (the box
    surface): the key packing needs it static."""
    s = tuple(shape) + (1,) * (3 - len(tuple(shape)))
    return 2 * (s[0] * s[1] + s[1] * s[2] + s[0] * s[2]) + 1


def _device(device) -> torch.device:
    return torch.device(device if device is not None else "cuda:0")


def _shift(g: torch.Tensor, k: int, axis: int, wrap: bool) -> torch.Tensor:
    """out[c] = g[c + k·e_axis]; torus wraps, mesh fills with zero
    (False) so windows crossing a wall read infeasible/absent."""
    if k == 0:
        return g
    r = torch.roll(g, -k, dims=axis)
    if wrap:
        return r
    d = g.shape[axis]
    idx = torch.arange(d, device=g.device)
    ok = (idx + k >= 0) & (idx + k < d)
    shape = [1, 1, 1]
    shape[axis] = d
    return torch.where(ok.reshape(shape), r,
                       torch.zeros((), dtype=r.dtype, device=r.device))


def _win_and(g, s: int, axis: int, wrap: bool):
    acc = g
    for i in range(1, s):
        acc = acc & _shift(g, i, axis, wrap)
    return acc


def _win_sum(g, s: int, axis: int, wrap: bool):
    acc = g
    for i in range(1, s):
        acc = acc + _shift(g, i, axis, wrap)
    return acc


def _win_or_back(g, s: int, axis: int, wrap: bool):
    """OR over backward shifts: out[c] = OR_{i<s} g[c - i·e_axis]
    (the box dilation the coverage union needs)."""
    acc = g
    for i in range(1, s):
        acc = acc | _shift(g, -i, axis, wrap)
    return acc


def _scan(free: torch.Tensor, dims: tuple[int, int, int], wrap: bool,
          orients: tuple[tuple[int, int, int], ...], cap: int):
    """free: (d0,d1,d2) bool → (key (A,) int32, covered (cells,) bool),
    the reference's `_build_scan` body."""
    cells = dims[0] * dims[1] * dims[2]
    A = len(orients) * cells
    free_i = free.to(torch.int32)
    base = torch.arange(cells, dtype=torch.int32,
                        device=free.device).reshape(dims)
    neg = torch.full((), -1, dtype=torch.int32, device=free.device)
    keys = []
    covered = torch.zeros(dims, dtype=torch.bool, device=free.device)
    for oi, (s0, s1, s2) in enumerate(orients):
        feas = _win_and(_win_and(_win_and(
            free, s0, 0, wrap), s1, 1, wrap), s2, 2, wrap)
        frag = torch.zeros(dims, dtype=torch.int32, device=free.device)
        # +x/-x faces: window-sum over (y,z), shifted past the box.
        ws_yz = _win_sum(_win_sum(free_i, s1, 1, wrap), s2, 2, wrap)
        if not (wrap and s0 == dims[0]):
            frag = frag + _shift(ws_yz, s0, 0, wrap) \
                + _shift(ws_yz, -1, 0, wrap)
        ws_xz = _win_sum(_win_sum(free_i, s0, 0, wrap), s2, 2, wrap)
        if not (wrap and s1 == dims[1]):
            frag = frag + _shift(ws_xz, s1, 1, wrap) \
                + _shift(ws_xz, -1, 1, wrap)
        ws_xy = _win_sum(_win_sum(free_i, s0, 0, wrap), s1, 1, wrap)
        if not (wrap and s2 == dims[2]):
            frag = frag + _shift(ws_xy, s2, 2, wrap) \
                + _shift(ws_xy, -1, 2, wrap)
        pid = base + oi * cells
        key = torch.where(feas, (cap - frag) * A + (A - 1 - pid), neg)
        keys.append(key.reshape(-1))
        covered = covered | _win_or_back(_win_or_back(_win_or_back(
            feas, s0, 0, wrap), s1, 1, wrap), s2, 2, wrap)
    return torch.cat(keys), covered.reshape(-1)


def device_scan(free_cells: np.ndarray, spec: MeshSpec,
                shape: Sequence[int], device=None):
    """Run the scan over one free mask on `device` (None = cuda:0).
    Returns (key (A,) int32, feas (A,) bool, frag (A,) int32, covered
    (cells,)) as host arrays — None when the shape has no valid
    orientation or the int32 key packing would overflow (the caller
    asks the host oracle; meshes that large are outside the device
    contract, as in the reference)."""
    orients = orientations(shape, spec)
    if not orients:
        return None
    cap = frag_cap(shape)
    A = len(orients) * spec.cells
    if cap * (A + 1) >= 2**31:
        return None
    grid = torch.from_numpy(np.ascontiguousarray(
        np.asarray(free_cells, dtype=np.bool_).reshape(spec.dims))).to(
            _device(device))
    key_dev, covered_dev = _scan(grid, spec.dims, spec.wrap, orients, cap)
    # One host read: the keys and the coverage in one int32 vector.
    both = torch.cat([key_dev, covered_dev.to(torch.int32)]).cpu().numpy()
    key = both[:A]
    covered = both[A:].astype(np.bool_)
    feas = key >= 0
    frag = np.where(feas, cap - np.where(feas, key, 0) // A, 0) \
        .astype(np.int32)
    return key, feas, frag, covered


def decode_key(best_key: int, spec: MeshSpec,
               shape: Sequence[int]) -> tuple[int, int]:
    """Packed winner key → (placement id, frag); (-1, 0) = infeasible."""
    if best_key < 0:
        return -1, 0
    orients = orientations(shape, spec)
    A = len(orients) * spec.cells
    return A - 1 - int(best_key) % A, frag_cap(shape) - int(best_key) // A


def best_key(key: np.ndarray, shards: int | None = None,
             device=None) -> int:
    """Winner selection over the packed keys — a shard-local max over
    a (S, -1) view padded with -1, then the max across shards, when
    `shards` > 1, all on `device` (None = cuda:0); the plain host max
    otherwise. The winner is the same at any shard count."""
    if len(key) == 0:
        return -1
    S = int(shards or 1)
    if S <= 1:
        return int(np.max(key))
    pad = (-len(key)) % S
    padded = np.pad(np.asarray(key, dtype=np.int32), (0, pad),
                    constant_values=-1)
    blocks = torch.from_numpy(padded).to(_device(device)).view(S, -1)
    local = blocks.amax(dim=1)
    return int(local.amax())


def fragmentation_pct(free_cells: np.ndarray,
                      covered: np.ndarray) -> float:
    """Stranded-for-this-shape free capacity: the percentage of free
    cells no feasible placement covers (100 = every free cell is
    stranded; 0 = all free capacity still coalesces into slices)."""
    total = int(np.count_nonzero(free_cells))
    if total == 0:
        return 0.0
    return 100.0 * (1.0 - int(np.count_nonzero(covered)) / total)
