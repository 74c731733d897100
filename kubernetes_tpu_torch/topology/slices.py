"""Host oracle for contiguous sub-mesh (slice) placement.

Naive, loop-per-placement reference semantics — deliberately written
in a different style from the vectorized device kernel
(topology/device.py) so the randomized differential suite compares two
independent derivations of the same contract:

Placement enumeration (the id contract, shared with the kernel):
  id = orientation_index * spec.cells + row-major anchor index,
with orientations from `mesh.orientations` (lex-ordered valid axis
permutations). On a torus every cell anchors every orientation; on a
non-wrap mesh an anchor whose box crosses a wall is infeasible.

Feasibility: every member cell of the anchored box is free.

Fragmentation score (lower = better): the count of (free outside
cell, direction) adjacency pairs pointing into the box — the free
boundary the placement would expose. Packing a slice snugly against
occupied cells / mesh walls minimizes it, which preserves large
contiguous free regions for future slices (the bin-packing contact
heuristic lifted to sub-meshes). Axes the box spans entirely on a
torus have no outside neighbor and contribute nothing. Infeasible
placements carry frag = 0 by convention (both implementations mask,
so the differential compare is exact).

Ties break to the LOWEST placement id — the same
first-feasible-wins determinism as the solver's node-index tie rule.

Copy of `kubernetes_tpu/topology/slices.py` (plain numpy): the
semantic reference `device_scan` is held to.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from kubernetes_tpu_torch.topology.mesh import MeshSpec, orientations

#: (axis, direction) pairs of the 6-neighborhood, enumeration order
#: fixed (it is summed, so order only matters for readability).
_FACES = tuple((axis, sign) for axis in range(3) for sign in (+1, -1))


def _anchor_ok(anchor: tuple[int, int, int], orient: tuple[int, int, int],
               spec: MeshSpec) -> bool:
    if spec.wrap:
        return True
    return all(a + s <= d
               for a, s, d in zip(anchor, orient, spec.dims))


def _member_cells(anchor: tuple[int, int, int],
                  orient: tuple[int, int, int],
                  spec: MeshSpec) -> list[int]:
    d0, d1, d2 = spec.dims
    out = []
    for i in range(orient[0]):
        for j in range(orient[1]):
            for k in range(orient[2]):
                out.append(spec.index_of((
                    (anchor[0] + i) % d0,
                    (anchor[1] + j) % d1,
                    (anchor[2] + k) % d2)))
    return out


def _frag_of(anchor: tuple[int, int, int], orient: tuple[int, int, int],
             spec: MeshSpec, free: np.ndarray) -> int:
    """Exposed-free-boundary count of one feasible placement (see
    module docstring); walls (non-wrap out-of-range halo cells) and
    holes/occupied cells contribute nothing."""
    frag = 0
    for axis, sign in _FACES:
        s, d = orient[axis], spec.dims[axis]
        if spec.wrap and s == d:
            continue  # box spans the ring: no outside cell on this axis
        off = [0, 0, 0]
        off[axis] = s if sign > 0 else -1
        spans = [range(orient[a]) if a != axis else (0,) for a in range(3)]
        for i in spans[0]:
            for j in spans[1]:
                for k in spans[2]:
                    c = [anchor[0] + i + off[0], anchor[1] + j + off[1],
                         anchor[2] + k + off[2]]
                    if spec.wrap:
                        c = [v % dd for v, dd in zip(c, spec.dims)]
                    elif not spec.contains(c):
                        continue
                    if free[spec.index_of(c)]:
                        frag += 1
    return frag


def oracle_scan(free: np.ndarray, spec: MeshSpec,
                shape: Sequence[int]) -> tuple[np.ndarray, np.ndarray]:
    """(feasible (A,), frag (A,) int32) over every placement id.
    `free` is a (spec.cells,) bool mask; frag is 0 where infeasible."""
    orients = orientations(shape, spec)
    cells = spec.cells
    feas = np.zeros((len(orients) * cells,), dtype=np.bool_)
    frag = np.zeros((len(orients) * cells,), dtype=np.int32)
    for oi, orient in enumerate(orients):
        for a in range(cells):
            anchor = spec.coord_of(a)
            if not _anchor_ok(anchor, orient, spec):
                continue
            members = _member_cells(anchor, orient, spec)
            if all(free[m] for m in members):
                pid = oi * cells + a
                feas[pid] = True
                frag[pid] = _frag_of(anchor, orient, spec, free)
    return feas, frag


def best_placement(feas: np.ndarray, frag: np.ndarray) -> int:
    """Lowest-id placement among the minimum-frag feasible ones
    (-1 when nothing is feasible)."""
    best, best_frag = -1, None
    for pid in range(len(feas)):
        if feas[pid] and (best_frag is None or frag[pid] < best_frag):
            best, best_frag = pid, int(frag[pid])
    return best


def placement_members(pid: int, spec: MeshSpec,
                      shape: Sequence[int]) -> list[int]:
    """Member cell indices of one placement id (sorted ascending —
    the member→coordinate assignment order the gang plan uses)."""
    orients = orientations(shape, spec)
    oi, a = divmod(pid, spec.cells)
    return sorted(_member_cells(spec.coord_of(a), orients[oi], spec))


def coverage(feas: np.ndarray, spec: MeshSpec,
             shape: Sequence[int]) -> np.ndarray:
    """(cells,) bool: cells belonging to >= 1 feasible placement. The
    complement over free cells is the stranded-for-this-shape capacity
    `scheduler_slice_fragmentation_pct` reports."""
    orients = orientations(shape, spec)
    covered = np.zeros((spec.cells,), dtype=np.bool_)
    for oi, orient in enumerate(orients):
        for a in range(spec.cells):
            if feas[oi * spec.cells + a]:
                covered[_member_cells(spec.coord_of(a), orient, spec)] = True
    return covered


def is_contiguous_slice(cells: Iterable[int], spec: MeshSpec,
                        shape: Sequence[int]) -> bool:
    """Do `cells` form EXACTLY one anchored box of `shape` (any valid
    orientation, torus wraparound included)? The Permit-time contract
    for slice-shaped gangs: every anchor candidate is a member cell
    (offset 0 is in every box), so the check is O(|cells|^2 · |O|)."""
    want = set(int(c) for c in cells)
    if not want or any(not 0 <= c < spec.cells for c in want):
        return False
    for orient in orientations(shape, spec):
        if orient[0] * orient[1] * orient[2] != len(want):
            continue
        for a in want:
            anchor = spec.coord_of(a)
            if not _anchor_ok(anchor, orient, spec):
                continue
            if set(_member_cells(anchor, orient, spec)) == want:
                return True
    return False
