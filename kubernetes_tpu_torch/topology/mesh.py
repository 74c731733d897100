"""Interconnect coordinate model: mesh shape + node→coordinate mapping.

A cluster's interconnect is a rectangular 2D/3D mesh or torus
(`KTPU_MESH_SHAPE`). Internally every shape is padded to 3D with
trailing size-1 axes so the oracle and the device kernel share one
code path; a 2D `4x8` torus is the (4, 8, 1) mesh with wraparound.

Node→coordinate contract (agent and scheduler must agree):

1. the `ktpu.io/topology-coord` label ("x,y" / "x,y,z") a NodeAgent
   stamps at registration wins;
2. otherwise the trailing integer in the node name is taken as the
   row-major cell index (kwok `node-17` staging works untouched);
3. a node with neither, or whose coordinate falls outside the mesh,
   is OFF-MESH: it schedules normally as flat capacity but can never
   host a slice member.

Orientations of a requested shape are the distinct axis permutations
of its padded 3-tuple (the rotations/reflections of an axis-aligned
box on a grid), lexicographically ordered — the enumeration order is
part of the placement-id contract shared by `slices` (oracle) and
`device` (kernel); only orientations that fit the mesh per-axis
(s <= d on every axis) are kept, on a torus a window equal to the
ring uses the whole ring exactly once.

Copy of `kubernetes_tpu/topology/mesh.py`.
"""

from __future__ import annotations

import itertools
import math
import re
from dataclasses import dataclass
from typing import Mapping, Sequence

#: node label carrying "x,y" / "x,y,z" interconnect coordinates
#: (NodeAgent stamps it at registration; see agent/agent.py).
MESH_COORD_LABEL = "ktpu.io/topology-coord"

_NAME_INDEX_RE = re.compile(r"(\d+)$")


@dataclass(frozen=True)
class MeshSpec:
    """One interconnect mesh: padded 3D dims + wraparound flag."""

    dims: tuple[int, int, int]
    wrap: bool = True

    @property
    def cells(self) -> int:
        d0, d1, d2 = self.dims
        return d0 * d1 * d2

    def coord_of(self, index: int) -> tuple[int, int, int]:
        """Row-major cell index → (x, y, z)."""
        _, d1, d2 = self.dims
        return (index // (d1 * d2), (index // d2) % d1, index % d2)

    def index_of(self, coord: Sequence[int]) -> int:
        _, d1, d2 = self.dims
        return (coord[0] * d1 + coord[1]) * d2 + coord[2]

    def contains(self, coord: Sequence[int]) -> bool:
        return all(0 <= c < d for c, d in zip(coord, self.dims))


def parse_mesh_shape(raw: str | None, n_nodes: int) -> MeshSpec:
    """KTPU_MESH_SHAPE → MeshSpec. `auto` (and any malformed value —
    a typo'd shape must not crash a control plane, the flags-registry
    posture) derives a near-square 2D torus covering `n_nodes`; cells
    beyond the node count are holes, never free."""
    wrap = True
    text = (raw or "auto").strip().lower()
    if text.endswith(":mesh"):
        wrap = False
        text = text[: -len(":mesh")]
    if text and text != "auto":
        try:
            dims = tuple(int(p) for p in text.split("x"))
        except ValueError:
            dims = ()
        if dims and 1 <= len(dims) <= 3 and all(d >= 1 for d in dims):
            padded = dims + (1,) * (3 - len(dims))
            return MeshSpec(dims=padded, wrap=wrap)
    d0 = max(1, math.isqrt(max(1, n_nodes - 1)) + 1)  # ceil(sqrt(n))
    d1 = max(1, -(-max(1, n_nodes) // d0))
    return MeshSpec(dims=(d0, d1, 1), wrap=True)


def parse_coord_label(value: str) -> tuple[int, int, int] | None:
    """"x,y" / "x,y,z" → padded 3-tuple (None on malformed input)."""
    try:
        parts = tuple(int(p) for p in value.split(","))
    except (ValueError, AttributeError):
        return None
    if not 1 <= len(parts) <= 3:
        return None
    return parts + (0,) * (3 - len(parts))


def node_cell(name: str, labels: Mapping[str, str] | None,
              spec: MeshSpec) -> int | None:
    """Flat cell index of one node (None = off-mesh). Label wins;
    trailing name integer is the row-major fallback."""
    coord = None
    if labels:
        value = labels.get(MESH_COORD_LABEL)
        if value is not None:
            coord = parse_coord_label(value)
            if coord is None or not spec.contains(coord):
                return None  # explicit but bad coordinate: off-mesh
            return spec.index_of(coord)
    m = _NAME_INDEX_RE.search(name or "")
    if m is None:
        return None
    index = int(m.group(1))
    return index if index < spec.cells else None


def normalize_shape(shape: Sequence[int]) -> tuple[int, int, int]:
    """Requested sliceShape → padded 3-tuple (dims >= 1 enforced)."""
    dims = tuple(int(s) for s in shape)[:3]
    if not dims or any(d < 1 for d in dims):
        raise ValueError(f"bad slice shape {shape!r}")
    return dims + (1,) * (3 - len(dims))


def orientations(shape: Sequence[int],
                 spec: MeshSpec) -> tuple[tuple[int, int, int], ...]:
    """Distinct valid axis permutations of the padded shape, lex order
    (the placement-id enumeration contract — see module docstring)."""
    padded = normalize_shape(shape)
    seen = sorted(set(itertools.permutations(padded)))
    return tuple(o for o in seen
                 if all(s <= d for s, d in zip(o, spec.dims)))
