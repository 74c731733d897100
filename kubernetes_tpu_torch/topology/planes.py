"""Per-node interconnect coordinate planes (the tensorized topology).

`TopologyPlanes` is the topology sibling of the r14 class planes:
ClusterTensors grows a `.topology` attribute carrying, for every node
row of the padded node axis, its mesh cell index and (x, y, z)
coordinates — plus the inverse cell→node map the slice allocator
walks. Like the taint interning, the planes are STATIC per node-set:
they are rebuilt only when the mesh flags or the (name, spec_epoch)
node fingerprint move, and reused (shared arrays, `rebuilt=False`)
otherwise; `topology_plane_rebuilds_total` counts the real rebuilds.

Cell collisions (two nodes claiming one coordinate — a mislabeled
agent) resolve deterministically: the LOWEST node index keeps the
cell, later claimants go off-mesh. Off-mesh nodes (cell -1) schedule
normally as flat capacity but never host slice members.

Copy of `kubernetes_tpu/topology/planes.py`.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Sequence

import numpy as np

from kubernetes_tpu_torch.topology.mesh import MeshSpec, node_cell, parse_mesh_shape

if TYPE_CHECKING:  # import cycle: scheduler.types pulls in ops.tensorize
    from kubernetes_tpu_torch.scheduler.types import NodeInfo


class TopologyPlanes:
    """Node-axis coordinate planes for one mesh spec + node set."""

    def __init__(self, spec: MeshSpec, nodes: "Sequence[NodeInfo]",
                 n_pad: int, fingerprint: tuple):
        self.spec = spec
        self.fingerprint = fingerprint
        self.rebuilt = True
        #: (n_pad,) int32 — row-major mesh cell per node row, -1 off-mesh
        #: (padding rows included).
        self.cell_of_node = np.full((n_pad,), -1, dtype=np.int32)
        #: (cells,) int32 — node row per mesh cell, -1 = hole (no node).
        self.node_of_cell = np.full((spec.cells,), -1, dtype=np.int32)
        #: (n_pad, 3) int32 — (x, y, z) per node row, -1 off-mesh.
        self.coords = np.full((n_pad, 3), -1, dtype=np.int32)
        for i, ni in enumerate(nodes):
            cell = node_cell(ni.name, ni.labels, spec)
            if cell is None or self.node_of_cell[cell] >= 0:
                continue  # off-mesh, or a later claimant of a taken cell
            self.cell_of_node[i] = cell
            self.node_of_cell[cell] = i
            self.coords[i] = spec.coord_of(cell)
        #: nodes actually on the mesh (drives the holes-are-never-free rule).
        self.on_mesh = int(np.count_nonzero(self.cell_of_node >= 0))

    def free_cells(self, node_free: np.ndarray) -> np.ndarray:
        """(cells,) bool free mask from a node-axis free mask: a cell is
        free iff a node occupies it AND that node is free. Holes and
        off-mesh nodes are never free (they can't host slice members)."""
        has_node = self.node_of_cell >= 0
        idx = np.where(has_node, self.node_of_cell, 0)
        return has_node & np.asarray(node_free, dtype=np.bool_)[idx]


def build_topology_planes(nodes: "Sequence[NodeInfo]", n_pad: int,
                          prev: TopologyPlanes | None) -> TopologyPlanes:
    """Build (or reuse) the planes for the current mesh flags + node
    set. Reuse keys on (raw flag values, (name, spec_epoch) per node):
    label moves bump spec_epoch, so a re-stamped coordinate rebuilds."""
    from kubernetes_tpu_torch.utils import flags

    raw_shape = flags.get("KTPU_MESH_SHAPE")
    fingerprint = (raw_shape, n_pad,
                   tuple((ni.name, ni.spec_epoch) for ni in nodes))
    if prev is not None and prev.fingerprint == fingerprint:
        prev.rebuilt = False
        return prev
    spec = parse_mesh_shape(raw_shape, len(nodes))
    return TopologyPlanes(spec, nodes, n_pad, fingerprint)
