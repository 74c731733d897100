"""Topology-aware slice placement: the port of `kubernetes_tpu/topology/`.

The scheduler's nodes stop being flat capacity vectors: every node
carries interconnect coordinates — its position in a configurable
2D/3D mesh or torus — and multi-host gangs request *shapes*, not
counts. The subsystem splits host/device the same way the solver does:

- `mesh`    — the coordinate model: KTPU_MESH_SHAPE parsing, the
  node→coordinate mapping (label first, name-derived fallback), and
  the orientation enumeration shared by oracle and scan.
- `slices`  — the HOST ORACLE: naive per-placement feasibility +
  fragmentation scoring, the semantic reference the device scan is
  held to (tests/test_torch_topology.py).
- `device`  — the scan as PyTorch ops on an explicit device: separable
  shifted-AND feasibility and face-sum fragmentation over the whole
  anchor grid at once, bit-identical to the oracle, with the sharded
  winner reduction.
- `planes`  — per-node coordinate planes tensorized alongside the
  class planes (ops/tensorize.ClusterTensors.topology), rebuilt only
  when the node set / mesh spec moves.

Everything rides `KTPU_TOPOLOGY` (kill switch): off restores the exact
flat-capacity call graph.
"""

from kubernetes_tpu_torch.topology.mesh import (
    MESH_COORD_LABEL,
    MeshSpec,
    node_cell,
    orientations,
    parse_mesh_shape,
)
from kubernetes_tpu_torch.topology.planes import TopologyPlanes
from kubernetes_tpu_torch.topology.slices import (
    best_placement,
    is_contiguous_slice,
    oracle_scan,
    placement_members,
)

__all__ = [
    "MESH_COORD_LABEL", "MeshSpec", "node_cell", "orientations",
    "parse_mesh_shape", "TopologyPlanes", "best_placement",
    "is_contiguous_slice", "oracle_scan", "placement_members",
]
