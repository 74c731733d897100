"""Mesh sharding for the scheduling tensors: the node-sharded solver."""

from kubernetes_tpu_torch.parallel.mesh import (
    NODES_AXIS,
    PODS_AXIS,
    SLICE_AXIS,
    Mesh,
    build_mesh,
    build_mesh_2d,
    build_multislice_mesh,
    pad_axis,
)
from kubernetes_tpu_torch.parallel.sharded import (
    resident_row_scatter,
    sharded_greedy_assign,
    sharded_greedy_assign_multislice,
    sharded_masks_scores,
    sharded_sinkhorn_plan,
)

__all__ = [
    "NODES_AXIS", "PODS_AXIS", "SLICE_AXIS", "Mesh",
    "build_mesh", "build_mesh_2d", "build_multislice_mesh", "pad_axis",
    "resident_row_scatter", "sharded_greedy_assign", "sharded_greedy_assign_multislice",
    "sharded_masks_scores", "sharded_sinkhorn_plan",
]
