"""The object store: the hub of the control plane (everything is
hub-and-spoke through the store; components communicate only by
reading/writing objects and watching for changes). Counterpart of
`kubernetes_tpu/store/`: the MVCC store with its watch cache, the core
validation, server-side apply, durability (the write-ahead log, its
snapshots and recovery) and the sharded store."""

from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Event,
    Expired,
    Invalid,
    ListResult,
    MVCCStore,
    NotFound,
    StoreError,
    binding_subresource,
    new_cluster_store,
)
from kubernetes_tpu_torch.store.sharded import (
    PARTITIONED_RESOURCES,
    ShardedNodeStore,
    control_plane_shards,
    shard_of,
)
from kubernetes_tpu_torch.store.apply import ApplyConflict, server_side_apply
from kubernetes_tpu_torch.store.durable import (
    DurabilityManager,
    WriteAheadLog,
    recover_store,
)
from kubernetes_tpu_torch.store.validation import install_core_validation

__all__ = [
    "ApplyConflict",
    "server_side_apply",
    "DurabilityManager",
    "WriteAheadLog",
    "recover_store",
    "AlreadyExists",
    "Conflict",
    "Event",
    "Expired",
    "Invalid",
    "ListResult",
    "MVCCStore",
    "NotFound",
    "StoreError",
    "binding_subresource",
    "new_cluster_store",
    "install_core_validation",
    "PARTITIONED_RESOURCES",
    "ShardedNodeStore",
    "control_plane_shards",
    "shard_of",
]
