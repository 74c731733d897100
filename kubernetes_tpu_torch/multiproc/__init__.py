"""Multi-process control plane.

The in-process sharded store (store/sharded.py) divides the O(table)
costs by S but every shard still shares one interpreter, one GIL, and
one event loop. This package moves each shard into its own OS
process behind the existing KTPU wire, the scheduler into a
leader-elected active/standby pair, and the shared RVCounter into
shared memory:

- rv.py            — `SharedRVCounter`: atomic int64 in shared memory,
                     monotonic setter (recovery can't regress RVs).
- shardproc.py     — shard apiserver child: mvcc store + watch cache +
                     per-shard WAL + wire socket.
- schedproc.py     — scheduler replica child: Lease-elected leader
                     rebuilds its assume-cache from informers.
- client.py        — `ProcessShardedStore`: the MVCCStore-shaped
                     facade routing over the shard sockets.
- controlplane.py  — `MultiProcessControlPlane`: spawn/kill/restart
                     supervisor + the measure-marker protocol.

Activation: `PerfRunner(processes=N)` / KTPU_PROCESSES. `1` is the
kill switch — the in-process tree is built exactly as before (no
facade, no children), so degradation is structural.

Copy of `kubernetes_tpu/multiproc/`, with the departures its modules
name: the scheduler replica builds `TorchBackend`, and its status row
carries its kernel launch counts, its `solve_provenance` and the
elections of every leader so far.
"""

from kubernetes_tpu_torch.multiproc.client import ProcessShardedStore
from kubernetes_tpu_torch.multiproc.controlplane import (
    MeasureProtocol,
    MultiProcessControlPlane,
)
from kubernetes_tpu_torch.multiproc.rv import SharedRVCounter

__all__ = [
    "MeasureProtocol",
    "MultiProcessControlPlane",
    "ProcessShardedStore",
    "SharedRVCounter",
]
