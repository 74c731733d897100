"""Client runtime: the reflector → informer triangle (client-go tools/cache
equivalents), event recording, the rate-limited work queue and the
conflict-retry helper the remote stores share, and leader election.
Counterpart of `kubernetes_tpu/client/`, with the sharded informer."""

from kubernetes_tpu_torch.client.informer import (
    Indexer,
    InformerFactory,
    ResourceEventHandler,
    ShardedInformer,
    SharedInformer,
    namespace_index,
)
from kubernetes_tpu_torch.client.events import EventRecorder
from kubernetes_tpu_torch.client.leaderelection import LeaderElector
from kubernetes_tpu_torch.client.retry import retry_on_conflict
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

__all__ = [
    "Indexer",
    "InformerFactory",
    "ResourceEventHandler",
    "ShardedInformer",
    "SharedInformer",
    "namespace_index",
    "EventRecorder",
    "LeaderElector",
    "RateLimitingQueue",
    "retry_on_conflict",
]
