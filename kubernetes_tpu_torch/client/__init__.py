"""Client runtime: the reflector → informer triangle (client-go tools/cache
equivalents), event recording and the rate-limited work queue. Counterpart
of `kubernetes_tpu/client/`; the sharded informer and leader election
wait."""

from kubernetes_tpu_torch.client.informer import (
    Indexer,
    InformerFactory,
    ResourceEventHandler,
    SharedInformer,
    namespace_index,
)
from kubernetes_tpu_torch.client.events import EventRecorder
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

__all__ = [
    "Indexer",
    "InformerFactory",
    "ResourceEventHandler",
    "SharedInformer",
    "namespace_index",
    "EventRecorder",
    "RateLimitingQueue",
]
