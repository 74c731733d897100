"""Client runtime: the reflector → informer triangle (client-go tools/cache
equivalents), event recording, the rate-limited work queue and the
conflict-retry helper the remote stores share. Counterpart of
`kubernetes_tpu/client/`; the sharded informer and leader election wait."""

from kubernetes_tpu_torch.client.informer import (
    Indexer,
    InformerFactory,
    ResourceEventHandler,
    SharedInformer,
    namespace_index,
)
from kubernetes_tpu_torch.client.events import EventRecorder
from kubernetes_tpu_torch.client.retry import retry_on_conflict
from kubernetes_tpu_torch.client.workqueue import RateLimitingQueue

__all__ = [
    "Indexer",
    "InformerFactory",
    "ResourceEventHandler",
    "SharedInformer",
    "namespace_index",
    "EventRecorder",
    "RateLimitingQueue",
    "retry_on_conflict",
]
