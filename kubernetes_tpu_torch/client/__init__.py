"""Client runtime: the reflector → informer triangle (client-go tools/cache
equivalents) and event recording. Counterpart of `kubernetes_tpu/client/`;
the sharded informer, the workqueue and leader election wait."""

from kubernetes_tpu_torch.client.informer import (
    Indexer,
    InformerFactory,
    ResourceEventHandler,
    SharedInformer,
    namespace_index,
)
from kubernetes_tpu_torch.client.events import EventRecorder

__all__ = [
    "Indexer",
    "InformerFactory",
    "ResourceEventHandler",
    "SharedInformer",
    "namespace_index",
    "EventRecorder",
]
