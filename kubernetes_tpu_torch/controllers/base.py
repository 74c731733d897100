"""Controller base: the informer → ratelimited workqueue → sync(key) triangle.

Parity target: the pattern every controller in pkg/controller/ follows
(SURVEY §3.4): shared informer handlers enqueue namespace/name keys into a
rate-limited workqueue, N worker tasks pop keys and run `sync(key)`
level-triggered; failures re-enqueue with exponential backoff; periodic
resync forces full reconciliation.

Copy of `kubernetes_tpu/controllers/base.py`, with `status_writer`: the
reference's workload controllers rewrite their object's status on every
sync even when nothing in it changed, and since each watches its own
resource, the write's event queues the same key again: a sync loop that
never rests. At 10,000 pods, where a ReplicaSet sync scans every pod, it
held a controller manager's loop and stalled the garbage collector's
cascade (17 pods/s). The port's controllers write a status only when it
changes (what the apiserver does with an unchanged update upstream); the
objects are the reference's after every sync.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Iterable

from kubernetes_tpu_torch.api.meta import deep_copy, namespaced_name
from kubernetes_tpu_torch.client import (
    InformerFactory,
    RateLimitingQueue,
    ResourceEventHandler,
)

logger = logging.getLogger(__name__)


def status_writer(mutate):
    """`mutate` for `guaranteed_update`, aborted (None: no write, no
    event) when it leaves the object's status as it was."""
    def write(obj):
        before = deep_copy(obj.get("status"))
        out = mutate(obj)
        if out is not None and out.get("status") == before:
            return None
        return out
    return write


class Controller:
    """Subclass contract: set NAME, implement `sync(key)`, and wire
    informers in `setup(factory)` using `enqueue`/`enqueue_obj`."""

    NAME = "controller"
    WORKERS = 2
    RESYNC_PERIOD = 0.0  # seconds; 0 disables periodic resync

    def __init__(self, store):
        self.store = store
        self.queue = RateLimitingQueue()
        self._tasks: list[asyncio.Task] = []
        self._stopped = False

    # -- wiring ------------------------------------------------------------

    def setup(self, factory: InformerFactory) -> None:
        raise NotImplementedError

    def watch_resource(self, factory: InformerFactory, resource: str,
                       key_fn=None) -> None:
        """Standard handler set: enqueue the object's key on add/update/delete."""
        key_fn = key_fn or namespaced_name

        def enq(obj):
            asyncio.ensure_future(self.queue.add(key_fn(obj)))

        factory.informer(resource).add_event_handler(ResourceEventHandler(
            on_add=enq, on_update=lambda old, new: enq(new), on_delete=enq))

    def watch_owned(self, factory: InformerFactory, resource: str,
                    kind: str) -> None:
        """Events of `resource` map back to the owning controller's key
        via the controllerRef (the addPod/deletePod pattern every
        workload controller shares — generalized for Job→CronJob etc.)."""
        def to_owner(obj):
            for ref in obj.get("metadata", {}).get("ownerReferences") or []:
                if ref.get("controller") and ref.get("kind") == kind:
                    ns = obj["metadata"].get("namespace", "default")
                    asyncio.ensure_future(
                        self.queue.add(f"{ns}/{ref['name']}"))
                    return

        factory.informer(resource).add_event_handler(ResourceEventHandler(
            on_add=to_owner, on_update=lambda o, n: to_owner(n),
            on_delete=to_owner))

    def watch_owned_pods(self, factory: InformerFactory, kind: str) -> None:
        self.watch_owned(factory, "pods", kind)

    async def enqueue(self, key: str) -> None:
        await self.queue.add(key)

    async def enqueue_after(self, key: str, delay: float) -> None:
        await self.queue.add_after(key, delay)

    # -- run loop ----------------------------------------------------------

    def start(self) -> None:
        for _ in range(self.WORKERS):
            self._tasks.append(asyncio.ensure_future(self._worker()))
        if self.RESYNC_PERIOD > 0:
            self._tasks.append(asyncio.ensure_future(self._resync_loop()))

    async def _worker(self) -> None:
        while not self._stopped:
            key, shutdown = await self.queue.get()
            if shutdown:
                return
            try:
                await self.sync(key)
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("%s: sync(%s) failed; requeueing",
                                 self.NAME, key)
                await self.queue.add_rate_limited(key)
            else:
                self.queue.forget(key)
            finally:
                await self.queue.done(key)

    async def _resync_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.RESYNC_PERIOD)
            for key in await self.resync_keys():
                await self.queue.add(key)

    async def resync_keys(self) -> Iterable[str]:
        return []

    async def sync(self, key: str) -> None:
        raise NotImplementedError

    async def stop(self) -> None:
        self._stopped = True
        await self.queue.shut_down()
        for t in self._tasks:
            t.cancel()
        await asyncio.gather(*self._tasks, return_exceptions=True)


class ControllerManager:
    """kube-controller-manager analog: hosts controllers over one shared
    informer factory (cmd/kube-controller-manager app/controllermanager.go)."""

    def __init__(self, store, controllers: list[Controller]):
        self.store = store
        self.controllers = controllers
        self.factory = InformerFactory(store)

    async def start(self) -> None:
        for c in self.controllers:
            c.setup(self.factory)
        self.factory.start()
        await self.factory.wait_for_sync()
        for c in self.controllers:
            c.start()

    async def stop(self) -> None:
        for c in self.controllers:
            await c.stop()
        self.factory.stop()

    async def run_with_leader_election(self, elector) -> None:
        """Leader-elected controller-manager lifetime: controllers run only
        while holding the lease (kube-controller-manager's
        leaderElectAndRun); losing it stops every controller so the
        standby replica converges instead of fighting."""
        async def lead():
            await self.start()
            await asyncio.Event().wait()  # run until cancelled

        try:
            await elector.run(on_started_leading=lead)
        finally:
            await self.stop()
