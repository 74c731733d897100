"""KWOK-style fake node controller: thousands of nodes without kubelets.

Parity target: kubernetes-sigs/kwok (SURVEY §4 "Scale simulation" row) +
cmd/kubemark hollow nodes: register N Node objects, renew their coordination
Leases on the kubelet cadence, and fake the pod lifecycle (bound pods are
marked Running, and terminate when deleted). This is what makes 5k/50k-node
configs runnable on one host with the REAL control plane (store, scheduler,
controllers all unmodified).

Copy of `kubernetes_tpu/controllers/kwok.py`.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object
from kubernetes_tpu_torch.api.types import (
    make_node,
    make_resource_slice,
    template_devices,
)
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)


class KwokController(Controller):
    NAME = "kwok"
    WORKERS = 2

    def __init__(self, store, *, node_count: int = 0,
                 node_template: dict | None = None,
                 lease_period: float = 2.0,
                 name_prefix: str = "kwok-node-",
                 device_zones: int = 2,
                 device_driver: str = "dra.ktpu"):
        super().__init__(store)
        self.node_count = node_count
        self.node_template = node_template or {}
        self.lease_period = lease_period
        self.name_prefix = name_prefix
        #: device-plugin seam (SURVEY §2.5 devicemanager): extended
        #: resources in the node template ALSO publish as per-node
        #: ResourceSlices (the DRA driver's ListAndWatch analog), split
        #: into contiguous blocks across this many NUMA zones (devices
        #: 0..n/z-1 in zone 0, etc. — the alignment MatchAttribute needs).
        self.device_zones = max(1, device_zones)
        self.device_driver = device_driver
        self._device_list: list[dict] | None = None  # built once
        self._managed: set[str] = set()
        self._ip_seq = 0  # fake pod IP allocator (see _mark_running)
        self._run_queue: list[str] = []
        self._run_draining = False
        self._stage_tasks: set[asyncio.Task] = set()

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")

        def on_pod(obj):
            # Fake kubelet: a pod bound to a managed node starts "Running".
            # Keys are buffered and drained by ONE task (not one task per
            # pod — at 10k pods/s the per-pod task + write overhead is a
            # top host cost).
            node = obj.get("spec", {}).get("nodeName")
            if node in self._managed and \
                    obj.get("status", {}).get("phase") == "Pending":
                self._run_queue.append(namespaced_name(obj))
                if not self._run_draining:
                    self._run_draining = True
                    asyncio.ensure_future(self._drain_mark_running())

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=on_pod, on_update=lambda o, n: on_pod(n)))

    async def _drain_mark_running(self) -> None:
        try:
            while self._run_queue:
                batch, self._run_queue = self._run_queue, []
                for key in batch:
                    await self._mark_running(key)
        finally:
            self._run_draining = False

    async def register_nodes(self) -> None:
        for i in range(self.node_count):
            name = f"{self.name_prefix}{i}"
            node = make_node(name, **self.node_template)
            node["metadata"].setdefault("annotations", {})[
                "kwok.x-k8s.io/node"] = "fake"
            try:
                await self.store.create("nodes", node)
            except AlreadyExists:
                pass
            self._managed.add(name)
            await self._publish_devices(name)

    def _template_devices(self) -> list[dict]:
        """Device list derived from the template ONCE (50k-node runs
        register 50k slices; re-parsing per node would be 400k throwaway
        dict builds). Naming/zoning convention: api.types.template_devices
        (shared with the hollow-kubelet agent)."""
        if self._device_list is None:
            self._device_list = template_devices(
                self.node_template.get("allocatable"), self.device_zones)
        return self._device_list

    async def _publish_devices(self, node_name: str) -> None:
        """Model HOW `google.com/tpu: 8` arrives: the kubelet device
        manager / DRA driver registers the node's devices. Extended
        resources in the template (names containing '/') publish as a
        ResourceSlice with per-device NUMA attributes, so BOTH device
        paths work against kwok nodes — legacy extended-resource counting
        (already in node.allocatable) and DRA claims."""
        devices = self._template_devices()
        if not devices:
            return
        try:
            # store.create deep-copies on entry; the shared list is safe.
            await self.store.create(
                "resourceslices",
                make_resource_slice(node_name, self.device_driver,
                                    devices))
        except AlreadyExists:
            pass
        except StoreError:
            logger.exception("kwok: device publish failed for %s",
                             node_name)

    def start(self) -> None:
        super().start()
        self._tasks.append(asyncio.ensure_future(self._lease_loop()))

    async def _lease_loop(self) -> None:
        """Renew every managed node's Lease (nodelease cadence)."""
        while not self._stopped:
            # Copy: fail_node() may discard from _managed while this loop is
            # suspended at an await; one tick's failure must not kill the task.
            for name in list(self._managed):
                if name not in self._managed:
                    continue
                try:
                    await self.store.guaranteed_update(
                        "leases", f"kube-node-lease/{name}",
                        self._renew)
                except NotFound:
                    lease = new_object("Lease", name, "kube-node-lease",
                                       spec={"renewTime": 0})
                    try:
                        await self.store.create("leases", lease)
                    except StoreError:
                        pass
                except StoreError:
                    pass
                except Exception:
                    logger.exception("kwok lease renew failed for %s", name)
            await asyncio.sleep(self.lease_period)

    @staticmethod
    def _renew(lease: dict) -> dict:
        lease.setdefault("spec", {})
        lease["spec"]["renewTime"] = lease["spec"].get("renewTime", 0) + 1
        return lease

    async def _mark_running(self, key: str) -> None:
        complete_after = [None]

        def mutate(pod):
            if pod.get("status", {}).get("phase") != "Pending":
                return None
            pod.setdefault("status", {})["phase"] = "Running"
            # Fake pod IP (kwok does the same): EndpointSlice endpoints
            # need addresses. Sequential allocation — unique by
            # construction (builtin hash() is salted per process and
            # collides at 50k scale).
            self._ip_seq += 1
            hi, lo = divmod(self._ip_seq, 254)
            pod["status"].setdefault(
                "podIP", f"10.{(hi >> 8) % 256}.{hi % 256}.{lo + 1}")
            conds = pod["status"].setdefault("conditions", [])
            if not any(c.get("type") == "Ready" for c in conds):
                conds.append({"type": "Ready", "status": "True"})
            complete_after[0] = (pod["metadata"].get("annotations") or {}).get(
                "kwok.x-k8s.io/complete-after")
            return pod
        try:
            await self.store.guaranteed_update(
                "pods", key, mutate, return_copy=False)
        except StoreError:
            return
        # Lifecycle stage (kwok Stage API analog): a pod annotated
        # `kwok.x-k8s.io/complete-after: "<seconds>"` runs to completion —
        # how Jobs finish in this kubelet-less world.
        if complete_after[0] is not None:
            try:
                delay = float(complete_after[0])
            except ValueError:
                return
            # Self-discarding set — one task per completing pod must not
            # accumulate for the controller's lifetime.
            t = asyncio.ensure_future(self._complete_later(key, delay))
            self._stage_tasks.add(t)
            t.add_done_callback(self._stage_tasks.discard)

    async def _complete_later(self, key: str, delay: float) -> None:
        await asyncio.sleep(delay)

        def mutate(pod):
            if pod.get("status", {}).get("phase") != "Running":
                return None
            pod["status"]["phase"] = "Succeeded"
            return pod
        try:
            await self.store.guaranteed_update(
                "pods", key, mutate, return_copy=False)
        except StoreError:
            pass

    def fail_node(self, name: str) -> None:
        """Fault injection: stop heartbeating one node (SURVEY §5.3 —
        node-death injection is first-class in the sim harness)."""
        self._managed.discard(name)

    async def sync(self, key: str) -> None:
        return
