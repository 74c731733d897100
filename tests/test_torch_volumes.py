"""The volume plugins and the PV binder in the port against the JAX
package on the CPU.

- The cases of `tests/test_volumes.py`, each run through both packages'
  store, PV binder (`controllers.PVBinderController` under a
  `ControllerManager`) and `Scheduler.run` (the host path, as the
  reference's cases run it), one script per case, with the outcomes
  required equal and as the reference's test expects them: a claim bound
  at once to a static PV; capacity and class matching; a PV released
  when its claim is deleted; a WaitForFirstConsumer claim provisioned on
  the node PreBind selected, the pod bound only after it; a bound PV's
  node affinity pinning its pod; a missing claim parking its pod; a
  no-provisioner class blocking until a local PV appears; the requeue of
  a parked pod when its Immediate claim binds; a node's
  `attachable-volumes` limit; ReadWriteOncePod admitting one pod and
  ReadWriteOnce pinning a joiner to the holder's node. The
  WaitForFirstConsumer, node-affinity and limit cases also run the port
  with `TorchBackend(device="cpu")` attached.
- `TorchBackend(device="cpu").assign` against `TPUBackend.assign` on
  `chip_smoke.volume_case`'s chunk (200 nodes in three zones, all four
  plugins active), flagless and with greedy pinned: identical
  assignments, diagnostics, solver metrics, host-fallback counts and
  verify rejects (the second pod of the shared ReadWriteOncePod claim).
- The default profile is the reference's 19 plugins, and the serving
  fast path refuses a pod with a claim in both packages (its volume
  gates), taking a plain pod.
- `chip_smoke.volume_loop` (both packages' loops with the PV binder
  beside them, 30 nodes, 10 + 20 pods with one claim each): every gate
  of `volume_violations` holds in the port; in the reference every gate
  but one, its batched placements' WaitForFirstConsumer claims staying
  unbound (its loop binds them with an empty CycleState, so
  VolumeBinding's PreBind does nothing; ROADMAP queue 3).

Waits use deadlines of 10-15 s, as the reference's cases do.

Tolerance: none.
"""

import asyncio
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (VOLUME_CHUNK, device_chunk_view, port_loop_api,
                        port_volume_api, port_volume_loop_api, volume_chunk,
                        volume_chunk_view, volume_loop, volume_violations)
from kubernetes_tpu.api import types as jtypes_api
from kubernetes_tpu.api.meta import new_object as jnew_object
from kubernetes_tpu.client import InformerFactory as JInformerFactory
from kubernetes_tpu.client import ResourceEventHandler as JHandler
from kubernetes_tpu.controllers import ControllerManager as JManager
from kubernetes_tpu.controllers import PVBinderController as JBinder
from kubernetes_tpu.controllers.pvbinder import pv_node_ok as jpv_node_ok
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu_torch.api import types as ttypes_api
from kubernetes_tpu_torch.api.meta import new_object
from kubernetes_tpu_torch.controllers import (ControllerManager,
                                              PVBinderController)
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from test_torch_noderesourcetopology import JAX_DEVICE_API
from test_torch_serving import Pair


def _api(types_mod, **kw):
    return SimpleNamespace(
        make_node=types_mod.make_node, make_pod=types_mod.make_pod,
        make_pv=types_mod.make_pv, make_pvc=types_mod.make_pvc,
        make_storage_class=types_mod.make_storage_class, **kw)


PORT = _api(ttypes_api, new_object=new_object,
            ControllerManager=ControllerManager,
            PVBinderController=PVBinderController,
            **{k: getattr(port_loop_api(), k) for k in (
                "InformerFactory", "Scheduler", "new_cluster_store",
                "install_core_validation")})
JAX = _api(jtypes_api, new_object=jnew_object, ControllerManager=JManager,
           PVBinderController=JBinder, InformerFactory=JInformerFactory,
           Scheduler=JScheduler, new_cluster_store=jnew_store,
           install_core_validation=jinstall)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


async def wait_for(predicate, timeout=10.0, interval=0.03):
    for _ in range(int(timeout / interval)):
        v = await predicate()
        if v:
            return v
        await asyncio.sleep(interval)
    return await predicate()


def pod_with_pvc(api, name, claim, **kw):
    pod = api.make_pod(name, requests={"cpu": "100m"}, **kw)
    pod["spec"]["volumes"] = [
        {"name": "data", "persistentVolumeClaim": {"claimName": claim}}]
    return pod


class Stack:
    """A store with nodes, optionally the PV binder under a
    ControllerManager, and a running Scheduler (the host path, or
    `backend`)."""

    def __init__(self, api, backend=None):
        self.api, self.backend = api, backend

    async def start(self, nodes=None, binder=True):
        api = self.api
        self.store = store = api.new_cluster_store()
        api.install_core_validation(store)
        for n in nodes or [api.make_node(f"n{i}") for i in range(3)]:
            await store.create("nodes", n)
        self.mgr = None
        if binder:
            self.mgr = api.ControllerManager(store,
                                             [api.PVBinderController(store)])
            await self.mgr.start()
        self.sched = api.Scheduler(store, seed=11, backend=self.backend)
        self.factory = api.InformerFactory(store)
        await self.sched.setup_informers(self.factory)
        self.factory.start()
        await self.factory.wait_for_sync()
        self.task = asyncio.ensure_future(self.sched.run())
        return store

    async def node_of(self, name, timeout=15.0):
        async def bound():
            pod = await self.store.get("pods", f"default/{name}")
            return pod["spec"].get("nodeName")
        return await wait_for(bound, timeout=timeout)

    async def stop(self):
        await self.sched.stop()
        self.task.cancel()
        await asyncio.gather(self.task, return_exceptions=True)
        if self.mgr is not None:
            await self.mgr.stop()
        self.factory.stop()
        self.store.stop()


def run_case(case, api, backend=None):
    async def body():
        stack = Stack(api, backend)
        try:
            return await case(stack, api)
        finally:
            await stack.stop()
    return asyncio.run(body())


async def immediate_binding_static_pv(stack, api):
    store = await stack.start()
    await store.create("persistentvolumes", api.make_pv("pv-a", "10Gi"))
    await store.create("persistentvolumeclaims", api.make_pvc(
        "data", request="5Gi"))

    async def bound():
        pvc = await store.get("persistentvolumeclaims", "default/data")
        return pvc["status"].get("phase") == "Bound" and \
            pvc["spec"].get("volumeName") == "pv-a"
    ok = await wait_for(bound)
    pv = await store.get("persistentvolumes", "pv-a")
    return ok, pv["status"]["phase"], pv["spec"]["claimRef"]["name"]


async def capacity_and_class_matching(stack, api):
    store = await stack.start()
    await store.create("persistentvolumes", api.make_pv("small", "1Gi"))
    await store.create("persistentvolumes", api.make_pv(
        "classed", "20Gi", storage_class="fast"))
    await store.create("persistentvolumes", api.make_pv("big", "20Gi"))
    await store.create("persistentvolumeclaims", api.make_pvc(
        "data", request="5Gi"))

    async def bound():
        pvc = await store.get("persistentvolumeclaims", "default/data")
        return pvc["spec"].get("volumeName")
    return await wait_for(bound)


async def pvc_delete_releases_pv(stack, api):
    store = await stack.start()
    await store.create("persistentvolumes", api.make_pv("pv-a", "10Gi"))
    await store.create("persistentvolumeclaims", api.make_pvc("data"))

    async def bound():
        pv = await store.get("persistentvolumes", "pv-a")
        return pv["status"].get("phase") == "Bound"
    first = await wait_for(bound)
    await store.delete("persistentvolumeclaims", "default/data")

    async def released():
        pv = await store.get("persistentvolumes", "pv-a")
        return pv["status"].get("phase") == "Available" and \
            not pv["spec"].get("claimRef")
    return first, await wait_for(released)


async def wffc_pod_schedules_after_provision(stack, api):
    store = await stack.start()
    await store.create("storageclasses", api.make_storage_class(
        "wffc", binding_mode="WaitForFirstConsumer"))
    await store.create("persistentvolumeclaims", api.make_pvc(
        "data", storage_class="wffc"))
    await store.create("pods", pod_with_pvc(api, "app", "data"))
    node = await stack.node_of("app")
    pvc = await store.get("persistentvolumeclaims", "default/data")
    ann = pvc["metadata"]["annotations"]["volume.kubernetes.io/selected-node"]
    pv = await store.get("persistentvolumes", pvc["spec"]["volumeName"])
    terms = pv["spec"]["nodeAffinity"]["required"]["nodeSelectorTerms"]
    return (bool(node), pvc["status"]["phase"], ann == node,
            terms[0]["matchFields"][0]["values"] == [node])


async def bound_pv_node_affinity(stack, api):
    store = await stack.start()
    pv = api.make_pv("local-pv", "10Gi", node_affinity={
        "nodeSelectorTerms": [{"matchFields": [
            {"key": "metadata.name", "operator": "In", "values": ["n1"]}]}]})
    await store.create("persistentvolumes", pv)
    await store.create("persistentvolumeclaims", api.make_pvc("data"))

    async def pvc_bound():
        c = await store.get("persistentvolumeclaims", "default/data")
        return c["status"].get("phase") == "Bound"
    ok = await wait_for(pvc_bound)
    await store.create("pods", pod_with_pvc(api, "app", "data"))
    return ok, await stack.node_of("app")


async def missing_pvc_is_unschedulable(stack, api):
    store = await stack.start()
    await store.create("pods", pod_with_pvc(api, "app", "nope"))
    await asyncio.sleep(0.5)
    pod = await store.get("pods", "default/app")
    return (pod["spec"].get("nodeName"),
            stack.sched.queue.stats()["unschedulable"])


async def no_provisioner_blocks_until_pv(stack, api):
    store = await stack.start()
    await store.create("storageclasses", api.make_storage_class(
        "local", binding_mode="WaitForFirstConsumer",
        provisioner="kubernetes.io/no-provisioner"))
    await store.create("persistentvolumeclaims", api.make_pvc(
        "data", storage_class="local"))
    await store.create("pods", pod_with_pvc(api, "app", "data"))
    await asyncio.sleep(0.5)
    before = (await store.get("pods", "default/app"))["spec"].get("nodeName")
    await store.create("persistentvolumes", api.make_pv(
        "local-1", "10Gi", storage_class="local",
        node_affinity={"nodeSelectorTerms": [{"matchFields": [
            {"key": "metadata.name", "operator": "In",
             "values": ["n2"]}]}]}))
    return before, await stack.node_of("app")


async def immediate_bind_requeues_parked_pod(stack, api):
    store = await stack.start()
    await store.create("storageclasses", api.make_storage_class(
        "slow", provisioner="kubernetes.io/no-provisioner"))
    await store.create("persistentvolumeclaims", api.make_pvc(
        "data", storage_class="slow"))
    await store.create("pods", pod_with_pvc(api, "app", "data"))
    await asyncio.sleep(0.4)
    parked = stack.sched.queue.stats()["unschedulable"]
    await store.create("persistentvolumes", api.make_pv(
        "pv-slow", "10Gi", storage_class="slow"))
    return parked, bool(await stack.node_of("app", timeout=10.0))


async def node_volume_limits(stack, api):
    node = api.make_node("tiny")
    node["status"]["allocatable"]["attachable-volumes-csi"] = "1"
    store = await stack.start(nodes=[node])
    for i in range(2):
        await store.create("persistentvolumes", api.make_pv(f"pv{i}", "10Gi"))
        await store.create("persistentvolumeclaims", api.make_pvc(f"c{i}"))

    async def claims_bound():
        cs = (await store.list("persistentvolumeclaims")).items
        return all(c["status"].get("phase") == "Bound" for c in cs)
    ok = await wait_for(claims_bound)
    await store.create("pods", pod_with_pvc(api, "p0", "c0"))
    first = await stack.node_of("p0")
    await store.create("pods", pod_with_pvc(api, "p1", "c1"))
    await asyncio.sleep(0.6)
    second = (await store.get("pods", "default/p1"))["spec"].get("nodeName")
    return ok, first, second


async def _bound_claim(store, api, name, modes):
    """A claim bound in advance (volumeName and its PV), so VolumeBinding
    passes without the PV binder."""
    await store.create("persistentvolumes", api.new_object(
        "PersistentVolume", f"pv-{name}", None,
        spec={"capacity": {"storage": "1Gi"}, "accessModes": modes}))
    await store.create("persistentvolumeclaims", api.new_object(
        "PersistentVolumeClaim", name, "default",
        spec={"accessModes": modes, "volumeName": f"pv-{name}",
              "resources": {"requests": {"storage": "1Gi"}}}))


async def rwop_claim_admits_one_pod(stack, api):
    nodes = [api.make_node(f"n{i}") for i in range(2)]
    store = await stack.start(nodes=nodes, binder=False)
    await _bound_claim(store, api, "exclusive", ["ReadWriteOncePod"])
    await store.create("pods", pod_with_pvc(api, "first", "exclusive"))
    first = await stack.node_of("first", timeout=4.0)
    await store.create("pods", pod_with_pvc(api, "second", "exclusive"))
    await asyncio.sleep(0.4)
    before = (await store.get("pods", "default/second"))["spec"].get(
        "nodeName")
    await store.delete("pods", "default/first")
    return bool(first), before, bool(await stack.node_of("second",
                                                         timeout=6.0))


async def rwo_claim_pins_to_attached_node(stack, api):
    nodes = [api.make_node(f"n{i}") for i in range(3)]
    store = await stack.start(nodes=nodes, binder=False)
    await _bound_claim(store, api, "shared", ["ReadWriteOnce"])
    await store.create("pods", pod_with_pvc(api, "holder", "shared",
                                            node_name="n1"))

    async def cached():
        return any(ni.pods for ni in stack.sched.cache.update_snapshot())
    await wait_for(cached)
    await store.create("pods", pod_with_pvc(api, "joiner", "shared"))
    return await stack.node_of("joiner", timeout=4.0)


#: case -> the outcome the reference's test expects.
CASES = {
    immediate_binding_static_pv: (True, "Bound", "data"),
    capacity_and_class_matching: "big",
    pvc_delete_releases_pv: (True, True),
    wffc_pod_schedules_after_provision: (True, "Bound", True, True),
    bound_pv_node_affinity: (True, "n1"),
    missing_pvc_is_unschedulable: (None, 1),
    no_provisioner_blocks_until_pv: (None, "n2"),
    immediate_bind_requeues_parked_pod: (1, True),
    node_volume_limits: (True, "tiny", None),
    rwop_claim_admits_one_pod: (True, None, True),
    rwo_claim_pins_to_attached_node: "n1",
}


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__)
def test_case_matches_reference(case):
    want = CASES[case]
    assert run_case(case, JAX) == want
    assert run_case(case, PORT) == want


@pytest.mark.parametrize("case", [wffc_pod_schedules_after_provision,
                                  bound_pv_node_affinity, node_volume_limits],
                         ids=lambda c: c.__name__)
def test_case_through_the_batched_backend(case):
    assert run_case(case, PORT, TorchBackend(device="cpu", max_batch=16)) \
        == CASES[case]


JAX_VOLUME_API = SimpleNamespace(**vars(JAX_DEVICE_API),
                                 registry=jregistry, framework=jframework)


@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_assign_matches_reference(mode):
    tb = TorchBackend(device="cpu", max_batch=VOLUME_CHUNK)
    got = volume_chunk_view(*volume_chunk(port_volume_api(), tb, 8, mode),
                            tb.counters)
    want = device_chunk_view(*volume_chunk(
        JAX_VOLUME_API, TPUBackend(max_batch=VOLUME_CHUNK, mesh=None), 8,
        mode))
    assert got["assignments"] == want["assignments"]
    assert got["diagnostics"] == want["diagnostics"]
    assert got.pop("verify_rejects") == 1
    assert got == want
    a = got["assignments"]
    assert a["default/vp-immediate"] is None
    assert a["default/vp-missing"] is None
    # The shared ReadWriteOncePod claim: the verify's full re-check
    # rejects its second placement, with VolumeRestrictions' status.
    assert a["default/vp-rwop-a"] is not None
    assert a["default/vp-rwop-b"] is None
    (_, code, reasons, plugin), = got["diagnostics"]["default/vp-rwop-b"]
    assert plugin == "VolumeRestrictions" and "ReadWriteOncePod" in reasons[0]
    assert got["host_fallback"] > 0
    placed = sum(v is not None for v in a.values())
    assert placed > len(a) // 2


def test_default_profile_is_the_references():
    assert tregistry.DEFAULT_PLUGINS == jregistry.DEFAULT_PLUGINS
    assert len(tregistry.DEFAULT_PLUGINS) == 19
    for name in ("VolumeBinding", "VolumeRestrictions", "VolumeZone",
                 "NodeVolumeLimits"):
        assert name in tbackend.MODELLED_PLUGINS
        assert name in tbackend._FILTER_ACTIVE


def test_fast_path_refuses_volume_pods_as_the_reference():
    pair = Pair(8)
    pvc = pod_with_pvc(PORT, "with-claim", "data-0")
    want, got, _ = pair.place(pvc)
    assert want is None and got is None
    assert pair.counters(pair.jfp) == pair.counters(pair.tfp) == (0, 1, 0)
    want, got, _ = pair.place(PORT.make_pod("plain",
                                            requests={"cpu": "100m"}))
    assert got == want is not None


def _loop_api(api, loop_api, pv_node_ok):
    out = SimpleNamespace(**vars(loop_api))
    for k in ("make_pv", "make_pvc", "make_storage_class",
              "ControllerManager", "PVBinderController"):
        setattr(out, k, getattr(api, k))
    out.pv_node_ok = pv_node_ok
    return out


@pytest.mark.parametrize("package", ["port", "jax"])
def test_volume_loop_gates(package):
    if package == "port":
        api, backend = port_volume_loop_api(), TorchBackend(device="cpu",
                                                            max_batch=16)
    else:
        loop_api = SimpleNamespace(
            make_node=JAX.make_node, make_pod=JAX.make_pod,
            InformerFactory=JInformerFactory, Scheduler=JScheduler,
            ResourceEventHandler=JHandler, install_core_validation=jinstall,
            new_cluster_store=jnew_store)
        api = _loop_api(JAX, loop_api, jpv_node_ok)
        backend = TPUBackend(max_batch=16, mesh=None)
    out = asyncio.run(volume_loop(api, backend, 30, 10, 20, batch_size=128,
                                  limit=2, timeout=120.0))
    faults = volume_violations(api, out)
    assert len(out["pods"]) == 30
    assert len(out["prebind_waits"]) == 30
    if package == "port":
        assert faults == []
    else:
        # The reference binds a batched placement with an empty
        # CycleState, so VolumeBinding's PreBind never selects a node for
        # a WaitForFirstConsumer claim (odd pods) the backend placed,
        # which stays unbound (a pod the host path placed has its claim
        # provisioned); every other gate holds (ROADMAP queue 3).
        assert set(faults) <= {f"vol-{k}: claim data-{k} not bound to a PV"
                               for k in range(1, 30, 2)}
