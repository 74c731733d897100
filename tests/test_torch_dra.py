"""DynamicResources (DRA) in the port against the JAX package on the CPU.

Inputs: `chip_smoke.device_case("dra", seed)` — 64 nodes in eight
ResourceSlice shapes (equal 4 + 4 TPU nodes, 3 + 5, TPUs with GPUs, no
slice, 2 + 2), resident pods holding claims allocated in the ledger or
not, and pending pods each referencing one claim: 2 TPUs on one `numa`,
3 TPUs unconstrained, two requests under one `numa` constraint, 1 GPU, 4
TPUs on one `numa`, and claims already allocated on a node (pinned);
built once with numpy and read by both packages.

- `_pick_devices`: the reference's claim-wide matchAttribute case (2 + 2
  free cannot hold two 2-device requests that must agree on `numa`), and
  every claim of the case against seeded free pools: equal picks.
- The plugin over both packages' stores and informers, one script:
  PreEnqueue before and after the claim exists, PreFilter (pinned, and
  claims pinned to two nodes), Filter on every node, Reserve (the assume
  ledger), a second claim's Reserve (refused where the first's assumed
  devices leave too few, taken on another node) and Unreserve, PreBind
  (status.allocation and reservedFor written), and the claims informer
  settling the assume: equal statuses, ledgers and claim objects at each
  step.
- The backend's rows: `_dra_state`'s counts equal, and `_dra_filter_row`
  of `TorchBackend` against `TPUBackend`'s for every pod: equal rows, None
  for the same claim shapes (the two-request claims), where the plugin's
  own row is used.
- `TorchBackend(device="cpu").assign` against `TPUBackend.assign` on the
  chunk, flagless and with greedy pinned: identical assignments,
  diagnostics, solver metrics and host-fallback counts; pinned pods land
  on their claim's node; the verify rejects pods whose devices the
  chunk's earlier placements took.

Waits on the informers use a 60 s deadline.

Tolerance: none (rows, picks, statuses and objects are exact).
"""

import asyncio
import copy
import time

import numpy as np
import pytest
import torch

from chip_smoke import (DEVICE_CHUNK, StaticInformers, device_case,
                        device_chunk, device_chunk_view, port_device_api)
from kubernetes_tpu.client import InformerFactory as JInformerFactory
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import dynamicresources as jdra
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu_torch.api.types import (make_device_class, make_node,
                                            make_pod, make_resource_claim,
                                            make_resource_slice)
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import dynamicresources as tdra
from kubernetes_tpu_torch.store import (install_core_validation,
                                        new_cluster_store)
from test_torch_noderesourcetopology import JAX_DEVICE_API, snapshot

NUMA = [{"matchAttribute": "numa"}]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def status(st):
    return st.code, list(st.reasons)


def test_match_attribute_applies_claim_wide():
    classes = {"tpu": make_device_class("tpu", {"type": "tpu"})}
    c = make_resource_claim("c", requests=[
        {"name": "a", "deviceClassName": "tpu", "count": 2},
        {"name": "b", "deviceClassName": "tpu", "count": 2}],
        constraints=NUMA)
    split = [{"name": f"dev-{z}-{k}",
              "attributes": {"type": "tpu", "numa": str(z)}}
             for z in range(2) for k in range(2)]
    one_zone = [{"name": f"dev-1-{k}",
                 "attributes": {"type": "tpu", "numa": "1"}}
                for k in range(4)]
    for mod in (tdra, jdra):
        assert mod.DynamicResources()._pick_devices(c, split, classes) \
            is None
        picked = mod.DynamicResources()._pick_devices(c, one_zone, classes)
        assert picked == ["dev-1-0", "dev-1-1", "dev-1-2", "dev-1-3"]


@pytest.mark.parametrize("seed", [3, 4])
def test_pick_devices_matches_reference(seed):
    case = device_case("dra", seed)
    rng = np.random.default_rng(seed)
    classes = {c["metadata"]["name"]: c
               for c in case["objects"]["deviceclasses"]}
    devices = [d for s in case["objects"]["resourceslices"]
               for d in s["spec"]["devices"]]
    tp, jp = tdra.DynamicResources(), jdra.DynamicResources()
    found = 0
    for claim in case["objects"]["resourceclaims"]:
        for _ in range(3):
            pool = [d for d in devices[:24] if rng.random() < 0.6]
            got = tp._pick_devices(claim, pool, classes)
            assert got == jp._pick_devices(claim, pool, classes)
            found += got is not None
    assert found


async def _plugin_script(api) -> list:
    """One event script through `api`'s DynamicResources over its own
    store and informers; returns what each step observed."""
    store = api.new_store()
    api.install(store)
    for i in range(3):
        await store.create("nodes", make_node(f"n{i}", allocatable={
            "cpu": "16", "memory": "64Gi", "pods": "110"}))
        await store.create("resourceslices", make_resource_slice(
            f"n{i}", "dra.ktpu", [
                {"name": f"dev-{z}-{k}",
                 "attributes": {"type": "tpu", "numa": str(z)}}
                for z in range(2) for k in range(2 + i)]))
    await store.create("deviceclasses", make_device_class(
        "tpu", {"type": "tpu"}))
    plugin = api.mod.DynamicResources()
    factory = api.factory(store)
    plugin.set_informers(factory)
    plugin.set_scheduler(type("S", (), {"store": store})())
    factory.start()
    await factory.wait_for_sync()
    out = []
    nodes = [api.types.NodeInfo(copy.deepcopy(n))
             for n in (await store.list("nodes")).items]
    snap = api.types.Snapshot(nodes, 1)

    def pod(name, *claims):
        return api.types.PodInfo(make_pod(name, requests={"cpu": "1"},
                                          resource_claims=[
            {"name": f"c{k}", "resourceClaimName": c}
            for k, c in enumerate(claims)]))

    async def settle(cond):
        deadline = time.monotonic() + 60.0
        while not cond():
            if time.monotonic() > deadline:
                raise TimeoutError("claims informer did not settle")
            await asyncio.sleep(0.01)

    p1 = pod("p1", "c-a")
    out.append(("pre_enqueue missing", status(plugin.pre_enqueue(p1))))
    await store.create("resourceclaims", make_resource_claim(
        "c-a", requests=[{"name": "t", "deviceClassName": "tpu",
                          "count": 3}], constraints=NUMA))
    await settle(lambda: plugin._claim_informer.indexer.get("default/c-a"))
    out.append(("pre_enqueue", status(plugin.pre_enqueue(p1))))
    state = api.framework.CycleState()
    out.append(("pre_filter", status(plugin.pre_filter(state, p1, snap))))
    out.append(("filter", [status(plugin.filter(state, p1, n))
                           for n in nodes]))
    out.append(("reserve", status(plugin.reserve(state, p1, "n1"))))
    out.append(("assumed", copy.deepcopy(
        {k: (a["node"], a["devices"], a["pod"])
         for k, a in plugin._assumed.items()}), plugin.assume_seq))
    # A second pod's claim sees n1's assumed devices as taken.
    await store.create("resourceclaims", make_resource_claim(
        "c-b", requests=[{"name": "t", "deviceClassName": "tpu",
                          "count": 4}]))
    await settle(lambda: plugin._claim_informer.indexer.get("default/c-b"))
    p2, s2 = pod("p2", "c-b"), api.framework.CycleState()
    plugin.pre_filter(s2, p2, snap)
    out.append(("reserve p2", status(plugin.reserve(s2, p2, "n1"))))
    out.append(("reserve p2 on n2", status(plugin.reserve(s2, p2, "n2"))))
    plugin.unreserve(s2, p2, "n2")
    out.append(("unreserve", sorted(plugin._assumed), plugin.assume_seq))
    out.append(("pre_bind", status(await plugin.pre_bind(state, p1, "n1"))))
    await settle(lambda: "default/c-a" not in plugin._assumed)
    claim = await store.get("resourceclaims", "default/c-a")
    out.append(("claim", claim["status"]["allocation"],
                [r["name"] for r in claim["status"]["reservedFor"]]))
    out.append(("ledger", {n: sorted(b) for n, b in
                           plugin._alloc_by_node.items()}))
    # Now allocated: a pod of that claim is pinned to n1; a pod holding
    # claims pinned to two nodes is unresolvable.
    p3, s3 = pod("p3", "c-a"), api.framework.CycleState()
    out.append(("pinned pre_filter", status(plugin.pre_filter(s3, p3,
                                                              snap))))
    out.append(("pinned filter", [status(plugin.filter(s3, p3, n))
                                  for n in nodes]))
    c_other = make_resource_claim("c-o", requests=[
        {"name": "t", "deviceClassName": "tpu", "count": 1}])
    c_other["status"] = {"allocation": {"nodeName": "n0",
                                        "devices": ["dev-0-0"]}}
    await store.create("resourceclaims", c_other)
    await settle(lambda: plugin._claim_informer.indexer.get("default/c-o"))
    p4 = pod("p4", "c-a", "c-o")
    out.append(("two nodes", status(plugin.pre_filter(
        api.framework.CycleState(), p4, snap))))
    out.append(("free n1", [d["name"] for d in plugin.free_devices(
        nodes[1])]))
    factory.stop()
    store.stop()
    return out


class _Api:
    def __init__(self, **kw):
        self.__dict__.update(kw)


PORT = _Api(new_store=new_cluster_store, install=install_core_validation,
            factory=InformerFactory, mod=tdra, types=ttypes,
            framework=tframework)
JAX = _Api(new_store=jnew_store, install=jinstall, factory=JInformerFactory,
           mod=jdra, types=jtypes, framework=jframework)


def test_plugin_script_matches_reference():
    got = asyncio.run(_plugin_script(PORT))
    want = asyncio.run(_plugin_script(JAX))
    assert got == want
    steps = dict((s[0], s[1:]) for s in got)
    assert steps["pre_enqueue missing"][0][0] != 0
    assert steps["reserve"][0][0] == 0
    # n1's 3 + 3 devices less the 3 assumed for p1 cannot hold 4; n2's can.
    assert steps["reserve p2"][0][0] != 0
    assert steps["reserve p2 on n2"][0][0] == 0
    assert steps["claim"][0]["nodeName"] == "n1"
    assert steps["free n1"][0] == ["dev-1-0", "dev-1-1", "dev-1-2"]
    assert steps["two nodes"][0][0] != 0


@pytest.mark.parametrize("seed", [8, 13])
def test_backend_rows_match_reference(seed):
    case = device_case("dra", seed)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    tp, jp = tdra.DynamicResources(), jdra.DynamicResources()
    tp.set_informers(StaticInformers(copy.deepcopy(case["objects"])))
    jp.set_informers(StaticInformers(copy.deepcopy(case["objects"])))
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    jb = TPUBackend(max_batch=DEVICE_CHUNK, mesh=None)
    tst = tb._dra_state(tp, tsnap, tb._tensors(tsnap))
    jst = jb._dra_state(jp, jsnap, jb._tensors(jsnap))
    assert tst["c_index"] == jst["c_index"]
    np.testing.assert_array_equal(tst["free_total"], jst["free_total"])
    assert sorted(tst["max_group"]) == sorted(jst["max_group"])
    for a in tst["max_group"]:
        np.testing.assert_array_equal(tst["max_group"][a],
                                      jst["max_group"][a], err_msg=a)
    tmemo, jmemo = {}, {}
    host_rows = 0
    for i, pod in enumerate(case["pods"]):
        got = tb._dra_filter_row(tst, tp, ttypes.PodInfo(copy.deepcopy(pod)),
                                 tmemo, i)
        want = jb._dra_filter_row(jst, jp, jtypes.PodInfo(
            copy.deepcopy(pod)), jmemo, i)
        if want is None:
            assert got is None
            host_rows += 1
        else:
            np.testing.assert_array_equal(got, want)
    assert host_rows  # the two-request claims take the plugin's row
    # A row is the plugin's own Filter over every node.
    pod = ttypes.PodInfo(copy.deepcopy(case["pods"][0]))
    state = tframework.CycleState()
    assert tp.pre_filter(state, pod, tsnap).is_success()
    assert list(tb._dra_filter_row(tst, tp, pod, {}, 0)) == [
        tp.filter(state, pod, n).is_success() for n in tsnap.nodes]


@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_assign_matches_reference(mode):
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    got = device_chunk_view(*device_chunk(port_device_api(), tb, "dra", 8,
                                          mode))
    want = device_chunk_view(*device_chunk(
        JAX_DEVICE_API, TPUBackend(max_batch=DEVICE_CHUNK, mesh=None),
        "dra", 8, mode))
    assert got["assignments"] == want["assignments"]
    assert got["diagnostics"] == want["diagnostics"]
    assert got == want
    assert got["host_fallback"] > 0
    for j in range(8):
        node = got["assignments"][f"default/pinned-{j}"]
        assert node in (None, f"dn-{8 * j + 1}")
    assert any(got["assignments"][f"default/pinned-{j}"] for j in range(8))
    rejected = [d for d in got["diagnostics"].values()
                if isinstance(d, list)]
    assert len(rejected) == tb.counters["verify_rejects"] > 0
    assert all(d[0][3] == "DynamicResources" for d in rejected)
