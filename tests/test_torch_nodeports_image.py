"""NodePorts and ImageLocality in the port against the JAX package on the
CPU, and the serving fast path's refusals of the device-topology pods.

- NodePorts: PreFilter and Filter of every pod of
  `chip_smoke.device_case("ports", seed)` (16 nodes; residents holding
  8080/TCP on 0.0.0.0 and 9090/TCP on 10.0.0.1; pods asking for 8080/TCP,
  8080/UDP, 9090 on 0.0.0.0 and on 10.0.0.2, 7070 and none) on every node:
  equal statuses; 8080/TCP and 9090 on 0.0.0.0 conflict where a resident
  holds them, 8080/UDP and 9090 on 10.0.0.2 do not.
- `TorchBackend(device="cpu").assign` against `TPUBackend.assign` on that
  chunk, flagless and with greedy pinned: identical assignments,
  diagnostics, solver metrics and host-fallback counts; the verify
  rejects, with NodePorts' reason, pods whose port an earlier placement
  of the same chunk took, and no two placed pods share a port on a node.
- ImageLocality: Score of seeded pods (one to three images) on seeded
  nodes (image lists): equal; `_static_score_row` equal between the two
  backends; and a chunk whose placements the image scores decide,
  assigned identically by both backends.
- The fast path under the DeviceTopology profile with NodeResourceTopology
  objects, a DeviceClass and a claim: a memory-only pod is taken; a pod
  with cpu (a zone-tracked request), a pod with a host port and a pod with
  a claim are declined (None), by the port as by the JAX package.

Tolerance: none (statuses, scores and placements are exact).
"""

import copy

import numpy as np
import pytest
import torch

from chip_smoke import (DEVICE_CHUNK, StaticInformers, device_case,
                        device_chunk, device_chunk_view, port_device_api)
from kubernetes_tpu import config as jconfig
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import core as jcore
from kubernetes_tpu.scheduler.plugins import nodeaffinity as jnodeaffinity
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu_torch import config as tconfig
from kubernetes_tpu_torch.api.types import (make_device_class, make_node,
                                            make_pod, make_resource_claim,
                                            split_node_topology)
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf.scheduler_perf import DEVICE_TOPOLOGY
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import core as tcore
from kubernetes_tpu_torch.scheduler.plugins import nodeaffinity as tnodeaffinity
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from test_torch_noderesourcetopology import JAX_DEVICE_API, snapshot
from test_torch_serving import Pair

PORTS_MSG = "node(s) didn't have free ports for the requested pod ports"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def status(st):
    return st.code, list(st.reasons)


@pytest.mark.parametrize("seed", [8, 9])
def test_node_ports_filter_matches_reference(seed):
    case = device_case("ports", seed)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    tp, jp = tnodeaffinity.NodePorts(), jnodeaffinity.NodePorts()
    seen = {}
    for pod in case["pods"]:
        tpi = ttypes.PodInfo(copy.deepcopy(pod))
        jpi = jtypes.PodInfo(copy.deepcopy(pod))
        ts, js = tframework.CycleState(), jframework.CycleState()
        pre = status(tp.pre_filter(ts, tpi, tsnap))
        assert pre == status(jp.pre_filter(js, jpi, jsnap))
        row = []
        for tn, jn in zip(tsnap.nodes, jsnap.nodes):
            got = status(tp.filter(ts, tpi, tn))
            assert got == status(jp.filter(js, jpi, jn))
            row.append(got[0] == 0)
        seen[pod["metadata"]["name"].split("-", 2)[2]] = row
    assert seen["tcp-8080"] == [False] * 4 + [True] * 12
    assert seen["any-9090"] == [True] * 4 + [False] * 2 + [True] * 10
    assert all(seen["udp-8080"]) and all(seen["ip-9090"])


@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_ports_assign_matches_reference(mode):
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    got = device_chunk_view(*device_chunk(port_device_api(), tb, "ports", 8,
                                          mode))
    want = device_chunk_view(*device_chunk(
        JAX_DEVICE_API, TPUBackend(max_batch=DEVICE_CHUNK, mesh=None),
        "ports", 8, mode))
    assert got["assignments"] == want["assignments"]
    assert got["diagnostics"] == want["diagnostics"]
    assert got == want
    rejected = [d for d in got["diagnostics"].values()
                if isinstance(d, list)]
    assert len(rejected) == tb.counters["verify_rejects"] > 0
    assert all(d[0][2] == [PORTS_MSG] and d[0][3] == "NodePorts"
               for d in rejected)
    # No two placed pods hold one port on one node, residents included.
    case = device_case("ports", 8)
    held = {(p["spec"]["nodeName"], 8080 if i < 4 else 9090)
            for i, p in enumerate(case["residents"])}
    for pod in case["pods"]:
        node = got["assignments"][f"default/{pod['metadata']['name']}"]
        for port in pod["spec"]["containers"][0].get("ports") or []:
            if node is None or port["protocol"] == "UDP" \
                    or port["hostIP"] == "10.0.0.2":
                continue
            assert (node, port["hostPort"]) not in held, pod
            held.add((node, port["hostPort"]))


def image_case(seed: int):
    rng = np.random.default_rng(seed)
    images = [f"registry/img-{k}:v1" for k in range(6)]
    nodes = [make_node(f"in-{i}", allocatable={
        "cpu": "8", "memory": "32Gi", "pods": "110"}, images=[
            {"names": [img], "sizeBytes": 100 << 20}
            for img in images if rng.random() < 0.4])
        for i in range(24)]
    pods = []
    for j in range(48):
        pod = make_pod(f"img-{j}", requests={"cpu": "500m",
                                             "memory": "1Gi"})
        chosen = rng.choice(images, size=int(rng.integers(1, 4)),
                            replace=False)
        pod["spec"]["containers"] = [
            {"name": f"c{k}", "image": str(img),
             "resources": {"requests": {"cpu": "250m"}}}
            for k, img in enumerate(chosen)]
        pods.append(pod)
    return {"nodes": nodes, "residents": [], "pods": pods}


def test_image_locality_matches_reference():
    case = image_case(5)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    tp, jp = tcore.ImageLocality(), jcore.ImageLocality()
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    jb = TPUBackend(max_batch=DEVICE_CHUNK, mesh=None)
    tct, jct = tb._tensors(tsnap), jb._tensors(jsnap)
    partial = 0
    for pod in case["pods"]:
        tpi = ttypes.PodInfo(copy.deepcopy(pod))
        jpi = jtypes.PodInfo(copy.deepcopy(pod))
        scores = [tp.score(tframework.CycleState(), tpi, n)
                  for n in tsnap.nodes]
        assert scores == [jp.score(jframework.CycleState(), jpi, n)
                          for n in jsnap.nodes]
        partial += any(0 < s < 100 for s in scores)
        got = tb._static_score_row(tp, tpi, tsnap, tct)
        want = jb._static_score_row(jp, jpi, jsnap, jct)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    assert partial


def test_image_locality_chunk_matches_reference():
    case = image_case(6)
    tfwk = tframework.Framework(tregistry.build_plugins(),
                                tregistry.DEFAULT_SCORE_WEIGHTS)
    jfwk = jframework.Framework(jregistry.build_plugins(),
                                jregistry.DEFAULT_SCORE_WEIGHTS)
    got, _ = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK).assign(
        [ttypes.PodInfo(copy.deepcopy(p)) for p in case["pods"]],
        snapshot(ttypes, case), tfwk)
    want, _ = TPUBackend(max_batch=DEVICE_CHUNK, mesh=None).assign(
        [jtypes.PodInfo(copy.deepcopy(p)) for p in case["pods"]],
        snapshot(jtypes, case), jfwk)
    assert got == want
    # The image scores decide: without ImageLocality the pods land
    # elsewhere.
    plain = tframework.Framework(
        tregistry.build_plugins([p for p in tregistry.DEFAULT_PLUGINS
                                 if p != "ImageLocality"]),
        tregistry.DEFAULT_SCORE_WEIGHTS)
    other, _ = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK).assign(
        [ttypes.PodInfo(copy.deepcopy(p)) for p in case["pods"]],
        snapshot(ttypes, case), plain)
    assert other != got


def device_profile(config_mod, objects):
    fwk = config_mod.load_config(
        DEVICE_TOPOLOGY["schedulerConfig"]).profiles[0].build_framework()
    for p in fwk.plugins:
        if p.NAME in ("NodeResourceTopologyMatch", "DynamicResources"):
            p.set_informers(StaticInformers(copy.deepcopy(objects)))
    return fwk


def test_fast_path_declines_device_topology_pods():
    pair = Pair(8, hetero=False)
    objects = {
        "noderesourcetopologies": [
            split_node_topology(f"n{i}", {"cpu": "8"}, 2)
            for i in range(8)],
        "deviceclasses": [make_device_class("tpu", {"type": "tpu"})],
        "resourceclaims": [make_resource_claim("c0", requests=[
            {"name": "t", "deviceClassName": "tpu", "count": 1}])]}
    pair.tfwk = device_profile(tconfig, objects)
    pair.jfwk = device_profile(jconfig, objects)

    def place(name, **kw):
        return pair.place(make_pod(name, uid=name, **kw))

    want, got, _ = place("memory-only", requests={"memory": "1Gi"})
    assert got == want is not None
    declined = [
        ("cpu", {"requests": {"cpu": "500m"}}),
        ("ports", {"requests": {"memory": "1Gi"}, "host_ports": [8080]}),
        ("claim", {"requests": {"memory": "1Gi"}, "resource_claims": [
            {"name": "c", "resourceClaimName": "c0"}]}),
    ]
    for name, kw in declined:
        want, got, _ = place(name, **kw)
        assert got is want is None, name
    assert pair.counters(pair.tfp) == pair.counters(pair.jfp) \
        == (1, len(declined), 0)
