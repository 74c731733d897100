"""NodeResourceTopologyMatch in the port against the JAX package on the CPU.

Inputs: `chip_smoke.device_case("nrt", seed)` — 64 nodes in eight shapes
(equal two-zone nodes for ties, three and four zones, an NRT whose policy
is not single-NUMA, a node with no NRT), seeded resident pods that fill
zones first-fit, and 112 pending pods (zone-fitting, zone-misaligned,
cpu-heavy, cpu-only and memory-only), built once with numpy and read by
both packages.

- `pack_zones` of every node: equal free lists.
- The plugin's PreFilter, Filter and Score for every (pod, node) pair under
  LeastAllocated, MostAllocated and BalancedAllocation: equal statuses,
  scores within atol=1e-9.
- The backend's rows: `_nrt_state`'s arrays equal, and `_nrt_filter_row`
  and `_nrt_score_row` of `TorchBackend` against `TPUBackend`'s for every
  pod under each strategy: filter rows equal, scores within atol=1e-4.
- `TorchBackend(device="cpu").assign` against `TPUBackend.assign` on the
  chunk, flagless and with greedy pinned: identical assignments,
  diagnostics, solver metrics and host-fallback counts; the verify
  rejects, with NodeResourceTopologyMatch's reason, pods that fit their
  node but no zone once the same chunk's earlier placements filled it.

Tolerance: scores atol=1e-9 for the plugin (the same float64 arithmetic)
and 1e-4 for the rows; none elsewhere.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (DEVICE_CHUNK, StaticInformers, device_case,
                        device_chunk, device_chunk_view, port_device_api)
from kubernetes_tpu import config as jconfig
from kubernetes_tpu.metrics.registry import SchedulerMetrics as JMetrics
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import noderesourcetopology as jnrt
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import noderesourcetopology as tnrt

STRATEGIES = ("LeastAllocated", "MostAllocated", "BalancedAllocation")
SEEDS = (8, 21)


def _jax_run_chunks(backend, pods, snapshot, fwk):
    ctx = backend._start(pods, snapshot, fwk)
    for run in backend._pipeline(ctx):
        backend._finalize_chunk(run, backend._fetch_assign(run), ctx)
    return ctx


#: `chip_smoke.device_chunk`'s api for the JAX package.
JAX_DEVICE_API = SimpleNamespace(types=jtypes, config=jconfig,
                                 SchedulerMetrics=JMetrics,
                                 run_chunks=_jax_run_chunks)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def snapshot(types_mod, case):
    infos = {n["metadata"]["name"]: types_mod.NodeInfo(copy.deepcopy(n))
             for n in case["nodes"]}
    for p in case["residents"]:
        infos[p["spec"]["nodeName"]].add_pod(
            types_mod.PodInfo(copy.deepcopy(p)))
    return types_mod.Snapshot(list(infos.values()), 1)


def plugin(mod, case, strategy):
    p = mod.NodeResourceTopologyMatch(
        {"scoringStrategy": {"type": strategy}})
    p.set_informers(StaticInformers(copy.deepcopy(case["objects"])))
    return p


def status(st):
    return st.code, list(st.reasons)


@pytest.mark.parametrize("seed", SEEDS)
def test_pack_zones_matches_reference(seed):
    case = device_case("nrt", seed)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    nrts = {n["metadata"]["name"]: n
            for n in case["objects"]["noderesourcetopologies"]}
    packed = 0
    for tn, jn in zip(tsnap.nodes, jsnap.nodes):
        nrt = nrts.get(tn.name)
        if nrt is None:
            continue
        got = tnrt.pack_zones(nrt, tn)
        assert got == jnrt.pack_zones(nrt, jn), tn.name
        caps = [c for _, c in tnrt._zone_caps(nrt)]
        assert all(0 <= f[r] <= c[r] for f, c in zip(got, caps) for r in c)
        packed += bool(tn.pods)
    assert packed > 10


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_plugin_filter_and_score_match_reference(strategy):
    case = device_case("nrt", 8)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    tp, jp = plugin(tnrt, case, strategy), plugin(jnrt, case, strategy)
    assert tp._zone_resources == jp._zone_resources
    rejected = scored = 0
    for pod in case["pods"]:
        tpi = ttypes.PodInfo(copy.deepcopy(pod))
        jpi = jtypes.PodInfo(copy.deepcopy(pod))
        assert tp.active_for(tpi) == jp.active_for(jpi)
        ts, js = tframework.CycleState(), jframework.CycleState()
        assert status(tp.pre_filter(ts, tpi, tsnap)) == status(
            jp.pre_filter(js, jpi, jsnap))
        for tn, jn in zip(tsnap.nodes, jsnap.nodes):
            got = status(tp.filter(ts, tpi, tn))
            assert got == status(jp.filter(js, jpi, jn)), (pod, tn.name)
            rejected += got[0] != 0
            score = tp.score(ts, tpi, tn)
            assert score == pytest.approx(jp.score(js, jpi, jn), abs=1e-9)
            scored += score > 0
    assert rejected and scored


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_backend_rows_match_reference(strategy):
    case = device_case("nrt", 21)
    tsnap, jsnap = snapshot(ttypes, case), snapshot(jtypes, case)
    tp, jp = plugin(tnrt, case, strategy), plugin(jnrt, case, strategy)
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    jb = TPUBackend(max_batch=DEVICE_CHUNK, mesh=None)
    tct, jct = tb._tensors(tsnap), jb._tensors(jsnap)
    tst = tb._nrt_state(tp, tsnap, tct)
    jst = jb._nrt_state(jp, jsnap, jct)
    assert tst["T"] == jst["T"] and tst["strategy"] == strategy
    for k in ("free", "cap", "zone_valid", "tracked"):
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    assert tb._nrt_state(tp, tsnap, tct) is tst  # cached per snapshot
    tmemo, jmemo = {}, {}
    for i, pod in enumerate(case["pods"]):
        tpi = ttypes.PodInfo(copy.deepcopy(pod))
        jpi = jtypes.PodInfo(copy.deepcopy(pod))
        np.testing.assert_array_equal(
            tb._nrt_filter_row(tst, tpi, tmemo, i),
            jb._nrt_filter_row(jst, jpi, jmemo, i))
        np.testing.assert_allclose(
            tb._nrt_score_row(tst, tpi, tmemo, i),
            jb._nrt_score_row(jst, jpi, jmemo, i), rtol=0, atol=1e-4)
    # The rows are the plugin's own Filter and Score over every node.
    pod = next(p for p in case["pods"]
               if "google.com/tpu" in p["spec"]["containers"][0][
                   "resources"].get("requests", {}))
    tpi = ttypes.PodInfo(copy.deepcopy(pod))
    state = tframework.CycleState()
    row = tb._nrt_filter_row(tst, tpi, {}, 0)
    assert list(row) == [tp.filter(state, tpi, n).is_success()
                         for n in tsnap.nodes]
    np.testing.assert_allclose(
        tb._nrt_score_row(tst, tpi, {}, 0),
        [tp.score(state, tpi, n) for n in tsnap.nodes], rtol=0, atol=1e-9)


@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_assign_matches_reference(mode):
    tb = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    got = device_chunk_view(*device_chunk(port_device_api(), tb, "nrt", 8,
                                          mode))
    want = device_chunk_view(*device_chunk(
        JAX_DEVICE_API, TPUBackend(max_batch=DEVICE_CHUNK, mesh=None),
        "nrt", 8, mode))
    assert got["assignments"] == want["assignments"]
    assert got["diagnostics"] == want["diagnostics"]
    assert got == want
    placed = [k for k, v in got["assignments"].items() if v is not None]
    assert 0 < len(placed) < len(got["assignments"])
    assert tb.counters["verify_rejects"] > 0
    assert tb.counters["optimal_solves"] == (mode == "auto")
    # The verify's rejections: pods the chunk's earlier placements left
    # without a zone on their node.
    rejected = [d for d in got["diagnostics"].values()
                if isinstance(d, list)]
    assert len(rejected) == tb.counters["verify_rejects"]
    assert all(d[0][3] == "NodeResourceTopologyMatch" for d in rejected)
