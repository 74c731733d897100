"""Gangs in the port (Coscheduling and the batched solve's all-or-nothing
mask) against the JAX package on the CPU.

- The plugin: both packages' Coscheduling over their own store and
  informers run one event script — PodGroups and pods created, PreEnqueue
  before and after a gang's members exist, Reserve and Permit of each
  member (the barrier parks members and releases the gang), Unreserve of a
  parked member (the rest of the gang is rejected), PostBind, and pod
  deletes (membership dropped) — and record every status, timeout,
  allow/reject call and the internal member sets after each step: equal.
- A PodGroup with `spec.sliceShape` raises nowhere: with TopologySlice in
  the profile its gang plans one contiguous sub-mesh in the backend's
  chunk and Permit releases it whole (tests/test_torch_topologyslice.py
  holds the slice half against the JAX package).
- The batch solve: `TorchBackend(device="cpu").assign` against
  `TPUBackend.assign` on the five gang chunk shapes of `chip_smoke.gang_chunk`
  (gangs that fit; a 64-member gang with one member no node holds; a gang
  whose quota is reduced by members already assembled; 18 gangs in one
  chunk, so two overflow the 16 slots; a gang of hard-spread pods in a
  spread chunk, folded out of the chained domain counts), flagless and
  with greedy pinned: assignments, diagnostics (reason counts, plugins,
  resolvability), solver metrics, the gang_overflow degradation count
  and the spread domain counts identical. Without Coscheduling in the
  profile a gang label builds no gang arrays.
- The loop: a small gang workload (gangs that fit, a gang held by
  PreEnqueue, a gang with a member no node holds) pre-created through
  both packages' `Scheduler.run`: the same bindings, the same gangs bound
  whole and the same gangs unbound, no partial gang.
- The fast path: a gang pod is ineligible only under Coscheduling.

Tolerance: none (integers and exact strings).
"""

import asyncio
import contextlib
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (GANG_CASES, GANG_CHUNK, GANG_LABEL,
                        N_GANG_CHUNK_NODES, PodGroupIndex, constraint_cluster,
                        constraint_snapshot, gang_chunk, gang_chunk_view,
                        gang_framework, gang_loop, gang_outcome,
                        port_gang_chunk, port_loop_api)
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.client import InformerFactory as JInformerFactory
from kubernetes_tpu.client import ResourceEventHandler as JHandler
from kubernetes_tpu.metrics.registry import SchedulerMetrics as JMetrics
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import coscheduling as jcos
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import coscheduling as tcos
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from kubernetes_tpu_torch.store import (install_core_validation,
                                        new_cluster_store)
from kubernetes_tpu_torch.utils import flags as tflags

JAX_API = SimpleNamespace(
    make_node=jmake_node, make_pod=jmake_pod,
    InformerFactory=JInformerFactory, Scheduler=JScheduler,
    ResourceEventHandler=JHandler, install_core_validation=jinstall,
    new_cluster_store=jnew_store)
PORT_API = port_loop_api()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- the plugin ---------------------------------------------------------------

class Handles:
    """The scheduler handle Coscheduling calls: records allow/reject."""

    def __init__(self):
        self.calls = []

    def allow_waiting_pod(self, key):
        self.calls.append(("allow", key))

    def reject_waiting_pod(self, key):
        self.calls.append(("reject", key))


def _state(cos) -> dict:
    return {name: {g: sorted(v) if isinstance(v, set) else sorted(v.items())
                   for g, v in getattr(cos, name).items() if v}
            for name in ("_waiting", "_bound", "_nodes")}


async def _plugin_script(mod, make_pod_fn, new_store, install, factory_cls,
                         types_mod, framework_mod):
    store = new_store()
    install(store)
    factory = factory_cls(store)
    cos = mod.Coscheduling()
    handles = Handles()
    cos.set_scheduler(handles)
    cos.set_informers(factory)
    factory.start()
    await factory.wait_for_sync()
    trace = []

    def pod(name, group, **kw):
        return make_pod_fn(name, labels={GANG_LABEL: group}, **kw)

    async def settle():
        for _ in range(20):
            await asyncio.sleep(0.005)

    def st(s):
        return (s.code, list(s.reasons))

    for g, mm in (("a", 3), ("b", 2)):
        await store.create("podgroups", mod.make_pod_group(
            g, mm, schedule_timeout_seconds=4.5 if g == "a" else None))
    objs = {f"a-{i}": pod(f"a-{i}", "a") for i in range(3)}
    objs.update({f"b-{i}": pod(f"b-{i}", "b") for i in range(2)})
    objs["orphan"] = pod("orphan", "missing")
    objs["plain"] = make_pod_fn("plain")
    await store.create("pods", objs["a-0"])
    await settle()
    pis = {n: types_mod.PodInfo(o) for n, o in objs.items()}
    trace.append(("pre_enqueue early", st(cos.pre_enqueue(pis["a-0"]))))
    for n in ("a-1", "a-2", "b-0", "b-1", "orphan", "plain"):
        await store.create("pods", objs[n])
    await settle()
    for n in ("a-0", "b-0", "orphan", "plain"):
        trace.append((f"pre_enqueue {n}", st(cos.pre_enqueue(pis[n]))))
    state = framework_mod.CycleState()
    for i, n in enumerate(("a-0", "a-1", "b-0", "plain")):
        trace.append((f"reserve {n}",
                      st(cos.reserve(state, pis[n], f"node-{i}"))))
        s, timeout = cos.permit(state, pis[n], f"node-{i}")
        trace.append((f"permit {n}", st(s), timeout, list(handles.calls),
                      _state(cos)))
    # A parked member fails downstream: the rest of its gang is rejected.
    cos.unreserve(state, pis["a-0"], "node-0")
    trace.append(("unreserve a-0", list(handles.calls), _state(cos)))
    for i, n in enumerate(("a-0", "a-1", "a-2")):
        cos.reserve(state, pis[n], f"node-{i}")
        s, timeout = cos.permit(state, pis[n], f"node-{i}")
        trace.append((f"permit again {n}", st(s), timeout,
                      list(handles.calls), _state(cos)))
    cos.reserve(state, pis["b-1"], "node-5")
    s, timeout = cos.permit(state, pis["b-1"], "node-5")
    trace.append(("permit b-1", st(s), timeout, list(handles.calls),
                  _state(cos)))
    for n in ("a-0", "b-1"):
        cos.post_bind(state, pis[n], "node-0")
    trace.append(("post_bind", _state(cos)))
    # Deleting members drops them from every set; a deleted group
    # vanishes for Permit.
    await store.delete("pods", "default/a-1")
    await store.delete("pods", "default/b-0")
    await settle()
    trace.append(("after deletes", _state(cos),
                  st(cos.pre_enqueue(pis["a-2"]))))
    await store.delete("podgroups", "default/b")
    await settle()
    s, timeout = cos.permit(state, pis["b-1"], "node-5")
    trace.append(("permit after group delete", st(s), timeout))
    cos.unreserve(state, pis["plain"], "node-3")
    trace.append(("unreserve plain", list(handles.calls), _state(cos)))
    factory.stop()
    store.stop()
    return trace


def test_plugin_event_script_matches_reference():
    got = asyncio.run(_plugin_script(
        tcos, make_pod, new_cluster_store, install_core_validation,
        InformerFactory, ttypes, tframework))
    want = asyncio.run(_plugin_script(
        jcos, jmake_pod, jnew_store, jinstall, JInformerFactory, jtypes,
        jframework))
    assert got == want
    # The script reached every branch: a park, a release, a rejection.
    calls = got[-1][1]
    assert ("reject", "default/a-1") in calls
    assert any(c[0] == "allow" for c in calls)
    assert got[0][1][0] != 0  # gated before minMember pods exist


def test_registry_and_pod_group_object_match_reference():
    assert "Coscheduling" in tregistry.IN_TREE
    assert "Coscheduling" not in tregistry.DEFAULT_PLUGINS
    assert "Coscheduling" not in jregistry.DEFAULT_PLUGINS
    assert tcos.POD_GROUP_LABEL == jcos.POD_GROUP_LABEL == GANG_LABEL
    assert tcos.DEFAULT_SCHEDULE_TIMEOUT == jcos.DEFAULT_SCHEDULE_TIMEOUT
    for args in (("g", 3), ("g", 5, "ns", 7.5), ("g", 2, "default", None,
                                                   [2, 2])):
        t, j = tcos.make_pod_group(*args), jcos.make_pod_group(*args)
        for obj in (t, j):
            obj["metadata"].pop("uid", None)
            obj["metadata"].pop("creationTimestamp", None)
        assert t == j
    obj = make_pod("p", labels={GANG_LABEL: "g"}, namespace="ns")
    assert tcos._pod_group_index(obj) == jcos._pod_group_index(obj) \
        == ["ns/g"]
    assert tcos._pod_group_index(make_pod("q")) == []


def test_store_accepts_pod_groups_as_the_reference():
    async def run(new_store, install, mod):
        store = new_store()
        install(store)
        try:
            await store.create("podgroups", mod.make_pod_group("g", 4))
            got = (await store.list("podgroups")).items
            return [(o["kind"], o["metadata"]["name"], o["spec"])
                    for o in got]
        finally:
            store.stop()

    assert asyncio.run(run(new_cluster_store, install_core_validation,
                           tcos)) == asyncio.run(run(jnew_store, jinstall,
                                                     jcos)) \
        == [("PodGroup", "g", {"minMember": 4})]


def test_slice_shaped_group_raises():
    """The slice-shaped group no longer raises anywhere: it plans (one
    contiguous 2x2 sub-mesh, TopologySlice) and binds whole (Permit's
    contiguity check releases the gang)."""
    from kubernetes_tpu_torch.topology.mesh import node_cell, parse_mesh_shape
    from kubernetes_tpu_torch.topology.slices import is_contiguous_slice

    pg = tcos.make_pod_group("s", 4, slice_shape=[2, 2])
    assert pg["spec"]["sliceShape"] == [2, 2]
    fwk = tframework.Framework(tregistry.build_plugins(
        list(tregistry.DEFAULT_PLUGINS) + ["Coscheduling", "TopologySlice"]),
        tregistry.DEFAULT_SCORE_WEIGHTS)
    cos, ts = fwk.plugins[-2], fwk.plugins[-1]
    cos.pg_informer = ts.pg_informer = PodGroupIndex({"default/s": pg})
    ts.device = "cpu"
    pods = [ttypes.PodInfo(make_pod(f"s-{k}", labels={GANG_LABEL: "s"}))
            for k in range(4)]
    # Without a pod informer no sibling is counted: gated, not raised.
    assert not cos.pre_enqueue(pods[0]).is_success()
    nodes = {f"node-{i}": make_node(f"node-{i}") for i in range(16)}
    snap = ttypes.Snapshot([ttypes.NodeInfo(n) for n in nodes.values()], 1)
    tb = tbackend.TorchBackend(device="cpu", max_batch=16)
    got, _ = tb.assign(pods, snap, fwk)
    placed = [got[pi.key] for pi in pods]
    spec = parse_mesh_shape("auto", 16)
    assert None not in placed and len(set(placed)) == 4
    assert is_contiguous_slice([node_cell(n, {}, spec) for n in placed],
                               spec, (2, 2))
    allowed = []
    cos.node_informer = PodGroupIndex(nodes)
    cos.node_informer.list = lambda: list(nodes.values())
    cos.set_scheduler(SimpleNamespace(
        metrics=None, allow_waiting_pod=allowed.append,
        reject_waiting_pod=lambda key: pytest.fail(f"{key} rejected")))
    statuses = []
    for pi, node in zip(pods, placed):
        st = tframework.CycleState()
        assert cos.reserve(st, pi, node).is_success()
        statuses.append(cos.permit(st, pi, node)[0])
    assert [s.is_success() for s in statuses] == [False] * 3 + [True]
    assert sorted(allowed) == [pi.key for pi in pods[:3]]


# -- the batch solve ----------------------------------------------------------

def run_jax(kind: str, mode: str, chunk: int = GANG_CHUNK):
    nodes, residents = constraint_cluster(3, N_GANG_CHUNK_NODES)
    groups, assembled, pods = gang_chunk(kind)
    fwk = gang_framework(jregistry, jframework, jcos.make_pod_group, groups,
                         assembled)
    snap = constraint_snapshot(jtypes, jmake_node, jmake_pod, nodes,
                               residents)
    b = jbackend.TPUBackend(max_batch=chunk, mesh=None)
    b.metrics = JMetrics()
    with contextlib.ExitStack() as stack:
        stack.enter_context(jflags.scoped_set("KTPU_SHORTLIST_K", 0))
        stack.enter_context(jflags.scoped_set("KTPU_SOLVE_MODE", mode))
        ctx = b._start([jtypes.PodInfo(jmake_pod(n, **kw))
                        for n, kw in pods], snap, fwk)
        for run in b._pipeline(ctx):
            b._finalize_chunk(run, b._fetch_assign(run), ctx)
    return ctx, b.metrics


@pytest.mark.parametrize("mode", ["auto", "greedy"])
@pytest.mark.parametrize("kind", GANG_CASES)
def test_gang_chunk_matches_reference(kind, mode):
    tb = tbackend.TorchBackend(device="cpu", max_batch=GANG_CHUNK)
    got = gang_chunk_view(*port_gang_chunk(tb, kind, mode))
    want = gang_chunk_view(*run_jax(kind, mode))
    assert got["assignments"] == want["assignments"]
    assert got["diagnostics"] == want["diagnostics"]
    assert got == want
    _, _, pods = gang_chunk(kind)
    outcome = gang_outcome(got["assignments"], pods)
    # What each shape is for.
    if kind == "fit":
        assert all(k == n for k, n in outcome.values())
    elif kind == "stranded":
        assert outcome["big"] == (0, 64)
    elif kind == "assembled":
        assert outcome == {"half": (6, 8), "whole": (0, 8)}
    elif kind == "overflow":
        assert got["gang_overflow"] == 2
        assert outcome["ov0"] == (0, 4)
        assert outcome["ov16"] == outcome["ov17"] == (3, 4)
    elif kind == "spread":
        assert outcome["sg"] == (0, 12)
        assert tb.counters["spread_chunks"] == 1
        assert sum(got["spread_counts"]) > 0
    if mode == "auto" and kind != "spread":
        # A gang chunk takes the optimal route at any size.
        assert got["metrics"]["solver_optimal_solves"] == 1
    if kind != "overflow":
        assert got["gang_overflow"] == 0


def test_spread_fold_back_counts_only_kept_placements():
    """The chained spread counts after the `spread` chunk equal the
    snapshot's counts plus one per placed app=spread-me pod in its zone:
    the dropped gang's in-scan increments are folded back out."""
    tb = tbackend.TorchBackend(device="cpu", max_batch=GANG_CHUNK)
    ctx, _ = port_gang_chunk(tb, "spread", "auto")
    assert len(ctx.spread["cons"]) == 1
    node_dom = ctx.spread["node_dom_host"][:, 0]
    nodes, residents = constraint_cluster(3, N_GANG_CHUNK_NODES)
    want = np.zeros(ctx.spread["dev_counts"].shape[0], np.int64)
    idx = {name: i for i, (name, _) in enumerate(nodes)}
    for name, kw in residents:
        if (kw.get("labels") or {}).get("app") == "spread-me":
            want[node_dom[idx[kw["node_name"]]]] += 1
    _, _, pods = gang_chunk("spread")
    for name, kw in pods:
        node = ctx.assignments[f"default/{name}"]
        if node is not None and kw.get("labels", {}).get("app") \
                == "spread-me" and node_dom[idx[node]] >= 0:
            want[node_dom[idx[node]]] += 1
    np.testing.assert_array_equal(ctx.spread["dev_counts"].numpy(), want)


def test_gang_label_without_coscheduling_places_as_reference():
    """Without Coscheduling in the profile the reference builds no gang
    arrays, so a stranded gang's placeable members place."""
    nodes, residents = constraint_cluster(3, N_GANG_CHUNK_NODES)
    _, _, pods = gang_chunk("stranded")
    jfwk = jframework.Framework(
        jregistry.build_plugins(list(tregistry.DEFAULT_PLUGINS)),
        jregistry.DEFAULT_SCORE_WEIGHTS)
    tfwk = tframework.Framework(tregistry.build_plugins(),
                                tregistry.DEFAULT_SCORE_WEIGHTS)
    jb = jbackend.TPUBackend(max_batch=GANG_CHUNK, mesh=None)
    with jflags.scoped_set("KTPU_SHORTLIST_K", 0):
        want, _ = jb.assign(
            [jtypes.PodInfo(jmake_pod(n, **kw)) for n, kw in pods],
            constraint_snapshot(jtypes, jmake_node, jmake_pod, nodes,
                                residents), jfwk)
    tb = tbackend.TorchBackend(device="cpu", max_batch=GANG_CHUNK)
    got, _ = tb.assign(
        [ttypes.PodInfo(make_pod(n, **kw)) for n, kw in pods],
        constraint_snapshot(ttypes, make_node, make_pod, nodes, residents),
        tfwk)
    assert got == want
    assert gang_outcome(got, pods)["big"] == (63, 64)


# -- the loop -----------------------------------------------------------------

def _gang_workload():
    nodes = [(f"node-{i}", {"allocatable": {"cpu": "4", "memory": "16Gi",
                                            "pods": "32"}})
             for i in range(12)]
    groups, pods = [], []
    for g, size, mm, unfit in (("g0", 8, 8, None), ("g1", 8, 8, None),
                               ("g2", 6, 6, None), ("held", 4, 5, None),
                               ("stranded", 8, 8, 3), ("g3", 8, 8, None)):
        groups.append((g, mm, 0.5))
        for i in range(size):
            req = {"cpu": "64"} if i == unfit else {"cpu": "500m",
                                                    "memory": "1Gi"}
            pods.append((f"{g}-{i}", {"requests": req,
                                      "labels": {GANG_LABEL: g}}))
    pods += [(f"solo-{i}", {"requests": {"cpu": "250m"}}) for i in range(6)]
    return nodes, groups, pods


def _loop(api, registry, framework_mod, make_pod_group, backend):
    nodes, groups, pods = _gang_workload()

    def profiles(store):
        return {"default-scheduler": gang_framework(
            registry, framework_mod, make_pod_group, None, {}, store=store)}

    return asyncio.run(gang_loop(api, profiles, make_pod_group, nodes, (),
                                 groups, pods, backend, 128, precreate=True,
                                 settle_s=0.8, timeout=120.0))


def test_gang_loop_matches_reference(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "0")
    got = _loop(PORT_API, tregistry, tframework, tcos.make_pod_group,
                tbackend.TorchBackend(device="cpu", max_batch=32))
    want = _loop(JAX_API, jregistry, jframework, jcos.make_pod_group,
                 jbackend.TPUBackend(max_batch=32, mesh=None))
    _, _, pods = _gang_workload()
    outcome = gang_outcome(got["assignments"], pods)
    assert outcome == gang_outcome(want["assignments"], pods)
    assert got["assignments"] == want["assignments"]
    assert {g: k for g, (k, _) in outcome.items()} == {
        "g0": 8, "g1": 8, "g2": 6, "held": 0, "stranded": 0, "g3": 8}
    assert all(got["assignments"][f"solo-{i}"] for i in range(6))


# -- the fast path ------------------------------------------------------------

def test_fast_path_takes_gang_pods_only_without_coscheduling():
    from test_torch_serving import Pair

    pair = Pair(8, hetero=False)
    # No labels beyond the group's would still be labeled; the default
    # profile without PodTopologySpread's default constraints isolates the
    # Coscheduling rule.
    plugins = [p for p in tregistry.DEFAULT_PLUGINS
               if p != "PodTopologySpread"]
    tfwk = tframework.Framework(tregistry.build_plugins(plugins),
                                tregistry.DEFAULT_SCORE_WEIGHTS)
    jfwk = jframework.Framework(jregistry.build_plugins(plugins),
                                jregistry.DEFAULT_SCORE_WEIGHTS)
    tcos_fwk = tframework.Framework(
        tregistry.build_plugins(plugins + ["Coscheduling"]),
        tregistry.DEFAULT_SCORE_WEIGHTS)
    jcos_fwk = jframework.Framework(
        jregistry.build_plugins(plugins + ["Coscheduling"]),
        jregistry.DEFAULT_SCORE_WEIGHTS)
    pod = make_pod("gang-0", uid="u-g", requests={"cpu": "100m"},
                   labels={GANG_LABEL: "g"})
    tsnap, jsnap = pair.tc.update_snapshot(), pair.jc.update_snapshot()
    got = pair.tfp.try_schedule(ttypes.PodInfo(pod), tsnap, tfwk)
    want = pair.jfp.try_schedule(jtypes.PodInfo(pod), jsnap, jfwk)
    assert got == want is not None
    assert pair.tfp.try_schedule(ttypes.PodInfo(pod), tsnap,
                                 tcos_fwk) is None
    assert pair.jfp.try_schedule(jtypes.PodInfo(pod), jsnap,
                                 jcos_fwk) is None


@pytest.mark.parametrize("kind", GANG_CASES)
def test_gangs_split_across_chunks_match_reference(kind):
    """16-pod chunks, pipelined, greedy pinned: a gang split over chunks
    gets each part's own quota (at most its members in the chunk), as in
    the reference."""
    tb = tbackend.TorchBackend(device="cpu", max_batch=16)
    got = gang_chunk_view(*port_gang_chunk(tb, kind, "greedy"))
    want = gang_chunk_view(*run_jax(kind, "greedy", chunk=16))
    assert got == want
    assert tb.counters["chunks"] > 1
