"""Slice-shaped gangs in the port (TopologySlice, Coscheduling's
contiguity check at Permit, the backend's gate) against the JAX package
on the CPU.

- The plugin: both packages' TopologySlice run one script over a 4x4
  auto torus with a busy cell — two 2x2 gangs planned at PreFilter (the
  second plan must not claim the first's nodes), the pins handed out in
  arrival order, a member with more members than cells, Reserve on the
  planned node and off it (the drift check drops the plan), Unreserve
  (drops the plan), a re-plan, PostBind of every member (the fully bound
  plan leaves the ledger), the pod-delete handler of a planned member,
  and the kill switch — recording every status, pin, plan, claim and
  the slice fragmentation gauge: equal.
- Coscheduling's Permit: a contiguous 2x2 gang released (and
  `slice_gangs_bound` counted), a bent gang, a gang with two members on
  one node and a gang with a member off the mesh rejected whole with
  their waiters, a count-only gang and a bent gang under KTPU_TOPOLOGY=0
  released: statuses, allow/reject calls and the counter equal.
- The backend's gate (`_FILTER_ACTIVE["TopologySlice"]`) equal for slice
  members, count-only gang members, lone pods and the kill switch.
- Phase 16(b)'s fixtures (`chip_smoke.slice_case`: two 2x2 gangs on a
  4x4 torus with a busy cell, a 2x2x2 gang on 4x4x2, an impossible 1x3
  gang) through `TorchBackend(device="cpu").assign` against
  `TPUBackend.assign`, flagless and with greedy pinned (assignments,
  diagnostics, the fragmentation gauge), and through both packages'
  `Scheduler.run` (placements and released gangs): equal, every gang
  whole on a contiguous sub-mesh, the impossible gang pending whole.
- A topology-free chunk places identically with KTPU_TOPOLOGY on and off.

Tolerance: none (integers, strings and the gauge's float, compared
exactly).
"""

import asyncio
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from chip_smoke import (GANG_LABEL, SLICE_CASES, PodGroupIndex,
                        constraint_cluster, constraint_snapshot,
                        port_slice_api, slice_case, slice_chunk, slice_loop,
                        slice_violations)
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
from kubernetes_tpu.topology import mesh as jmesh
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins.registry import (
    DEFAULT_PLUGINS, DEFAULT_SCORE_WEIGHTS, build_plugins)
from kubernetes_tpu_torch.utils import flags

JAX_API = SimpleNamespace(
    make_node=jmake_node, make_pod=jmake_pod,
    InformerFactory=JInformerFactory, Scheduler=JScheduler,
    ResourceEventHandler=JHandler, install_core_validation=jinstall,
    new_cluster_store=jnew_store, types=jtypes, framework=jframework,
    registry=jregistry, coscheduling=jcos, mesh=jmesh,
    SchedulerMetrics=JMetrics)
PORT_API = port_slice_api()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


class _Informer:
    """A stand-in informer: an indexer over fixed objects and the handlers
    the plugin registers."""

    def __init__(self, objects: dict):
        self.indexer = self
        self._objects = objects
        self.handlers = []

    def get(self, key):
        return self._objects.get(key)

    def list(self):
        return list(self._objects.values())

    def add_event_handler(self, handler):
        self.handlers.append(handler)


class _Factory:
    def __init__(self, informers: dict):
        self._informers = informers

    def informer(self, resource):
        return self._informers.setdefault(resource, _Informer({}))


def _status(st):
    return (st.code, tuple(st.reasons))


def _plugin_script(api) -> list:
    ts = api.registry.IN_TREE["TopologySlice"]()
    if hasattr(ts, "device"):
        ts.device = "cpu"
    metrics = api.SchedulerMetrics()
    ts.set_scheduler(SimpleNamespace(metrics=metrics))
    mk = api.coscheduling.make_pod_group
    groups = {"default/g1": mk("g1", 4, slice_shape=[2, 2]),
              "default/g2": mk("g2", 4, slice_shape=[2, 2]),
              "default/g3": mk("g3", 2, slice_shape=[1, 1]),
              "default/c": mk("c", 2)}
    factory = _Factory({"podgroups": _Informer(groups)})
    ts.set_informers(factory)
    nodes = []
    for i in range(16):
        ni = api.types.NodeInfo(api.make_node(f"node-{i}", allocatable={
            "cpu": "4", "memory": "16Gi", "pods": "110"}))
        if i == 5:
            ni.add_pod(api.types.PodInfo(api.make_pod(
                "busy", node_name="node-5", requests={"cpu": "4"})))
        nodes.append(ni)
    snap = api.types.Snapshot(nodes, 1)

    def pod(name, group=None):
        labels = {GANG_LABEL: group} if group else {}
        return api.types.PodInfo(api.make_pod(name, labels=labels,
                                              requests={"cpu": "1"}))

    def ledger():
        return ({gk: (list(p.nodes), sorted(p.assigned.items()), p.bound,
                      p.frag) for gk, p in sorted(ts._plans.items())},
                sorted(ts._claims.items()),
                round(metrics.slice_fragmentation_pct.value(), 9))

    out = []
    states = {}

    def pre(name, group):
        pi = pod(name, group)
        st = api.framework.CycleState()
        states[name] = (pi, st)
        out.append(("pre", name, _status(ts.pre_filter(st, pi, snap)),
                    st.read("TopologySlice/node"), ts.active_for(pi)))

    for k in range(4):
        pre(f"g1-{k}", "g1")
    for k in range(4):
        pre(f"g2-{k}", "g2")
    pre("g3-0", "g3")
    pre("g3-1", "g3")      # more members than cells
    pre("c-0", "c")        # count-only gang: skipped
    pre("solo", None)
    out.append(("ledger", ledger()))
    for name in ("solo", "c-0", "g1-0"):
        pi, st = states[name]
        out.append(("filter", name, [
            _status(ts.filter(st, pi, ni)) for ni in nodes]))
    for k in range(4):
        pi, st = states[f"g1-{k}"]
        out.append(("reserve", k, _status(ts.reserve(
            st, pi, st.read("TopologySlice/node")))))
    pi, st = states["g2-0"]
    out.append(("drift", _status(ts.reserve(st, pi, "node-0"))))
    out.append(("ledger", ledger()))
    pi, st = states["g1-1"]
    ts.unreserve(st, pi, st.read("TopologySlice/node"))
    out.append(("ledger", ledger()))
    for k in range(4):
        pre(f"g1-{k}", "g1")
    for k in range(4):
        pi, st = states[f"g1-{k}"]
        ts.post_bind(st, pi, st.read("TopologySlice/node"))
        out.append(("bound", k, ledger()))
    pre("g2-0", "g2")
    deleted = api.make_pod("g2-0", labels={GANG_LABEL: "g2"})
    for h in factory.informer("pods").handlers:
        if h.on_delete is not None:
            h.on_delete(deleted)
    out.append(("deleted", ledger()))
    with flags.scoped_set("KTPU_TOPOLOGY", "0"):
        pi, st = pod("g2-1", "g2"), api.framework.CycleState()
        out.append(("off", _status(ts.pre_filter(st, pi, snap)),
                    ts.active_for(pi)))
    return out


def test_plugin_script_matches_the_reference():
    got = _plugin_script(PORT_API)
    assert got == _plugin_script(JAX_API)
    # Two disjoint plans, the busy cell avoided.
    plans = next(row for row in got if row[0] == "ledger")[1][0]
    assert set(plans["default/g1"][0]).isdisjoint(plans["default/g2"][0])
    assert "node-5" not in plans["default/g1"][0] + plans["default/g2"][0]


def _permit_script(api) -> list:
    mk = api.coscheduling.make_pod_group
    groups = {f"default/{g}": mk(g, 4, slice_shape=[2, 2])
              for g in ("s", "b", "d", "o", "x")}
    groups["default/c"] = mk("c", 2)
    node_objs = {f"node-{i}": api.make_node(f"node-{i}") for i in range(16)}
    node_objs["edge"] = api.make_node("edge")
    calls = []
    metrics = api.SchedulerMetrics()
    cos = api.coscheduling.Coscheduling()
    cos.pg_informer = _Informer(groups)
    cos.node_informer = _Informer(node_objs)
    cos.set_scheduler(SimpleNamespace(
        metrics=metrics,
        allow_waiting_pod=lambda k: calls.append(("allow", k)),
        reject_waiting_pod=lambda k: calls.append(("reject", k))))
    out = []

    def gang(g, placement):
        for k, node in enumerate(placement):
            pi = api.types.PodInfo(api.make_pod(f"{g}-{k}", labels={
                GANG_LABEL: g}))
            st = api.framework.CycleState()
            cos.reserve(st, pi, node)
            status, timeout = cos.permit(st, pi, node)
            out.append((g, k, _status(status), timeout))
        out.append((g, sorted(calls), metrics.slice_gangs_bound.value()))
        calls.clear()

    gang("s", ["node-0", "node-1", "node-4", "node-5"])     # contiguous
    gang("b", ["node-0", "node-1", "node-4", "node-6"])     # bent
    gang("d", ["node-0", "node-1", "node-4", "node-4"])     # shared node
    gang("o", ["node-0", "node-1", "node-4", "edge"])       # off-mesh
    gang("c", ["node-9", "node-3"])                         # count-only
    with flags.scoped_set("KTPU_TOPOLOGY", "0"):
        gang("x", ["node-0", "node-1", "node-4", "node-6"])  # bent, off
    return out


def test_permit_contiguity_matches_the_reference():
    got = _permit_script(PORT_API)
    assert got == _permit_script(JAX_API)
    released = {row[0]: row[1] for row in got if len(row) == 3}
    assert [c for c, _ in released["s"]] == ["allow"] * 3
    for g in ("b", "d", "o"):
        assert [c for c, _ in released[g]] == ["reject"] * 3
    assert [c for c, _ in released["x"]] == ["allow"] * 3
    # Counted per released sliceShape gang (the kill-switched one too).
    assert [row[2] for row in got if len(row) == 3] == [1.0] * 5 + [2.0]


def test_backend_gate_matches_the_reference():
    def gates(api, active):
        ts = api.registry.IN_TREE["TopologySlice"]()
        mk = api.coscheduling.make_pod_group
        ts.pg_informer = PodGroupIndex({
            "default/s": mk("s", 4, slice_shape=[2, 2]),
            "default/c": mk("c", 4)})
        pods = [api.make_pod("a", labels={GANG_LABEL: "s"}),
                api.make_pod("b", labels={GANG_LABEL: "c"}),
                api.make_pod("c"), api.make_pod("d", labels={
                    GANG_LABEL: "missing"})]
        rows = []
        for off in (False, True):
            with flags.scoped_set("KTPU_TOPOLOGY", "0" if off else "1"):
                rows.append([active["TopologySlice"](
                    ts, api.types.PodInfo(p), None) for p in pods])
        return rows

    got = gates(PORT_API, tbackend._FILTER_ACTIVE)
    assert got == gates(JAX_API, jbackend._FILTER_ACTIVE)
    assert got == [[True, False, False, False], [False] * 4]
    assert "TopologySlice" in tbackend.MODELLED_PLUGINS


@pytest.mark.parametrize("mode", ["auto", "greedy"])
@pytest.mark.parametrize("kind", SLICE_CASES)
def test_slice_chunk_matches_tpu_backend(kind, mode):
    got = slice_chunk(PORT_API, tbackend.TorchBackend(device="cpu",
                                                      max_batch=64),
                      kind, mode)
    want = slice_chunk(JAX_API, jbackend.TPUBackend(max_batch=64, mesh=None),
                       kind, mode)
    paths = got.pop("paths")
    assert want.pop("paths") is None
    assert got == want
    assert slice_violations(PORT_API, slice_case(kind),
                            got["assignments"]) == []
    assert paths == {"device": 3 if kind == "impossible-1x3" else
                     len(slice_case(kind)["groups"]), "oracle": 0}
    if kind == "impossible-1x3":
        assert [v for k, v in got["assignments"].items()
                if "/g4-" in k] == [None] * 3


@pytest.mark.parametrize("kind", SLICE_CASES)
def test_slice_loop_matches_the_reference(kind):
    case = slice_case(kind)
    with flags.scoped_set("KTPU_MESH_SHAPE", case["mesh"]):
        got = asyncio.run(slice_loop(PORT_API, tbackend.TorchBackend(
            device="cpu"), kind, 16384))
        want = asyncio.run(slice_loop(JAX_API, jbackend.TPUBackend(
            max_batch=64, mesh=None), kind, 16384))
    assert got == want
    assert slice_violations(PORT_API, case, got["assignments"]) == []
    gangs = [g for g, _ in case["groups"]]
    placed = {g: sum(got["assignments"][f"{g}-{k}"] is not None
                     for k in range(len(got["assignments"])) if
                     f"{g}-{k}" in got["assignments"]) for g in gangs}
    assert got["slice_gangs_bound"] == sum(v > 0 for v in placed.values())
    if kind == "impossible-1x3":
        assert placed == {"g4": 0}
        assert all(got["assignments"][f"solo-{k}"] for k in range(4))
    else:
        assert all(got["assignments"].values())


def test_topology_free_chunk_is_unchanged_by_the_flag():
    nodes, residents = constraint_cluster(3, 48)
    pods = [ttypes.PodInfo(make_pod(f"p{i}", requests={
        "cpu": f"{200 + 100 * (i % 5)}m", "memory": "512Mi"}))
        for i in range(96)]
    fwk = tframework.Framework(
        build_plugins(list(DEFAULT_PLUGINS) + ["Coscheduling",
                                               "TopologySlice"]),
        DEFAULT_SCORE_WEIGHTS)
    fwk.plugins[-2].pg_informer = fwk.plugins[-1].pg_informer = \
        PodGroupIndex({})
    outs = []
    for on in ("1", "0"):
        with flags.scoped_set("KTPU_TOPOLOGY", on):
            for mode in ("auto", "greedy"):
                with flags.scoped_set("KTPU_SOLVE_MODE", mode):
                    tb = tbackend.TorchBackend(device="cpu", max_batch=64)
                    snap = constraint_snapshot(ttypes, make_node, make_pod,
                                               nodes, residents)
                    outs.append(tb.assign(pods, snap, fwk)[0])
                    assert (tb._ct.topology is None) == (on == "0")
    assert outs[0] == outs[2] and outs[1] == outs[3]
    assert sum(v is not None for v in outs[0].values()) > 0
    assert np.all([fwk.plugins[-1].paths[k] == 0 for k in ("device",
                                                          "oracle")])
