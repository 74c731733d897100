"""The port's churn harness and node agents against the JAX package on
the CPU, and the open-loop families through the port's runner.

- Arrivals (`perf/churn/arrivals.py`): the Poisson, burst and ramp
  (up and down) timelines of several seeds, rates and durations, and
  `stable_seed`: equal; the same errors for a bad rate or model.
- Fault timelines (`build_fault_timeline`): every kind's resolved
  events (node picks, rollout offsets, gang counts, sliceDeath's
  required keys) equal by signature; `is_saturated` and `find_knee`
  equal on the same rows.
- The injector's slice kinds over a store: gangArrival (a sliceShape
  PodGroup, then its members) and sliceDeath (the first member's node
  cordoned and its agent stopped, the gang and its PodGroup deleted, the
  replacement gang created), plus cordon, uncordon, drain and
  rolloutWave, with a create callback that binds each pod as it is
  created: the fault records (all but the measured recovery seconds),
  the net pod count, the agents stopped and the store's objects equal.
- The departures: an exception inside a handler propagates out of
  `drain()` (the reference records `recovered: False`); `killLeader`
  with no control plane raises, naming `processes >= 2` (the reference
  records `recovered: False`); a `descheduler` block on a runner with no
  backend and no card is refused (the descheduler scores on a card or on
  the device it is given, with no fallback).
- NodeAgent: registration with a coordinate label and published
  devices, the lease, mark-Running of a bound pod and device allocation
  from its claim, equal to the reference's agent on its own store; a
  non-graceful stop writes nothing more.
- `CHURN_DAY` and `CHURN_SLICE_PACKING` equal the YAML's entries.
- ChurnSlicePacking/64Agents-2x2 (not cut) and a short ChurnDay row
  (100 nodes, 30 warm-up pods, 50/s for 1.5 s) through the port's
  `PerfRunner` with `TorchBackend(device="cpu")`, held to phase 16(c)'s
  gates (both faults recovered, each slice gang whole on a contiguous
  sub-mesh, the replacement off the dead node, no node over capacity)
  and, for ChurnDay, no create error and no node over capacity. Each
  open-loop run has its own deadline.

Tolerance: none (open-loop timings are held to gates, not values).
"""

import asyncio
import copy
import math
import time
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (GANG_LABEL, churn_slice_violations, over_capacity,
                        slice_runner_cls)
from kubernetes_tpu.agent.agent import NodeAgent as JNodeAgent
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.api.types import (
    make_resource_claim as jmake_resource_claim)
from kubernetes_tpu.perf import churn as jchurn
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu_torch.agent import NodeAgent
from kubernetes_tpu_torch.api.types import (make_node, make_pod,
                                            make_resource_claim)
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import churn as tchurn
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from kubernetes_tpu_torch.store import (install_core_validation,
                                        new_cluster_store)

JAX = SimpleNamespace(churn=jchurn, make_node=jmake_node, make_pod=jmake_pod,
                      new_store=jnew_store, install=jinstall,
                      NodeAgent=JNodeAgent, claim=jmake_resource_claim)
PORT = SimpleNamespace(churn=tchurn, make_node=make_node, make_pod=make_pod,
                       new_store=new_cluster_store,
                       install=install_core_validation, NodeAgent=NodeAgent,
                       claim=make_resource_claim)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_arrival_timelines_match_the_reference():
    specs = [{"model": "poisson", "rate": 20}, {"model": "poisson",
                                                 "rate": 250},
             {"model": "burst", "rate": 40, "burstSize": 8},
             {"model": "burst", "rate": 3},
             {"model": "ramp", "rate": 10, "endRate": 80},
             {"model": "ramp", "rate": 90, "endRate": 5},
             {"model": "ramp", "rate": 30}]
    for spec in specs:
        for seed in (0, 17, 123):
            for duration in (1.0, 6.0):
                got = tchurn.make_arrival_process(spec, seed).timeline(
                    duration)
                assert got == jchurn.make_arrival_process(
                    spec, seed).timeline(duration), (spec, seed, duration)
    assert tchurn.arrivals.stable_seed("a", 1, 2.5) == \
        jchurn.arrivals.stable_seed("a", 1, 2.5)
    for bad in ({"model": "poisson", "rate": 0}, {"model": "zipf",
                                                   "rate": 1}):
        with pytest.raises(ValueError):
            tchurn.make_arrival_process(bad)
        with pytest.raises(ValueError):
            jchurn.make_arrival_process(bad)


FAULT_SPECS = [
    {"at": 1.0, "kind": "gangArrival", "sliceShape": [2, 2]},
    {"at": 3.5, "kind": "sliceDeath", "group": "slice-1000",
     "sliceShape": [2, 2]},
    {"at": 0.5, "kind": "nodeDeath"}, {"at": 2.0, "kind": "drain"},
    {"at": 2.0, "kind": "cordon", "node": "node-3"},
    {"at": 2.5, "kind": "uncordon"}, {"at": 1.5, "kind": "rolloutWave"},
    {"at": 4.0, "kind": "gangArrival"}, {"at": 4.5, "kind": "killLeader"},
    {"at": 0.1, "kind": "rolloutWave", "count": 3, "stride": 7}]


def test_fault_timelines_match_the_reference():
    names = [f"node-{i}" for i in range(64)]
    for seed in (0, 17):
        got = tchurn.build_fault_timeline(FAULT_SPECS, seed, names)
        want = jchurn.build_fault_timeline(FAULT_SPECS, seed, names)
        assert [e.signature() for e in got] == [e.signature() for e in want]
    for bad, pool in (([{"kind": "sliceDeath", "group": "g"}], names),
                      ([{"kind": "nodeDeath"}], None)):
        with pytest.raises(ValueError):
            tchurn.build_fault_timeline(bad, 0, pool)
        with pytest.raises(ValueError):
            jchurn.build_fault_timeline(bad, 0, pool)
    rows = [{"churn_offered_rate": r, "churn_arrivals_total": int(r * 10),
             "churn_backlog_final": b, "churn_achieved_rate": a,
             "attempt_p999_ms": r / 10}
            for r, b, a in ((100, 3, 99.0), (400, 40, 390.0),
                            (1600, 900, 1400.0), (50, 30, 49.0),
                            (800, 10, 300.0))]
    assert tchurn.find_knee(rows) == jchurn.find_knee(rows)
    for row in rows:
        args = (row["churn_arrivals_total"], row["churn_backlog_final"],
                0.2, row["churn_offered_rate"], row["churn_achieved_rate"])
        assert tchurn.is_saturated(*args) == jchurn.is_saturated(*args)


class _Agent:
    def __init__(self, name, stops):
        self.node_name, self._stops = name, stops

    async def stop(self, graceful: bool = True) -> None:
        self._stops.append((self.node_name, graceful))


async def _injector_script(api, specs, n_nodes: int = 16,
                           fail_create: bool = False):
    store = api.new_store()
    api.install(store)
    for i in range(n_nodes):
        await store.create("nodes", api.make_node(f"node-{i}"))
    bound: set = set()
    stops: list = []
    rr = [0]

    async def create_pod(name, template=None):
        if fail_create and not name.startswith("warm-"):
            raise RuntimeError("create failed")
        tmpl = dict(template or {"requests": {"cpu": "100m"}})
        ns = tmpl.pop("namespace", "default")
        nodes = (await store.list("nodes")).items
        free = [n["metadata"]["name"] for n in nodes
                if not (n.get("spec") or {}).get("unschedulable")]
        node = free[rr[0] % len(free)]
        rr[0] += 1
        await store.create("pods", api.make_pod(name, namespace=ns,
                                                node_name=node, **tmpl))
        bound.add(f"{ns}/{name}")

    for i in range(6):
        await create_pod(f"warm-{i}")
    agents = [_Agent(f"node-{i}", stops) for i in range(n_nodes)]
    inj = api.churn.FaultInjector(
        store=store, agents=agents, bound_keys=bound, create_pod=create_pod,
        backlog_fn=lambda: 0, pod_template={"requests": {"cpu": "100m"}},
        recovery_timeout=5.0)
    timeline = api.churn.build_fault_timeline(
        specs, 3, [a.node_name for a in agents])
    t0 = time.monotonic()
    err = None
    try:
        await inj.run(timeline, t0 - 10.0)   # every event due at once
        await inj.drain()
    except Exception as e:   # the port's drain raises; compared below
        err = e
    records = [{k: v for k, v in r.items() if k != "recovery_s"}
               for r in inj.results]
    pods = sorted((p["metadata"]["name"], (p["metadata"].get("labels")
                                           or {}).get(GANG_LABEL))
                  for p in (await store.list("pods")).items)
    groups = sorted((g["metadata"]["name"], g["spec"].get("sliceShape"))
                    for g in (await store.list("podgroups")).items)
    cordoned = sorted(n["metadata"]["name"]
                      for n in (await store.list("nodes")).items
                      if (n.get("spec") or {}).get("unschedulable"))
    store.stop()
    return {"records": records, "net": inj.net_created, "stops": stops,
            "pods": pods, "groups": groups, "cordoned": cordoned}, err


SLICE_FAULTS = [
    {"at": 0.0, "kind": "gangArrival", "sliceShape": [2, 2]},
    {"at": 0.5, "kind": "sliceDeath", "group": "slice-0",
     "sliceShape": [2, 2]},
    {"at": 0.6, "kind": "cordon", "node": "node-9"},
    {"at": 0.7, "kind": "uncordon", "node": "node-9"},
    {"at": 0.8, "kind": "drain", "node": "node-2", "uncordon": False},
    {"at": 0.9, "kind": "rolloutWave", "count": 2}]


def test_injector_matches_the_reference_over_a_store():
    got, err = asyncio.run(_injector_script(PORT, SLICE_FAULTS))
    want, jerr = asyncio.run(_injector_script(JAX, SLICE_FAULTS))
    assert err is None and jerr is None
    assert got == want
    assert [r["recovered"] for r in got["records"]] == [True] * 6
    assert ("slice-0-r500", [2, 2]) in got["groups"]
    assert not any(g == "slice-0" for g, _ in got["groups"])
    dead = got["records"][1]["node"]
    assert (dead, False) in got["stops"] and dead in got["cordoned"]


def test_handler_exceptions_propagate_out_of_drain():
    spec = [{"at": 0.0, "kind": "gangArrival", "count": 2}]
    _, err = asyncio.run(_injector_script(PORT, spec, fail_create=True))
    assert isinstance(err, RuntimeError) and "create failed" in str(err)
    want, jerr = asyncio.run(_injector_script(JAX, spec, fail_create=True))
    assert jerr is None and want["records"][0]["recovered"] is False
    kill = [{"at": 0.0, "kind": "killLeader", "node": "node-1"}]
    _, err = asyncio.run(_injector_script(PORT, kill))
    assert isinstance(err, RuntimeError) and "processes >= 2" in str(err)
    want, jerr = asyncio.run(_injector_script(JAX, kill))
    assert jerr is None and want["records"][0]["recovered"] is False
    _, err = asyncio.run(_injector_script(PORT, [{"at": 0.0,
                                                  "kind": "meteor"}]))
    assert isinstance(err, ValueError)


def test_descheduler_block_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    template = copy.deepcopy(tperf.CHURN_DAY["workloadTemplate"])
    template[-1]["descheduler"] = {"enabled": True}
    params = {"initNodes": 4, "warmupPods": 2, "rate": 5, "duration": 0.2}
    with pytest.raises(RuntimeError, match="Descheduler"):
        asyncio.run(asyncio.wait_for(tperf.PerfRunner().run(
            template, params, timeout=30.0), 60.0))


async def _agent_script(api, tmp):
    store = api.new_store()
    api.install(store)
    agent = api.NodeAgent(
        store, "node-7", checkpoint_dir=str(tmp), lease_period=0.05,
        topology_coord="1,3", node_template={"allocatable": {
            "cpu": "8", "memory": "32Gi", "pods": "110",
            "google.com/tpu": "4"}})
    await api.NodeAgent.start_many([agent])
    claim = api.claim("c1")
    claim["status"] = {"allocation": {"nodeName": "node-7", "devices": [
        "google.com--tpu-0", "google.com--tpu-1"]}}
    await store.create("resourceclaims", claim)
    await store.create("pods", api.make_pod(
        "p1", node_name="node-7", resource_claims=[
            {"name": "tpu", "resourceClaimName": "c1"}]))
    await store.create("pods", api.make_pod("p2", node_name="node-8"))
    deadline = time.monotonic() + 10.0
    while time.monotonic() < deadline:
        p1 = await store.get("pods", "default/p1")
        leases = (await store.list("leases")).items
        if (p1.get("status") or {}).get("phase") == "Running" and leases \
                and leases[0]["spec"]["renewTime"] >= 2:
            break
        await asyncio.sleep(0.02)
    await agent.stop(graceful=False)
    rv = (await store.list("pods")).resource_version
    await asyncio.sleep(0.2)
    quiet = (await store.list("pods")).resource_version == rv
    node = await store.get("nodes", "node-7")
    slices = (await store.list("resourceslices")).items
    p1 = await store.get("pods", "default/p1")
    p2 = await store.get("pods", "default/p2")
    out = {"labels": node["metadata"].get("labels"),
           "annotations": node["metadata"].get("annotations"),
           "devices": [d for s in slices for d in s["spec"]["devices"]],
           "p1": (p1["status"]["phase"], p1["status"].get("podIP"),
                  p1["status"].get("conditions")),
           "p2": p2["status"].get("phase"),
           "ledger": agent.ledger.get("default/p1"),
           "lease": leases[0]["metadata"]["name"] if leases else None,
           "quiet": quiet}
    store.stop()
    return out


def test_node_agent_matches_the_reference(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = asyncio.run(asyncio.wait_for(_agent_script(PORT, tmp_path / "t"),
                                       30.0))
    want = asyncio.run(asyncio.wait_for(_agent_script(JAX, tmp_path / "j"),
                                        30.0))
    assert got == want
    assert got["p1"][0] == "Running" and got["p2"] == "Pending"
    assert got["labels"]["ktpu.io/topology-coord"] == "1,3"
    assert got["ledger"] == {"tpu": ["google.com--tpu-0",
                                     "google.com--tpu-1"]}
    assert len(got["devices"]) == 4 and got["quiet"]


@pytest.mark.parametrize("name", ["ChurnDay", "ChurnSlicePacking"])
def test_churn_constants_equal_the_yaml_entries(name):
    from pathlib import Path

    from kubernetes_tpu.perf import scheduler_perf as jperf

    yaml = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / \
        "perf" / "config" / "performance-config.yaml"
    entry = next(c for c in jperf.load_config(str(yaml))
                 if c["name"] == name)
    const = {"ChurnDay": tperf.CHURN_DAY,
             "ChurnSlicePacking": tperf.CHURN_SLICE_PACKING}[name]
    assert const == entry


def _cpu_run(family, workload, params=None, deadline: float = 120.0):
    params = params or next(w["params"] for w in family["workloads"]
                            if w["name"] == workload)
    runner = slice_runner_cls(tperf.PerfRunner)(
        backend=TorchBackend(device="cpu"), batch_size=16384,
        scheduler_config=family.get("schedulerConfig"))
    result = asyncio.run(asyncio.wait_for(runner.run(
        family["workloadTemplate"], params, timeout=deadline), deadline))
    return runner, result, params


def test_churn_slice_packing_64_agents_holds_the_gates():
    runner, result, params = _cpu_run(tperf.CHURN_SLICE_PACKING,
                                      "64Agents-2x2")
    assert churn_slice_violations(runner, result, params) == []
    r = result.as_dict()
    assert r["churn_arrivals_total"] > 0 and r["churn_create_errors"] == 0
    assert r["slice_gangs_bound_total"] == 2
    assert r["churn_recovery_seconds_max"] is not None
    assert r["topology_plane_rebuilds_total"] >= 0
    assert r["agent_start_seconds"] > 0
    assert runner.gang_nodes["slice-1000"] and math.prod(
        params["shape"]) == len(runner.gang_nodes["slice-1000-r3500"])


def test_short_churn_day_row_holds_the_gates():
    params = {"initNodes": 100, "warmupPods": 30, "rate": 50,
              "duration": 1.5}
    runner, result, _ = _cpu_run(tperf.CHURN_DAY, None, params, 60.0)
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    r = result.as_dict()
    assert r["churn_arrivals_total"] > 0 and r["churn_create_errors"] == 0
    assert r["churn_arrival_model"] == "poisson"
    assert r["measured_pods"] == r["churn_arrivals_total"]
    assert over_capacity(nodes, pods) == []
    assert len(pods) == 30 + r["churn_arrivals_total"]
