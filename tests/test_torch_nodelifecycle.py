"""The port's node lifecycle controller, the injector's nodeDeath and
`NodeAgent.force_relist` against the JAX package on the CPU.

- `NodeLifecycleController` with an injected clock (the staleness clock;
  the monitor tick and the eviction delays are short real sleeps), as
  `tests/test_controllers.py:167` and `:203` drive the reference's: two
  nodes with leases, pods on the one whose lease goes stale carrying a
  short, a long, an unbounded and the admission-default toleration. The
  same taint on the same node (and Ready=Unknown), the same evictions,
  the same pending evictions, then on the lease's renewal the same
  untaint (Ready=True) with the pending evictions cancelled; and with
  `toleration_seconds_cap` the capped pods evicted and the unbounded one
  kept.
- The injector's `nodeDeath`: without an agent (createNodes staging) the
  Node is deleted and replacements follow at once; with an agent, it is
  stopped ungracefully and the replacements wait for the displaced pods'
  eviction (here a delete after a short delay): the same fault records
  (recovery seconds aside), net pod counts, stops and store objects.
- `force_relist`: 500 agents relisting at once cost no new direct store
  scan and at least 500 watch-cache hits
  (`tests/test_watch_cache_smoke.py:70`), the same counts in both
  packages; and a pod deleted while an agent's
  watch was down has its devices reclaimed by the relist's reconcile,
  after which the new watch marks a new pod Running.

Tolerance: none (identical objects and records); every wait has its own
deadline of 60 s.
"""

import asyncio
import time
from types import SimpleNamespace

import pytest

from kubernetes_tpu.agent.agent import NodeAgent as JNodeAgent
from kubernetes_tpu.api.meta import new_object as jnew_object
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.api.types import (
    make_resource_claim as jmake_resource_claim)
from kubernetes_tpu.controllers import ControllerManager as JManager
from kubernetes_tpu.controllers import NodeLifecycleController as JNLC
from kubernetes_tpu.perf import churn as jchurn
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu.store.mvcc import MVCCStore as JMVCCStore
from kubernetes_tpu_torch.agent import NodeAgent
from kubernetes_tpu_torch.api.meta import new_object
from kubernetes_tpu_torch.api.types import (TAINT_UNREACHABLE, make_node,
                                            make_pod, make_resource_claim)
from kubernetes_tpu_torch.controllers import (ControllerManager,
                                              NodeLifecycleController)
from kubernetes_tpu_torch.perf import churn as tchurn
from kubernetes_tpu_torch.store import (install_core_validation,
                                        new_cluster_store)
from kubernetes_tpu_torch.store.mvcc import MVCCStore

JAX = SimpleNamespace(new_store=jnew_store, install=jinstall,
                      make_node=jmake_node, make_pod=jmake_pod,
                      new_object=jnew_object, NLC=JNLC, Manager=JManager,
                      churn=jchurn, NodeAgent=JNodeAgent, MVCC=JMVCCStore,
                      claim=jmake_resource_claim)
PORT = SimpleNamespace(new_store=new_cluster_store,
                       install=install_core_validation, make_node=make_node,
                       make_pod=make_pod, new_object=new_object,
                       NLC=NodeLifecycleController, Manager=ControllerManager,
                       churn=tchurn, NodeAgent=NodeAgent, MVCC=MVCCStore,
                       claim=make_resource_claim)

DEADLINE = 60.0


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


async def _until(pred, what: str) -> None:
    end = time.monotonic() + DEADLINE
    while time.monotonic() < end:
        if await pred():
            return
        await asyncio.sleep(0.01)
    raise TimeoutError(what)


def _tol(seconds):
    tol = {"key": TAINT_UNREACHABLE, "operator": "Exists",
           "effect": "NoExecute"}
    if seconds is not None:
        tol["tolerationSeconds"] = seconds
    return [tol]


async def _lifecycle_script(api, cap) -> list:
    store = api.new_store()
    api.install(store)
    clock = _Clock()
    nlc = api.NLC(store, node_monitor_period=0.02,
                  node_monitor_grace_period=10.0,
                  default_toleration_seconds=0.05,
                  toleration_seconds_cap=cap, clock=clock)
    mgr = api.Manager(store, [nlc])
    for n in ("n1", "n2"):
        await store.create("nodes", api.make_node(n))
        await store.create("leases", api.new_object(
            "Lease", n, "kube-node-lease", spec={"renewTime": 0}))
    for name, node, secs in (("short", "n1", 0.05), ("long", "n1", 30),
                             ("forever", "n1", None), ("default", "n1", ""),
                             ("other", "n2", 0.05)):
        tols = {} if secs == "" else {"tolerations": _tol(secs)}
        await store.create("pods", api.make_pod(name, node_name=node,
                                                **tols))

    async def renew(node: str, at: float):
        clock.t = at
        lease = await store.get("leases", f"kube-node-lease/{node}")
        lease["spec"]["renewTime"] += 1
        await store.update("leases", lease)
        await _until(lambda: _true(nlc._last_heartbeat.get(node) == at),
                     f"{node}'s renewal seen")

    async def state():
        nodes = (await store.list("nodes")).items
        pods = (await store.list("pods")).items
        return {
            "taints": {n["metadata"]["name"]: n["spec"].get("taints")
                       for n in nodes},
            "ready": {n["metadata"]["name"]: [
                c["status"] for c in (n.get("status") or {}).get(
                    "conditions") or [] if c.get("type") == "Ready"]
                for n in nodes},
            "pods": sorted(p["metadata"]["name"] for p in pods),
            "pending": sorted(nlc._evictions)}

    async def tainted(node: str) -> bool:
        n = await store.get("nodes", node)
        return any(t["key"] == TAINT_UNREACHABLE
                   for t in n["spec"].get("taints") or [])

    out = []
    try:
        await mgr.start()
        await asyncio.sleep(0.2)
        out.append(await state())                 # fresh: no taint
        await renew("n2", 8.0)
        clock.t = 12.0                            # n1 stale, n2 not
        await _until(lambda: tainted("n1"), "n1 tainted")
        # Admission gives "default" the 300 s toleration; the cap
        # shortens it and "long"'s 30 s, never the unbounded one.
        gone = {"short"} if cap is None else {"short", "long", "default"}

        async def evicted():
            names = {p["metadata"]["name"]
                     for p in (await store.list("pods")).items}
            return not (names & gone)
        await _until(evicted, "evictions")
        await asyncio.sleep(0.2)
        out.append(await state())
        await renew("n1", 12.0)

        async def untainted():
            return not await tainted("n1")
        await _until(untainted, "n1 untainted")
        await asyncio.sleep(0.2)
        out.append(await state())
    finally:
        await mgr.stop()
        store.stop()
    return out


async def _true(v):
    return v


@pytest.mark.parametrize("cap", [None, 0.05])
def test_lifecycle_matches_the_reference(cap):
    got = asyncio.run(_lifecycle_script(PORT, cap))
    want = asyncio.run(_lifecycle_script(JAX, cap))
    assert got == want
    fresh, dead, back = got
    assert fresh["taints"] == {"n1": None, "n2": None}
    assert dead["taints"]["n1"] == [{"key": TAINT_UNREACHABLE,
                                     "effect": "NoExecute"}]
    assert dead["ready"]["n1"] == ["Unknown"] and not dead["taints"]["n2"]
    if cap is None:
        assert dead["pods"] == ["default", "forever", "long", "other"]
        assert dead["pending"] == ["default/default", "default/long"]
    else:
        assert dead["pods"] == ["forever", "other"]
    assert back["taints"]["n1"] == [] and back["ready"]["n1"] == ["True"]
    assert back["pending"] == [] and back["pods"] == dead["pods"]


class _Agent:
    def __init__(self, name, stops):
        self.node_name, self._stops = name, stops

    async def stop(self, graceful: bool = True) -> None:
        self._stops.append((self.node_name, graceful))


async def _node_death_script(api, with_agent: bool) -> dict:
    store = api.new_store()
    api.install(store)
    for i in range(4):
        await store.create("nodes", api.make_node(f"node-{i}"))
    bound: set = set()
    rr = [0]

    async def create_pod(name, template=None):
        node = f"node-{2 + rr[0] % 2}"
        rr[0] += 1
        await store.create("pods", api.make_pod(
            name, node_name=node, **dict(template or {})))
        bound.add(f"default/{name}")

    for i in range(3):
        await store.create("pods", api.make_pod(f"p{i}", node_name="node-1"))
        bound.add(f"default/p{i}")
    stops: list = []
    agents = [_Agent("node-1", stops)] if with_agent else []
    inj = api.churn.FaultInjector(
        store=store, agents=agents, bound_keys=bound, create_pod=create_pod,
        backlog_fn=lambda: 0, pod_template={"requests": {"cpu": "100m"}},
        recovery_timeout=DEADLINE)
    timeline = api.churn.build_fault_timeline(
        [{"at": 0.0, "kind": "nodeDeath", "node": "node-1"}], 0,
        ["node-1"])

    async def evict_later():
        # The lifecycle controller's part, done by hand: the displaced
        # pods' deletes land after the kill.
        await asyncio.sleep(0.1)
        assert [s for s in stops] == [("node-1", False)]
        for i in range(3):
            await store.delete("pods", f"default/p{i}")
            bound.discard(f"default/p{i}")

    t0 = time.monotonic()
    evictor = asyncio.ensure_future(evict_later()) if with_agent else None
    await inj.run(timeline, t0 - 1.0)
    await inj.drain()
    if evictor is not None:
        await evictor
    records = [{k: v for k, v in r.items() if k != "recovery_s"}
               for r in inj.results]
    out = {"records": records, "net": inj.net_created, "stops": stops,
           "nodes": sorted(n["metadata"]["name"]
                           for n in (await store.list("nodes")).items),
           "pods": sorted((p["metadata"]["name"], p["spec"].get("nodeName"))
                          for p in (await store.list("pods")).items)}
    store.stop()
    return out


@pytest.mark.parametrize("with_agent", [False, True])
def test_node_death_matches_the_reference(with_agent):
    got = asyncio.run(asyncio.wait_for(
        _node_death_script(PORT, with_agent), DEADLINE))
    want = asyncio.run(asyncio.wait_for(
        _node_death_script(JAX, with_agent), DEADLINE))
    assert got == want
    rec = got["records"][0]
    assert rec["recovered"] and rec["displaced_pods"] == 3 \
        and rec["replacements"] == 3 and rec["node"] == "node-1"
    assert [n for n, _ in got["pods"]] == ["p0-r0", "p1-r0", "p2-r0"] \
        if with_agent else ["p0", "p0-r0", "p1", "p1-r0", "p2", "p2-r0"]
    assert ("node-1" in got["nodes"]) == with_agent
    assert got["net"] == (0 if with_agent else 3)


async def _storm_script(api, tmp, n: int) -> dict:
    s = api.MVCC()
    for i in range(10):
        await s.create("pods", {
            "metadata": {"name": f"p{i}", "namespace": "default"},
            "spec": {"nodeName": "node-0"}, "status": {"phase": "Running"}})
    agents = [api.NodeAgent(s, f"node-{i}", checkpoint_dir=str(tmp),
                            lease_period=60.0) for i in range(n)]
    try:
        await api.NodeAgent.start_many(agents)
        boot = dict(s.list_direct_total)
        h0 = s.cacher.metrics.hits.value()
        await asyncio.gather(*(a.force_relist() for a in agents))
        return {"boot": boot,
                "storm_scans": {r: v - boot.get(r, 0)
                                for r, v in s.list_direct_total.items()},
                "hits": s.cacher.metrics.hits.value() - h0,
                "watching": sum(a._watch_task is not None
                                and not a._watch_task.done()
                                for a in agents)}
    finally:
        await asyncio.gather(*(a.stop() for a in agents))
        s.stop()


def test_relist_storm_costs_no_store_scan(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = asyncio.run(asyncio.wait_for(
        _storm_script(PORT, tmp_path / "t", 500), DEADLINE))
    want = asyncio.run(asyncio.wait_for(
        _storm_script(JAX, tmp_path / "j", 500), DEADLINE))
    assert got == want
    assert all(v <= 1 for v in got["boot"].values()), got["boot"]
    assert all(v == 0 for v in got["storm_scans"].values())
    assert got["hits"] >= 500 and got["watching"] == 500


async def _reconcile_script(api, tmp) -> dict:
    store = api.new_store()
    api.install(store)
    agent = api.NodeAgent(
        store, "node-7", checkpoint_dir=str(tmp), lease_period=60.0,
        node_template={"allocatable": {
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
    await _until(lambda: _true(bool(agent.ledger.get("default/p1"))),
                 "p1's devices allocated")
    # The watch goes down; the pod is deleted meanwhile.
    agent._watch_task.cancel()
    await asyncio.gather(agent._watch_task, return_exceptions=True)
    await store.delete("pods", "default/p1")
    await asyncio.sleep(0.1)
    held = agent.ledger.get("default/p1")
    await agent.force_relist()
    await _until(lambda: _true(not agent.ledger.get("default/p1")),
                 "p1's devices reclaimed")
    await store.create("pods", api.make_pod("p2", node_name="node-7"))

    async def running():
        p2 = await store.get("pods", "default/p2")
        return (p2.get("status") or {}).get("phase") == "Running"
    await _until(running, "p2 Running through the new watch")
    out = {"held_while_down": held,
           "after": agent.ledger.get("default/p1"),
           "tasks": len(agent._tasks)}
    await agent.stop()
    store.stop()
    return out


def test_force_relist_reconciles_a_pod_deleted_while_down(tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got = asyncio.run(asyncio.wait_for(
        _reconcile_script(PORT, tmp_path / "t"), DEADLINE))
    want = asyncio.run(asyncio.wait_for(
        _reconcile_script(JAX, tmp_path / "j"), DEADLINE))
    assert got == want
    assert got["held_while_down"] == {"tpu": ["google.com--tpu-0",
                                              "google.com--tpu-1"]}
    assert not got["after"]
