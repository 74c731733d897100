"""Preemption in the port (DefaultPreemption and the batched victim
proposal `solver.propose_victims`) against the JAX package on the CPU.

- `propose_victims` against the reference's on seeded buckets
  (`chip_smoke.victim_case`: full nodes with 0-4 victims ascending in
  priority, coarse priorities that tie for the rotation tiebreak, banned
  nodes, 8 padding rows), two buckets threading the post-claim carry,
  and priorities within 200 of 2^31 - 1, where the float32 priority sums
  are no longer exact: node, count and the carry identical.
- `prime_wave` then `post_filter` on a fixed snapshot (a 150-preemptor
  wave, so the proposal runs in two 128-row buckets; preemptors with a
  zone selector ban two thirds of the nodes), the diagnostics each
  package's batched backend gives: the same nominations, statuses,
  victims (in eviction order), routes and ledgers. The wave's resync age
  (WAVE_MAX_AGE_S) and the promise TTL (PROMISE_TTL_S) are pinned by an
  injected clock: a reused wave, a rebuilt one after victims left and a
  preemptor bound, in-flight re-nominations, and promises aged out.
  Every victim lies below its preemptor's priority.
- Preemption/100Nodes through both packages' PerfRunner and
  `Scheduler.run` (128-pod solve chunks): every preemptor bound (the
  scoped barriers), the same victim counts and attempt counts.
- `PREEMPTION` equals the reference YAML's Preemption entry.
- No fallback: a `prime_wave` or `propose_victims` failure propagates out
  of `Scheduler.run` (the reference logs it and goes on).

Tolerance: none.
"""

import asyncio
import contextlib
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import victim_case
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import scheduler as jscheduler
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import defaultpreemption as jpre
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import scheduler as tscheduler
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import defaultpreemption as tpre
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- propose_victims ----------------------------------------------------------

def _both(args):
    ref = jsolver.propose_victims(*[jnp.asarray(a) for a in args])
    got = tsolver.propose_victims(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    return [np.asarray(a) for a in ref], [t.numpy() for t in got]


@pytest.mark.parametrize("seed,n,near_max", [
    (5, 1, False), (6, 256, False),
    (1, 40, False), (2, 97, False), (3, 40, True), (4, 97, True)])
def test_propose_victims_matches_reference(seed, n, near_max):
    args = victim_case(seed, n, p=32, near_max=near_max)
    ref, got = _both(args)
    for name, a, b in zip(("node", "count", "used", "pods_used", "vreq",
                           "vprio"), ref, got):
        np.testing.assert_array_equal(b, a, err_msg=name)
    node, count = got[0], got[1]
    assert (node[-8:] == -1).all() and (count[-8:] == 0).all()
    if n == 1:  # one node: its victims go to the first preemptors alone
        assert (node[:-8] == 0).sum() >= 1 and (node[:-8] == -1).any()
        return
    assert (node[:-8] >= 0).sum() > 8
    assert (count > 1).any()
    # Equal-cost ties are broken by the rotation: the proposals spread.
    assert len(set(node[node >= 0].tolist())) > 8


def test_propose_victims_threads_the_carry_across_buckets():
    """Two buckets, the second starting from the first's carry, as
    `prime_wave` runs a wave wider than 128."""
    first = victim_case(7, 60, p=24)
    second = victim_case(8, 60, p=24)
    ref1, got1 = _both(first)
    carried = list(second)
    carried[3], carried[5], carried[7], carried[8] = got1[2], got1[3], \
        got1[4], got1[5]
    ref_carried = list(second)
    ref_carried[3], ref_carried[5], ref_carried[7], ref_carried[8] = \
        ref1[2], ref1[3], ref1[4], ref1[5]
    ref2 = [np.asarray(a) for a in jsolver.propose_victims(
        *[jnp.asarray(a) for a in ref_carried])]
    got2 = [t.numpy() for t in tsolver.propose_victims(
        *[torch.from_numpy(np.ascontiguousarray(a)) for a in carried])]
    for a, b in zip(ref2, got2):
        np.testing.assert_array_equal(b, a)
    # The carry moved: a claimed prefix shifted out of some node's rows.
    assert not np.array_equal(got1[5], first[8])


# -- prime_wave and post_filter ---------------------------------------------

N_NODES = 24


def _objects(bound_preemptors=(), gone_victims=()):
    """Nodes (cpu 4, pods 32; zone-a on every third) full of four cpu-1
    fillers each (priorities 0 and 5 alternating by node, one priority-50
    filler on every fifth node), plus the bound preemptors given as
    (name, node)."""
    nodes = [(f"node-{i}", {"allocatable": {"cpu": "4", "memory": "16Gi",
                                            "pods": "32"},
                            "labels": {"zone": "a" if i % 3 == 0 else "b"}})
             for i in range(N_NODES)]
    residents = []
    for i in range(N_NODES):
        for k in range(4):
            prio = 50 if (i % 5 == 0 and k == 3) else (0 if i % 2 else 5)
            name = f"fill-{i}-{k}"
            if name in gone_victims:
                continue
            residents.append((name, {"requests": {"cpu": "1"},
                                     "priority": prio,
                                     "node_name": f"node-{i}"}))
    for name, node in bound_preemptors:
        residents.append((name, {"requests": {"cpu": "1"}, "priority": 100,
                                 "node_name": node}))
    return nodes, residents


def _preemptors(n: int):
    out = []
    for i in range(n):
        kw = {"requests": {"cpu": "2" if i % 7 == 0 else "1"},
              "priority": 100 if i % 11 else 40}
        if i % 4 == 0:
            kw["node_selector"] = {"zone": "a"}
        out.append((f"pre-{i}", kw))
    return out


def _snapshot(types_mod, mk_node, mk_pod, nodes, residents, generation):
    infos = {name: types_mod.NodeInfo(mk_node(name, **kw))
             for name, kw in nodes}
    for name, kw in residents:
        infos[kw["node_name"]].add_pod(types_mod.PodInfo(mk_pod(name, **kw)))
    return types_mod.Snapshot(list(infos.values()), generation)


class Clock:
    def __init__(self, t: float):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _ledgers(p) -> dict:
    return {"claimed": sorted(p._claimed),
            "promised": {n: sorted(v) for n, v in p._promised.items()},
            "promised_pods": dict(p._promised_pods),
            "promised_victims": {k: list(v)
                                 for k, v in p._promised_victims.items()},
            "wave_claims": p._wave_claims}


def _preemption_script(pkg: str, clock: Clock) -> list:
    if pkg == "port":
        types_mod, mk_node, mk_pod = ttypes, make_node, make_pod
        registry, framework_mod = tregistry, tframework
        backend = tbackend.TorchBackend(device="cpu", max_batch=256)
        plugin = tpre.DefaultPreemption(device="cpu", clock=clock)
        ctx = contextlib.nullcontext
    else:
        types_mod, mk_node, mk_pod = jtypes, jmake_node, jmake_pod
        registry, framework_mod = jregistry, jframework
        backend = jbackend.TPUBackend(max_batch=256, mesh=None)
        plugin = jpre.DefaultPreemption()
        def ctx():
            return jflags.scoped_set("KTPU_SHORTLIST_K", 0)
    fwk = framework_mod.Framework(
        registry.build_plugins(list(tregistry.DEFAULT_PLUGINS)),
        registry.DEFAULT_SCORE_WEIGHTS)
    evicted = []
    plugin.framework = fwk
    plugin.evict = lambda pod, keys, node: evicted.append(
        (pod.key, node, list(keys)))
    trace = []
    pods = [types_mod.PodInfo(mk_pod(n, **kw)) for n, kw in _preemptors(150)]

    def failure_wave(snap, wave_pods):
        with ctx():
            assignments, diags = backend.assign(wave_pods, snap, fwk)
        failed = [p for p in wave_pods if assignments[p.key] is None]
        plugin.prime_wave(failed, snap, diags)
        trace.append(("primed", sorted(plugin._primed.items())))
        for p in failed:
            state = framework_mod.CycleState()
            fwk.run_pre_filter(state, p, snap)
            node, st = plugin.post_filter(state, p, snap, diags[p.key])
            trace.append((p.key, node, st.code, list(st.reasons)))
        trace.append(("ledgers", _ledgers(plugin), list(evicted),
                      dict(getattr(plugin, "paths", {}))))
        evicted.clear()
        return failed

    nodes, residents = _objects()
    snap = _snapshot(types_mod, mk_node, mk_pod, nodes, residents, 1)
    failure_wave(snap, pods)
    # 0.2 s on: the wave is reused; the first preemptors retry while their
    # victims are still resident (in-flight re-nominations).
    clock.t += 0.2
    failure_wave(snap, pods[:20])
    # 1 s on, victims of the first 30 preemptors left and 10 of them bound:
    # the wave is rebuilt, claims pruned, bound promises dropped.
    clock.t += 1.0
    gone = {vk.split("/", 1)[1] for pk, vks in _promised_victims(plugin)
            if int(pk.rsplit("-", 1)[1]) < 30 for vk in vks}
    bound = [(p.key.split("/", 1)[1], plugin._promised_pods[p.key])
             for p in pods[:10] if p.key in plugin._promised_pods]
    nodes, residents = _objects(bound, gone)
    snap = _snapshot(types_mod, mk_node, mk_pod, nodes, residents, 2)
    failure_wave(snap, pods[10:60])
    # Past the promise TTL: the promises of preemptors that never bound
    # age out at the next rebuild.
    clock.t += 40.0
    failure_wave(snap, pods[60:70])
    return trace


def _promised_victims(plugin):
    return sorted(plugin._promised_victims.items())


def test_prime_wave_and_post_filter_match_reference(monkeypatch):
    clock = Clock(1000.0)
    got = _preemption_script("port", clock)
    ref_clock = Clock(1000.0)
    monkeypatch.setattr(time, "monotonic", ref_clock)
    want = _preemption_script("jax", ref_clock)
    monkeypatch.undo()
    # The reference has no route counters; compare the rest.
    strip = [t[:3] if t[0] == "ledgers" else t for t in got]
    assert strip == [t[:3] if t[0] == "ledgers" else t for t in want]
    ledgers = [t for t in got if t[0] == "ledgers"]
    first = got[:got.index(ledgers[0])]
    nominated = sum(1 for t in first if t[0].startswith("default/") and t[1])
    # Every nomination of the first wave came from the device proposal.
    assert ledgers[0][3]["primed"] == nominated == 84
    # 0.2 s on, the retries re-nominate without evicting again.
    assert ledgers[1][3]["in_flight"] == 20 and not ledgers[1][2]
    # The rebuild after 1 s pruned the departed victims' claims, and past
    # the TTL every promise of a preemptor that never bound aged out.
    assert len(ledgers[2][1]["claimed"]) < len(ledgers[1][1]["claimed"])
    assert ledgers[-1][1]["promised_pods"] == {}
    # Every victim lies below its preemptor's priority.
    prio = {f"default/pre-{i}": (100 if i % 11 else 40) for i in range(150)}
    for t in ledgers:
        for pod_key, _node, keys in t[2]:
            for vk in keys:
                i, k = (int(x) for x in vk.rsplit("fill-", 1)[1].split("-"))
                vprio = 50 if (i % 5 == 0 and k == 3) else (
                    0 if i % 2 else 5)
                assert vprio < prio[pod_key]


def test_prime_wave_runs_on_the_card_by_default():
    plugin = tpre.DefaultPreemption()
    assert plugin.device is None
    if not torch.cuda.is_available():
        plugin.framework = tframework.Framework(
            tregistry.build_plugins(), tregistry.DEFAULT_SCORE_WEIGHTS)
        nodes, residents = _objects()
        snap = _snapshot(ttypes, make_node, make_pod, nodes, residents, 1)
        pod = ttypes.PodInfo(make_pod("pre-x", requests={"cpu": "1"},
                                      priority=100))
        with pytest.raises((RuntimeError, AssertionError)):
            plugin.prime_wave([pod], snap, {})


# -- the loop -----------------------------------------------------------------

def test_preemption_constant_equals_the_yaml_entry():
    entry = next(c for c in jperf.load_config(str(YAML))
                 if c["name"] == "Preemption")
    assert tperf.PREEMPTION == entry


def _victims_recorded(monkeypatch, sched_mod):
    got = []
    evict = sched_mod.Scheduler._preemption_evict

    def recorded(self, pod, victim_keys, node_name):
        got.append((pod.priority, len(victim_keys)))
        return evict(self, pod, victim_keys, node_name)
    monkeypatch.setattr(sched_mod.Scheduler, "_preemption_evict", recorded)
    return got


def test_preemption_100_nodes_matches_reference(monkeypatch):
    case = dict(tperf.PREEMPTION)
    port_victims = _victims_recorded(monkeypatch, tscheduler)
    ref_victims = _victims_recorded(monkeypatch, jscheduler)
    got = tperf.run_suite(
        [case], backend_factory=lambda: tbackend.TorchBackend(
            device="cpu", max_batch=128), batch_size=16384,
        filter_name="Preemption/100Nodes", timeout=300)
    want = jperf.run_suite(
        [case], backend_factory=lambda: jbackend.TPUBackend(
            max_batch=128, mesh=None), batch_size=16384,
        filter_name="Preemption/100Nodes", timeout=300)
    g, w = got["Preemption/100Nodes"], want["Preemption/100Nodes"]
    for key in ("measured_pods", "scheduled_total", "unschedulable_total"):
        assert g[key] == w[key], key
    # 400 fillers + 40 + 100 preemptors bound; each preemptor failed once.
    assert g["scheduled_total"] == 540 and g["unschedulable_total"] == 140
    assert sum(n for _, n in port_victims) == sum(n for _, n in ref_victims)
    assert sorted(port_victims) == sorted(ref_victims)
    assert len(port_victims) == 140 and all(p == 1000
                                            for p, _ in port_victims)


def _raising_run(monkeypatch, target: str):
    if target == "propose_victims":
        def lost(*args, **kw):
            raise RuntimeError("card lost in propose_victims")
        monkeypatch.setattr(tsolver, "propose_victims", lost)
    else:
        def lost(self, pods, snapshot, statuses):
            raise RuntimeError("card lost in prime_wave")
        monkeypatch.setattr(tpre.DefaultPreemption, "prime_wave", lost)
    case = {"name": "Preemption", "workloadTemplate":
            tperf.PREEMPTION["workloadTemplate"],
            "workloads": [{"name": "tiny", "params": {
                "initNodes": 8, "fillerPods": 32, "warmupPreemptors": 12,
                "measurePods": 4}}]}
    return tperf.run_suite([case], backend_factory=lambda: tbackend.
                           TorchBackend(device="cpu"), batch_size=16384,
                           timeout=60)


@pytest.mark.parametrize("target", ["prime_wave", "propose_victims"])
def test_device_proposal_failure_makes_run_raise(monkeypatch, target):
    with pytest.raises(RuntimeError, match=f"card lost in {target}"):
        _raising_run(monkeypatch, target)


def test_scheduler_wires_the_plugin(monkeypatch):
    """The loop wires DefaultPreemption as the reference does (framework,
    evict) and hands it the backend's device."""
    from kubernetes_tpu_torch.store import new_cluster_store

    store = new_cluster_store()
    try:
        sched = tscheduler.Scheduler(
            store, backend=tbackend.TorchBackend(device="cpu"))
        fwk = sched.profiles["default-scheduler"]
        (plugin,) = [p for p in fwk.post_filter_plugins
                     if p.NAME == "DefaultPreemption"]
        assert plugin.framework is fwk
        assert plugin.evict == sched._preemption_evict
        assert str(plugin.device) == "cpu"
    finally:
        store.stop()


# -- the host side ------------------------------------------------------------

def test_constants_match_reference():
    for name in ("WAVE_DEVICE_BUCKET", "WAVE_MAX_CLAIMS", "WAVE_MAX_AGE_S",
                 "PROMISE_TTL_S"):
        assert getattr(tpre.DefaultPreemption, name) == \
            getattr(jpre.DefaultPreemption, name), name
    assert tsolver.PRIO_INF == int(jsolver.PRIO_INF)
    assert tpre._WaveState.INF == jpre._WaveState.INF


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wave_state_candidates_and_claims_match_reference(seed):
    """The host wave tensors: ranked candidates per preemptor (banned
    nodes, both priorities), then claims in order — equal rankings, victim
    lists and arrays after each claim."""
    rng = np.random.default_rng(seed)
    nodes, residents = _objects()
    keep = rng.random(len(residents)) < 0.85
    residents = [r for r, k in zip(residents, keep) if k]
    pending = _preemptors(24)
    bans = [set(rng.choice(N_NODES, size=i % 4, replace=False).tolist())
            for i in range(len(pending))]
    outs = []
    for types_mod, mk_node, mk_pod, mod in (
            (ttypes, make_node, make_pod, tpre),
            (jtypes, jmake_node, jmake_pod, jpre)):
        snap = _snapshot(types_mod, mk_node, mk_pod, nodes, residents, 1)
        claimed, promised = {"default/fill-1-0"}, {}
        wave = mod._WaveState(snap, claimed, promised)
        out = []
        for (name, kw), banned in zip(pending, bans):
            pod = types_mod.PodInfo(mk_pod(name, **kw))
            ranked = wave.candidates(pod, banned)
            out.append(ranked)
            if ranked:
                args = (*ranked[0], pod, claimed, promised)
                got = wave.claim(*args, 7.0) if mod is tpre \
                    else wave.claim(*args)
                out.append([v.key for v in got])
        out.append([np.asarray(getattr(wave, a)).tolist() for a in (
            "rel", "vreq", "vprio", "vsum", "vmax", "vcount", "used",
            "pods_used")])
        out.append(sorted(claimed))
        outs.append(out)
    assert outs[0] == outs[1]
    assert sum(1 for o in outs[0][:-2] if o and isinstance(o[0], tuple)) > 10


def test_host_scan_matches_reference():
    """With no primed proposal and the ranked search skipped, post_filter
    falls to the per-node host scan (`_select_victims`, `_pick_one`): the
    same nominations and victims."""
    nodes, residents = _objects()
    out = []
    for types_mod, mk_node, mk_pod, mod, registry, framework_mod in (
            (ttypes, make_node, make_pod, tpre, tregistry, tframework),
            (jtypes, jmake_node, jmake_pod, jpre, jregistry, jframework)):
        snap = _snapshot(types_mod, mk_node, mk_pod, nodes, residents, 1)
        fwk = framework_mod.Framework(
            registry.build_plugins(list(tregistry.DEFAULT_PLUGINS)),
            registry.DEFAULT_SCORE_WEIGHTS)
        plugin = mod.DefaultPreemption(framework=fwk)
        evicted = []
        plugin.evict = lambda pod, keys, node: evicted.append(
            (node, sorted(keys)))
        got = []
        for name, kw in _preemptors(30):
            pod = types_mod.PodInfo(mk_pod(name, **kw))
            state = framework_mod.CycleState()
            fwk.run_pre_filter(state, pod, snap)
            node, st = plugin._post_filter_scan(state, pod, snap, {})
            got.append((node, st.code))
        out.append((got, evicted, sorted(plugin._claimed)))
    assert out[0] == out[1]
    assert sum(1 for node, _ in out[0][0] if node) > 10


def test_eviction_tolerates_a_victim_already_gone():
    """`_preemption_evict` deletes the victims it can and still nominates
    the node when one is already gone (store semantics)."""
    from kubernetes_tpu_torch.store import new_cluster_store

    async def run():
        store = new_cluster_store()
        try:
            sched = tscheduler.Scheduler(store)
            await store.create("pods", make_pod("v1"))
            await store.create("pods", make_pod("pre"))
            pod = ttypes.PodInfo(make_pod("pre"))
            sched._preemption_evict(pod, ["default/gone", "default/v1"],
                                    "node-3")
            for _ in range(20):
                await asyncio.sleep(0.005)
            names = [p["metadata"]["name"]
                     for p in (await store.list("pods")).items]
            pre = await store.get("pods", "default/pre")
            return names, pre["status"].get("nominatedNodeName"), \
                sched.metrics.preemption_victims.count()
        finally:
            store.stop()

    names, nominated, observed = asyncio.run(run())
    assert names == ["pre"] and nominated == "node-3" and observed == 1
