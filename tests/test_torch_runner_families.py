"""The port's runner on the families it gained (SchedulingGated,
AgentRelistStorm, ChurnDayFaults, ChurnRebalance), against the JAX
package's runner on the same templates at reduced sizes, on the CPU.

- `SCHEDULING_GATED`, `AGENT_RELIST_STORM`, `CHURN_DAY_FAULTS` and
  `CHURN_REBALANCE` equal the YAML's entries.
- `ungatePods` (the template of `tests/test_perf_harness.py:108`): every
  gated pod bound, the measured window the 12 ungated pods, in both
  runners (the host path), and through `TorchBackend(device="cpu")` none
  bound before the ungate (`chip_smoke.gated_runner_cls`).
- `relistStorm` (40 agents): every agent relisted, the same cache hits
  and misses in both runners, no direct store scan during the storm
  (`chip_smoke.storm_violations`).
- `churn` (delete and recreate 4 pods): the same pods, all bound, in
  both runners.
- A nodeDeath window (`CHURN_DAY_FAULTS`' template, 60 agents, 20/s for
  2.5 s, the kill at 0.5 s, grace 1 s): the same fault (kind, time, node,
  recovered) in both runners on the host path, and through
  `TorchBackend(device="cpu")` `chip_smoke.node_death_violations`' gates.
- A descheduler off/on window (`CHURN_REBALANCE`' template, 40 nodes, 80
  warm-up pods, waves of 18, 3 s): evictions the sum of the cycles', none
  over the budget, none with the descheduler off, the curve sampled
  (`chip_smoke.rebalance_violations`); the JAX runner evicts too.
- Provenance on the CPU: the platform, the versions, the plain route, no
  card fields; a failed nvidia-smi raises on a CUDA device.
- `profile_dir`: one Chrome trace of the measured window; no backend, a
  second `start_profile` and a profiler that cannot start all raise.

Tolerance: none (open-loop windows are held to gates and to what both
runners decide alike, not pod by pod).
"""

import asyncio
import copy
import json
import os
import subprocess
from pathlib import Path

import pytest
import torch

from chip_smoke import (counted_descheduler, gated_runner_cls,
                        node_death_violations, rebalance_violations,
                        storm_runner_cls, storm_violations)
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops.backend import TorchBackend, solve_provenance
from kubernetes_tpu_torch.perf import scheduler_perf as tperf

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" / \
    "config" / "performance-config.yaml"
DEADLINE = 60.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _run(runner, template, params=None):
    return asyncio.run(asyncio.wait_for(runner.run(
        template, params or {}, timeout=DEADLINE), DEADLINE + 10))


def _port(cls=tperf.PerfRunner, backend=None, **kw):
    if backend is None:
        return cls(**kw)
    return cls(backend=backend, batch_size=16384, **kw)


@pytest.mark.parametrize("name", ["SchedulingGated", "AgentRelistStorm",
                                  "ChurnDayFaults", "ChurnRebalance"])
def test_family_constants_equal_the_yaml_entries(name):
    entry = next(c for c in jperf.load_config(str(YAML))
                 if c["name"] == name)
    const = {"SchedulingGated": tperf.SCHEDULING_GATED,
             "AgentRelistStorm": tperf.AGENT_RELIST_STORM,
             "ChurnDayFaults": tperf.CHURN_DAY_FAULTS,
             "ChurnRebalance": tperf.CHURN_REBALANCE}[name]
    assert const == entry


UNGATE = [
    {"opcode": "createNodes", "count": 5},
    {"opcode": "createPods", "count": 12,
     "podTemplate": {"scheduling_gates": ["hold"]}},
    {"opcode": "sleep", "duration": 0.2},
    {"opcode": "ungatePods", "collectMetrics": True},
]


def test_ungate_pods_matches_the_reference():
    want = _run(jperf.PerfRunner(), UNGATE)
    got = _run(_port(), UNGATE)
    for res in (got, want):
        assert res.scheduled_total == 12 and res.measured_pods == 12
        assert res.throughput > 0
    runner = _port(gated_runner_cls(tperf.PerfRunner),
                   TorchBackend(device="cpu"))
    res = _run(runner, UNGATE)
    assert runner.bound_at_measure == 0 and len(runner.bound_names) == 12
    assert res.measured_pods == 12 and res.scheduled_total == 12


STORM = [
    {"opcode": "startAgents", "count": 40, "leasePeriod": 10.0},
    {"opcode": "createPods", "count": 20},
    {"opcode": "barrier"},
    {"opcode": "relistStorm"},
    {"opcode": "createPods", "count": 10, "collectMetrics": True},
    {"opcode": "barrier"},
]


def test_relist_storm_matches_the_reference():
    want = _run(jperf.PerfRunner(), STORM).as_dict()
    runner = _port(storm_runner_cls(tperf.PerfRunner))
    res = _run(runner, STORM)
    got = res.as_dict()
    keys = ("relist_storm_agents", "relist_storm_cache_hits",
            "relist_storm_cache_misses", "measured_pods", "scheduled_total")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert storm_violations(runner, res, 40) == []
    assert got["relist_storm_agents"] == 40 and got["scheduled_total"] == 30
    assert got["relist_storm_seconds"] > 0


CHURN = [
    {"opcode": "createNodes", "count": 5},
    {"opcode": "createPods", "count": 10},
    {"opcode": "barrier"},
    {"opcode": "churn", "count": 4},
    {"opcode": "barrier"},
]


async def _pods_after(perf, runner, template):
    """Run `template` and list the store's pods after it (taken from the
    package's `new_cluster_store`: the reference's runner has no
    `_drive`)."""
    made = []
    orig = perf.new_cluster_store

    def keep(*a, **kw):
        made.append(orig(*a, **kw))
        return made[-1]

    perf.new_cluster_store = keep
    try:
        res = await runner.run(template, {}, timeout=DEADLINE)
    finally:
        perf.new_cluster_store = orig
    pods = (await made[0].list("pods")).items
    return res, sorted((p["metadata"]["name"],
                        bool(p["spec"].get("nodeName"))) for p in pods)


def test_churn_opcode_matches_the_reference():
    res, got = asyncio.run(_pods_after(tperf, _port(), CHURN))
    jres, want = asyncio.run(_pods_after(jperf, jperf.PerfRunner(), CHURN))
    assert got == want
    assert len(got) == 10 and all(b for _, b in got)
    assert {n for n, _ in got} >= {f"pod-{i}" for i in range(10, 14)}
    assert res.scheduled_total == jres.scheduled_total == 14


DEATH = {"initNodes": 60, "warmupPods": 30, "rate": 20, "duration": 2.5,
         "faultAt": 0.5, "grace": 1.0}


def test_node_death_window():
    template = tperf.CHURN_DAY_FAULTS["workloadTemplate"]
    want = _run(jperf.PerfRunner(), template, DEATH).churn_faults
    got = _run(_port(), template, DEATH).churn_faults
    keys = ("kind", "at", "node", "recovered")
    assert [{k: r[k] for k in keys} for r in got] == \
        [{k: r[k] for k in keys} for r in want]

    class Keeping(tperf.PerfRunner):
        async def _drive(self, template_ops, params, timeout, store,
                         metrics, sched, factory):
            self.store = store
            return await super()._drive(template_ops, params, timeout,
                                        store, metrics, sched, factory)

    runner = _port(Keeping, TorchBackend(device="cpu"))
    res = _run(runner, template, DEATH)
    assert node_death_violations(runner, res) == []
    rec = res.churn_faults[0]
    assert rec["recovered"] and rec["displaced_pods"] >= 1
    assert res.churn_recovery_seconds_max == rec["recovery_s"]


REBALANCE = {"initNodes": 40, "warmupPods": 80, "rate": 8, "duration": 3.0,
             "budget": 4, "waveCount": 18}


@pytest.mark.parametrize("enabled", [False, True])
def test_descheduler_window(enabled):
    template = tperf.CHURN_REBALANCE["workloadTemplate"]
    params = dict(REBALANCE, descheduler=enabled)
    cfg = tperf.CHURN_REBALANCE["schedulerConfig"]
    with counted_descheduler(torch) as log:
        res = _run(_port(backend=TorchBackend(device="cpu"),
                         scheduler_config=cfg), template, params)
    assert rebalance_violations(res, log["cycles"], 4, enabled) == []
    assert res.churn_faults_injected == {"rolloutWave": 2}
    curve = res.churn_fragmentation_curve
    assert all(len(p) == 3 for p in curve) and curve[0][0] < 0.1
    if enabled:
        assert res.churn_descheduler_evictions > 0
        assert res.churn_rebalance_recovery_s is not None
        assert log["last_inputs"][0].shape == (40, 2)
        jres = _run(jperf.PerfRunner(scheduler_config=cfg), template, params)
        assert jres.churn_descheduler_evictions > 0
    else:
        assert res.churn_descheduler_evictions == 0
        assert res.churn_rebalance_recovery_s is None


def test_provenance_on_the_cpu(monkeypatch):
    res = _run(_port(backend=TorchBackend(device="cpu")), UNGATE)
    prov = res.solve_provenance
    assert prov == solve_provenance("cpu")
    assert prov["platform"] == "cpu" and prov["solve_kernel"] == "plain"
    assert prov["torch_version"] == torch.__version__
    assert prov["cpu_count"] == os.cpu_count()
    assert "card_name" not in prov and "power_limit" not in prov
    assert res.as_dict()["solve_provenance"] == prov
    assert _run(_port(), UNGATE).solve_provenance == {}

    def fail(*a, **kw):
        raise subprocess.CalledProcessError(9, a[0])

    monkeypatch.setattr(tbackend.subprocess, "run", fail)
    with pytest.raises(subprocess.CalledProcessError):
        solve_provenance("cuda:0")


def test_profile_dir_writes_the_measured_window(tmp_path, monkeypatch):
    trace_dir = tmp_path / "traces"
    res = _run(_port(backend=TorchBackend(device="cpu"),
                     profile_dir=str(trace_dir)), UNGATE)
    assert res.measured_pods == 12
    files = sorted(trace_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)
    with pytest.raises(ValueError, match="profile_dir"):
        tperf.PerfRunner(profile_dir=str(trace_dir))
    backend = TorchBackend(device="cpu")
    backend.start_profile(str(trace_dir))
    with pytest.raises(RuntimeError, match="already"):
        backend.start_profile(str(trace_dir))
    assert backend.stop_profile().endswith(".json")
    assert backend.stop_profile() is None

    class Broken:
        def __init__(self, *a, **kw):
            pass

        def start(self):
            raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler, "profile", Broken)
    with pytest.raises(RuntimeError, match="unavailable"):
        backend.start_profile(str(trace_dir))
    with pytest.raises(RuntimeError, match="unavailable"):
        _run(_port(backend=TorchBackend(device="cpu"),
                   profile_dir=str(tmp_path / "t2")), copy.deepcopy(UNGATE))
