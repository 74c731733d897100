"""PolicyScale through the port's runner on the CPU against the JAX
package's.

- `POLICY_SCALE` equals the PolicyScale entry the JAX `load_config`
  reads from `performance-config.yaml`.
- PolicyScale's template cut to 50 nodes, 20 + 100 pods and 100 policies
  over 10 tenants, through both runners on the host path (no backend),
  over the KTPU wire and over HTTP, with a Metadata audit rule for pods:
  the same bound count, measured and scheduled counts, and the same
  policy evaluations, index hits, residue scans, rebuilds and audit
  events in the measured window. The port's event recorder writes its
  last events before the runner closes the client, so it logs no
  "event drain error".
- The same cut through the port's runner with `TorchBackend(device="cpu")`
  over the wire passes phase 18(a)'s gates (`chip_smoke.policy_violations`:
  every pod bound, no denial, `POLICY_SCALE_EVALS_PER_POD` evaluations per
  measured pod, index hits), with the plain solve in its provenance and
  at least one backend dispatch.
- `run_suite` takes a family's `throughApiserver`, `policyCount`,
  `policyTenants` and `auditLevel` and runs it; `main` takes
  `--through-apiserver`.
- No fallback across the boundary: a backend that raises inside a wire
  run fails the run with its exception, a server that fails to start
  fails it with the server's error (and stops the store), and a wire
  codec the port does not know is refused.

Tolerance: none (counts are exact).
"""

import asyncio
import copy
import json
import logging
from pathlib import Path

import pytest
import torch

import chip_smoke
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from test_torch_apiserver import reference_wire_in_tmpdir  # noqa: F401

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"
CUT = {"initNodes": 50, "initPods": 20, "measurePods": 100}
POLICIES, TENANTS = 100, 10
AUDIT = [{"level": "Metadata", "resources": ["pods"]}]
COUNTERS = ("measured_pods", "scheduled_total", "policy_evaluations_total",
            "policy_index_hits_total", "policy_index_residue_scans_total",
            "policy_index_rebuilds_total", "audit_events_total",
            "audit_events_dropped_total")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def _short_bookmarks(monkeypatch):
    """An HTTP server's stop waits for each open watch's next frame; a
    short bookmark interval keeps that wait short in both packages."""
    from kubernetes_tpu.store import mvcc as jmvcc
    from kubernetes_tpu_torch.store import mvcc as tmvcc
    for m in (jmvcc, tmvcc):
        monkeypatch.setattr(m, "BOOKMARK_INTERVAL_S", 0.05)


def test_policy_scale_constant_equals_the_yaml_entry():
    entry = next(c for c in jperf.load_config(str(YAML))
                 if c["name"] == "PolicyScale")
    assert tperf.POLICY_SCALE == entry


def keeping(perf):
    """The package's PerfRunner keeping its backing store, read after the
    run (both packages' `_drive` take it fourth)."""
    class Keeping(perf.PerfRunner):
        async def _drive(self, *args):
            self.backing = args[3]
            return await super()._drive(*args)
    return Keeping


def run_cut(perf, boundary, backend=None, batch_size=1):
    runner = keeping(perf)(backend=backend, batch_size=batch_size,
                           through_apiserver=boundary,
                           policy_count=POLICIES, policy_tenants=TENANTS,
                           audit_rules=copy.deepcopy(AUDIT))
    res = asyncio.run(runner.run(
        copy.deepcopy(tperf.POLICY_SCALE["workloadTemplate"]), CUT,
        timeout=120.0))
    pods = asyncio.run(runner.backing.list("pods")).items
    return runner, res, pods


@pytest.mark.parametrize("boundary", ["wire", "http"])
@pytest.mark.usefixtures("reference_wire_in_tmpdir")
def test_policy_scale_cut_matches_the_reference(boundary, caplog):
    out = {}
    for name, perf in (("jax", jperf), ("torch", tperf)):
        _, res, pods = run_cut(perf, boundary)
        bound = sum(bool(p["spec"].get("nodeName")) for p in pods)
        out[name] = (bound, len(pods),
                     {k: getattr(res, k) for k in COUNTERS})
    assert out["torch"] == out["jax"]
    assert [r.getMessage() for r in caplog.records
            if r.name == "kubernetes_tpu_torch.client.events"
            and r.levelno >= logging.WARNING] == []
    bound, total, counters = out["jax"]
    assert bound == total == 120 and counters["measured_pods"] == 100
    assert counters["policy_evaluations_total"] == \
        100 * chip_smoke.POLICY_SCALE_EVALS_PER_POD
    assert counters["audit_events_total"] > 0


def test_policy_scale_cut_passes_phase_18_gates_on_torch_backend():
    runner, res, pods = run_cut(tperf, "wire",
                                backend=TorchBackend(device="cpu"),
                                batch_size=16384)
    assert chip_smoke.policy_violations(
        runner, res, pods, 120, chip_smoke.POLICY_SCALE_EVALS_PER_POD) == []
    assert res.solve_provenance["solve_kernel"] == "plain"
    assert res.solver_solve_chunks >= 1
    assert res.policy_index_residue_scans_total == 0


def test_run_suite_takes_the_boundary_keys(capsys, tmp_path):
    case = copy.deepcopy(tperf.SCHEDULING_BASIC)
    case.update({"name": "Boundary", "throughApiserver": "wire",
                 "policyCount": 10, "policyTenants": 0,
                 "auditLevel": "Metadata"})
    case["workloads"] = [{"name": "tiny", "params": {
        "initNodes": 5, "initPods": 5, "measurePods": 20}}]
    got = tperf.run_suite([case])["Boundary/tiny"]
    assert got["measured_pods"] == 20 and got["scheduled_total"] == 25
    assert got["policy_evaluations_total"] == 20 * 10
    assert got["audit_events_total"] > 0
    # The CLI's boundary for families that name none.
    import yaml
    plain = copy.deepcopy(tperf.SCHEDULING_BASIC)
    plain["workloads"] = case["workloads"]
    cfg = tmp_path / "suite.yaml"
    cfg.write_text(yaml.safe_dump([plain]))
    assert tperf.main([str(cfg), "--backend", "host", "--through-apiserver",
                       "http", "--timeout", "120"]) == 0
    out = json.loads(capsys.readouterr().out)["SchedulingBasic/tiny"]
    assert out["measured_pods"] == 20
    assert out["policy_evaluations_total"] == 0


class RaisingBackend(TorchBackend):
    def _finalize_chunk(self, run, assign_np, ctx):
        raise RuntimeError("device lost")


@pytest.mark.parametrize("boundary", ["wire", "http"])
def test_boundary_runs_have_no_fallback(monkeypatch, boundary):
    from kubernetes_tpu_torch.apiserver import server as tserver
    from kubernetes_tpu_torch.apiserver import wire as twire

    monkeypatch.setenv("KTPU_SERVING", "0")
    template = tperf.SCHEDULING_BASIC["workloadTemplate"]
    params = {"initNodes": 5, "initPods": 20, "measurePods": 20}
    runner = tperf.PerfRunner(
        backend=RaisingBackend(device="cpu", max_batch=16),
        batch_size=16384, through_apiserver=boundary, policy_count=2)
    with pytest.raises(RuntimeError, match="device lost"):
        asyncio.run(runner.run(template, params, timeout=60.0))

    stopped = []
    orig_new_store = tperf.new_cluster_store

    def tracked(*a, **kw):
        store = orig_new_store(*a, **kw)
        stop = store.stop
        store.stop = lambda: (stopped.append(True), stop())[1]
        return store

    async def refuse(self):
        raise OSError("address in use")

    monkeypatch.setattr(tperf, "new_cluster_store", tracked)
    monkeypatch.setattr(tserver.APIServer, "start", refuse)
    with pytest.raises(OSError, match="address in use"):
        asyncio.run(tperf.PerfRunner(through_apiserver=boundary).run(
            template, params, timeout=60.0))
    assert stopped == [True]
    with pytest.raises(ValueError, match="codec"):
        twire.WireStore("unix:/nonexistent", enc="yaml")
