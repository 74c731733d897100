"""The port's scheduler_perf runner on the CPU against the JAX package's.

- `SCHEDULING_BASIC` equals the SchedulingBasic entry the JAX
  `load_config` reads from `performance-config.yaml`, and the port's
  `load_config()` with no path returns it without a YAML parser.
- A small SchedulingBasic (20 nodes, 50 init pods, 200 measured pods)
  through the port's `run_suite` on `TorchBackend(device="cpu")` binds
  every pod through `Scheduler.run`, and its result keys are the
  reference's (each port key is in the JAX runner's result for the same
  workload on `TPUBackend(max_batch=16, mesh=None)`), with the same
  measured, scheduled and unschedulable counts and the same all-nodes
  fragmentation (placement-invariant once every pod places).
- `main` runs a YAML config on the torch backend, and with no options
  runs TorchBackend on cuda:0 (raising without CUDA); an opcode or a family
  setting that is not ported raises; a barrier raises the loop's own
  exception when a backend raises, in `assign`, at its chunk stream's
  first chunk or mid-stream (no fallback).

Tolerance: none (counts and the fragmentation are exact).
"""

import asyncio
import json
from pathlib import Path

import pytest
import torch

from chip_smoke import AssignOnly
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import scheduler_perf as tperf

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"
SMALL = {"initNodes": 20, "initPods": 50, "measurePods": 200}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def test_scheduling_basic_constant_equals_the_yaml_entry():
    entry = next(c for c in jperf.load_config(str(YAML))
                 if c["name"] == "SchedulingBasic")
    assert tperf.SCHEDULING_BASIC == entry
    assert tperf.load_config() == [entry]
    assert tperf.load_config() is not tperf.load_config()


def small_suite():
    case = tperf.load_config()[0]
    case["workloads"] = [{"name": "small", "params": dict(SMALL)}]
    return [case]


def test_small_scheduling_basic_binds_every_pod_with_reference_keys():
    got = tperf.run_suite(small_suite(), backend_factory=lambda: TorchBackend(
        device="cpu"), batch_size=16384)["SchedulingBasic/small"]
    want = jperf.run_suite(small_suite(), backend_factory=lambda: TPUBackend(
        max_batch=16, mesh=None), batch_size=16384)["SchedulingBasic/small"]
    assert set(got) <= set(want)
    for key in ("measured_pods", "scheduled_total", "unschedulable_total",
                "fragmentation_pct"):
        assert got[key] == want[key], key
    assert got["measured_pods"] == 200 and got["scheduled_total"] == 250
    assert got["unschedulable_total"] == 0
    assert got["throughput_pods_per_sec"] > 0
    assert got["attempt_percentiles_exact"]
    assert got["events_dropped_total"] == 0


def test_runner_without_a_backend_binds_on_the_host_path():
    template = tperf.SCHEDULING_BASIC["workloadTemplate"]
    res = asyncio.run(tperf.PerfRunner(batch_size=1).run(
        template, {"initNodes": 5, "initPods": 10, "measurePods": 20}))
    assert res.measured_pods == 20 and res.scheduled_total == 30
    assert res.solver_solve_chunks == 0
    assert res.serving_fast_path_pods_total == 0


class RaisingBackend(TorchBackend):
    def __init__(self, raise_at: int, **kw):
        super().__init__(**kw)
        self.raise_at, self.finalized = raise_at, 0

    def _finalize_chunk(self, run, assign_np, ctx):
        if self.finalized == self.raise_at:
            raise RuntimeError("device lost")
        self.finalized += 1
        return super()._finalize_chunk(run, assign_np, ctx)


@pytest.mark.parametrize("where", ["assign", "mid-stream",
                                   "stream-first-chunk"])
def test_barrier_raises_the_loops_exception(monkeypatch, where):
    """The runner's barrier raises the loop's exception wherever the
    backend fails: in `assign` (a backend seen through
    `chip_smoke.AssignOnly`), at the stream's first chunk, or mid-stream
    after the first chunk was yielded (16-pod chunks)."""
    monkeypatch.setenv("KTPU_SERVING", "0")
    template = tperf.SCHEDULING_BASIC["workloadTemplate"]
    backend = RaisingBackend(1 if where == "mid-stream" else 0,
                             device="cpu", max_batch=16)
    if where == "assign":
        backend = AssignOnly(backend)
    runner = tperf.PerfRunner(backend=backend, batch_size=16384)
    with pytest.raises(RuntimeError, match="device lost"):
        asyncio.run(runner.run(template, {"initNodes": 5, "initPods": 40,
                                          "measurePods": 20}, timeout=60.0))


def test_main_runs_a_yaml_config(tmp_path, capsys):
    import yaml
    cfg = tmp_path / "suite.yaml"
    cfg.write_text(yaml.safe_dump(small_suite()))
    assert tperf.main([str(cfg), "--backend", "torch", "--device", "cpu",
                       "--filter", "small", "--timeout", "120"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["SchedulingBasic/small"]["measured_pods"] == 200


def test_main_defaults_to_the_card(monkeypatch, capsys):
    """With no options `main` runs TorchBackend on cuda:0 with the
    reference bench's 16384-pod pops; the host path is an opt-in."""
    seen = {}

    def fake_run_suite(config, backend_factory=None, batch_size=1, **kw):
        seen["factory"], seen["batch"] = backend_factory, batch_size
        return {}

    monkeypatch.setattr(tperf, "run_suite", fake_run_suite)
    assert tperf.main([]) == 0
    assert seen["batch"] == 16384
    if torch.cuda.is_available():
        assert seen["factory"]().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            seen["factory"]()
    assert tperf.main(["--device", "cpu"]) == 0
    assert seen["factory"]().device.type == "cpu"
    assert tperf.main(["--backend", "host"]) == 0
    assert seen["factory"] is None and seen["batch"] == 1
    capsys.readouterr()


def test_unported_opcodes_and_settings_raise():
    # Upstream scheduler_perf's createNamespaces is in neither package.
    with pytest.raises(ValueError, match="createNamespaces"):
        asyncio.run(tperf.PerfRunner().run([{"opcode": "createNamespaces"}],
                                           {}))
    suite = small_suite()
    suite[0]["throughApiserver"] = "wire"
    with pytest.raises(NotImplementedError, match="throughApiserver"):
        tperf.run_suite(suite)
