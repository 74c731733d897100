"""The port's scheduler loop on the CPU against the JAX package's.

Both packages' `Scheduler.run` drive the same seeded workload
(`chip_smoke.loop_cluster`: 25 nodes of three shapes with taints, a zone
label and a cordoned node; pods with random requests and priorities,
tolerations, zone selectors, preferred node affinity, and pods that fit
nowhere), each package's objects built by its own make_node / make_pod,
through the same harness (`chip_smoke.run_loop`) and the same profile (the
six Filter/Score plugins plus PrioritySort, SchedulingGates and
DefaultBinder); the port on `TorchBackend(device="cpu", max_batch=16)`,
the reference on `TPUBackend(max_batch=16, mesh=None)`.

- Pre-created (every pod queued before `run` opens the loop, one pop),
  with the serving tier on and off: the same `spec.nodeName` for every
  pod, the same unschedulable set, the same FailedScheduling messages,
  the same fast-path count and the same attempt counts by result; no node
  over capacity.
- Lone pods under KTPU_SERVING=0, each awaited (a misfit last): every
  one takes the seeded host path (a one-pod dispatch), and the
  placements and messages are identical (seed 42).
- Serving on with a trickle of lone pods: the fast path places pods.
- No fallback: a backend whose `assign` raises, and a fast path that
  raises, each make `run` raise, with no pod bound and no
  `backend_fallback` attempt counted.

Tolerance: none.
"""

import asyncio
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (LoopRun, loop_cluster, over_capacity, port_loop_api,
                        run_loop)
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.client import InformerFactory as JInformerFactory
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler.plugins.registry import DEFAULT_PLUGINS
from kubernetes_tpu_torch.serving import SinglePodFastPath

JAX_API = SimpleNamespace(
    make_node=jmake_node, make_pod=jmake_pod,
    InformerFactory=JInformerFactory, Scheduler=JScheduler,
    install_core_validation=jinstall, new_cluster_store=jnew_store)
PORT_API = port_loop_api()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def attempts(metrics) -> dict:
    return {r: metrics.schedule_attempts.value(
        result=r, profile="default-scheduler")
        for r in ("scheduled", "unschedulable", "error", "backend_fallback")}


def both(nodes, pods, trickle=False):
    port = asyncio.run(run_loop(PORT_API, nodes, pods, TorchBackend(
        device="cpu", max_batch=16), 128, trickle=trickle))
    ref = asyncio.run(run_loop(JAX_API, nodes, pods, TPUBackend(
        max_batch=16, mesh=None), 128, trickle=trickle))
    return port, ref


def test_default_profile_is_the_loop_profile():
    assert DEFAULT_PLUGINS == [
        "PrioritySort", "SchedulingGates", "NodeUnschedulable", "NodeName",
        "TaintToleration", "NodeAffinity", "NodeResourcesFit",
        "NodeResourcesBalancedAllocation", "DefaultBinder"]


@pytest.mark.parametrize("serving", ["1", "0"], ids=["serving", "no-serving"])
@pytest.mark.parametrize("seed", [3, 5])
def test_precreated_workload_matches_reference(monkeypatch, serving, seed):
    monkeypatch.setenv("KTPU_SERVING", serving)
    nodes, pods = loop_cluster(seed, 25, 60)
    port, ref = both(nodes, pods)
    assert port["assignments"] == ref["assignments"]
    assert port["failed"] == ref["failed"]
    unsched = {k for k, v in port["assignments"].items() if v is None}
    assert unsched and unsched == set(port["failed"])
    assert attempts(port["metrics"]) == attempts(ref["metrics"])
    fast = port["metrics"].serving_fast_path_pods.value()
    assert fast == ref["metrics"].serving_fast_path_pods.value()
    assert (fast > 0) == (serving == "1")
    assert (port["serving"] is None) == (serving == "0")
    assert not over_capacity(port["nodes"], port["pods"])


def test_lone_pods_take_the_host_path_as_the_reference(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "0")
    nodes, _ = loop_cluster(3, 25, 0)
    _, lone = loop_cluster(11, 25, 60, "lone")
    # One misfit, last: a parked pod is retried when a later pod is added
    # (Pod/Add has no hint, so it requeues), and the retry can race the
    # next lone pod into one pop.
    lone = [pod for pod in lone if pod[1]["priority"] >= 0][:29] \
        + [pod for pod in lone if pod[1]["priority"] < 0][:1]
    port, ref = both(nodes, lone, trickle=True)
    assert port["assignments"] == ref["assignments"]
    assert port["failed"] == ref["failed"] != {}
    assert attempts(port["metrics"]) == attempts(ref["metrics"])
    assert port["metrics"].solve_duration.count() == 0  # no backend chunk


def test_serving_trickle_takes_the_fast_path(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "1")
    nodes, _ = loop_cluster(3, 25, 0)
    _, lone = loop_cluster(12, 25, 24, "lone")
    lone = [(n, kw) for n, kw in lone if kw["priority"] >= 0]
    got = asyncio.run(run_loop(PORT_API, nodes, lone, TorchBackend(
        device="cpu", max_batch=16), 128, trickle=True))
    assert got["metrics"].serving_fast_path_pods.value() > 0
    assert all(got["assignments"].values())
    assert not over_capacity(got["nodes"], got["pods"])


class RaisingBackend(TorchBackend):
    def assign(self, pods, snapshot, fwk):
        raise RuntimeError("device lost")


async def raising_run(backend, pods) -> tuple[dict, dict]:
    nodes, _ = loop_cluster(3, 25, 0)
    lr = LoopRun(PORT_API, backend, 128)
    await lr.start(nodes)
    try:
        await lr.create(pods)
        await lr.wait(lambda: lr.queued() == len(pods), "pods queued")
        lr.open()
        with pytest.raises(RuntimeError, match="device lost"):
            await lr.wait(lambda: False, "the loop raising", timeout=60.0)
        assignments, *_ = await lr.results()
        return assignments, attempts(lr.sched.metrics)
    finally:
        await lr.close()


def test_raising_backend_makes_run_raise(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "0")
    _, pods = loop_cluster(3, 25, 10)
    assignments, counts = asyncio.run(raising_run(
        RaisingBackend(device="cpu", max_batch=16), pods))
    assert not any(assignments.values())
    assert counts["backend_fallback"] == 0 and counts["scheduled"] == 0


def test_raising_fast_path_makes_run_raise(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "1")

    def lost(self, pi, snapshot, fwk, record=True):
        raise RuntimeError("device lost")
    monkeypatch.setattr(SinglePodFastPath, "try_schedule", lost)
    _, pods = loop_cluster(3, 25, 10)
    assignments, counts = asyncio.run(raising_run(
        TorchBackend(device="cpu", max_batch=16), pods))
    assert not any(assignments.values())
    assert counts["scheduled"] == 0
