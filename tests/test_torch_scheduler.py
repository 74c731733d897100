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
- No fallback: a backend that raises in `assign`, at its chunk stream's
  first chunk or mid-stream (after the first chunk's pods are bound), and
  a fast path that raises, each make `run` raise, with no pod of a chunk
  not yet yielded bound and no `backend_fallback` attempt counted.

Tolerance: none.
"""

import asyncio
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (AssignOnly, LoopRun, loop_cluster, over_capacity,
                        port_loop_api, run_loop)
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
    """The port's default profile is the reference's whole, in the
    reference's order, with its weights: the four volume plugins after
    NodePorts, DefaultPreemption just before DefaultBinder, Coscheduling
    registered but not enabled."""
    from kubernetes_tpu.scheduler.plugins import registry as jregistry
    from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry

    assert DEFAULT_PLUGINS == [
        "PrioritySort", "SchedulingGates", "NodeUnschedulable", "NodeName",
        "TaintToleration", "NodeAffinity", "NodePorts", "VolumeBinding",
        "VolumeRestrictions", "VolumeZone", "NodeVolumeLimits",
        "NodeResourcesFit", "NodeResourcesBalancedAllocation",
        "InterPodAffinity", "PodTopologySpread", "ImageLocality",
        "DynamicResources", "DefaultPreemption", "DefaultBinder"]
    assert DEFAULT_PLUGINS == jregistry.DEFAULT_PLUGINS
    assert "Coscheduling" in tregistry.IN_TREE
    assert "Coscheduling" not in DEFAULT_PLUGINS
    assert DEFAULT_PLUGINS == [p for p in jregistry.DEFAULT_PLUGINS
                               if p in tregistry.IN_TREE]
    assert tregistry.DEFAULT_SCORE_WEIGHTS == {
        k: v for k, v in jregistry.DEFAULT_SCORE_WEIGHTS.items()
        if k in tregistry.IN_TREE}


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


RAISE_AT = {"assign": 0, "stream-first-chunk": 0, "mid-stream": 1}


def raising_backend(where: str, **kw):
    """A CPU `TorchBackend` whose chunk finalize raises "device lost" at
    the first chunk (`assign`, seen through `chip_smoke.AssignOnly`, or
    the stream's first chunk) or at the second, after the stream yielded
    the first (`mid-stream`)."""
    backend = RaisingBackend(RAISE_AT[where], device="cpu", **kw)
    return AssignOnly(backend) if where == "assign" else backend


class RaisingBackend(TorchBackend):
    def __init__(self, raise_at: int, **kw):
        super().__init__(**kw)
        self.raise_at, self.finalized = raise_at, 0

    def _finalize_chunk(self, run, assign_np, ctx):
        if self.finalized == self.raise_at:
            raise RuntimeError("device lost")
        self.finalized += 1
        return super()._finalize_chunk(run, assign_np, ctx)


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


@pytest.mark.parametrize("where", sorted(RAISE_AT))
def test_raising_backend_makes_run_raise(monkeypatch, where):
    """`run` raises wherever the backend fails: in `assign`, at the
    stream's first chunk, or mid-stream once the first chunk's pods are
    bound; no `backend_fallback` is counted and the pods of the chunks not
    yet yielded stay unbound (no host-path rerun)."""
    monkeypatch.setenv("KTPU_SERVING", "0")
    _, pods = loop_cluster(3, 25, 40)
    assignments, counts = asyncio.run(raising_run(
        raising_backend(where, max_batch=16), pods))
    assert counts["backend_fallback"] == 0
    bound = sum(v is not None for v in assignments.values())
    if where == "mid-stream":
        # The first chunk's 16 pods were yielded: the placed ones bound,
        # the rest failed through the failure wave; no other pod bound.
        assert 0 < counts["scheduled"] == bound <= 16
        assert counts["scheduled"] + counts["unschedulable"] == 16
    else:
        assert bound == 0 and counts["scheduled"] == 0


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
