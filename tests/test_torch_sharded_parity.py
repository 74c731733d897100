"""Sharded against unsharded scheduling, and the per-shard tensor accounting.

- The loop: the reference's randomized parity fixture (48 nodes of mixed
  capacities and zone labels, 96 pods, 30% of them with a zone selector;
  seeds 11 and 23) goes through the port's `Scheduler` with
  `TorchBackend(device="cpu")` over `new_cluster_store(shards=S)` for S in
  {1, 2, 4, 8}, with the serving tier on (lone pods on the fast path) and
  off (every pod in a chunk). Every pod is queued before the loop opens
  (the serving tier's routing reads the wall clock, so a trickle would
  not be exact).
  The assignment maps must be equal, not merely equivalent, and the node
  informer on a sharded store must run one reflector per shard
  (`ShardedInformer`), so the parity cannot come from a silent fallback
  to one stream.
- The tensors: `ClusterTensors`' `prep_shards`, `shard_ids` and
  `shard_rebuilds`, and the backend's
  `scheduler_tpu_shard_tensor_rebuilds_total`, equal the JAX package's over
  a sequence of incremental snapshots of each package's `SchedulerCache`
  (binds, a node update, a node removal, a node added), at a pinned shard
  count and under the flagless threshold policy; and the delta build's
  arrays equal a full build's.
Tolerance: none.
"""

import asyncio
import random
import time

import numpy as np
import pytest

from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.metrics import registry as jregistry
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.ops import tensorize as jtensorize
from kubernetes_tpu.scheduler import cache as jcache
from kubernetes_tpu.scheduler import types as jstypes
from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.client import (
    InformerFactory,
    ResourceEventHandler,
    ShardedInformer,
)
from kubernetes_tpu_torch.metrics import registry as tregistry
from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops import tensorize as ttensorize
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.scheduler import cache as tcache
from kubernetes_tpu_torch.scheduler import types as tstypes
from kubernetes_tpu_torch.store import (
    install_core_validation,
    new_cluster_store,
)

ZONES = ("a", "b", "c")


def random_cluster(seed: int, n_nodes: int = 48, n_pods: int = 96):
    """The reference's fixture (tests/test_sharded_parity.py): plentiful
    capacity so every pod schedules."""
    rng = random.Random(seed)
    nodes = []
    for i in range(n_nodes):
        nodes.append(dict(
            name=f"n-{i:03d}",
            allocatable={"cpu": str(rng.choice((4, 8, 16))),
                         "memory": rng.choice(("16Gi", "32Gi", "64Gi")),
                         "pods": "110"},
            labels={"zone": rng.choice(ZONES)}))
    pods = []
    for i in range(n_pods):
        spec = dict(
            name=f"p-{i:03d}",
            requests={"cpu": f"{rng.choice((100, 250, 500))}m",
                      "memory": rng.choice(("128Mi", "256Mi", "512Mi"))})
        if rng.random() < 0.3:
            spec["node_selector"] = {"zone": rng.choice(ZONES)}
        pods.append(spec)
    return nodes, pods


async def schedule(shards: int, nodes, pods, batch: int = 64) -> dict:
    """Create nodes, sync the informers, create and queue every pod, then
    run the loop until every pod is bound. Returns the assignments, the
    node informer's shard count and the backend's shard accounting."""
    store = new_cluster_store(shards=shards)
    install_core_validation(store)
    for spec in nodes:
        await store.create("nodes", ttypes.make_node(**spec))
    metrics = SchedulerMetrics()
    backend = TorchBackend(device="cpu", max_batch=batch)
    sched = Scheduler(store, seed=42, backend=backend, metrics=metrics)
    factory = InformerFactory(store)
    await sched.setup_informers(factory)
    bound: dict[str, str] = {}

    def track(obj):
        node = obj.get("spec", {}).get("nodeName")
        if node:
            bound[namespaced_name(obj)] = node

    factory.informer("pods").add_event_handler(ResourceEventHandler(
        on_add=track, on_update=lambda old, new: track(new)))
    factory.start()
    await factory.wait_for_sync()
    run_task = None
    try:
        for spec in pods:
            await store.create("pods", ttypes.make_pod(**spec))
        deadline = time.monotonic() + 60
        while sched.queue.stats()["active"] < len(pods):
            assert time.monotonic() < deadline, "pods not queued"
            await asyncio.sleep(0.005)
        run_task = asyncio.ensure_future(sched.run(batch_size=batch))
        while len(bound) < len(pods):
            if run_task.done():
                raise run_task.exception() or RuntimeError("loop ended")
            assert time.monotonic() < deadline, \
                f"only {len(bound)}/{len(pods)} pods bound"
            await asyncio.sleep(0.01)
        informer = factory.informer("nodes")
        return {"bound": dict(bound),
                "informer_shards": getattr(informer, "_shard_count", 1),
                "sharded_informer": isinstance(informer, ShardedInformer),
                "control_shards": backend.control_shards,
                "prep_shards": backend._ct.prep_shards,
                "cross_shard": metrics.cross_shard_reductions.value(),
                "fast_path": metrics.serving_fast_path_pods.value(),
                "rebuilds": sum(
                    metrics.shard_tensor_rebuilds._values.values())}
    finally:
        await sched.stop()
        if run_task is not None:
            run_task.cancel()
            await asyncio.gather(run_task, return_exceptions=True)
        factory.stop()
        store.stop()


@pytest.mark.parametrize("seed,serving", [(11, "1"), (23, "1"), (11, "0")])
def test_sharded_assignment_parity(seed, serving, monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", serving)
    nodes, pods = random_cluster(seed)
    runs = {s: asyncio.run(schedule(s, nodes, pods)) for s in (1, 2, 4, 8)}
    reference = runs[1]["bound"]
    assert len(reference) == len(pods)
    for s, run in runs.items():
        diverged = sum(1 for k in run["bound"]
                       if run["bound"][k] != reference.get(k))
        assert run["bound"] == reference, f"shards={s}: {diverged} differ"
        assert run["sharded_informer"]
        assert run["informer_shards"] == s
        assert run["control_shards"] == s and run["prep_shards"] == s
        assert run["rebuilds"] > 0
        # One cross-shard reduction per pod a chunk solved above one
        # shard (lone pods take the serving fast path).
        chunk_pods = len(pods) - run["fast_path"]
        assert run["cross_shard"] == (0 if s == 1 else chunk_pods)
        if serving == "0":
            assert chunk_pods == len(pods)


def cache_script(pkg: str):
    """A sequence of snapshots from `pkg`'s SchedulerCache: the nodes, two
    rounds of binds, a node's label update, a node removal, a node added,
    another bind. Yields each snapshot."""
    types, stypes, cache_mod = {
        "jax": (jtypes, jstypes, jcache),
        "port": (ttypes, tstypes, tcache)}[pkg]
    cache = cache_mod.SchedulerCache()
    for i in range(40):
        cache.add_node(types.make_node(f"node-{i:02d}"))
    yield cache.update_snapshot()
    rng = np.random.default_rng(5)
    k = 0
    for _ in range(2):
        for _ in range(6):
            pod = types.make_pod(f"p-{k}", requests={"cpu": "500m",
                                                     "memory": "1Gi"})
            pod["spec"]["nodeName"] = f"node-{int(rng.integers(0, 40)):02d}"
            cache.add_pod(stypes.PodInfo(pod))
            k += 1
        yield cache.update_snapshot()
    node = types.make_node("node-07", labels={"tier": "hot"})
    cache.update_node(node)
    yield cache.update_snapshot()
    cache.remove_node("node-13")
    yield cache.update_snapshot()
    cache.add_node(types.make_node("node-99"))
    yield cache.update_snapshot()
    pod = types.make_pod("p-last", requests={"cpu": "1"})
    pod["spec"]["nodeName"] = "node-99"
    cache.add_pod(stypes.PodInfo(pod))
    yield cache.update_snapshot()


def tensor_trace(pkg: str, shards: int | None) -> list:
    tensorize = {"jax": jtensorize, "port": ttensorize}[pkg]
    out, prev = [], None
    for snap in cache_script(pkg):
        ct = tensorize.ClusterTensors(snap, prev=prev, shards=shards)
        ids = None if ct.shard_ids is None else ct.shard_ids.tolist()
        out.append((ct.prep_shards, ids, list(ct.shard_rebuilds),
                    ct.used_q.tolist(), ct.node_names))
        prev = ct
    return out


@pytest.mark.parametrize("shards", [None, 1, 3, 8])
def test_shard_accounting_matches_the_reference(shards, monkeypatch):
    monkeypatch.setenv("KTPU_SHARD_THRESHOLD", "30")
    got = tensor_trace("port", shards)
    assert got == tensor_trace("jax", shards)
    want_s = 8 if shards is None else shards
    assert [g[0] for g in got] == [want_s] * len(got)
    if want_s > 1:
        # The first build rewrites every shard; a round of binds only the
        # shards of the nodes that gained pods.
        assert got[0][2] == list(range(want_s))
        assert 0 < len(got[1][2]) <= want_s


def backend_rebuilds(pkg: str, shards: int) -> list:
    if pkg == "jax":
        backend = jbackend.TPUBackend(max_batch=16, mesh=None)
        metrics = jregistry.SchedulerMetrics()
    else:
        backend = tbackend.TorchBackend(device="cpu", max_batch=16)
        metrics = tregistry.SchedulerMetrics()
    backend.metrics = metrics
    backend.control_shards = shards
    out = []
    for snap in cache_script(pkg):
        backend._tensors(snap)
        out.append(dict(sorted(
            (k[0], v) for k, v in
            metrics.shard_tensor_rebuilds._values.items())))
    return out


@pytest.mark.parametrize("shards", [1, 4])
def test_backend_rebuild_counter_matches_the_reference(shards):
    got = backend_rebuilds("port", shards)
    assert got == backend_rebuilds("jax", shards)
    assert sum(got[-1].values()) > 0


def test_delta_build_equals_a_full_build():
    snaps = list(cache_script("port"))
    prev = ttensorize.ClusterTensors(snaps[0], shards=4)
    delta = ttensorize.ClusterTensors(snaps[1], prev=prev, shards=4)
    full = ttensorize.ClusterTensors(snaps[1], shards=4)
    for name in ("used_q", "used_nz_q", "used_pods", "alloc_q"):
        np.testing.assert_array_equal(getattr(delta, name),
                                      getattr(full, name))
    assert delta.node_names == full.node_names
    assert delta.alloc_q is prev.alloc_q          # shared, not rebuilt
    assert delta.delta_build and not full.delta_build
    assert delta.shard_ids is prev.shard_ids
    assert full.shard_rebuilds == [0, 1, 2, 3]
    assert set(delta.shard_rebuilds) < {0, 1, 2, 3}
