"""The port's rebalance descheduler and `solver.consolidation_scores`
against the JAX package on the CPU.

- `consolidation_scores` on `chip_smoke.consolidation_case`'s fixtures
  (uniform nodes that tie everywhere, a node exactly at the threshold, a
  resource with zero allocatable on some nodes, empty nodes, invalid rows,
  random free planes) at several seeds and sizes: bitwise equal to the
  JAX function's (the scores as int32 bits, -inf included).
- `DeschedulerController.rebalance_once` on identical stores in both
  packages (the port's on `device="cpu"`): the same evicted pods, the
  same replacements (name and spec; the uid is fresh in each), the same
  eviction counts and metric, under the budget cap of
  `tests/test_optimal_smoke.py:232` (12 spread pods, budget 3), the
  no-headroom cluster of `:280`, and a mixed cluster whose uniform nodes
  tie (the host `np.argsort` order decides which drain).
- No fallback: with no device and no card the controller refuses to be
  built; `KTPU_DESCHEDULER_BUDGET` is read live as in the reference.

Tolerance: none (bitwise scores, identical evictions).
"""

import asyncio
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import CONSOLIDATION_CASES, consolidation_case
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.client import InformerFactory as JFactory
from kubernetes_tpu.controllers import DeschedulerController as JDesch
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers import DeschedulerController
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.store import new_cluster_store
from kubernetes_tpu_torch.utils import flags as tflags

JAX = SimpleNamespace(make_node=jmake_node, make_pod=jmake_pod,
                      Factory=JFactory, new_store=jnew_store, flags=jflags,
                      desch=lambda store, **kw: JDesch(store, **kw))
PORT = SimpleNamespace(make_node=make_node, make_pod=make_pod,
                       Factory=InformerFactory, new_store=new_cluster_store,
                       flags=tflags,
                       desch=lambda store, **kw: DeschedulerController(
                           store, device="cpu", **kw))


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("n", [1, 96, 1000])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("kind", CONSOLIDATION_CASES)
def test_consolidation_scores_bitwise(kind, seed, n):
    free, alloc, used, valid, thr = consolidation_case(kind, seed, n)
    want = jsolver.consolidation_scores(
        *map(jnp.asarray, (free, alloc, used, valid)), thr)
    got = tsolver.consolidation_scores(
        *map(torch.from_numpy, (free, alloc, used, valid)), thr)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_consolidation_fixtures_reach_every_arm():
    free, alloc, used, valid, thr = consolidation_case("at-threshold")
    got = tsolver.consolidation_scores(
        *map(torch.from_numpy, (free, alloc, used, valid)), thr).numpy()
    # Two pods leave exactly the threshold (eligible); three leave less.
    assert np.all(got[::2] == np.float32(0.5))
    assert np.all(np.isneginf(got[1::2]))
    for kind, arm in (("empty", lambda u, v: u == 0),
                      ("invalid", lambda u, v: ~v)):
        free, alloc, used, valid, thr = consolidation_case(kind, 3)
        got = tsolver.consolidation_scores(
            *map(torch.from_numpy, (free, alloc, used, valid)), thr).numpy()
        mask = arm(used, valid)
        assert mask.any() and np.all(np.isneginf(got[mask]))
        assert np.isfinite(got).any()
    free, alloc, used, valid, thr = consolidation_case("uniform")
    got = tsolver.consolidation_scores(
        *map(torch.from_numpy, (free, alloc, used, valid)), thr).numpy()
    assert len(set(got.tolist())) == 1 and np.isfinite(got).all()


async def _rebalance_script(api, nodes: list, pods: list, budget,
                            threshold: float, env_budget=None) -> dict:
    store = api.new_store()
    try:
        for name, alloc in nodes:
            await store.create("nodes", api.make_node(
                name, allocatable=alloc))
        for name, node, req in pods:
            await store.create("pods", api.make_pod(
                name, requests=req, node_name=node, phase="Running",
                uid=f"{name}-uid"))
        factory = api.Factory(store)
        d = api.desch(store, budget=budget, threshold=threshold)
        d.setup(factory)
        factory.start()
        await factory.wait_for_sync()
        if env_budget is None:
            evicted = await d.rebalance_once()
        else:
            with api.flags.scoped_set("KTPU_DESCHEDULER_BUDGET", env_budget):
                evicted = await d.rebalance_once()
        left = sorted(p["metadata"]["name"]
                      for p in (await store.list("pods")).items)
        twins = []
        for p in (await store.list("pods")).items:
            if "-reb" in p["metadata"]["name"]:
                meta = dict(p["metadata"])
                for k in ("uid", "resourceVersion", "creationTimestamp"):
                    meta.pop(k, None)
                twins.append((meta, p["spec"], p["status"]))
        twins.sort(key=lambda t: t[0]["name"])
        factory.stop()
        return {"evicted": evicted, "evictions": d.evictions,
                "metric": d.metrics.evictions.value(), "left": left,
                "twins": twins}
    finally:
        store.stop()


_BIG = {"cpu": "8", "memory": "32Gi", "pods": "110"}
_SMALL = {"cpu": "1", "memory": "4Gi", "pods": "110"}
_RCASES = {
    # tests/test_optimal_smoke.py:232: one small pod on each of 12 nodes,
    # every node above the threshold, the budget from the flag.
    "budget-cap": (
        [(f"dn{i}", _BIG) for i in range(12)],
        [(f"dp{i}", f"dn{i}", {"cpu": "500m"}) for i in range(12)],
        None, 0.2, "3"),
    # :280: no spare capacity anywhere, so nothing may be evicted.
    "no-headroom": (
        [(f"fn{i}", _SMALL) for i in range(4)],
        [(f"fp{i}", f"fn{i}", {"cpu": "800m"}) for i in range(4)],
        8, 0.1, None),
    # Uniform half-empty nodes tie; packed nodes, an empty node and a
    # node whose pods need more than the budget left stay put.
    "ties": (
        [(f"n{i}", {"cpu": "4", "memory": "16Gi", "pods": "16"})
         for i in range(10)],
        [(f"a{i}-{k}", f"n{i}", {"cpu": "500m", "memory": "1Gi"})
         for i in range(6) for k in range(2)]
        + [(f"b{k}", "n6", {"cpu": "500m", "memory": "1Gi"})
           for k in range(7)]
        + [(f"c{k}", "n7", {"cpu": "1", "memory": "4Gi"})
           for k in range(4)]
        + [(f"d{k}", "n8", {"cpu": "250m", "memory": "512Mi"})
           for k in range(3)],
        5, 0.4, None),
}


@pytest.mark.parametrize("case", sorted(_RCASES))
def test_rebalance_once_matches_the_reference(case):
    nodes, pods, budget, threshold, env_budget = _RCASES[case]
    got = asyncio.run(asyncio.wait_for(_rebalance_script(
        PORT, nodes, pods, budget, threshold, env_budget), 60.0))
    want = asyncio.run(asyncio.wait_for(_rebalance_script(
        JAX, nodes, pods, budget, threshold, env_budget), 60.0))
    assert got == want
    assert got["evicted"] == got["evictions"] == got["metric"] \
        == len(got["twins"])
    assert len(got["left"]) == len(pods)
    for meta, spec, status in got["twins"]:
        assert "nodeName" not in spec and status == {"phase": "Pending"}
    if case == "budget-cap":
        assert 0 < got["evicted"] <= 3
    elif case == "no-headroom":
        assert got["evicted"] == 0
    else:
        assert 0 < got["evicted"] <= 5


def test_no_card_no_controller(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    store = new_cluster_store()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            DeschedulerController(store)
        d = DeschedulerController(store, device="cpu")
        assert d.device == torch.device("cpu")
        assert d.budget == tflags.get("KTPU_DESCHEDULER_BUDGET") == 8
        assert tflags.get("KTPU_DESCHEDULER") is False
    finally:
        store.stop()
