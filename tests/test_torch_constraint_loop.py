"""The constraint families through the port's scheduler loop and serving
fast path against the JAX package's, on the CPU; and the port's
scheduler_perf constants of the constraint families.

- The loop: `chip_smoke.constraint_cluster` (48 nodes in three zones,
  keyless and tainted nodes, residents with anti-affinity and preferred
  terms) with every template of `chip_smoke.constraint_pod` pre-created
  (anti-affinity, zone affinity to hubs, preferred terms, two hard spread
  templates, one under a minDomains deficit, labeled plain pods) through
  the port's `Scheduler.run` with `TorchBackend(device="cpu")` and the
  reference's with `TPUBackend`, serving on and off: the same nodeName
  for every pod, the same FailedScheduling messages (verify-rejected pods
  among them), the same attempt counts; no two `color: blue` pods on one
  node; no node over capacity.
- The fast path's eligibility through the two plugins' activity gates,
  against the JAX `SinglePodFastPath` under the same profile: a plain pod
  against a term-free cluster is eligible; a labeled pod (default spread
  constraints), a pod with required, preferred or anti-affinity terms and
  a pod with a hard spread constraint are not; once a resident carries a
  required anti-affinity term, no pod is.
- `SCHEDULING_POD_ANTI_AFFINITY`, `SCHEDULING_POD_AFFINITY` and
  `TOPOLOGY_SPREADING` equal their entries in the reference's YAML.
- `Scheduler.setup_informers` wires both plugins' NamespaceResolver to
  the namespaces informer; a Namespace added with matching labels moves
  the resolver's epoch, and `TorchBackend` then drops its compiled rows.

Tolerance: none (placements, messages and counts are exact).
"""

import asyncio
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from chip_smoke import (ANTI_BLUE, CONSTRAINT_KINDS, blue_pods_share_a_node,
                        constraint_cluster, constraint_pod, constraint_pods,
                        over_capacity, port_loop_api, run_loop)
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.client import InformerFactory as JInformerFactory
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu.scheduler import Scheduler as JScheduler
from kubernetes_tpu.store import install_core_validation as jinstall
from kubernetes_tpu.store import new_cluster_store as jnew_store
from kubernetes_tpu_torch.api.types import make_pod
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from test_torch_serving import Pair

JAX_API = SimpleNamespace(
    make_node=jmake_node, make_pod=jmake_pod,
    InformerFactory=JInformerFactory, Scheduler=JScheduler,
    install_core_validation=jinstall, new_cluster_store=jnew_store)
PORT_API = port_loop_api()
YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def attempts(metrics) -> dict:
    return {r: metrics.schedule_attempts.value(
        result=r, profile="default-scheduler")
        for r in ("scheduled", "unschedulable", "error")}


@pytest.mark.parametrize("serving", ["1", "0"], ids=["serving", "no-serving"])
def test_constraint_loop_matches_reference(monkeypatch, serving):
    monkeypatch.setenv("KTPU_SERVING", serving)
    nodes, residents = constraint_cluster(5, 48)
    pods = constraint_pods(CONSTRAINT_KINDS, 144)
    port = asyncio.run(run_loop(PORT_API, nodes, pods, TorchBackend(
        device="cpu", max_batch=64), 256, residents=residents))
    ref = asyncio.run(run_loop(JAX_API, nodes, pods, TPUBackend(
        max_batch=64, mesh=None), 256, residents=residents))
    assert port["assignments"] == ref["assignments"]
    assert port["failed"] == ref["failed"]
    assert attempts(port["metrics"]) == attempts(ref["metrics"])
    pending = {name for name, _ in pods}
    placed = [k for k, v in port["assignments"].items()
              if k in pending and v is not None]
    assert 0 < len(placed) < len(pending) and port["failed"]
    assert not blue_pods_share_a_node(port["pods"])
    assert not over_capacity(port["nodes"], port["pods"])


def test_fast_path_eligibility_matches_reference():
    pair = Pair(12, hetero=False)

    def place(name, **kw):
        kw.setdefault("requests", {"cpu": "100m"})
        return pair.place(make_pod(name, uid=name, **kw))

    want, got, _ = place("plain")
    assert got == want is not None
    ineligible = [
        ("labeled", {"labels": {"app": "web"}}),
        ("anti", constraint_pod("anti", 0)[1]),
        ("worker", constraint_pod("worker", 1)[1]),
        ("pref", constraint_pod("pref", 2)[1]),
        ("spread", constraint_pod("spread", 3)[1]),
    ]
    for name, kw in ineligible:
        want, got, _ = place(name, **kw)
        assert got is want is None, name
    assert pair.counters(pair.tfp) == pair.counters(pair.jfp) \
        == (1, len(ineligible), 0)
    guard = make_pod("guard", uid="guard", node_name="n1",
                     affinity=ANTI_BLUE, requests={"cpu": "100m"})
    pair.assume(guard, "n1")
    want, got, _ = place("plain-after")
    assert got is want is None


def test_constraint_family_constants_equal_the_yaml_entries():
    entries = {c["name"]: c for c in jperf.load_config(str(YAML))}
    for const in (tperf.SCHEDULING_POD_ANTI_AFFINITY,
                  tperf.SCHEDULING_POD_AFFINITY, tperf.TOPOLOGY_SPREADING):
        assert const == entries[const["name"]], const["name"]


def test_scheduler_wires_the_namespace_resolver():
    """`Scheduler.setup_informers` reaches both plugins' `set_informers`:
    their NamespaceResolver reads Namespace labels from the store's
    namespaces informer, a relabel moves its epoch, and the backend then
    drops its compiled affinity rows."""
    from kubernetes_tpu_torch.api.meta import new_object
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.scheduler import types as ttypes
    from kubernetes_tpu_torch.store import (install_core_validation,
                                            new_cluster_store)

    term = {"topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "x"}},
            "namespaceSelector": {"matchLabels": {"team": "a"}}}

    def namespace(name, team):
        return new_object("Namespace", name, None, labels={"team": team})

    async def main():
        store = new_cluster_store()
        install_core_validation(store)
        await store.create("namespaces", namespace("blue", "a"))
        backend = TorchBackend(device="cpu")
        sched = Scheduler(store, seed=1, backend=backend)
        factory = InformerFactory(store)
        await sched.setup_informers(factory)
        factory.start()
        await factory.wait_for_sync()
        try:
            fwk = sched.profiles["default-scheduler"]
            ipa, pts = (next(p for p in fwk.plugins if p.NAME == name)
                        for name in ("InterPodAffinity", "PodTopologySpread"))
            assert ipa.ns_resolver(term, "default") == ("blue",)
            assert pts.constraint_namespaces(term, "default") == ("blue",)
            snap = ttypes.Snapshot([], 1)
            backend._ns_resolver = ipa.ns_resolver
            ct = backend._tensors(snap)
            first = backend._affinity_compiler(snap, ct)
            assert backend._affinity_compiler(snap, ct) is first
            epoch = ipa.ns_resolver.epoch
            await store.create("namespaces", namespace("green", "a"))
            for _ in range(200):
                if ipa.ns_resolver.epoch != epoch:
                    break
                await asyncio.sleep(0.01)
            assert ipa.ns_resolver(term, "default") == ("blue", "green")
            assert backend._affinity_compiler(snap, ct) is not first
        finally:
            factory.stop()
            store.stop()

    asyncio.run(main())
