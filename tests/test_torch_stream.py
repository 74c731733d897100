"""The chunk stream (`TorchBackend.assign_stream` / `assign_async`) in the
port against the JAX package's on the CPU.

- Chunk by chunk (`max_batch=16`, at least three chunks): the port's
  `assign_stream` against `TPUBackend.assign_stream` on the same inputs,
  the yielded chunk's pod keys and the accumulated assignments and
  diagnostics after each yield equal, greedy and flagless: the seeded
  48-node cluster of `tests/test_torch_backend.py` (templates, pinned
  pods, pods that fit nowhere: chunks with failures) and a gang chunk
  (`chip_smoke.gang_chunk("fit")`, Coscheduling in the profile).
- `assign_async` equals `assign` in both packages, and the port's stream
  equals its `assign` in counters and `timings` keys, its yield order
  `assign`'s finalize order.
- The loop takes the stream: both packages' `Scheduler.run` on a
  pre-created `chip_smoke.loop_cluster` workload of 120 pods (16-pod
  chunks, serving off) bind exactly the same pods to the same nodes,
  with the same FailedScheduling messages, and the port's loop calls
  `assign_stream` and never `assign`.

Tolerance: none.
"""

import asyncio
import contextlib

import pytest
import torch

from chip_smoke import (constraint_cluster, constraint_snapshot,
                        diagnostics_view, drain_stream, finalize_order,
                        gang_chunk, gang_framework, loop_cluster,
                        port_loop_api, run_loop, N_GANG_CHUNK_NODES)
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu.api.types import make_pod as jmake_pod
from kubernetes_tpu.ops.backend import TPUBackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import coscheduling as jcos
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import coscheduling as tcos
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from test_torch_backend import _snapshot, cluster_objects
from test_torch_scheduler import JAX_API

CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@contextlib.contextmanager
def solve_flags(mode: str):
    with jflags.scoped_set("KTPU_SOLVE_MODE", mode), \
            jflags.scoped_set("KTPU_SHORTLIST_K", 0), \
            jflags.scoped_set("KTPU_PALLAS", "interpret"), \
            jflags.scoped_set("KTPU_WAVE_WIDTH", 8):
        yield


def basic_inputs(pkg: str):
    """(pods, snapshot, framework) of the 48-node cluster in `pkg`."""
    nodes, residents, pending = cluster_objects()
    if pkg == "jax":
        return ([jtypes.PodInfo(p) for p in pending],
                _snapshot(jtypes, nodes, residents),
                jframework.Framework(
                    jregistry.build_plugins(list(tregistry.DEFAULT_PLUGINS)),
                    jregistry.DEFAULT_SCORE_WEIGHTS))
    return ([ttypes.PodInfo(p) for p in pending],
            _snapshot(ttypes, nodes, residents),
            tframework.Framework(tregistry.build_plugins(),
                                 tregistry.DEFAULT_SCORE_WEIGHTS))


def gang_inputs(pkg: str):
    """(pods, snapshot, framework) of the "fit" gang chunk in `pkg`."""
    nodes, residents = constraint_cluster(3, N_GANG_CHUNK_NODES)
    groups, assembled, pods = gang_chunk("fit")
    if pkg == "jax":
        return ([jtypes.PodInfo(jmake_pod(n, **kw)) for n, kw in pods],
                constraint_snapshot(jtypes, jmake_node, jmake_pod, nodes,
                                    residents),
                gang_framework(jregistry, jframework, jcos.make_pod_group,
                               groups, assembled))
    return ([ttypes.PodInfo(make_pod(n, **kw)) for n, kw in pods],
            constraint_snapshot(ttypes, make_node, make_pod, nodes,
                                residents),
            gang_framework(tregistry, tframework, tcos.make_pod_group,
                           groups, assembled))


def backend(pkg: str):
    if pkg == "jax":
        return TPUBackend(max_batch=CHUNK, mesh=None)
    return TorchBackend(device="cpu", max_batch=CHUNK)


INPUTS = {"basic": basic_inputs, "gang": gang_inputs}


@pytest.mark.parametrize("mode", ["greedy", "auto"])
@pytest.mark.parametrize("case", sorted(INPUTS))
def test_stream_matches_reference_chunk_by_chunk(case, mode):
    with solve_flags(mode):
        want, _ = drain_stream(backend("jax"), *INPUTS[case]("jax"))
        got, _ = drain_stream(backend("port"), *INPUTS[case]("port"))
    assert len(got) == len(want) >= 3
    for k, (g, w) in enumerate(zip(got, want)):
        assert g[0] == w[0], k
        assert g[1] == w[1], k
        assert g[2] == w[2], k
    final = got[-1][1]
    if case == "basic":
        # Chunks with failures: the pods that fit nowhere.
        assert any(v is not None for v in final.values())
        assert all(final[f"default/huge-{i}"] is None for i in range(3))
        assert set(got[-1][2]) >= {f"default/huge-{i}" for i in range(3)}
    else:
        # Six whole gangs of 10 and 16 lone pods, over five chunks.
        assert all(v is not None for v in final.values())


@pytest.mark.parametrize("mode", ["greedy", "auto"])
@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_assign_async_equals_assign(pkg, mode):
    with solve_flags(mode):
        b1, b2 = backend(pkg), backend(pkg)
        want_a, want_d = b1.assign(*basic_inputs(pkg))
        got_a, got_d = asyncio.run(b2.assign_async(*basic_inputs(pkg)))
    assert got_a == want_a
    assert diagnostics_view(got_d) == diagnostics_view(want_d)
    if pkg == "port":
        assert b2.counters == b1.counters
        assert b2.timings.keys() == b1.timings.keys()
        assert all(b2.timings[k] > 0 for k in ("assign_s", "prep_s",
                                               "device_s", "verify_s"))
        assert b2.timings["assign_s"] >= b2.timings["prep_s"]


def test_stream_order_is_assign_finalize_order():
    with solve_flags("auto"):
        order, want_a, _ = finalize_order(backend("port"),
                                          *basic_inputs("port"))
        seen, ctx = drain_stream(backend("port"), *basic_inputs("port"))
    assert [keys for keys, _, _ in seen] == order
    assert dict(ctx.assignments) == want_a
    _, snap, fwk = basic_inputs("port")
    assert asyncio.run(backend("port").assign_async([], snap, fwk)) \
        == ({}, {})


class StreamCounting(TorchBackend):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.calls = {"assign": 0, "assign_stream": 0}

    def assign(self, pods, snapshot, fwk):
        self.calls["assign"] += 1
        return super().assign(pods, snapshot, fwk)

    def assign_stream(self, pods, snapshot, fwk):
        self.calls["assign_stream"] += 1
        return super().assign_stream(pods, snapshot, fwk)


def test_loop_through_the_stream_binds_as_the_reference(monkeypatch):
    monkeypatch.setenv("KTPU_SERVING", "0")
    nodes, pods = loop_cluster(5, 25, 120)
    tb = StreamCounting(device="cpu", max_batch=CHUNK)
    port = asyncio.run(run_loop(port_loop_api(), nodes, pods, tb, 128))
    ref = asyncio.run(run_loop(JAX_API, nodes, pods, TPUBackend(
        max_batch=CHUNK, mesh=None), 128))
    assert port["assignments"] == ref["assignments"]
    assert port["failed"] == ref["failed"]
    assert tb.calls["assign_stream"] >= 1 and tb.calls["assign"] == 0
    assert tb.counters["chunks"] >= 3
    assert sum(v is not None for v in port["assignments"].values()) > 100
