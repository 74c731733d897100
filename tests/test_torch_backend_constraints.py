"""The port's batch cycle on the constraint families against the JAX
backend, end to end on the CPU.

A seeded 36-node cluster in three zones (`chip_smoke.constraint_cluster`:
a few nodes without the zone key, a few tainted; resident pods with
labels, hostname anti-affinity and preferred affinity terms, in two
namespaces) and pending pods of six templates (`chip_smoke.constraint_pod`):
hostname anti-affinity (`color: blue`), required zone affinity to hub
pods, preferred affinity plus preferred anti-affinity with a `{}`
namespace selector, a hard zone spread with a soft hostname spread, a
hard zone spread whose minDomains (5) exceeds the zone count, plain
labeled pods (which take PodTopologySpread's default constraints), and
blue spread pods with zone anti-affinity to blue pods (verify-rejected
once a blue pod of the batch holds their zone; their counts fold out of
the chained spread counts). Each
case runs `TorchBackend(device="cpu").assign` and the reference
`TPUBackend.assign` (shortlist off) at the same flags:

- an anti-affinity chunk of 80 pods, flagless (the Sinkhorn route with
  verify rejections) and with greedy pinned (the W=32 wave);
- the zone-affinity and preferred-term templates, flagless;
- hard spread at W=1 and W=32 (the spread scan in one chunk);
- hetero spread: every template in one chunk;
- a multi-chunk chain with verify rejections (16-pod chunks, pipelined).

Assignments, diagnostics (reason counts, plugins, resolvability; the
per-node statuses of verify rejections), the solver counters (optimal
solves and fallbacks, wave commits and replays) and, for spread, the
union table and the final chained domain counts are identical: no
tolerance (integers and exact strings). Also: a cached affinity compiler
is dropped when the resident pods change.
"""

import contextlib

import numpy as np
import pytest
import torch

from chip_smoke import (ANTI_BLUE, CONSTRAINT_KINDS, constraint_cluster,
                        constraint_pod, constraint_pods, constraint_snapshot)
from kubernetes_tpu.metrics.registry import SchedulerMetrics as JMetrics
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics as TMetrics
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from kubernetes_tpu_torch.utils import flags as tflags

COUNTERS = ("solver_optimal_solves", "solver_optimal_fallbacks",
            "solver_wave_commits", "solver_wave_replays")
N_NODES = 36


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def pending(kinds, count: int) -> list[dict]:
    return [make_pod(name, **kw) for name, kw in constraint_pods(kinds,
                                                                count)]


def anti_pod(i: int) -> ttypes.PodInfo:
    name, kw = constraint_pod("anti", i)
    return ttypes.PodInfo(make_pod(name, **kw))


def snapshot(types_mod, nodes, residents, generation: int = 1):
    return constraint_snapshot(types_mod, make_node, make_pod, nodes,
                               residents, generation)


def run_jax(nodes, residents, pods, max_batch, flag_items):
    snap = snapshot(jtypes, nodes, residents)
    fwk = jframework.Framework(
        jregistry.build_plugins(list(tregistry.DEFAULT_PLUGINS)),
        jregistry.DEFAULT_SCORE_WEIGHTS)
    b = jbackend.TPUBackend(max_batch=max_batch, mesh=None)
    b.metrics = JMetrics()
    with contextlib.ExitStack() as stack:
        stack.enter_context(jflags.scoped_set("KTPU_SHORTLIST_K", 0))
        for k, v in flag_items:
            stack.enter_context(jflags.scoped_set(k, v))
        ctx = b._start([jtypes.PodInfo(p) for p in pods], snap, fwk)
        for run in b._pipeline(ctx):
            b._finalize_chunk(run, b._fetch_assign(run), ctx)
    return b, ctx


def run_torch(nodes, residents, pods, max_batch, flag_items):
    snap = snapshot(ttypes, nodes, residents)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    b = tbackend.TorchBackend(device="cpu", max_batch=max_batch)
    b.metrics = TMetrics()
    pis = [ttypes.PodInfo(p) for p in pods]
    with contextlib.ExitStack() as stack:
        for k, v in flag_items:
            stack.enter_context(tflags.scoped_set(k, v))
        b._check_supported(pis, fwk)
        ctx = b._start(pis, snap, fwk)
        b._run_chunks(ctx)
    return b, ctx


def diag_view(d):
    if hasattr(d, "reason_counts"):
        return ("map", d.reason_counts, sorted(d.plugins), d.resolvable)
    return ("nodes", {n: (s.code, list(s.reasons), s.plugin)
                      for n, s in d.items()})


def compare(kinds, count, max_batch, flag_items=()):
    nodes, residents = constraint_cluster(3, N_NODES)
    pods = pending(kinds, count)
    jb, jctx = run_jax(nodes, residents, pods, max_batch, flag_items)
    tb, tctx = run_torch(nodes, residents, pods, max_batch, flag_items)
    assert tctx.assignments == jctx.assignments
    assert set(tctx.diagnostics) == set(jctx.diagnostics)
    for key, d in jctx.diagnostics.items():
        assert diag_view(tctx.diagnostics[key]) == diag_view(d), key
    for name in COUNTERS:
        assert getattr(tb.metrics, name).value() == \
            getattr(jb.metrics, name).value(), name
    jsp, tsp = jctx.spread, tctx.spread
    assert (tsp is None) == (jsp is None)
    if jsp is not None and jsp.get("cons"):
        assert tsp["cons"] == jsp["cons"]
        assert tsp["tpl_cols"] == jsp["tpl_cols"]
        # The table in index form is the reference's one-hot table.
        dom = np.asarray(jsp["dom_onehot_host"])
        cid = np.asarray(jsp["cid_onehot_host"])
        node_dom = tsp["node_dom_host"]
        want = np.full(node_dom.shape, -1, np.int64)
        nz_n, nz_d = np.nonzero(dom)
        want[nz_n, np.argmax(cid[nz_d], axis=1)] = nz_d
        np.testing.assert_array_equal(node_dom, want)
        np.testing.assert_array_equal(
            tsp["dev_counts"].numpy(),
            np.asarray(jsp["dev_counts"]).astype(np.int32))
    return tb, tctx


def placed(ctx):
    return sum(v is not None for v in ctx.assignments.values())


@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_anti_affinity_chunk(mode):
    tb, ctx = compare(("anti",), 80, 128, [("KTPU_SOLVE_MODE", mode)])
    assert tb.counters["optimal_solves"] == (mode == "auto")
    assert tb.counters["verify_rejects"] > 0
    nodes = [n for n in ctx.assignments.values() if n]
    assert len(nodes) == len(set(nodes)) == placed(ctx)


def test_affinity_and_preferred_terms_flagless():
    tb, ctx = compare(("worker", "pref", "plain"), 72, 128)
    assert tb.counters["optimal_solves"] == 1
    assert 0 < placed(ctx)


@pytest.mark.parametrize("wave_w", [1, 32])
def test_hard_spread_chunk(wave_w):
    tb, ctx = compare(("spread",), 64, 128,
                      [("KTPU_WAVE_WIDTH", wave_w)])
    assert tb.counters["spread_chunks"] == 1
    assert tb.counters["optimal_fallbacks"] == 1
    assert placed(ctx) == 64


def test_hetero_spread_chunk():
    tb, ctx = compare(CONSTRAINT_KINDS, 96, 128)
    assert tb.counters["spread_chunks"] == 1
    assert len(ctx.spread["cons"]) == 2


def test_multi_chunk_chain_with_verify_rejections():
    tb, ctx = compare(CONSTRAINT_KINDS, 96, 16)
    assert tb.counters["chunks"] == 6
    assert tb.counters["verify_rejects"] > 0
    assert tb.pipeline_depth == 4


def test_affinity_compiler_is_dropped_when_residents_change():
    """Assign, add a resident anti-affine pod, assign again with the same
    backend: the second assign sees the new resident (its symmetry row
    forbids its node to `color: blue` pods), as a fresh backend does."""
    nodes, residents = constraint_cluster(3, N_NODES)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    tb = tbackend.TorchBackend(device="cpu", max_batch=64)
    first = [anti_pod(0)]
    got, _ = tb.assign(first, snapshot(ttypes, nodes, residents, 1), fwk)
    target = got["default/anti-0"]
    assert target is not None
    stale = tb._affinity
    residents = residents + [("guard", {
        "labels": {"app": "guard"}, "node_name": target,
        "affinity": ANTI_BLUE, "requests": {"cpu": "100m"}})]
    snap2 = snapshot(ttypes, nodes, residents, 2)
    again = [anti_pod(1)]
    got2, _ = tb.assign(again, snap2, fwk)
    fresh = tbackend.TorchBackend(device="cpu", max_batch=64)
    want2, _ = fresh.assign(again, snapshot(ttypes, nodes, residents, 2),
                            fwk)
    assert tb._affinity is not stale
    assert got2 == want2
    assert got2["default/anti-1"] not in (None, target)
    # The stale rows would have let the pod onto the guarded node.
    col = tb._ct.name_to_idx[target]
    assert stale.filter_row(again[0])[col]
    assert not tb._affinity.filter_row(again[0])[col]
