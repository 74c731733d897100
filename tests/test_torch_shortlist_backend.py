"""The port's shortlist routing against the JAX backend, on the CPU.

Mirrors `tests/test_shortlist_smoke.py` and `tests/test_block_index_smoke.py`
for `kubernetes_tpu_torch`:

- the tuner's shortlist and block-width rows (`shortlist_k`,
  `block_width`, the fallback-rate boost in `decide`, the M+1 <= B guard)
  row for row against the reference's `AdaptiveTuner`;
- `TorchBackend(device="cpu").assign` against `TPUBackend.assign` with
  `max_batch=16`: on a uniform 150-node cluster with no flag (the shortlist
  engages above 4·(16+16) = 128 nodes), and on the reference's seeded
  160-node cluster with K=16 forced, `KTPU_BLOCK_WIDTH=16` and `LARGE_N`
  patched to 1 (the block prefilter), the wavefront on and off. The
  assignments and every solver metric are identical, and the reference's
  own metrics show each route ran;
- the sharded route with `shortlist_k` and `block_w` on 1- and 4-shard
  meshes against the single-device shortlist solve and the reference's
  sharded solve on the virtual 8-device mesh.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.metrics import registry as jmetrics
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.parallel import build_mesh as jbuild_mesh
from kubernetes_tpu.parallel import sharded as jsharded
from kubernetes_tpu.scheduler import cache as jcache
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.metrics import registry as tmetrics
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.parallel import build_mesh as tbuild_mesh
from kubernetes_tpu_torch.parallel import sharded as tsharded
from kubernetes_tpu_torch.scheduler import cache as tcache
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from test_tpu_backend import TOL_POOL, random_cluster

SLICE_PLUGINS = list(tregistry.DEFAULT_PLUGINS)
SOLVER_METRICS = ("solver_shortlist_pods", "solver_shortlist_fallbacks",
                  "solver_blocks_scanned", "solver_blocks_pruned",
                  "solver_scan_width", "solver_wave_commits",
                  "solver_wave_replays")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the tuner's rows
# ---------------------------------------------------------------------------

def test_shortlist_width_rows_match_the_reference():
    tt, jt = tbackend.AdaptiveTuner(), jbackend.AdaptiveTuner()
    for name in ("SHORTLIST_FACTOR", "SHORTLIST_MAX_BOOST",
                 "SHORTLIST_FALLBACK_RATIO", "SHORTLIST_MIN_SAMPLE",
                 "BLOCK_WIDTH", "LARGE_N"):
        assert getattr(tt, name) == getattr(jt, name), name
    cases = [(1024, 50_000), (1024, 8_192), (1024, 8_191), (1024, 5_000),
             (16, 150), (16, 128), (16, 127), (16, 16)]
    for chunk, n in cases:
        assert tt.shortlist_k(chunk, n) == jt.shortlist_k(chunk, n)
    assert tt.shortlist_k(1024, 8_192) == 1024
    assert tt.shortlist_k(1024, 5_000) == 0
    assert tt.shortlist_k(16, 150) == 16 and tt.shortlist_k(16, 127) == 0


def test_card_tuner_prunes_only_when_asked(monkeypatch):
    """A CUDA backend's tuner (prune_auto=False) keeps the full-width
    solve and prefilter at every size; KTPU_SHORTLIST_K still sets K (0
    still disables) and KTPU_BLOCK_WIDTH the block width. A CPU backend's
    tuner prunes where the reference does."""
    card = tbackend.AdaptiveTuner(prune_auto=False)
    for chunk, n in ((1024, 50_000), (1024, 8_192), (16, 150)):
        assert card.shortlist_k(chunk, n) == 0
    monkeypatch.setenv("KTPU_SHORTLIST_K", "1024")
    assert card.shortlist_k(1024, 50_000) == 1024
    assert card.block_width(50_176, 50_000, 1024) == 0
    monkeypatch.setenv("KTPU_BLOCK_WIDTH", "128")
    assert card.block_width(50_176, 50_000, 1024) == 128
    monkeypatch.setenv("KTPU_BLOCK_INDEX", "0")
    assert card.block_width(50_176, 50_000, 1024) == 0
    monkeypatch.setenv("KTPU_SHORTLIST_K", "0")
    assert card.shortlist_k(1024, 50_000) == 0
    for name in ("KTPU_SHORTLIST_K", "KTPU_BLOCK_WIDTH", "KTPU_BLOCK_INDEX"):
        monkeypatch.delenv(name)
    cpu = tbackend.TorchBackend(device="cpu")._tuner
    assert cpu.prune_auto and cpu.shortlist_k(1024, 50_000) == 1024
    assert cpu.block_width(50_176, 50_000, 1024) == 128


def test_boost_rule_matches_the_reference():
    """The fallback-rate boost: only past the sample size, only above the
    rate, doubling to the cap; a widened K can switch off on a cluster it
    outgrew."""
    tt, jt = tbackend.AdaptiveTuner(), jbackend.AdaptiveTuner()
    samples = [(100, 100), (1024, 100), (1024, 512), (1024, 1024),
               (4096, 4096), (600, 600), (600, 600)]
    for pods, fallbacks in samples:
        for t in (tt, jt):
            t.observe_solve(pods, fallbacks)
            t.decide()
        assert tt.shortlist_boost == jt.shortlist_boost
        for chunk, n in ((1024, 50_000), (1024, 9_000), (1024, 200_000)):
            assert tt.shortlist_k(chunk, n) == jt.shortlist_k(chunk, n)
    assert tt.shortlist_boost == tt.SHORTLIST_MAX_BOOST


@pytest.mark.parametrize("env", [
    {}, {"KTPU_BLOCK_INDEX": "0"}, {"KTPU_BLOCK_WIDTH": "64"},
    {"KTPU_BLOCK_WIDTH": "0"}, {"KTPU_BLOCK_WIDTH": "4096"}])
def test_block_width_rows_match_the_reference(monkeypatch, env):
    """Active from LARGE_N with a shortlist; the kill switch, the width
    override and the M+1 <= B guard route 0 where the reference does."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    tt, jt = tbackend.AdaptiveTuner(), jbackend.AdaptiveTuner()
    big = tt.LARGE_N
    rows = [(big, big, 1024), (big, big, 0), (4096, 4096, 256),
            (50_176, 50_000, 1024), (50_176, 50_000, 8192),
            (512, 40_000, 1024), (big + 256, big, 16_000)]
    for n_pad, n_real, k in rows:
        assert tt.block_width(n_pad, n_real, k) \
            == jt.block_width(n_pad, n_real, k), (env, n_pad, n_real, k)
    if not env:
        assert tt.block_width(big, big, 1024) == tt.BLOCK_WIDTH
        assert tt.block_width(50_176, 50_000, 1024) == 128
    # M + 1 > B: 512 columns in blocks of 128 hold 4 blocks, and K=1024
    # selects M = 18.
    assert tt.block_width(512, 40_000, 1024) == 0


# ---------------------------------------------------------------------------
# TorchBackend against TPUBackend
# ---------------------------------------------------------------------------

def _uniform_nodes(n: int) -> list[dict]:
    return [make_node(f"n{i}", allocatable={"cpu": "8", "memory": "32Gi",
                                            "pods": "110"})
            for i in range(n)]


def _snapshots(nodes: list[dict], residents: list[tuple[dict, str]]):
    """The same cluster through each package's SchedulerCache."""
    out = []
    for cache_mod, types_mod in ((jcache, jtypes), (tcache, ttypes)):
        cache = cache_mod.SchedulerCache()
        for nd in nodes:
            cache.add_node(nd)
        for pd, _ in residents:
            cache.add_pod(types_mod.PodInfo(pd))
        out.append(cache.update_snapshot())
    return out


def _random_cluster(seed: int, n: int):
    """The reference's `random_cluster` as node and resident pod dicts."""
    snap = random_cluster(random.Random(seed), n)
    nodes = [ni.node for ni in snap.nodes]
    residents = [(pi.pod, ni.name) for ni in snap.nodes for pi in ni.pods]
    return nodes, residents


def _template_pods(n: int, two: bool) -> list[dict]:
    return [make_pod(
        f"pend-{i}",
        requests={"cpu": "500m", "memory": "512Mi"} if (i % 2 or not two)
        else {"cpu": "1", "memory": "2Gi"},
        tolerations=TOL_POOL if (two and i % 2) else None, uid=f"uid-{i}")
        for i in range(n)]


def _run_both(nodes, residents, pods):
    jsnap, tsnap = _snapshots(nodes, residents)
    out = []
    for types_mod, fw, reg, backend, metrics, snap in (
            (jtypes, jframework, jregistry,
             lambda: jbackend.TPUBackend(max_batch=16, mesh=None),
             jmetrics, jsnap),
            (ttypes, tframework, tregistry,
             lambda: tbackend.TorchBackend(device="cpu", max_batch=16),
             tmetrics, tsnap)):
        fwk = fw.Framework(reg.build_plugins(SLICE_PLUGINS),
                           reg.DEFAULT_SCORE_WEIGHTS)
        b = backend()
        b.metrics = metrics.SchedulerMetrics()
        assignments, diagnostics = b.assign(
            [types_mod.PodInfo(p) for p in pods], snap, fwk)
        values = {k: getattr(b.metrics, k).value() for k in SOLVER_METRICS}
        reasons = {k: sorted(st.reasons[0] if st.reasons else ""
                             for st in v.values())
                   for k, v in diagnostics.items()}
        out.append((assignments, values, reasons, b))
    return out


def test_shortlist_on_by_default_above_the_threshold():
    """No flag: 150 uniform nodes clear 4·(16+16), so every chunk (35 pods,
    a partial last chunk whose padding rides the scan) takes the pruned
    solve in both packages, at scan width K + P = 32."""
    (ja, jm, jr, _), (ta, tm, tr, tb) = _run_both(
        _uniform_nodes(150), [], _template_pods(35, two=False))
    assert ta == ja and tr == jr
    assert tm == jm
    assert jm["solver_shortlist_pods"] == 35
    assert jm["solver_scan_width"] == 32
    assert jm["solver_blocks_scanned"] == 0
    assert all(v is not None for v in ta.values())
    assert tb.counters["shortlist_pods"] == 35
    assert tb.counters["shortlist_fallbacks"] \
        == jm["solver_shortlist_fallbacks"]


def test_below_the_threshold_keeps_the_full_scan():
    (ja, jm, _, _), (ta, tm, _, _) = _run_both(
        _uniform_nodes(100), [], _template_pods(8, two=False))
    assert ta == ja and tm == jm
    assert tm["solver_shortlist_pods"] == 0
    assert tm["solver_scan_width"] == 100


@pytest.mark.parametrize("wavefront", [False, True])
@pytest.mark.parametrize("block_index", [False, True])
def test_forced_shortlist_and_block_index(monkeypatch, wavefront,
                                          block_index):
    """The reference's seeded 160-node cluster (taints, resident pods) and
    50 pods of two templates, one tolerating the taint pool: K=16 forced,
    the block prefilter (width 16, LARGE_N patched to 1) on or off, the
    wavefront at W=4 or off. Identical assignments, diagnostics and solver
    metrics; the route each case names ran in the reference."""
    monkeypatch.setenv("KTPU_SHORTLIST_K", "16")
    if wavefront:
        monkeypatch.setenv("KTPU_WAVE_WIDTH", "4")
    else:
        monkeypatch.setenv("KTPU_WAVEFRONT", "0")
    if block_index:
        monkeypatch.setenv("KTPU_BLOCK_WIDTH", "16")
        monkeypatch.setattr(jbackend.AdaptiveTuner, "LARGE_N", 1)
        monkeypatch.setattr(tbackend.AdaptiveTuner, "LARGE_N", 1)
    else:
        monkeypatch.setenv("KTPU_BLOCK_INDEX", "0")
    nodes, residents = _random_cluster(9, 160)
    (ja, jm, jr, _), (ta, tm, tr, tb) = _run_both(
        nodes, residents, _template_pods(50, two=True))
    assert ta == ja and tr == jr
    assert tm == jm
    assert jm["solver_shortlist_pods"] == 50
    assert (jm["solver_blocks_scanned"] > 0) == block_index
    assert (jm["solver_wave_commits"] + jm["solver_wave_replays"] > 0) \
        == wavefront
    assert tb.counters["blocks_scanned"] == jm["solver_blocks_scanned"]
    assert tb.counters["blocks_pruned"] == jm["solver_blocks_pruned"]


def test_block_index_on_and_off_place_alike(monkeypatch):
    """A uniform fleet, which only the uniform arm can prune: with the
    block prefilter (K=16, width 16, LARGE_N patched to 1) both packages
    prune the same blocks, and the KTPU_BLOCK_INDEX kill switch changes
    the route, never an assignment."""
    monkeypatch.setenv("KTPU_SHORTLIST_K", "16")
    monkeypatch.setenv("KTPU_BLOCK_WIDTH", "16")
    monkeypatch.setattr(jbackend.AdaptiveTuner, "LARGE_N", 1)
    monkeypatch.setattr(tbackend.AdaptiveTuner, "LARGE_N", 1)
    runs = []
    for flag in ("1", "0"):
        monkeypatch.setenv("KTPU_BLOCK_INDEX", flag)
        (ja, jm, _, _), (ta, tm, _, _) = _run_both(
            _uniform_nodes(256), [], _template_pods(40, two=False))
        assert ta == ja and tm == jm
        runs.append((ta, tm))
    (on, mon), (off, moff) = runs
    assert on == off
    assert mon["solver_blocks_pruned"] > 0
    assert moff["solver_blocks_scanned"] == 0


# ---------------------------------------------------------------------------
# the sharded route
# ---------------------------------------------------------------------------

def _sharded_case(seed: int, p: int = 12, n: int = 64, r: int = 2):
    rng = np.random.default_rng(seed)
    alloc = rng.integers(4_000, 64_000, size=(n, r)).astype(np.int32)
    used = (alloc * rng.uniform(0, 0.5, size=(n, r))).astype(np.int32)
    return dict(
        req_q=rng.integers(100, 9_000, size=(p, r)).astype(np.int32),
        free_q=alloc - used,
        free_pods=(110 - rng.integers(0, 30, size=(n,))).astype(np.int32),
        used_nz_q=used, alloc_q=alloc, mask=rng.random((p, n)) < 0.9,
        static=rng.uniform(0, 10, size=(p, n)).astype(np.float32),
        col_w=np.ones((r,), np.float32), col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 100.0], np.float32),
        shape_s=np.array([0.0, 10.0], np.float32))


def _args(d, lib):
    conv = (lambda x: jnp.asarray(x)) if lib == "jax" \
        else (lambda x: torch.from_numpy(np.ascontiguousarray(x)))
    return [conv(d[k]) for k in (
        "req_q", "req_q", "free_q", "free_pods", "used_nz_q", "alloc_q",
        "mask", "static", "col_w", "col_mask", "shape_u", "shape_s")] \
        + [1.0, 1.0, "LeastAllocated"]


@pytest.mark.parametrize("k,bw", [(3, 0), (8, 0), (3, 4), (3, 8), (3, 16)])
def test_sharded_shortlist_matches_single_device_and_reference(k, bw):
    """1 and 4 shards of the port against the port's single-device solve
    and the reference's sharded solve: identical assignments. At 4 shards
    of 16 columns, bw=16 fails the shard-local M+1 <= B guard and keeps
    the full-width local prefilter (the reference's `_block_w_for`)."""
    d = _sharded_case(11)
    single = tsolver.greedy_assign_rescoring(*_args(d, "torch"))
    assert tsharded._block_w_for(16, 3, 16) == \
        jsharded._block_w_for(16, 3, 16) == 0
    for shards in (1, 4):
        got = tsharded.sharded_greedy_assign(
            tbuild_mesh(shards, device="cpu"), *_args(d, "torch"),
            shortlist_k=k, block_w=bw)
        np.testing.assert_array_equal(got.numpy(), single.numpy())
        ref = jsharded.sharded_greedy_assign(
            jbuild_mesh(shards), *_args(d, "jax"), shortlist_k=k,
            block_w=bw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert len(jax.devices()) >= 4


def test_sharded_shortlist_with_class_rows_and_exceptions():
    """Class planes (C rows addressed through `rows`, with the per-row
    request vectors the shard-local prefilter reads), exception columns in
    other shards, and a tight fleet that sends steps to the shard-local
    fallback: identical to the single-device solve at 1 and 4 shards."""
    rng = np.random.default_rng(5)
    n, p, c, r = 64, 24, 3, 2
    d = _sharded_case(5, p=c, n=n)
    d["free_q"] = (d["alloc_q"] * 0.15).astype(np.int32)
    rows = rng.integers(0, c, size=(p,)).astype(np.int32)
    exc = np.full((p,), -1, np.int32)
    exc[[2, 9, 17]] = (5, 40, 63)
    args = _args(d, "torch")
    req = torch.from_numpy(d["req_q"][rows])
    single = tsolver.greedy_assign_rescoring(
        req, req, *args[2:], rows=torch.from_numpy(rows),
        exc=torch.from_numpy(exc))
    for shards in (1, 4):
        got = tsharded.sharded_greedy_assign(
            tbuild_mesh(shards, device="cpu"), req, req, *args[2:],
            shortlist_k=4, rows=torch.from_numpy(rows),
            exc=torch.from_numpy(exc), row_req_q=args[0],
            row_req_nz_q=args[1], block_w=4)
        np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert (single.numpy() >= 0).any()


def test_sharded_shortlist_routes(monkeypatch):
    """wave_w > 1 keeps the wave form; at W <= 1 the shortlist runs one
    narrow pass, and the pass with full local rows only after a poisoned
    one (the tight fleet). Assignments equal the single-device solve."""
    passes = []
    one_pass = tsharded._shortlist_pass

    def counted(*a, **kw):
        passes.append(kw["inline"])
        return one_pass(*a, **kw)
    monkeypatch.setattr(tsharded, "_shortlist_pass", counted)
    d = _sharded_case(11)
    single = tsolver.greedy_assign_rescoring(*_args(d, "torch"))
    mesh = tbuild_mesh(4, device="cpu")
    got = tsharded.sharded_greedy_assign(mesh, *_args(d, "torch"),
                                         shortlist_k=3, wave_w=4)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert passes == []
    got = tsharded.sharded_greedy_assign(mesh, *_args(d, "torch"),
                                         shortlist_k=8)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    tight = dict(d, free_q=(d["alloc_q"] * 0.15).astype(np.int32))
    single = tsolver.greedy_assign_rescoring(*_args(tight, "torch"))
    got = tsharded.sharded_greedy_assign(mesh, *_args(tight, "torch"),
                                         shortlist_k=3)
    np.testing.assert_array_equal(got.numpy(), single.numpy())
    assert passes[-2:] == [False, True], passes
