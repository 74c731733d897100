"""The port's solve-mode policy against the JAX reference's, on the CPU.

`AdaptiveTuner.solve_mode` of both packages over a grid of the flag
(`KTPU_SOLVE_MODE` unset, greedy, optimal, auto), the chunk's real pods,
gang, spread, class planes and node count: the same answer on every point.
Then `TorchBackend.assign` on the seeded cluster of test_torch_backend:
with no flag set, a chunk the policy sends to the optimal mode runs the
Sinkhorn route and places exactly as the reference's flagless
`TPUBackend.assign` (and so under `KTPU_SOLVE_MODE=optimal`, at 79 and at
32 pods per chunk); chunks under 64 pods run greedy and place as the
reference; and without class planes the optimal chunk falls back to greedy
structurally, counted, as in the reference.
"""

import itertools

import pytest
import torch

from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from kubernetes_tpu_torch.utils import flags as tflags
from test_torch_backend import SLICE_PLUGINS, _snapshot, cluster_objects

#: Every flag the batch cycles below read, unset for a flagless run.
_FLAGS = ("KTPU_SOLVE_MODE", "KTPU_WAVE_WIDTH", "KTPU_CLASS_PLANES",
          "KTPU_CLASS_PAD", "KTPU_SHORTLIST_K", "KTPU_PALLAS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def flagless(monkeypatch):
    for name in _FLAGS:
        monkeypatch.delenv(name, raising=False)


def _modes(tuner, n_nodes, p_real, gang, spread, classes):
    tuner.n_nodes = n_nodes
    return tuner.solve_mode(p_real, has_gang=gang, spread=spread,
                            class_mode=classes)


@pytest.mark.parametrize("flag", [None, "greedy", "optimal", "auto"])
@pytest.mark.parametrize("n_nodes", [5000, 32768])
def test_policy_equals_reference(flagless, flag, n_nodes):
    """Each package's flag set by its own `scoped_set`; the rest of the
    grid is swept inside."""
    grid = list(itertools.product((1, 63, 64, 1024), (False, True),
                                  (False, True), (False, True)))
    jt, tt = jbackend.AdaptiveTuner(), tbackend.AdaptiveTuner()
    assert tt.OPTIMAL_MIN_PODS == jt.OPTIMAL_MIN_PODS == 64
    assert tt.LARGE_N == jt.LARGE_N
    if flag is None:
        want = [_modes(jt, n_nodes, *g) for g in grid]
        got = [_modes(tt, n_nodes, *g) for g in grid]
    else:
        with jflags.scoped_set("KTPU_SOLVE_MODE", flag):
            want = [_modes(jt, n_nodes, *g) for g in grid]
        with tflags.scoped_set("KTPU_SOLVE_MODE", flag):
            got = [_modes(tt, n_nodes, *g) for g in grid]
    assert got == want
    # The grid reaches every answer the policy has, except where the flag
    # pins greedy.
    if flag != "greedy":
        assert {m for m, _ in got} == {"greedy", "optimal"}
        assert any(fb for _, fb in got)


def test_malformed_flag_degrades_to_auto(flagless):
    tt = tbackend.AdaptiveTuner()
    with tflags.scoped_set("KTPU_SOLVE_MODE", "sinkhorn"):
        assert tflags.get("KTPU_SOLVE_MODE") == "auto"
        assert _modes(tt, 5000, 64, False, False, True) == ("optimal", False)


def _torch_inputs():
    nodes, residents, pending = cluster_objects(seed=7)
    snap = _snapshot(ttypes, nodes, residents)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    return snap, fwk, [ttypes.PodInfo(p) for p in pending]


def _jax_assign(max_batch):
    nodes, residents, pending = cluster_objects(seed=7)
    snap = _snapshot(jtypes, nodes, residents)
    fwk = jframework.Framework(jregistry.build_plugins(SLICE_PLUGINS),
                               jregistry.DEFAULT_SCORE_WEIGHTS)
    b = jbackend.TPUBackend(max_batch=max_batch, multistart=4, mesh=None)
    assignments, _ = b.assign([jtypes.PodInfo(p) for p in pending], snap,
                              fwk)
    return b, assignments


def test_optimal_chunk_places_as_flagless_reference(flagless):
    """One chunk of all 79 pending pods: the reference's policy sends it
    to the optimal mode (the chunk where greedy placed 62 of 79 pods
    elsewhere); flagless and with KTPU_SOLVE_MODE=optimal the port places
    exactly as the reference, through one Sinkhorn solve. A 32-pod chunk
    is greedy flagless and optimal when pinned, in both packages."""
    snap, fwk, pods = _torch_inputs()
    assert len(pods) >= 64
    jt = jbackend.AdaptiveTuner()
    jt.n_nodes = len(snap.nodes)
    assert jt.solve_mode(len(pods), has_gang=False, spread=False,
                         class_mode=True) == ("optimal", False)
    _, want = _jax_assign(128)
    for flag in (None, "optimal"):
        tb = tbackend.TorchBackend(device="cpu", max_batch=128)
        if flag is None:
            got, _ = tb.assign(pods, snap, fwk)
        else:
            with tflags.scoped_set("KTPU_SOLVE_MODE", flag):
                got, _ = tb.assign(pods, snap, fwk)
        assert got == want, flag
        assert tb.counters["chunks"] == tb.counters["optimal_solves"] == 1
        assert tb.counters["sinkhorn_iterations"] == 24
        assert tb.counters["optimal_fallbacks"] == 0
    assert 0 < sum(v is not None for v in got.values()) < len(got)
    # The 32-pod pin: every chunk optimal in both packages.
    with jflags.scoped_set("KTPU_SOLVE_MODE", "optimal"):
        _, want32 = _jax_assign(32)
    tb32 = tbackend.TorchBackend(device="cpu", max_batch=32)
    with tflags.scoped_set("KTPU_SOLVE_MODE", "optimal"):
        got32, _ = tb32.assign(pods, snap, fwk)
    assert got32 == want32
    assert tb32.counters["optimal_solves"] == tb32.counters["chunks"] == 3
    with tflags.scoped_set("KTPU_SOLVE_MODE", "greedy"):
        tb.assign(pods, snap, fwk)
    assert tb.counters["chunks"] == 2 and tb.counters["optimal_solves"] == 1


def test_small_chunks_place_as_flagless_reference(flagless):
    """max_batch=32: every chunk is under 64 pods, so both packages run
    greedy with no flag set, and place identically."""
    _, want = _jax_assign(32)
    snap, fwk, pods = _torch_inputs()
    tb = tbackend.TorchBackend(device="cpu", max_batch=32, multistart=4)
    got, _ = tb.assign(pods, snap, fwk)
    assert got == want
    assert tb.counters["optimal_fallbacks"] == 0
    assert 0 < sum(v is not None for v in got.values()) < len(got)


def test_structural_fallback_is_greedy_and_counted(flagless, monkeypatch):
    """Class planes off: the 79-pod chunk is not eligible for the optimal
    mode, so both packages run greedy with the fallback counted, and
    place identically."""
    monkeypatch.setenv("KTPU_CLASS_PLANES", "0")
    jb, want = _jax_assign(128)
    assert jb._tuner.solve_mode(79, has_gang=False, spread=False,
                                class_mode=False) == ("greedy", True)
    snap, fwk, pods = _torch_inputs()
    tb = tbackend.TorchBackend(device="cpu", max_batch=128, multistart=4)
    got, _ = tb.assign(pods, snap, fwk)
    assert got == want
    assert tb.counters["optimal_fallbacks"] == 1
