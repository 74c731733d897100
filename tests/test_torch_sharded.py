"""The port's node-sharded solver (`kubernetes_tpu_torch.parallel`) and its
`wave_eval` plain version against the JAX package, on the CPU.

The same seeded numpy inputs go through the reference's
`parallel.sharded_greedy_assign(..., pallas=True)` on a mesh of virtual
host devices (each wave's evaluation is the Pallas `wave_eval`, run in
interpret mode as the JAX package's own tests run it) and through the
port's `sharded_greedy_assign` on a mesh of the same shape whose shards all
sit on the CPU, with the kernel off (its plain version is what runs on the
CPU). Contract: assignments IDENTICAL; masks identical; scores within
`atol=1e-4` (the port's scores differ from jitted XLA by a few ulp, see
ROADMAP "Measured before the port began") with identical -inf positions.

Shapes are fixed across seeds so each JAX function compiles once: n=64
nodes, p=32 pods.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu.ops import pallas_kernel
from kubernetes_tpu import parallel as jpar
from kubernetes_tpu_torch import parallel as tpar
from kubernetes_tpu_torch.ops import convert, solver as tsolver
from kubernetes_tpu_torch.ops import wave_eval as twave
from test_wavefront_solver import _problem

STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")
N, P = 64, 32
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _storm(seed: int, r: int = 2, classes=None, pinned: bool = False,
           tight: bool = True):
    """A conflict storm (`_problem`; tight: contested capacity and pod
    slots), with class planes when `classes`, and pinned exception columns
    in GLOBAL coordinates when `pinned`. Returns the reference's argument
    dict."""
    rng = np.random.default_rng(seed)
    args, _ = _problem(rng, n=N, p=P, r=r, tight=tight, classes=classes)
    if pinned:
        exc = np.full((P,), -1, np.int32)
        exc[rng.choice(P, size=6, replace=False)] = rng.integers(
            0, N, size=6).astype(np.int32)
        args["exc"] = jnp.asarray(exc)
    return args


_POS = ("req_q", "req_nz_q", "free_q", "free_pods", "used_nz_q", "alloc_q",
        "mask", "static_scores", "fit_col_w", "bal_col_mask", "shape_u",
        "shape_s", "w_fit", "w_bal")


def _jax_assign(fn, mesh, args, strategy, **kw):
    pos = [args[k] for k in _POS]
    return np.asarray(fn(mesh, *pos, strategy, rows=args.get("rows"),
                         exc=args.get("exc"), **kw))


def _port_assign(fn, mesh, args, strategy, **kw):
    inputs = convert.sharded_solver_inputs(mesh, args)
    return fn(mesh, strategy=strategy, **inputs, **kw).numpy()


def _replays(args, strategy, w) -> int:
    """Waves the single-device wave scan replays on these inputs: the
    sharded route takes the same commit/replay decisions."""
    t = convert.sharded_solver_inputs(tpar.build_mesh(1, device=CPU), args)
    _, _, rep = tsolver.greedy_assign_rescoring_wave(
        strategy=strategy, wave_w=w, **t)
    return rep


# ---------------------------------------------------------------------------
# wave_eval: the plain version against the Pallas kernel
# ---------------------------------------------------------------------------

def _eval_inputs(seed: int, r: int, uniform: bool, n=N, w=8, c=3):
    """One wave's shard-local inputs: class row 0 infeasible everywhere,
    padding members, exception columns inside and outside the shard
    (el out of [0, n)), and with `uniform` identical nodes (every score
    ties)."""
    rng = np.random.default_rng(seed)
    if uniform:
        alloc = np.tile(rng.integers(3, 9, size=(1, r)) * 1000, (n, 1))
    else:
        alloc = rng.integers(2, 9, size=(n, r)) * 1000
    alloc = alloc.astype(np.int32)
    used = (alloc * rng.uniform(0, 0.6, size=(n, r))).astype(np.int32)
    if uniform:
        used[:] = used[0]
    mask = rng.random((c, n)) > 0.2
    mask[0] = False
    static = (np.repeat(rng.integers(0, 3, size=(c, 1)), n, axis=1)
              if uniform else rng.uniform(0, 4, size=(c, n))
              ).astype(np.float32)
    req = rng.integers(100, 2500, size=(w, r)).astype(np.int32)
    base = n                                           # this shard's base
    e = np.full((w,), -1, np.int32)
    e[1], e[2], e[3] = base + 5, 7, base + n + 1       # one in-shard, two not
    return dict(
        mask=mask, static_sc=static, alloc_q=alloc, free_q=alloc - used,
        free_pods=rng.integers(0, 3, size=(n,)).astype(np.int32),
        used_nz=used, req=req, req_nz=req,
        row=rng.integers(0, c, size=(w,)).astype(np.int32),
        e=e, el=(e - base).astype(np.int32),
        real=np.arange(w) < w - 2,                    # two padding members
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32),
        w_fit=np.float32(1.0), w_bal=np.float32(1.0))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wave_eval_reference_matches_pallas(strategy):
    for seed, r, uniform in ((1, 2, False), (2, 3, False), (3, 2, True)):
        a = _eval_inputs(seed, r, uniform)
        jm, jmm = pallas_kernel.wave_eval(
            *(jnp.asarray(v) for v in a.values()), strategy, interpret=True)
        t = {k: convert.to_tensor(v, CPU) if np.ndim(v) else float(v)
             for k, v in a.items()}
        tm, tmm = twave.wave_eval_reference(**t, strategy=strategy)
        np.testing.assert_array_equal(tmm.numpy(), np.asarray(jmm))
        jm, tm = np.asarray(jm), tm.numpy()
        np.testing.assert_array_equal(np.isneginf(tm), np.isneginf(jm))
        finite = np.isfinite(jm)
        np.testing.assert_allclose(tm[finite], jm[finite], rtol=0,
                                   atol=1e-4)
        assert finite.any() and not finite.all()
        assert not tmm.numpy()[-2:].any()              # padding members
        assert not tmm.numpy()[a["row"] == 0].any()    # the infeasible row
        assert not tmm.numpy()[2:4].any()              # exc in another shard


def test_wave_eval_shard_axis_matches_per_shard_calls():
    """The launch layout with a leading shard axis computes, per shard,
    exactly what the reference's one-shard call does."""
    a = _eval_inputs(4, 2, False, n=4 * 16)
    t = {k: convert.to_tensor(v, CPU) if np.ndim(v) else float(v)
         for k, v in a.items()}
    s, L = 4, 16
    base = torch.arange(s, dtype=torch.int32) * L
    el = t["e"][None, :] - base[:, None]
    stacked = dict(t, el=el,
                   mask=t["mask"].reshape(-1, s, L).transpose(0, 1),
                   static_sc=t["static_sc"].reshape(-1, s, L).transpose(0, 1),
                   alloc_q=t["alloc_q"].reshape(s, L, -1),
                   free_q=t["free_q"].reshape(s, L, -1),
                   used_nz=t["used_nz"].reshape(s, L, -1),
                   free_pods=t["free_pods"].reshape(s, L))
    before = twave.wave_eval.launches
    got_m, got_g = twave.wave_eval(**stacked, strategy="LeastAllocated")
    assert twave.wave_eval.launches == before      # CPU: the plain version
    for k in range(s):
        one = {name: (v[k] if name in ("mask", "static_sc", "alloc_q",
                                       "free_q", "used_nz", "free_pods",
                                       "el") else v)
               for name, v in stacked.items()}
        m, g = twave.wave_eval_reference(**one, strategy="LeastAllocated")
        assert torch.equal(got_m[k], m) and torch.equal(got_g[k], g)


# ---------------------------------------------------------------------------
# the sharded solver against the reference
# ---------------------------------------------------------------------------

#: (shards, W, strategy, planes): each case is one JAX compile, so the
#: cases cover shards {1, 4, 8}, W {2, 8}, the three strategies and both
#: plane forms without taking their product. "classes" = class planes
#: through `rows` with pinned exceptions in global coordinates, on tight
#: storms; "pods" = per-pod planes on a loose and a tight storm.
CASES = [(1, 2, "MostAllocated", "classes"),
         (4, 8, "LeastAllocated", "pods"),
         (8, 2, "RequestedToCapacityRatio", "pods"),
         (8, 8, "LeastAllocated", "classes")]


@pytest.mark.parametrize("shards,w,strategy,planes", CASES)
def test_sharded_wavefront_matches_jax(shards, w, strategy, planes):
    jmesh, tmesh = jpar.build_mesh(shards), tpar.build_mesh(shards, CPU)
    if planes == "classes":
        problems = [_storm(seed, classes=4, pinned=True) for seed in (11, 12)]
    else:
        problems = [_storm(20, r=3, tight=False), _storm(26, r=3)]
    replays = 0
    for i, args in enumerate(problems):
        want = _jax_assign(jpar.sharded_greedy_assign, jmesh, args,
                           strategy, wave_w=w, pallas=True)
        got = _port_assign(tpar.sharded_greedy_assign, tmesh, args,
                           strategy, wave_w=w, kernel=False)
        np.testing.assert_array_equal(got, want, err_msg=f"problem {i}")
        replays += _replays(args, strategy, w)
    assert replays > 0                    # the storms drove the replay


def test_sharded_serial_route_matches_jax():
    """wave_w ≤ 1: the one-pod step at 4 shards."""
    jmesh, tmesh = jpar.build_mesh(4), tpar.build_mesh(4, CPU)
    for seed in (30, 31):
        args = _storm(seed, classes=4, pinned=True)
        want = _jax_assign(jpar.sharded_greedy_assign, jmesh, args,
                           "MostAllocated")
        got = _port_assign(tpar.sharded_greedy_assign, tmesh, args,
                           "MostAllocated")
        np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")


def test_multislice_matches_jax():
    """A 2 × 2 (slice × nodes) mesh: node axis over both, reductions
    innermost first (the serial step; the wavefront form on this mesh is
    held against the single-device solver below)."""
    jmesh = jpar.build_multislice_mesh(2, 2)
    tmesh = tpar.build_multislice_mesh(2, 2, device=CPU)
    for seed in (40, 41):
        args = _storm(seed, classes=4, pinned=True)
        want = _jax_assign(jpar.sharded_greedy_assign_multislice, jmesh,
                           args, "RequestedToCapacityRatio")
        got = _port_assign(tpar.sharded_greedy_assign_multislice, tmesh,
                           args, "RequestedToCapacityRatio")
        np.testing.assert_array_equal(got, want, err_msg=f"seed={seed}")


def test_masks_scores_match_jax():
    """The (pods × nodes) phase on a (2, 4) mesh: masks identical, static
    scores within atol=1e-4."""
    rng = np.random.default_rng(50)
    p, n, r, tf, tp = 8, N, 2, 3, 2
    alloc = rng.integers(2, 9, size=(n, r)).astype(np.int32) * 1000
    used = (alloc * rng.uniform(0, 0.9, size=(n, r))).astype(np.int32)
    alloc_pods = rng.integers(1, 6, size=(n,)).astype(np.int32)
    arrays = dict(
        alloc_q=alloc, used_q=used, used_nz_q=used, alloc_pods=alloc_pods,
        used_pods=np.minimum(rng.integers(0, 6, size=(n,)),
                             alloc_pods).astype(np.int32),
        req_q=rng.integers(100, 3000, size=(p, r)).astype(np.int32),
        req_nz_q=rng.integers(100, 3000, size=(p, r)).astype(np.int32),
        untol_f=rng.random((p, tf)) > 0.7, untol_p=rng.random((p, tp)) > 0.4,
        taint_f_mat=rng.random((n, tf)) > 0.8,
        taint_p_mat=rng.random((n, tp)) > 0.5,
        static_mask=rng.random((p, n)) > 0.1,
        host_scores=rng.uniform(0, 30, size=(p, n)).astype(np.float32))
    jmesh = jpar.build_mesh_2d(8)
    tmesh = tpar.build_mesh_2d(8, device=CPU)
    assert tmesh.shape == dict(jmesh.shape) == {"pods": 2, "nodes": 4}
    want = jpar.sharded_masks_scores(
        jmesh, *(jnp.asarray(v) for v in arrays.values()), 3.0, True,
        "LeastAllocated")
    got = tpar.sharded_masks_scores(
        tmesh, **convert.masks_scores_inputs(
            tmesh, dict(arrays, w_taint=np.float32(3.0),
                        taint_filter_on=np.bool_(True))),
        strategy="LeastAllocated")
    for name, g, w in zip(("mask", "feasible"), got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0,
                               atol=1e-4)
    assert got[1].any() and not got[1].all()
    assert (got[2].numpy() != arrays["host_scores"]).any()  # taint scored


# ---------------------------------------------------------------------------
# port-only behaviour (no JAX)
# ---------------------------------------------------------------------------

def test_padded_node_axis_and_kernel_route_on_cpu():
    """convert pads a node axis the shard count does not divide (padding
    never fits), and kernel=True on CPU tensors runs the plain version:
    on a 1-D and a 2 × 4 multislice mesh, with and without the kernel,
    the same assignments as the single-device solver and no launch
    counted."""
    rng = np.random.default_rng(60)
    args, _ = _problem(rng, n=62, p=P, r=2, tight=True, classes=3)
    one = convert.sharded_solver_inputs(tpar.build_mesh(1, CPU), args)
    want = tsolver.greedy_assign_rescoring(strategy="LeastAllocated", **one)
    before = twave.wave_eval.launches
    for fn, mesh in ((tpar.sharded_greedy_assign, tpar.build_mesh(8, CPU)),
                     (tpar.sharded_greedy_assign_multislice,
                      tpar.build_multislice_mesh(2, 4, device=CPU))):
        inputs = convert.sharded_solver_inputs(mesh, args)
        assert inputs["free_q"].shape[0] == 64
        assert inputs["mask"].shape[1] == 64
        for kernel in (True, False):
            got = fn(mesh, strategy="LeastAllocated", wave_w=8,
                     kernel=kernel, **inputs)
            assert torch.equal(got, want), (mesh.shape, kernel)
    assert twave.wave_eval.launches == before


@pytest.mark.parametrize("option", [
    dict(shortlist_k=4), dict(block_w=8), dict(shortlist_k=4, wave_w=1),
    dict(shortlist_k=4, block_w=8, wave_w=1)])
def test_unported_options_raise(option):
    """The shard-local shortlist and block index are ported: no option
    raises any more. wave_w > 1 wins over shortlist_k (the shortlist runs
    at W <= 1); block_w without a shortlist is ignored, as in the
    reference. Every route places as the single-device solve does."""
    storm = _storm(70)
    args = convert.sharded_solver_inputs(tpar.build_mesh(2, CPU), storm)
    one = convert.sharded_solver_inputs(tpar.build_mesh(1, CPU), storm)
    want = tsolver.greedy_assign_rescoring(strategy="LeastAllocated", **one)
    for fn, mesh in ((tpar.sharded_greedy_assign, tpar.build_mesh(2, CPU)),
                     (tpar.sharded_greedy_assign_multislice,
                      tpar.build_multislice_mesh(2, 1, device=CPU))):
        got = fn(mesh, strategy="LeastAllocated", **args,
                 **{"wave_w": 8, **option})
        assert torch.equal(got, want), (mesh.shape, option)


def test_build_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tpar.build_mesh, tpar.build_mesh_2d,
                  lambda: tpar.build_multislice_mesh(2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    mesh = tpar.build_mesh(4, device="cpu")
    assert mesh.devices == (CPU,) * 4 and mesh.device == CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tpar.build_mesh(2).devices == (torch.device("cuda:0"),) * 2


def test_mesh_shapes_and_limits():
    with pytest.raises(ValueError, match="NODE_PAD"):
        tpar.build_multislice_mesh(3, 1, device=CPU)
    with pytest.raises(ValueError, match="divide"):
        tpar.build_mesh_2d(6, pods_parallelism=4, device=CPU)
    two = tpar.Mesh(("nodes",), (2,), (CPU, torch.device("meta")))
    with pytest.raises(NotImplementedError, match="Blocked on hardware"):
        two.device
    args = convert.sharded_solver_inputs(tpar.build_mesh(1, CPU),
                                         _storm(71))
    with pytest.raises(ValueError, match="divide into 3 shards"):
        tpar.sharded_greedy_assign(tpar.build_mesh(3, CPU),
                                   strategy="LeastAllocated", **args)
    assert tpar.pad_axis(np.ones((5, 2)), 4, 0).shape == (8, 2)
