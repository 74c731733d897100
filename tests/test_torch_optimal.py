"""The port's Sinkhorn optimal route against the JAX reference, on the CPU.

Every input is made from a seed with numpy and handed to both packages.
Tolerances, and why:

- `chunk_start_scores`: atol 1e-4 on O(100) scores, the port's stated
  bound for live scores (fit and balanced differ by a few ulp where XLA
  fuses; see ROADMAP "Measured before the port began").
- `sinkhorn_plan` / `sharded_sinkhorn_plan`: rtol 1e-4, atol 1e-5 on the
  plan and on the log-plan, the reference's own parity tolerance
  (tests/test_optimal_solver.py::TestShardedSinkhornParity); the
  sanitization mask (-1e30 entries) must be exactly equal. The sums run in
  another order than XLA's, and `exp`/`log` are other implementations.
- fragmentation: rtol 1e-6, a mean of O(1) fractions over a few hundred
  nodes summed in another order.
- assignments, counters and masks: identical.

The large-spread fixtures scale the costs by 10 and 100, so `exp` of the
row-relative costs falls into float32's subnormal range. XLA on the CPU
flushes those values to zero and a TPU has none; the port flushes them
explicitly (`solver._sinkhorn`), and without that flush these fixtures
differ from the reference by up to ~14 in the log-plan.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kubernetes_tpu import parallel as jpar
from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.ops import kernels as jkernels
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch import parallel as tpar
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.ops import kernels as tkernels
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops import wave_kernel
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from kubernetes_tpu_torch.utils import flags as tflags
from test_optimal_solver import _class_problem
from test_torch_backend import SLICE_PLUGINS, _snapshot, cluster_objects

CPU = torch.device("cpu")
STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")
PLAN_TOL = dict(rtol=1e-4, atol=1e-5)
#: Every flag the batch cycles below read, unset for a flagless run.
_FLAGS = ("KTPU_SOLVE_MODE", "KTPU_WAVE_WIDTH", "KTPU_CLASS_PLANES",
          "KTPU_CLASS_PAD", "KTPU_SHORTLIST_K", "KTPU_PALLAS",
          "KTPU_SINKHORN_ITERS", "KTPU_SINKHORN_TEMP")


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


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _both_plans(feasible, cost, counts, cap, iters=24, temp=0.05):
    """(JAX (log_plan, plan), port (log_plan, plan)) as numpy."""
    jl, jp = jsolver.sinkhorn_plan(
        jnp.asarray(feasible), jnp.asarray(cost), jnp.asarray(counts),
        jnp.asarray(cap), jnp.int32(iters), jnp.float32(temp))
    tl, tp = tsolver.sinkhorn_plan(_t(feasible), _t(cost), _t(counts),
                                   _t(cap), iters, temp)
    return (np.asarray(jl), np.asarray(jp)), (tl.numpy(), tp.numpy())


def _assert_plans_agree(ref, got, what=""):
    (jl, jp), (tl, tp) = ref, got
    np.testing.assert_array_equal(tl == -1e30, jl == -1e30,
                                  err_msg=f"{what}: sanitization")
    np.testing.assert_allclose(tl, jl, **PLAN_TOL, err_msg=f"{what}: log")
    np.testing.assert_allclose(tp, jp, **PLAN_TOL, err_msg=f"{what}: plan")


def _spread_problem(seed: int, spread: float):
    """A seeded class problem of C 2-16 classes over N 50-3000 nodes with
    costs uniform in [0, 4 * spread): spreads 10 and 100 drive `exp` of
    the row-relative costs into float32's subnormal range."""
    rng = np.random.default_rng(seed)
    c, n = int(rng.integers(2, 17)), int(rng.integers(50, 3001))
    feasible = rng.random((c, n)) > 0.2
    feasible[:, 0] = True
    cost = (rng.uniform(0, 4, (c, n)) * spread).astype(np.float32)
    counts = rng.integers(0, 40, (c,)).astype(np.float32)
    cap = rng.integers(0, 8, (n,)).astype(np.float32)
    return feasible, cost, counts, cap


# --- chunk_start_scores -----------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
def test_chunk_start_scores_matches_reference(strategy):
    rng = np.random.default_rng(STRATEGIES.index(strategy))
    n, s, r = 96, 7, 3
    alloc = (rng.integers(1, 9, (n, r)) * 1000).astype(np.int32)
    alloc[::11, 2] = 0                       # a column with no allocatable
    used = (alloc * rng.uniform(0, 0.9, (n, r))).astype(np.int32)
    req = rng.integers(0, 2500, (s, r)).astype(np.int32)
    static = rng.uniform(0, 50, (s, n)).astype(np.float32)
    static[1] = -1e30                        # a sanitized plan row
    colw = np.array([1.0, 2.0, 1.0], np.float32)
    balm = np.array([True, True, False])
    su = np.array([0.0, 50.0, 100.0], np.float32)
    ss = np.array([0.0, 4.0, 10.0], np.float32)
    want = np.asarray(jkernels.chunk_start_scores(
        jnp.asarray(alloc), jnp.asarray(used), jnp.asarray(req),
        jnp.asarray(static), jnp.asarray(colw), jnp.asarray(balm),
        jnp.asarray(su), jnp.asarray(ss), jnp.float32(1.0),
        jnp.float32(2.0), strategy))
    got = tkernels.chunk_start_scores(
        _t(alloc), _t(used), _t(req), _t(static), _t(colw), _t(balm),
        _t(su), _t(ss), 1.0, 2.0, strategy).numpy()
    assert got.dtype == np.float32 and got.shape == (s, n)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got[1] == -1e30).all()


# --- sinkhorn_plan ----------------------------------------------------------

def test_plan_marginals_and_feasibility():
    """TestSinkhornPlan's first fixture: the reference's plan, and the
    same properties — full row counts, column inequality, no mass on an
    infeasible cell."""
    rng = np.random.default_rng(0)
    c, n = 5, 12
    feasible = rng.random((c, n)) > 0.3
    feasible[:, 0] = True
    cost = rng.uniform(0, 4, size=(c, n)).astype(np.float32)
    counts = rng.integers(1, 6, size=(c,)).astype(np.float32)
    cap = np.full((n,), 50.0, np.float32)
    ref, got = _both_plans(feasible, cost, counts, cap, iters=48)
    _assert_plans_agree(ref, got)
    log_plan, plan = got
    np.testing.assert_allclose(plan.sum(axis=1), counts, rtol=1e-3)
    assert (plan.sum(axis=0) <= cap + 1e-3).all()
    assert (plan[~feasible] == 0).all()
    assert (log_plan[~feasible] == -1e30).all()


def test_plan_column_capacity_binds():
    feasible = np.ones((3, 4), bool)
    cost = np.zeros((3, 4), np.float32)
    counts = np.asarray([4.0, 4.0, 4.0], np.float32)
    cap = np.asarray([2.0, 2.0, 2.0, 2.0], np.float32)
    ref, got = _both_plans(feasible, cost, counts, cap, iters=64)
    _assert_plans_agree(ref, got)
    assert (got[1].sum(axis=0) <= cap + 1e-3).all()


def test_plan_degenerate_inputs_stay_finite():
    """All-infeasible rows, zero capacity, zero counts."""
    feasible = np.zeros((2, 3), bool)
    z = np.zeros((2, 3), np.float32)
    ref, got = _both_plans(feasible, z, np.zeros((2,), np.float32),
                           np.zeros((3,), np.float32), iters=8)
    _assert_plans_agree(ref, got)
    assert np.isfinite(got[1]).all()
    assert (got[0] == -1e30).all()


def test_plan_empty_class_row_stays_finite():
    """The backend's row 0: all infeasible, its count the padding pods,
    so u[0] = count / eps, about 1e13 — finite, and equal to the
    reference's."""
    rng = np.random.default_rng(5)
    feasible = rng.random((4, 40)) > 0.3
    feasible[0] = False
    cost = rng.uniform(0, 100, (4, 40)).astype(np.float32)
    counts = np.array([24.0, 300.0, 500.0, 200.0], np.float32)
    cap = np.full((40,), 30.0, np.float32)
    ref, got = _both_plans(feasible, cost, counts, cap)
    _assert_plans_agree(ref, got)
    assert np.isfinite(got[1]).all() and (got[0][0] == -1e30).all()


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_plan_on_class_problems(seed, tight):
    """test_optimal_solver's `_class_problem` fixtures (32 iterations,
    its `_optimal_scores`)."""
    pr = _class_problem(np.random.default_rng(seed), n=24, c=5, p=31, r=2,
                        tight=tight)
    counts = np.bincount(pr["rows"], minlength=5).astype(np.float32)
    ref, got = _both_plans(pr["mask"], pr["scores"], counts,
                           pr["free_pods"], iters=32)
    _assert_plans_agree(ref, got, f"seed {seed} tight {tight}")


@pytest.mark.parametrize("spread", [1.0, 10.0, 100.0])
def test_plan_large_cost_spread_flushes_subnormals(spread):
    """Six seeded problems per spread. Without the port's flush of
    `exp`'s subnormal outputs, spreads 10 and 100 miss the reference by
    up to ~14 in the log-plan of feasible entries."""
    for seed in range(6):
        ref, got = _both_plans(*_spread_problem(seed, spread))
        _assert_plans_agree(ref, got, f"seed {seed} spread {spread}")


def test_plan_identical_columns_are_bit_identical():
    """Groups of identical columns (feasibility, cost and capacity) get
    one log-plan value per group: the rounding's lowest-id tie rule then
    makes it first-fit. Both fixtures have N = 4093, which leaves a ragged
    tail after any vector width: a reduction over the class axis that sums
    the tail in another order splits the heterogeneous chunk's groups."""
    from chip_smoke import identical_column_groups
    from test_torch_cuda import _plan_case

    rng = np.random.default_rng(11)
    groups = rng.integers(0, 5, size=(4093,))
    feasible = (rng.random((6, 5)) > 0.2)[:, groups]
    cost = rng.uniform(0, 60, (6, 5)).astype(np.float32)[:, groups]
    cap = rng.integers(1, 9, (5,)).astype(np.float32)[groups]
    counts = rng.integers(0, 200, (6,)).astype(np.float32)
    for problem in ((_t(feasible), _t(cost), _t(counts), _t(cap)),
                    _plan_case(4133, 4093, CPU)[0]):
        log_plan, _ = tsolver.sinkhorn_plan(*problem, 24, 0.05)
        assert identical_column_groups(torch, problem[0], problem[1],
                                       problem[3], log_plan) < 4093


def test_plan_is_float32_and_knobs_are_live(flagless):
    assert tflags.get("KTPU_SINKHORN_ITERS") == 24
    assert tflags.get("KTPU_SINKHORN_TEMP") == pytest.approx(0.05)
    with tflags.scoped_set("KTPU_SINKHORN_ITERS", "9"), \
            tflags.scoped_set("KTPU_SINKHORN_TEMP", "0.2"):
        assert tflags.get("KTPU_SINKHORN_ITERS") == 9
        assert tflags.get("KTPU_SINKHORN_TEMP") == pytest.approx(0.2)
    with tflags.scoped_set("KTPU_SINKHORN_TEMP", "warm"):
        assert tflags.get("KTPU_SINKHORN_TEMP") == pytest.approx(0.05)
    f, c, n, cap = _spread_problem(1, 1.0)
    log_plan, plan = tsolver.sinkhorn_plan(_t(f), _t(c), _t(n), _t(cap),
                                           0, 0.05)   # 0 runs 1 iteration
    assert log_plan.dtype == plan.dtype == torch.float32
    ref, _ = _both_plans(f, c, n, cap, iters=1)
    np.testing.assert_allclose(log_plan.numpy(), ref[0], **PLAN_TOL)


# --- the rounding -----------------------------------------------------------

def _rounding_args(pr, static):
    r = pr["alloc_q"].shape[1]
    return dict(
        req_q=pr["req_q"], req_nz_q=pr["req_q"],
        free_q=pr["alloc_q"] - pr["used_q"], free_pods=pr["free_pods"],
        used_nz_q=pr["used_q"], alloc_q=pr["alloc_q"], mask=pr["mask"],
        static_scores=static.astype(np.float32),
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 100.0], np.float32),
        shape_s=np.array([0.0, 10.0], np.float32))


def _rounding_case(seed, tight):
    """A `_class_problem` fixture, its four pod orders and no gangs, and
    both packages' log-plans of it (32 iterations)."""
    rng = np.random.default_rng(seed)
    pr = _class_problem(rng, n=24, c=5, p=31, r=2, tight=tight)
    p = pr["req_q"].shape[0]
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(3)])
    counts = np.bincount(pr["rows"], minlength=5).astype(np.float32)
    (jl, _), (tl, _) = _both_plans(pr["mask"], pr["scores"], counts,
                                   pr["free_pods"], iters=32)
    return pr, perms, jl, tl


def _round(pr, perms, jl, tl):
    """The reference's `multistart_greedy_assign` on `jl`, and the port's
    plain and kernel forms on `tl` (on the CPU the kernel form runs its
    plain version: no launch is counted); live weights zeroed."""
    p = pr["req_q"].shape[0]
    onehot = np.zeros((p, 4), np.float32)
    required = np.zeros((4,), np.float32)
    want = np.asarray(jsolver.multistart_greedy_assign(
        **{k: jnp.asarray(v) for k, v in _rounding_args(pr, jl).items()},
        w_fit=jnp.float32(0.0), w_bal=jnp.float32(0.0),
        strategy="LeastAllocated", perms=jnp.asarray(perms),
        gang_onehot=jnp.asarray(onehot), gang_required=jnp.asarray(required),
        rows=jnp.asarray(pr["rows"])))
    ta = {k: _t(v) for k, v in _rounding_args(pr, tl).items()}
    before = wave_kernel.wave_solve.launches
    got = [fn(**ta, w_fit=0.0, w_bal=0.0, strategy="LeastAllocated",
              perms=_t(perms), gang_onehot=_t(onehot),
              gang_required=_t(required), rows=_t(pr["rows"])).numpy()
           for fn in (tsolver.multistart_greedy_assign,
                      tsolver.multistart_greedy_assign_kernel)]
    assert wave_kernel.wave_solve.launches == before
    return want, got


def _row_orders(log_plan, mask):
    """Per class row, its feasible nodes in the rounding's order (log-plan
    descending, then node id ascending)."""
    n = log_plan.shape[1]
    return [tuple(j for j in np.lexsort((np.arange(n), -row)) if m[j])
            for row, m in zip(log_plan, mask)]


@pytest.mark.parametrize("tight", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_rounding_of_one_plan_matches_reference(seed, tight):
    """The reference's log-plan as static scores in both packages: the
    port's W=1 multistart, plain and kernel form, places exactly as the
    reference's `multistart_greedy_assign`."""
    pr, perms, jl, _ = _rounding_case(seed, tight)
    want, got = _round(pr, perms, jl, jl)
    for name, g in zip(("plain", "kernel form"), got):
        np.testing.assert_array_equal(g, want, err_msg=name)
    assert (want >= 0).any()


@pytest.mark.parametrize("tight", [False, True])
def test_rounded_assignments_from_each_plan(tight):
    """Each package rounds its OWN plan. Where the two plans rank every
    class row's feasible nodes the same, the assignments are identical.
    Where they do not, each swapped pair is a float tie: two values within
    1e-6 of each other in both plans. (On tight fixtures a node whose
    remaining pod slot binds has plan mass exactly 1 in exact arithmetic;
    the reference's log-plan holds 0.0 or -5.96e-08 there, one float32 ulp
    of 1 apart, and the port's another of the two.)"""
    same_order = 0
    for seed in range(4):
        pr, perms, jl, tl = _rounding_case(seed, tight)
        oj, ot = _row_orders(jl, pr["mask"]), _row_orders(tl, pr["mask"])
        if oj == ot:
            want, got = _round(pr, perms, jl, tl)
            for name, g in zip(("plain", "kernel form"), got):
                np.testing.assert_array_equal(g, want,
                                              err_msg=f"{name} {seed}")
            same_order += 1
            continue
        for r, (a, b) in enumerate(zip(oj, ot)):
            for x, y in zip(a, b):
                if x != y:
                    assert abs(jl[r, x] - jl[r, y]) <= 1e-6, (seed, r)
                    assert abs(tl[r, x] - tl[r, y]) <= 1e-6, (seed, r)
    assert same_order >= (4 if not tight else 2)


def test_w1_kernel_form_on_sanitized_rows_with_exceptions():
    """`multistart_greedy_assign_kernel` equals the plain multistart on a
    plane whose rows hold -1e30 (the sanitized log-plan) and on pods with
    exception columns, all with w_fit = w_bal = 0."""
    from chip_smoke import hetero_chunk
    arrays, rows, exc, perms = hetero_chunk(seed=21, n=200, p=96, k=4)
    static = arrays["static_scores"].copy()
    static[:, ::3] = -1e30
    static[2] = -1e30
    t = {k: _t(v) for k, v in dict(arrays, static_scores=static).items()}
    p = rows.shape[0]
    gang = (torch.zeros((p, 4)), torch.zeros((4,)))
    kw = dict(w_fit=0.0, w_bal=0.0, strategy="LeastAllocated",
              perms=_t(perms), gang_onehot=gang[0], gang_required=gang[1],
              rows=_t(rows), exc=_t(exc))
    want = tsolver.multistart_greedy_assign(**t, **kw)
    got = tsolver.multistart_greedy_assign_kernel(**t, **kw)
    assert torch.equal(got, want)
    assert 0 < int((want >= 0).sum()) < p


# --- fragmentation ----------------------------------------------------------

def test_fragmentation_matches_reference():
    rng = np.random.default_rng(3)
    n, r = 257, 3
    alloc = (rng.integers(1, 9, (n, r)) * 1000).astype(np.int32)
    alloc[::7, 1] = 0
    free = (alloc * rng.uniform(0, 1, (n, r))).astype(np.int32)
    used_pods = rng.integers(0, 3, (n,)).astype(np.int32)
    valid = np.arange(n) < 250
    for args_np in ((free, alloc, valid),):
        want = float(jsolver.fragmentation(*map(jnp.asarray, args_np)))
        got = tsolver.fragmentation(*map(_t, args_np))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)
    for pods in (used_pods, np.zeros_like(used_pods)):
        a = (free, alloc, pods, valid)
        want = float(jsolver.fragmentation_occupied(*map(jnp.asarray, a)))
        got = float(tsolver.fragmentation_occupied(*map(_t, a)))
        np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(tsolver.fragmentation_occupied(
        _t(free), _t(alloc), _t(np.zeros_like(used_pods)), _t(valid))) == 0


# --- sharded_sinkhorn_plan --------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_sharded_plan_matches_reference(n_devices):
    """TestShardedSinkhornParity's fixture: the port's S-shard plan against
    the JAX shard_map plan on the virtual CPU mesh and against the port's
    single-device plan."""
    import jax
    if len(jax.devices()) < n_devices:
        pytest.skip("the virtual CPU mesh has fewer devices")
    rng = np.random.default_rng(n_devices)
    c, n = 6, 64
    feasible = rng.random((c, n)) > 0.25
    feasible[:, 0] = True
    cost = rng.uniform(0, 4, size=(c, n)).astype(np.float32)
    counts = rng.integers(1, 8, size=(c,)).astype(np.float32)
    cap = rng.integers(0, 6, size=(n,)).astype(np.float32)
    jl, jp = jpar.sharded_sinkhorn_plan(
        jpar.build_mesh(n_devices), jnp.asarray(feasible), jnp.asarray(cost),
        jnp.asarray(counts), jnp.asarray(cap), 32, 0.05)
    tl, tp = tpar.sharded_sinkhorn_plan(
        tpar.build_mesh(n_devices, CPU), _t(feasible), _t(cost),
        _t(counts), _t(cap), 32, 0.05)
    _assert_plans_agree((np.asarray(jl), np.asarray(jp)),
                        (tl.numpy(), tp.numpy()), f"{n_devices} shards")
    sl, sp = tsolver.sinkhorn_plan(_t(feasible), _t(cost), _t(counts),
                                   _t(cap), 32, 0.05)
    assert torch.equal(tl == -1e30, sl == -1e30)
    np.testing.assert_allclose(tp.numpy(), sp.numpy(), **PLAN_TOL)


def test_sharded_plan_multislice_and_limits():
    """A 2 x 2 (slice x nodes) mesh reduces over both axes; a node count
    the shards do not divide, and a mesh over two devices, raise."""
    f, c, n, cap = _spread_problem(2, 10.0)
    f, c, cap = f[:, :800], c[:, :800], cap[:800]
    mesh = tpar.build_multislice_mesh(2, 2, device=CPU)
    got = tpar.sharded_sinkhorn_plan(
        mesh, _t(f), _t(c), _t(n), _t(cap), 24, 0.05,
        axes=(tpar.SLICE_AXIS, tpar.NODES_AXIS))
    want = tsolver.sinkhorn_plan(_t(f), _t(c), _t(n), _t(cap), 24, 0.05)
    assert torch.equal(got[0] == -1e30, want[0] == -1e30)
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), **PLAN_TOL)
    with pytest.raises(ValueError, match="divide into 3 shards"):
        tpar.sharded_sinkhorn_plan(tpar.build_mesh(3, CPU), _t(f), _t(c),
                                   _t(n), _t(cap), 24, 0.05)
    two = tpar.Mesh(("nodes",), (2,), (CPU, torch.device("meta")))
    with pytest.raises(NotImplementedError, match="Blocked on hardware"):
        tpar.sharded_sinkhorn_plan(two, _t(f), _t(c), _t(n), _t(cap), 24,
                                   0.05)


# --- the route through the backend ------------------------------------------

def _jax_backend_inputs(max_batch):
    nodes, residents, pending = cluster_objects(seed=7)
    snap = _snapshot(jtypes, nodes, residents)
    fwk = jframework.Framework(jregistry.build_plugins(SLICE_PLUGINS),
                               jregistry.DEFAULT_SCORE_WEIGHTS)
    jb = jbackend.TPUBackend(max_batch=max_batch, multistart=4, mesh=None)
    return jb, snap, fwk, [jtypes.PodInfo(p) for p in pending]


def _torch_backend_inputs():
    nodes, residents, pending = cluster_objects(seed=7)
    snap = _snapshot(ttypes, nodes, residents)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    return snap, fwk, [ttypes.PodInfo(p) for p in pending]


def test_fused_program_optimal_matches_reference(flagless):
    """`mask_solve_update(solve_mode="optimal")` vs the reference's
    `_mask_solve_update` on the seed-7 cluster's one 79-pod chunk,
    carried across by ops/convert.py: assignments, used state and the
    diagnostic planes identical."""
    jb, jsnap, jfwk, jpods = _jax_backend_inputs(128)
    ctx = jb._start(jpods, jsnap, jfwk)
    prep = jb._prep_chunk(ctx.chunks[0], ctx)
    st, p = jb.ensure_static(ctx.ct), ctx.params
    named = dict(alloc_q=st["alloc_q"], used_pack=jb._dev_used,
                 alloc_pods=st["alloc_pods"], class_pack=prep["dev_pack"],
                 cls_idx=prep["dev_cls"], exc_col=prep["dev_exc"],
                 taint_f_mat=st["taint_f"], taint_p_mat=st["taint_p"],
                 class_mask=prep["dev_mask"],
                 class_scores=prep["dev_scores"], perms=prep["dev_perms"])
    gang = jb._gang_args(prep, prep["batch"])
    P = prep["batch"].req_q.shape[0]
    spread = jb._spread_dummies(ctx.ct.n_pad, P)
    ref = jbackend._mask_solve_update(
        **named, fit_col_w=p["fit_col_w"], bal_col_mask=p["bal_col_mask"],
        shape_u=p["shape_u"], shape_s=p["shape_s"], w_fit=p["w_fit"],
        w_bal=p["w_bal"], w_taint=p["w_taint"],
        taint_filter_on=p["taint_filter_on"], dom_onehot=spread[0],
        cid_onehot=spread[1], dom_counts=spread[2], max_skew=spread[3],
        sp_min_ok=spread[4], sp_haskey=spread[5], sp_applies=spread[6],
        sp_contrib=spread[7], gang_onehot=gang[0],
        gang_required=gang[1], sink_iters=np.int32(24),
        sink_temp=np.float32(0.05), n_real=np.int32(ctx.ct.n_real),
        strategy=p["strategy"], use_spread=False, shortlist_k=0,
        wave_w=0, solve_mode="optimal", pallas="off", block_w=0)
    ref = [np.asarray(x) for x in ref]
    kwargs = convert.mask_solve_inputs(
        **named, params=p, gang_onehot=gang[0], gang_required=gang[1],
        wave_w=0, solve_mode="optimal", sink_iters=24, sink_temp=0.05,
        device="cpu")
    got = [x.numpy() for x in tbackend.mask_solve_update(**kwargs)]
    for name, g, r in zip(("assign", "used_pack", "fit0", "taint_ok"),
                          got, ref[:4]):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    assert (ref[0][:P] >= 0).sum() > 64


@pytest.mark.parametrize("wave_w", [1, 8])
def test_greedy_at_small_wave_width_matches_reference(flagless, wave_w):
    """KTPU_SOLVE_MODE=greedy with KTPU_WAVE_WIDTH=1 routes every chunk to
    the W=1 multistart (the reference's `multistart_greedy_assign`; it
    raised before the W=1 route existed) and W=8 to the wavefront; both
    place as the reference at the same flags."""
    jb, jsnap, jfwk, jpods = _jax_backend_inputs(128)
    with jflags.scoped_set("KTPU_SOLVE_MODE", "greedy"), \
            jflags.scoped_set("KTPU_WAVE_WIDTH", wave_w):
        want, _ = jb.assign(jpods, jsnap, jfwk)
    snap, fwk, pods = _torch_backend_inputs()
    tb = tbackend.TorchBackend(device="cpu", max_batch=128)
    with tflags.scoped_set("KTPU_SOLVE_MODE", "greedy"), \
            tflags.scoped_set("KTPU_WAVE_WIDTH", wave_w):
        got, _ = tb.assign(pods, snap, fwk)
    assert got == want
    assert tb.counters["optimal_solves"] == 0
    assert (tb.counters["wave_commits"] + tb.counters["wave_replays"]
            == (0 if wave_w == 1 else len(pods)))


def test_flagless_iterations_knob_is_read_per_chunk(flagless):
    """The Sinkhorn knobs are live: a chunk run with KTPU_SINKHORN_ITERS=5
    reports 5 in the iterations gauge and places as the reference does
    under the same knob."""
    jb, jsnap, jfwk, jpods = _jax_backend_inputs(128)
    with jflags.scoped_set("KTPU_SINKHORN_ITERS", 5):
        want, _ = jb.assign(jpods, jsnap, jfwk)
    snap, fwk, pods = _torch_backend_inputs()
    tb = tbackend.TorchBackend(device="cpu", max_batch=128)
    with tflags.scoped_set("KTPU_SINKHORN_ITERS", 5):
        got, _ = tb.assign(pods, snap, fwk)
    assert got == want
    assert tb.counters["optimal_solves"] == 1
    assert tb.counters["sinkhorn_iterations"] == 5
    assert os.environ.get("KTPU_SINKHORN_ITERS") is None


@pytest.mark.parametrize("feature", ["gang", "spread"])
def test_gangs_and_spread_still_raise_flagless(flagless, feature):
    """The Sinkhorn route opens only eligible chunks. A chunk of 64 or
    more pods, one of them gang-labelled, places as the reference does:
    the default profile has no Coscheduling, so the label builds no gang
    arrays and the chunk takes the optimal route like any other. One of
    them with a hard topology spread constraint makes the chunk
    ineligible for the plan (structurally greedy in the reference): it
    runs the spread scan with the optimal-fallback bit set and places
    every pod as the reference does."""
    from kubernetes_tpu_torch.api.types import make_pod

    snap, fwk, pods = _torch_backend_inputs()
    tb = tbackend.TorchBackend(device="cpu", max_batch=128)
    if feature == "gang":
        odd = make_pod("gang-0", requests={"cpu": "1"},
                       labels={tbackend.POD_GROUP_LABEL: "pg"})
        jb, jsnap, jfwk, jpods = _jax_backend_inputs(128)
        want, _ = jb.assign(jpods + [jtypes.PodInfo(odd)], jsnap, jfwk)
        got, _ = tb.assign(pods + [ttypes.PodInfo(odd)], snap, fwk)
        assert got == want
        assert got["default/gang-0"] is not None
        assert tb.counters["chunks"] == tb.counters["optimal_solves"] == 1
        assert tb.counters["optimal_fallbacks"] == 0
        return
    odd = make_pod("spread-0", requests={"cpu": "1"},
                   topology_spread_constraints=[{
                       "maxSkew": 1,
                       "topologyKey": "topology.kubernetes.io/zone",
                       "whenUnsatisfiable": "DoNotSchedule"}])
    jb, jsnap, jfwk, jpods = _jax_backend_inputs(128)
    want, _ = jb.assign(jpods + [jtypes.PodInfo(odd)], jsnap, jfwk)
    got, _ = tb.assign(pods + [ttypes.PodInfo(odd)], snap, fwk)
    assert got == want
    assert tb.counters["chunks"] == tb.counters["spread_chunks"] == 1
    assert tb.counters["optimal_solves"] == 0
    assert tb.counters["optimal_fallbacks"] == 1
