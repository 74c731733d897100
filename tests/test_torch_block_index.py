"""The port's block-sparse prefilter against the JAX package's, on the CPU.

Mirrors `tests/test_block_index_solver.py`: the five block kernels of
`ops/kernels.py` (`_block_fold`, `block_capacity_aggregates`,
`block_feasible_stat`, `block_score_upper_bound`, `gathered_start_scores`)
and `solver.block_bound_prefilter` against the reference's, on the same
seeded inputs: integer aggregates, candidates, thresholds and the blocks
scanned and pruned identical, the float planes within the port's stated
score bound. Then the prefilter's outputs through the shortlist scans, and
the shortlist fixtures `chip_smoke.py` phase 13(a) runs on the card
(`chip_smoke.shortlist_case`: every arm of the exactness predicate, padding
columns, a ragged last block, exception columns and a poisoning storm)
through the whole shortlist route of both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SHORTLIST_CASES, SOLVE_ORDER, run_shortlist
from chip_smoke import shortlist_case, shortlist_inputs
from kubernetes_tpu.ops import kernels as jkernels
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu_torch.ops import kernels as tkernels
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.serving import resident
from test_shortlist_solver import prefilter, solver_args, synthetic
from test_torch_shortlist import _t, port_table, targs, tprefilter

LA = "LeastAllocated"
STRATEGIES = (LA, "MostAllocated", "RequestedToCapacityRatio")

# The reference's functions, jitted once per shape (their op-by-op form
# compiles every op on the CPU).
_jblock_bound_prefilter = jax.jit(jsolver.block_bound_prefilter,
                                  static_argnames=("strategy", "k",
                                                   "block_w"))
_jaggregates = jax.jit(jkernels.block_capacity_aggregates,
                       static_argnames=("block_w",))
_jfeasible_stat = jax.jit(jkernels.block_feasible_stat,
                          static_argnames=("block_w",))
_jupper_bound = jax.jit(jkernels.block_score_upper_bound,
                        static_argnames=("strategy",))
_jgathered = jax.jit(jkernels.gathered_start_scores,
                     static_argnames=("strategy",))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def block_prefilter(d, k, bw, strategy, w_fit=1.0, w_bal=1.0, n_real=None):
    """`test_block_index_solver.block_prefilter`, jitted: the reference's
    (per-pod scan arguments, scanned, pruned)."""
    a = solver_args(d, w_fit, w_bal)
    n = d["alloc_q"].shape[0]
    n_real = n if n_real is None else n_real
    fits0 = np.all(d["req_q"][:, None, :]
                   <= (d["alloc_q"] - d["used_q"])[None], axis=-1) \
        & ((d["alloc_pods"] - d["used_pods"]) >= 1)[None]
    feas = d["mask"] & fits0 & (np.arange(n) < n_real)[None]
    sc0, cand, thresh, scanned, pruned = _jblock_bound_prefilter(
        a[5], a[4], a[0], a[7], jnp.asarray(feas), *a[8:14],
        strategy=strategy, n_real=jnp.int32(n_real), k=k, block_w=bw)
    p = d["req_q"].shape[0]
    return ((sc0, jnp.arange(p, dtype=jnp.int32), cand, thresh,
             jnp.asarray(d["mask"].any(axis=1))), int(scanned), int(pruned))


def tblock_prefilter(d, k, bw, strategy, w_fit=1.0, w_bal=1.0, n_real=None):
    """`block_prefilter` for the port: (per-pod scan arguments, scanned,
    pruned)."""
    a = targs(d, w_fit, w_bal)
    n = d["alloc_q"].shape[0]
    n_real = n if n_real is None else n_real
    fits0 = torch.all(a[0][:, None, :] <= a[2][None], dim=-1) \
        & (a[3] >= 1)[None]
    feas = a[6] & fits0 & (torch.arange(n) < n_real)[None]
    sc0, cand, thresh, scanned, pruned = tsolver.block_bound_prefilter(
        a[5], a[4], a[0], a[7], feas, *a[8:14], strategy, n_real, k, bw)
    p = d["req_q"].shape[0]
    return ((sc0, torch.arange(p, dtype=torch.int32), cand, thresh,
             a[6].any(dim=1)), int(scanned), int(pruned))


def same_block(d, k, bw, strategy, w=1.0, n_real=None):
    """Port and reference block prefilters on `d`: candidates, thresholds
    and counters identical, sc0 within the score bound. Returns both."""
    jb, jsc, jpr = block_prefilter(d, k, bw, strategy, w, w, n_real)
    tb, tsc, tpr = tblock_prefilter(d, k, bw, strategy, w, w, n_real)
    np.testing.assert_array_equal(tb[2].numpy(), np.asarray(jb[2]))
    np.testing.assert_array_equal(tb[3].numpy(), np.asarray(jb[3]))
    np.testing.assert_allclose(tb[0].numpy(), np.asarray(jb[0]), atol=1e-4)
    assert (tsc, tpr) == (jsc, jpr)
    return jb, tb, tpr


# ---------------------------------------------------------------------------
# the five block kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,bw", [(96, 16), (72, 16), (64, 8)])
def test_block_kernels_match_the_reference(n, bw):
    rng = np.random.default_rng(n + bw)
    d = synthetic(rng, P=6, N=n)
    d["alloc_q"][rng.random(n) < 0.1, 0] = 0         # zero-alloc columns
    n_real = n - 5
    col_real = np.arange(n) < n_real
    feas = d["mask"] & (rng.random(d["mask"].shape) < 0.8)
    feas[0, :bw] = False                              # an empty block
    for fill in (0, resident._BLOCK_BIG):
        np.testing.assert_array_equal(
            tkernels._block_fold(_t(d["alloc_q"]), bw, fill).numpy(),
            np.asarray(jkernels._block_fold(
                jnp.asarray(d["alloc_q"]), bw, fill)))
    jagg = _jaggregates(jnp.asarray(d["alloc_q"]), jnp.asarray(d["used_q"]),
                        jnp.asarray(col_real), block_w=bw)
    tagg = tkernels.block_capacity_aggregates(
        _t(d["alloc_q"]), _t(d["used_q"]), _t(col_real), bw)
    for j, t in zip(jagg, tagg):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    jst = _jfeasible_stat(jnp.asarray(feas), jnp.asarray(d["static_sc"]),
                          block_w=bw)
    tst = tkernels.block_feasible_stat(_t(feas), _t(d["static_sc"]), bw)
    for j, t in zip(jst, tst):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert tst[2].dtype == torch.int32
    a, ja = targs(d), solver_args(d)
    for strategy in STRATEGIES:
        jub = _jupper_bound(
            jst[0], jst[2], jagg[0], jagg[2], jagg[3], jagg[4], ja[1],
            *ja[8:14], strategy=strategy)
        tub = tkernels.block_score_upper_bound(
            tst[0], tst[2], tagg[0], tagg[2], tagg[3], tagg[4], a[1],
            *a[8:14], strategy)
        np.testing.assert_array_equal(tub.numpy(), np.asarray(jub))
        cols = rng.integers(0, n, size=(6, 20))
        jg = _jgathered(
            ja[5][cols], ja[4][cols], ja[1], jnp.take_along_axis(
                ja[7], jnp.asarray(cols), axis=1), *ja[8:14],
            strategy=strategy)
        tg = tkernels.gathered_start_scores(
            a[5][cols], a[4][cols], a[1], torch.gather(
                a[7], 1, _t(cols)), *a[8:14], strategy)
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4)
        # A gathered column is the full pass's value, bit for bit.
        full = tkernels.chunk_start_scores(a[5], a[4], a[1], a[7],
                                           *a[8:14], strategy)
        np.testing.assert_array_equal(
            tg.numpy(), torch.gather(full, 1, _t(cols)).numpy())


def test_resident_planes_share_the_sentinel():
    assert resident._BLOCK_BIG is tkernels._BLOCK_BIG


# ---------------------------------------------------------------------------
# prefilter parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("bw", [8, 16])
def test_prefilter_randomized(strategy, bw):
    for seed in range(3):
        d = synthetic(np.random.default_rng(seed))
        jb, tb, _ = same_block(d, 6, bw, strategy)
        # And the full-width prefilter's shortlist, as the reference's
        # test holds it.
        np.testing.assert_array_equal(
            tb[2].numpy(), np.asarray(prefilter(d, 6, strategy)[2]))


def test_prefilter_padding_columns_excluded():
    for seed in range(3):
        d = synthetic(np.random.default_rng(30 + seed), N=96)
        same_block(d, 5, 16, LA, n_real=77)


def test_prefilter_ragged_last_block():
    same_block(synthetic(np.random.default_rng(40), N=72), 4, 16, LA)


def test_prefilter_width_wider_than_n_is_a_shape_error():
    d = synthetic(np.random.default_rng(41), N=8)
    with pytest.raises(ValueError):
        tblock_prefilter(d, 4, 16, LA)
    with pytest.raises(ValueError):
        block_prefilter(d, 4, 16, LA)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_prefilter_score_ties_at_k_boundary(k):
    for seed in range(3):
        d = synthetic(np.random.default_rng(200 + seed), score_levels=2)
        same_block(d, k, 8, LA, w=0.0)


def _fleet(static=None, used=None):
    n, r, c = 256, 3, 4
    return dict(
        alloc_q=np.full((n, r), 40_000, np.int32),
        used_q=np.full((n, r), 10_000, np.int32) if used is None else used,
        alloc_pods=np.full((n,), 110, np.int32),
        used_pods=np.zeros((n,), np.int32),
        req_q=np.full((c, r), 5_000, np.int32),
        mask=np.ones((c, n), bool),
        static_sc=np.zeros((c, n), np.float32) if static is None
        else static,
        col_w=np.ones((r,), np.float32), col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 100.0], np.float32),
        shape_s=np.array([0.0, 10.0], np.float32))


def test_pruning_fires_on_dominated_blocks():
    """The strict arm: two leading blocks win by a wide static margin."""
    static = np.full((4, 256), -100.0, np.float32)
    static[:, :32] = 100.0
    assert same_block(_fleet(static=static), 3, 16, LA)[2] > 0


def test_pruning_fires_on_uniform_fleet():
    """The uniform arm: identical nodes tie every bound."""
    assert same_block(_fleet(), 3, 16, LA)[2] > 0


def test_pruning_survives_advancing_drain_frontier():
    """The selection sits mid-range behind three full blocks: they prune
    as empty, the uniform tail after the last selected block as uniform."""
    used = np.full((256, 3), 10_000, np.int32)
    used[:48] = 40_000
    assert same_block(_fleet(used=used), 3, 16, LA)[2] > 0


def test_uniform_block_before_the_selection_takes_the_full_pass():
    """Identical nodes, the last half a hair better: the uniform blocks
    before the selection would win its ties, so nothing prunes and the
    full-width pass decides, in both packages."""
    static = np.zeros((4, 256), np.float32)
    static[:, 128:] = 0.001
    assert same_block(_fleet(static=static), 3, 16, LA)[2] == 0


@pytest.mark.parametrize("kind,full_passes", [("uniform", 0),
                                               ("before", 1)])
def test_full_pass_runs_only_when_pruning_fails(monkeypatch, kind,
                                                full_passes):
    """The exactness predicate is read once and the full-width scoring
    runs only when it fails: a pruned chunk scores no column outside its
    selected blocks, so `blocks_pruned` counts columns never scored."""
    static = np.zeros((4, 256), np.float32)
    if kind == "before":
        static[:, 128:] = 0.001
    calls, reads = [], []
    score, read = tkernels.chunk_start_scores, tsolver._any_flag
    # Full-width scoring takes the (N, R) planes; the gathered pass takes
    # (C, G, R) columns through the same function.
    monkeypatch.setattr(tkernels, "chunk_start_scores",
                        lambda *a, **kw: calls.append(a[0].dim() == 2)
                        or score(*a, **kw))
    monkeypatch.setattr(tsolver, "_any_flag",
                        lambda f: reads.append(1) or read(f))
    _, _, pruned = same_block(_fleet(static=static), 3, 16, LA)
    assert (sum(calls), len(reads)) == (full_passes, 1)
    assert (pruned > 0) == (full_passes == 0)


# ---------------------------------------------------------------------------
# the prefilter's outputs through the scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", [LA, "MostAllocated"])
def test_scan_parity(strategy):
    for seed in range(3):
        d = synthetic(np.random.default_rng(seed))
        jb, tb, _ = same_block(d, 6, 8, strategy)
        ref, jfall = jsolver.greedy_assign_rescoring_shortlist(
            *solver_args(d), strategy, *jb)
        got, tfall = tsolver.greedy_assign_rescoring_shortlist(
            *targs(d), strategy, *tb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert int(tfall) == int(jfall)


def test_scan_tight_capacity_forces_fallback():
    hit = 0
    for seed in range(3):
        d = synthetic(np.random.default_rng(100 + seed), P=20, N=48,
                      tight=True)
        jb, tb, _ = same_block(d, 4, 8, LA)
        ref, jfall = jsolver.greedy_assign_rescoring_shortlist(
            *solver_args(d), LA, *jb)
        got, tfall = tsolver.greedy_assign_rescoring_shortlist(
            *targs(d), LA, *tb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        assert int(tfall) == int(jfall)
        hit += int(tfall)
    assert hit > 0


def test_spread_scan():
    import test_shortlist_solver as reference_tests
    for seed in range(3):
        rng = np.random.default_rng(400 + seed)
        d = synthetic(rng, P=12, N=48)
        sp = reference_tests.TestSpreadParity._spread(None, rng, 48, 12)
        jb, tb, _ = same_block(d, 5, 8, LA)
        ref, jcounts, jfall = jsolver.greedy_assign_rescoring_spread_shortlist(
            *solver_args(d), LA, *sp, *jb)
        got, tcounts, tfall = tsolver.greedy_assign_rescoring_spread_shortlist(
            *targs(d), LA, *port_table(sp), *tb)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(tcounts.numpy(),
                                      np.asarray(jcounts).astype(np.int32))
        assert int(tfall) == int(jfall)
        # The full-width prefilter's scan places alike.
        full, _, _ = tsolver.greedy_assign_rescoring_spread_shortlist(
            *targs(d), LA, *port_table(sp), *tprefilter(d, 5, LA))
        np.testing.assert_array_equal(full.numpy(), got.numpy())


# ---------------------------------------------------------------------------
# phase 13(a)'s fixtures, small, through the whole route of both packages
# ---------------------------------------------------------------------------

def reference_route(case, strategy, k, bw, wave_w):
    """`chip_smoke.run_shortlist` with the JAX package's functions."""
    arrays, class_req, rows, exc, perms, n_real = case
    feasible, has_node = shortlist_inputs(case)
    a = [jnp.asarray(arrays[x]) for x in SOLVE_ORDER]
    sc0, cand, thresh, scanned, pruned = _jblock_bound_prefilter(
        a[5], a[4], jnp.asarray(class_req), a[7], jnp.asarray(feasible),
        *a[8:14], strategy=strategy, n_real=jnp.int32(n_real), k=k,
        block_w=bw)
    r, e = jnp.asarray(rows), jnp.asarray(exc)
    sl = (sc0, r, cand[r], thresh[r], jnp.asarray(has_node))
    p = rows.shape[0]
    gang = (jnp.zeros((p, 16)), jnp.zeros((16,)))

    def host(t):
        return tuple(int(x) if np.ndim(x) == 0 else np.asarray(x)
                     for x in t)
    return {
        "cand": np.asarray(cand), "thresh": np.asarray(thresh),
        "scanned": int(scanned), "pruned": int(pruned),
        "identity": host(jsolver.greedy_assign_rescoring_shortlist(
            *a, strategy, *sl, rows=r, exc=e)),
        "wave": host(jsolver.greedy_assign_rescoring_shortlist_wave(
            *a, strategy, wave_w, *sl, rows=r, exc=e)),
        "multistart": host(jsolver.multistart_greedy_assign_shortlist(
            *a, strategy, jnp.asarray(perms), *gang, *sl, rows=r, exc=e)),
        "multistart_wave": host(
            jsolver.multistart_greedy_assign_shortlist_wave(
                *a, strategy, wave_w, jnp.asarray(perms), *gang, *sl,
                rows=r, exc=e))}


@pytest.mark.parametrize("kind", SHORTLIST_CASES)
def test_phase13_fixtures_match_the_reference(kind):
    """264 columns in blocks of 16 (a ragged last block), 48 pods, K=8,
    W=8; RequestedToCapacityRatio on the uniform fleet, LeastAllocated
    elsewhere."""
    i = SHORTLIST_CASES.index(kind)
    strategy = "RequestedToCapacityRatio" if kind == "uniform" else LA
    case = shortlist_case(kind, 7 + i, 264, 48, 16)
    ref = reference_route(case, strategy, 8, 16, 8)
    got = run_shortlist(torch, case, strategy, 8, 16, 8, "cpu")
    np.testing.assert_array_equal(got["cand"], ref["cand"])
    np.testing.assert_array_equal(got["thresh"], ref["thresh"])
    assert (got["scanned"], got["pruned"]) == (ref["scanned"],
                                               ref["pruned"])
    for route in ("identity", "wave", "multistart", "multistart_wave"):
        np.testing.assert_array_equal(got[route][0], ref[route][0])
        assert got[route][1:] == ref[route][1:], route
    if kind in ("uniform", "frontier", "padded"):
        assert got["pruned"] > 0
    if kind in ("before", "tight"):
        assert got["pruned"] == 0
    if kind in ("tight", "pinned"):
        assert got["identity"][1] > 0
    if kind == "storm":
        assert got["multistart"][1] == 48
