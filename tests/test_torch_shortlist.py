"""The port's shortlist-pruned scans against the JAX package's, on the CPU.

Mirrors `tests/test_shortlist_solver.py`: the same seeded fixtures
(`synthetic`) go through the reference's scans, jitted on the CPU, and the
port's on `device="cpu"`:

- `shortlist_prefilter`: candidates and thresholds identical (the
  (value desc, index asc) top-k rule, ties included);
- `greedy_assign_rescoring_shortlist`: randomized parity per strategy,
  tight capacity that forces fallbacks, ties at the K boundary, a uniform
  round robin with no fallback;
- `multistart_greedy_assign_shortlist`: with and without a tight cluster
  (poisoned chunks rerun whole), and gangs;
- `greedy_assign_rescoring_spread_shortlist`: randomized parity and a
  tight skew, the reference's one-hot table carried into the port's index
  form (`SpreadTable`);
- the wave forms (`greedy_assign_rescoring_shortlist_wave`,
  `multistart_greedy_assign_shortlist_wave`) at W = 4 and 8.

Assignments, fallbacks, commits, replays and domain counts are identical:
no tolerance (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu_torch.ops import kernels as tkernels
from kubernetes_tpu_torch.ops import solver as tsolver
import test_shortlist_solver as reference_tests
from test_shortlist_solver import prefilter, solver_args, synthetic

LA = "LeastAllocated"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def targs(d, w_fit=1.0, w_bal=1.0):
    """`solver_args` for the port: the same arrays as CPU tensors."""
    free_q = d["alloc_q"] - d["used_q"]
    free_pods = d["alloc_pods"] - d["used_pods"]
    return [_t(x) for x in (
        d["req_q"], d["req_q"], free_q, free_pods, d["used_q"],
        d["alloc_q"], d["mask"], d["static_sc"], d["col_w"], d["col_mask"],
        d["shape_u"], d["shape_s"])] + [w_fit, w_bal]


def tprefilter(d, k, strategy, w_fit=1.0, w_bal=1.0):
    """The port's `prefilter`: per-pod shortlist arguments."""
    a = targs(d, w_fit, w_bal)
    sc0 = tkernels.chunk_start_scores(a[5], a[4], a[0], a[7], *a[8:14],
                                      strategy)
    fits0 = torch.all(a[0][:, None, :] <= a[2][None], dim=-1) \
        & (a[3] >= 1)[None]
    cand, thresh = tsolver.shortlist_prefilter(a[6] & fits0, sc0, k)
    p = d["req_q"].shape[0]
    return (sc0, torch.arange(p, dtype=torch.int32), cand, thresh,
            a[6].any(dim=1))


def same_prefilter(jp, tp):
    np.testing.assert_array_equal(tp[2].numpy(), np.asarray(jp[2]))
    np.testing.assert_array_equal(tp[3].numpy(), np.asarray(jp[3]))
    np.testing.assert_allclose(tp[0].numpy(), np.asarray(jp[0]), atol=1e-4)


def perms_of(d, k=3):
    p = d["req_q"].shape[0]
    perms = np.tile(np.arange(p, dtype=np.int32), (k, 1))
    sizes = d["req_q"].sum(axis=1)
    perms[1] = np.argsort(-sizes, kind="stable")
    perms[2] = np.argsort(sizes, kind="stable")
    return perms


def gangs(p, members=0):
    gang = np.zeros((p, 4), np.float32)
    req = np.zeros((4,), np.float32)
    if members:
        gang[:members, 0] = 1.0
        req[0] = float(members)
    return gang, req


# ---------------------------------------------------------------------------
# identity order, one pod per step
# ---------------------------------------------------------------------------

def identity_both(d, k, strategy, w=1.0):
    ja = solver_args(d, w, w)
    jp = prefilter(d, k, strategy, w, w)
    tp = tprefilter(d, k, strategy, w, w)
    same_prefilter(jp, tp)
    ref, jfall = jsolver.greedy_assign_rescoring_shortlist(
        *ja, strategy, *jp)
    got, tfall = tsolver.greedy_assign_rescoring_shortlist(
        *targs(d, w, w), strategy, *tp)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert int(tfall) == int(jfall)
    full = tsolver.greedy_assign_rescoring(*targs(d, w, w), strategy)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    return got.numpy(), int(tfall)


@pytest.mark.parametrize("strategy", [LA, "MostAllocated"])
def test_identity_randomized(strategy):
    total = 0
    for seed in range(6):
        total += identity_both(synthetic(np.random.default_rng(seed)), 6,
                               strategy)[1]
    if strategy == LA:
        assert total > 0


def test_identity_tight_capacity_forces_fallback():
    hit = 0
    for seed in range(4):
        d = synthetic(np.random.default_rng(100 + seed), P=20, N=48,
                      tight=True)
        hit += identity_both(d, 4, LA)[1]
    assert hit > 0


@pytest.mark.parametrize("k", [1, 4, 9])
def test_identity_score_ties_at_k_boundary(k):
    """Quantized statics and zero live weights: exact ties straddle the
    shortlist boundary at nearly every step."""
    for seed in range(4):
        d = synthetic(np.random.default_rng(200 + seed), score_levels=2)
        identity_both(d, k, LA, w=0.0)


def test_identity_uniform_round_robin_no_fallback():
    d = synthetic(np.random.default_rng(7), P=16, N=128)
    d["alloc_q"][:] = 32_000
    d["used_q"][:] = 0
    d["used_pods"][:] = 0
    d["req_q"][:] = 900
    d["mask"][:] = True
    d["static_sc"][:] = 0.0
    got, fall = identity_both(d, 16, LA)
    assert fall == 0
    assert len(set(got.tolist())) == 16


@pytest.mark.parametrize("tight", [False, True])
def test_full_rows_only_after_a_poisoned_pass(monkeypatch, tight):
    """The single-order scans run the narrow pass first and the pass with
    full rows only when the narrow one poisoned; either way the result is
    the reference's."""
    passes = []
    scan = tsolver._shortlist_scan

    def counted(*a, **kw):
        passes.append(kw["inline_fallback"])
        return scan(*a, **kw)
    monkeypatch.setattr(tsolver, "_shortlist_scan", counted)
    if tight:
        d = synthetic(np.random.default_rng(101), P=20, N=48, tight=True)
        _, fall = identity_both(d, 4, LA)
        assert fall > 0 and passes == [False, True]
    else:
        d = synthetic(np.random.default_rng(7), P=16, N=128)
        d["alloc_q"][:] = 32_000
        d["used_q"][:] = 0
        d["used_pods"][:] = 0
        d["req_q"][:] = 900
        d["mask"][:] = True
        d["static_sc"][:] = 0.0
        _, fall = identity_both(d, 16, LA)
        assert fall == 0 and passes == [False]


# ---------------------------------------------------------------------------
# multistart (permuted orders, poisoned-chunk rerun)
# ---------------------------------------------------------------------------

def multistart_both(d, k, members=0):
    p = d["req_q"].shape[0]
    perms = perms_of(d)
    gang, req = gangs(p, members)
    ref, jfall = jsolver.multistart_greedy_assign_shortlist(
        *solver_args(d), LA, jnp.asarray(perms), jnp.asarray(gang),
        jnp.asarray(req), *prefilter(d, k, LA))
    got, tfall = tsolver.multistart_greedy_assign_shortlist(
        *targs(d), LA, _t(perms), _t(gang), _t(req), *tprefilter(d, k, LA))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert tfall == int(jfall)
    full = tsolver.multistart_greedy_assign(
        *targs(d), LA, _t(perms), _t(gang), _t(req))
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    return tfall


@pytest.mark.parametrize("tight", [False, True])
def test_multistart_randomized(tight):
    falls = [multistart_both(
        synthetic(np.random.default_rng(300 + seed), tight=tight), 6)
        for seed in range(4)]
    assert all(f in (0, 16) for f in falls)
    if tight:
        assert max(falls) == 16


def test_multistart_clean_chunk():
    """K = P on a uniform fleet: no order poisons, so the orders' own
    narrow scans decide (no rerun)."""
    d = synthetic(np.random.default_rng(8), P=16, N=128)
    d["alloc_q"][:] = 32_000
    d["used_q"][:] = 0
    d["used_pods"][:] = 0
    d["mask"][:] = True
    d["static_sc"][:] = 0.0
    assert multistart_both(d, 16) == 0


def test_multistart_gangs_ride_both_paths():
    d = synthetic(np.random.default_rng(42), P=12, N=64)
    multistart_both(d, 6, members=4)


# ---------------------------------------------------------------------------
# spread scan
# ---------------------------------------------------------------------------

def port_table(sp):
    """The reference's one-hot spread inputs in the port's index form."""
    dom_onehot, cid, counts, skew, min_ok, has_key, applies, contrib = (
        np.asarray(x) for x in sp)
    n, c = has_key.shape
    dom_cid = np.argmax(cid, axis=1).astype(np.int64)
    node_dom = np.full((n, c), -1, np.int64)
    for j in range(n):
        for d in np.nonzero(dom_onehot[j])[0]:
            node_dom[j, dom_cid[d]] = d
    table = tsolver.SpreadTable(
        _t(node_dom), _t(dom_cid), _t(skew.astype(np.int32)),
        _t(min_ok > 0), _t(has_key > 0))
    return (table, _t(counts.astype(np.int32)), _t(applies > 0),
            _t(contrib.astype(np.int32)))


def spread_both(d, sp, k):
    ref, jcounts, jfall = jsolver.greedy_assign_rescoring_spread_shortlist(
        *solver_args(d), LA, *sp, *prefilter(d, k, LA))
    got, tcounts, tfall = tsolver.greedy_assign_rescoring_spread_shortlist(
        *targs(d), LA, *port_table(sp), *tprefilter(d, k, LA))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(tcounts.numpy(),
                                  np.asarray(jcounts).astype(np.int32))
    assert int(tfall) == int(jfall)
    table, counts, applies, contrib = port_table(sp)
    full, fcounts = tsolver.greedy_assign_rescoring_spread(
        *targs(d), LA, table, counts, applies, contrib)
    np.testing.assert_array_equal(got.numpy(), full.numpy())
    np.testing.assert_array_equal(tcounts.numpy(), fcounts.numpy())
    return int(tfall)


def test_spread_randomized():
    total = 0
    for seed in range(4):
        rng = np.random.default_rng(400 + seed)
        d = synthetic(rng, P=12, N=48)
        sp = reference_tests.TestSpreadParity._spread(None, rng, 48, 12)
        total += spread_both(d, sp, 5)
    assert total > 0


def test_spread_tight_skew_forces_fallback():
    rng = np.random.default_rng(77)
    n, p, dd = 32, 16, 2
    d = synthetic(rng, P=p, N=n, mask_p=1.0)
    d["static_sc"][:] = 0.0
    dom_onehot = np.zeros((n, dd), np.float32)
    dom_onehot[np.arange(n), np.arange(n) % dd] = 1.0
    sp = [jnp.asarray(x) for x in (
        dom_onehot, np.ones((dd, 1), np.float32), np.zeros((dd,), np.float32),
        np.array([1.0], np.float32), np.ones((1,), np.float32),
        np.ones((n, 1), np.float32), np.ones((p, 1), np.float32),
        np.ones((p, 1), np.float32))]
    assert spread_both(d, sp, 4) > 0


# ---------------------------------------------------------------------------
# wave forms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wave_w", [4, 8])
def test_wave_forms(wave_w):
    """Identity waves (serial replay over full rows, counted as
    fallbacks) and multistart waves (poison and whole-chunk rerun) place
    as the W=1 scans do, with the reference's counters."""
    seen = set()
    for seed, tight in ((0, False), (1, False), (101, True)):
        d = synthetic(np.random.default_rng(seed), tight=tight)
        ja, jp = solver_args(d), prefilter(d, 6, LA)
        ta, tp = targs(d), tprefilter(d, 6, LA)
        ref = jsolver.greedy_assign_rescoring_shortlist_wave(
            *ja, LA, wave_w, *jp)
        got = tsolver.greedy_assign_rescoring_shortlist_wave(
            *ta, LA, wave_w, *tp)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert [int(x) for x in got[1:]] == [int(x) for x in ref[1:]]
        serial = tsolver.greedy_assign_rescoring(*ta, LA)
        np.testing.assert_array_equal(got[0].numpy(), serial.numpy())
        seen.update(k for k, v in zip(("commit", "replay"), got[2:])
                    if int(v))
        p = d["req_q"].shape[0]
        perms = perms_of(d)
        gang, req = gangs(p)
        ref = jsolver.multistart_greedy_assign_shortlist_wave(
            *ja, LA, wave_w, jnp.asarray(perms), jnp.asarray(gang),
            jnp.asarray(req), *jp)
        got = tsolver.multistart_greedy_assign_shortlist_wave(
            *ta, LA, wave_w, _t(perms), _t(gang), _t(req), *tp)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
        assert list(got[1:]) == [int(x) for x in ref[1:]]
    assert seen == {"commit", "replay"}
