"""The serving fast path's single-pod solve against the JAX package.

`solver.solve_one` and `solver.solve_one_fresh` of the port, fed through
`ops/convert.solve_one_inputs`, against the jitted reference functions on
the same seeded numpy inputs: every strategy, random taint membership and a
90%-dense base mask, nodes that all tie (the lowest index must win), a pod
that fits nowhere (-1), the taint filter off, nonzero f16 and f32 host
score rows, and a node count that is not a multiple of 8. The fused form
takes delta buckets of 1, 2 and 4 rows, padded by repeating the first row:
the index and the returned pack must be identical and the input pack
unchanged. Tolerance: none — indices and packs are integers.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu_torch.ops import convert, solver

STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def case(seed: int, n: int = 1000, r: int = 2, tf: int = 3, tp: int = 2,
         uniform: bool = False, scores: str = "zero",
         taint_filter_on: bool = True, huge: bool = False,
         strategy: str = "LeastAllocated"):
    """(positional arrays of the reference solve_one, _fwk_params dict)."""
    rng = np.random.default_rng(seed)
    if uniform:
        alloc_q = np.tile(np.array([8000, 32768] + [64] * (r - 2),
                                   np.int32), (n, 1))
        used_q = np.tile(alloc_q[:1] // 4, (n, 1))
        taint_f = np.zeros((n, tf), np.bool_)
        taint_p = np.zeros((n, tp), np.bool_)
        alloc_pods = np.full((n,), 110, np.int32)
        used_pods = np.full((n,), 3, np.int32)
    else:
        alloc_q = rng.choice([4000, 8000, 16000], size=(n, r)).astype(
            np.int32)
        used_q = (alloc_q * rng.uniform(0, 1.05, size=(n, r))).astype(
            np.int32)
        taint_f = rng.random((n, tf)) < 0.15
        taint_p = rng.random((n, tp)) < 0.3
        alloc_pods = rng.choice([10, 110], size=n).astype(np.int32)
        used_pods = rng.integers(0, 12, size=n).astype(np.int32)
    used_nz = used_q if uniform else used_q + rng.integers(
        0, 50, size=(n, r)).astype(np.int32)
    used_pack = np.concatenate([used_q, used_nz, used_pods[:, None]],
                               axis=1).astype(np.int32)
    m = rng.random(((n + 7) // 8) * 8) < 0.9
    m[n:] = False
    mask_bits = np.packbits(m)
    if scores == "zero":
        host_scores = np.zeros((n,), np.float16)
    elif scores == "f16":
        host_scores = rng.choice([0.0, 12.5, 50.0, 100.0], size=n).astype(
            np.float16)
    else:
        host_scores = rng.uniform(0, 2000, size=n).astype(np.float32)
    req = rng.integers(100, 1200, size=r).astype(np.int32)
    if huge:
        req[0] = 10 ** 6
    req_nz = np.maximum(req, 100).astype(np.int32)
    untol_f = (rng.random(tf) < 0.5).astype(np.int32)
    untol_p = (rng.random(tp) < 0.6).astype(np.int32)
    req_pack = np.concatenate([req, req_nz, untol_f, untol_p]).astype(
        np.int32)
    params = {
        "fit_col_w": rng.choice([1.0, 2.0], size=r).astype(np.float32),
        "bal_col_mask": np.ones((r,), np.bool_),
        "shape_u": np.array([0, 50, 100], np.float32),
        "shape_s": np.array([10, 3, 0], np.float32),
        "w_fit": np.float32(1.0), "w_bal": np.float32(1.0),
        "w_taint": np.float32(3.0),
        "taint_filter_on": np.bool_(taint_filter_on),
        "strategy": strategy,
    }
    arrays = (alloc_q, used_pack, alloc_pods, taint_f, taint_p, mask_bits,
              host_scores, req_pack)
    return arrays, params


def _tail(params):
    return (params["fit_col_w"], params["bal_col_mask"], params["shape_u"],
            params["shape_s"], params["w_fit"], params["w_bal"],
            params["w_taint"], params["taint_filter_on"],
            params["strategy"])


def _ref_one(arrays, params) -> int:
    return int(np.asarray(jsolver.solve_one(*arrays, *_tail(params))))


def _port_one(arrays, params) -> int:
    return int(solver.solve_one(
        *convert.solve_one_inputs(arrays, params, "cpu")))


CASES = [dict(seed=s, strategy=st) for s in range(3) for st in STRATEGIES] + [
    dict(seed=10, uniform=True),
    dict(seed=11, uniform=True, strategy="MostAllocated"),
    dict(seed=12, huge=True),
    dict(seed=13, taint_filter_on=False),
    dict(seed=14, scores="f16"),
    dict(seed=15, scores="f32", strategy="MostAllocated"),
    dict(seed=16, n=1003),
    dict(seed=17, n=1003, uniform=True),
    dict(seed=18, r=3, strategy="RequestedToCapacityRatio"),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_solve_one_matches_reference(kw):
    arrays, params = case(**kw)
    want = _ref_one(arrays, params)
    got = _port_one(arrays, params)
    assert got == want
    if kw.get("huge"):
        assert got == -1
    elif kw.get("uniform"):
        # Every score ties: the lowest feasible index wins.
        n = arrays[0].shape[0]
        feasible = np.unpackbits(arrays[5])[:n].astype(bool)
        assert got == int(np.argmax(feasible))
    else:
        assert got >= 0


@pytest.mark.parametrize("bucket,real", [(1, 1), (2, 2), (4, 3), (4, 1)])
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_solve_one_fresh_matches_reference(bucket, real, strategy):
    arrays, params = case(seed=40 + bucket + real, strategy=strategy,
                          uniform=(real == 1))
    rng = np.random.default_rng(bucket * 10 + real)
    used_pack = arrays[1]
    n, w = used_pack.shape
    idx = np.sort(rng.choice(n, size=real, replace=False)).astype(np.int32)
    vals = rng.integers(0, 40, size=(real, w)).astype(np.int32)
    rows = np.concatenate([idx, np.full((bucket - real,), idx[0], np.int32)])
    vals = np.concatenate([vals, np.repeat(vals[:1], bucket - real, axis=0)])
    fresh = (arrays[0], used_pack, rows, vals) + tuple(arrays[2:])
    ref_idx, ref_pack = jsolver.solve_one_fresh(*fresh, *_tail(params))
    args = convert.solve_one_inputs(fresh, params, "cpu")
    before = args[1].clone()
    got_idx, got_pack = solver.solve_one_fresh(*args)
    assert int(got_idx) == int(np.asarray(ref_idx))
    assert np.array_equal(got_pack.numpy(), np.asarray(ref_pack))
    assert torch.equal(args[1], before)
    # The fused form equals the plain solve on the refreshed pack.
    plain = (arrays[0], np.asarray(ref_pack)) + tuple(arrays[2:])
    assert int(got_idx) == _port_one(plain, params)


def test_solve_one_inputs_refuses_a_wrong_arity():
    arrays, params = case(seed=1)
    with pytest.raises(ValueError, match="solve_one takes 8"):
        convert.solve_one_inputs(arrays[:5], params, "cpu")
