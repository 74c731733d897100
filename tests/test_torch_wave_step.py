"""The sharded wave step's plain version, on the CPU.

`ops/wave_eval.wave_step_reference` is the reference's sharded wave step
(`kubernetes_tpu/parallel/sharded.py` `_wave_body.wave_step`) on tensors.
It is held here, wave by wave, against the inline wave body the port ran
before it moved into one function (`_inline_wave`, kept verbatim below):
assignments, the commit/replay decision and the carry after each wave
identical, over W in {1, 2, 8, 32, 64}, 1, 4 and 8 shards, a multislice
mesh, conflict storms, ties, members with no feasible node, padding members
and exception columns.

The CUDA wave step resolves each member's pick from per-block top lists
instead of W argmax rounds over the nodes. `test_top_lists_give_the_same
_picks` checks that rule in plain Python on the same cases: with the nodes
cut into blocks, each block keeping its top w + 1 (score desc, id asc) for
member w, the best entry of the union that no earlier member took is the
pick of the sequential rounds, ties included.

The JAX differentials of the whole route are in test_torch_sharded.py.
"""

import numpy as np
import pytest
import torch

from chip_smoke import hetero_chunk, storm
from kubernetes_tpu_torch import parallel as tpar
from kubernetes_tpu_torch.ops import solver as tsolver
from kubernetes_tpu_torch.ops import wave_eval as twave
from kubernetes_tpu_torch.parallel import sharded as tsharded

NEG_INF = float("-inf")
INT_MAX = 2**31 - 1
STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _inline_wave(st, req, req_nz, row, e, real):
    """The wave body as the port ran it inline before `wave_step_reference`
    (one iteration of its loop, verbatim but for the return)."""
    s, L = st.S, st.L
    W = req.shape[0]
    w_iota = torch.arange(W, device=req.device)
    later = w_iota[None, :] < w_iota[:, None]             # j < w
    shard_ix = torch.arange(s, device=req.device)[:, None, None]
    base32 = st.base.to(torch.int32)
    el = (e[None, :] - base32[:, None]).contiguous()     # local exc
    masked, m = twave.wave_eval_reference(
        st.mask, st.static, st.alloc, st.fq, st.fp, st.unz, req, req_nz,
        row, e, el, real, *st.score_args)                # (S, W, L)
    taken = torch.zeros((s, L), dtype=torch.bool, device=masked.device)
    bs, ys = [], []
    for w in range(W):
        rv = torch.where(taken, NEG_INF, masked[:, w])
        gbest, gidx = st.winner(*st.local_best(rv))
        y = torch.where(torch.isfinite(gbest), gidx, INT_MAX)
        if w + 1 < W:
            taken = taken | (st.gid == y)
        ys.append(y)
        bs.append(gbest)
    b = torch.stack(bs)
    y = torch.stack(ys)                                # global ids
    hit = y < INT_MAX
    li = y[None, :] - st.base[:, None]                 # (S, W)
    own = (li >= 0) & (li < L)
    safe = li.clamp(0, L - 1)
    idx = st.base[:, None] + safe
    fr_j = st.fq_flat[idx] - req                       # (S, W, R)
    fp_j = st.fp_flat[idx] - 1
    unz_j = st.unz_flat[idx] + req_nz
    upd = st.live_scores(
        st.alloc_flat[idx], unz_j, req_nz,
        st.static[shard_ix, row.long()[None, :, None], safe[:, None, :]])
    cap = torch.all(req[None, :, None, :] <= fr_j[:, None, :, :], dim=-1)
    feas = torch.gather(m, 2, safe[:, None, :].expand(s, W, W)) & cap \
        & (fp_j >= 1)[:, None, :] & (hit[None, :] & own)[:, None, :]
    beats = feas & ((upd > b[None, :, None])
                    | ((upd == b[None, :, None])
                       & (y[None, None, :] < y[None, :, None])))
    conflict = st.reduce(torch.any(beats & later, dim=2)
                         .to(torch.int32), torch.amax) > 0
    if not bool(conflict.any()):
        st.commit(y, req, req_nz)
        return torch.where(hit, y, -1), True, masked
    rl = row.long()
    return torch.cat([
        st.serial_step(req[w], req_nz[w],
                       st.gate(rl[w:w + 1], e[w:w + 1]) & real[w],
                       rl[w:w + 1])
        for w in range(W)]), False, masked


def _problem(kind: str, seed: int, p: int):
    """Class-plane arrays, rows and exceptions of one seeded chunk:
    "storm" (identical nodes, contested capacity: conflicts and replays),
    "hetero" (groups of identical nodes, near-ties, an exhausted resource).
    A few pods take the empty class row 0, so they fit nowhere."""
    if kind == "storm":
        arrays, rows, exc, _ = storm(seed=seed, n=64, p=p, k=1)
    else:
        arrays, rows, exc, _ = hetero_chunk(seed=seed, n=128, p=p, k=1,
                                            groups=12)
    rows = rows.copy()
    rows[np.random.default_rng(seed).choice(p, size=3, replace=False)] = 0
    return arrays, rows, exc


def _shards(arrays, sizes, strategy):
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrays.items()}
    return twave.Shards(sizes, t["free_q"], t["free_pods"], t["used_nz_q"],
                        t["alloc_q"], t["mask"], t["static_scores"],
                        t["fit_col_w"], t["bal_col_mask"], t["shape_u"],
                        t["shape_s"], 1.0, 1.0, strategy), t


def _waves(t, rows, exc, w):
    """The per-wave inputs of the chunk: (req, req_nz, row, e, real)."""
    (req_w, req_nz_w, rows_w, ex_w), real_w = tsolver._wave_split(
        w, (t["req_q"], t["req_nz_q"], torch.from_numpy(rows),
            torch.from_numpy(exc)))
    return list(zip(req_w, req_nz_w, rows_w, ex_w, real_w))


#: (kind, seed, pods, W, mesh axes, strategy): pods not a multiple of W
#: leave padding members in the last wave.
CASES = [
    ("storm", 1, 61, 1, (4,), "LeastAllocated"),
    ("storm", 2, 61, 2, (1,), "MostAllocated"),
    ("storm", 3, 100, 8, (8,), "RequestedToCapacityRatio"),
    ("storm", 4, 100, 32, (4,), "LeastAllocated"),
    ("storm", 5, 150, 64, (8,), "MostAllocated"),
    ("storm", 6, 100, 8, (2, 2), "LeastAllocated"),
    ("hetero", 7, 90, 8, (1,), "LeastAllocated"),
    ("hetero", 8, 90, 32, (4,), "RequestedToCapacityRatio"),
    ("hetero", 9, 130, 64, (8,), "MostAllocated"),
    ("hetero", 10, 90, 32, (2, 4), "MostAllocated"),
]


@pytest.mark.parametrize("kind,seed,p,w,sizes,strategy", CASES)
def test_wave_step_reference_equals_inline_body(kind, seed, p, w, sizes,
                                                strategy):
    arrays, rows, exc = _problem(kind, seed, p)
    got_st, t = _shards(arrays, sizes, strategy)
    want_st, _ = _shards(arrays, sizes, strategy)
    decisions = []
    for i, wave in enumerate(_waves(t, rows, exc, w)):
        want, committed, _ = _inline_wave(want_st, *wave)
        got, replayed = twave.wave_step_reference(got_st, *wave)
        assert got.dtype == torch.int32 and replayed.shape == (1,)
        assert torch.equal(got, want.to(torch.int32)), (i, got, want)
        assert bool(replayed) == (not committed), i
        for g, c in zip(got_st.carry(), want_st.carry()):
            assert torch.equal(g, c), i
        decisions.append(committed)
    if kind == "storm" and w >= 8:
        assert not all(decisions)          # the storm drove a replay
    if w <= 8:
        assert any(decisions)              # and the fast commit ran


@pytest.mark.parametrize("kind,seed,p,w,sizes,strategy", CASES)
def test_wave_body_routes_agree(kind, seed, p, w, sizes, strategy):
    """`_wave_body` with the kernel on (CPU: the plain version through
    `wave_step`) and off: the same assignments and replay flags, equal to
    the single-device serial solver's, and no launch counted."""
    arrays, rows, exc = _problem(kind, seed, p)
    before = (twave.wave_eval.launches, twave.wave_resolve.launches)
    out = {}
    for kernel in (True, False):
        st, t = _shards(arrays, sizes, strategy)
        out[kernel] = tsharded._wave_body(
            st, t["req_q"], t["req_nz_q"], torch.from_numpy(rows),
            torch.from_numpy(exc), w, kernel)
    assert (twave.wave_eval.launches, twave.wave_resolve.launches) == before
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1], out[False][1])
    assert out[True][1].shape == (-(-p // w),)
    serial = tsolver.greedy_assign_rescoring(
        t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
        t["used_nz_q"], t["alloc_q"], t["mask"], t["static_scores"],
        t["fit_col_w"], t["bal_col_mask"], t["shape_u"], t["shape_s"],
        1.0, 1.0, strategy, rows=torch.from_numpy(rows),
        exc=torch.from_numpy(exc))
    assert torch.equal(out[True][0], serial)
    assert (out[True][0][torch.from_numpy(rows) == 0] == -1).all()


def _top_list_picks(masked: np.ndarray, block: int, L: int):
    """Member by member: each block of `block` nodes inside a shard keeps
    its top w + 1 (score desc, id asc) finite entries for member w; the
    pick is the best entry of the union not taken by an earlier member.
    masked (S, W, L). Returns (best scores, global ids, INT_MAX = none)."""
    s, W, _ = masked.shape
    taken, bs, ys = set(), [], []
    for w in range(W):
        union = []
        for sh in range(s):
            for lo in range(0, L, block):
                entries = [(float(masked[sh, w, n]), -(sh * L + n))
                           for n in range(lo, min(lo + block, L))
                           if masked[sh, w, n] != NEG_INF]
                union += sorted(entries, reverse=True)[:w + 1]
        free = [k for k in union if -k[1] not in taken]
        if free:
            score, neg = max(free)
            taken.add(-neg)
            bs.append(score)
            ys.append(-neg)
        else:
            bs.append(NEG_INF)
            ys.append(INT_MAX)
    return bs, ys


@pytest.mark.parametrize("kind,seed,p,w,sizes,strategy", CASES)
def test_top_lists_give_the_same_picks(kind, seed, p, w, sizes, strategy):
    arrays, rows, exc = _problem(kind, seed, p)
    st, t = _shards(arrays, sizes, strategy)
    seen_ties = False
    for wave in _waves(t, rows, exc, w):
        el = (wave[3][None, :] - st.base32[:, None]).contiguous()
        masked, _ = twave.wave_eval_reference(
            st.mask, st.static, st.alloc, st.fq, st.fp, st.unz, wave[0],
            wave[1], wave[2], wave[3], el, wave[4], *st.score_args)
        b, y = twave.wave_picks(st, masked)
        m = masked.numpy()
        for block in (3, 16, 256):
            bs, ys = _top_list_picks(m, block, st.L)
            assert ys == y.tolist(), block
            assert bs == b.tolist(), block
        finite = m[np.isfinite(m)]
        seen_ties |= len(np.unique(finite)) < len(finite)
        twave.wave_step_reference(st, *wave)         # advance the carry
    assert seen_ties


def test_wave_step_on_cpu_runs_the_plain_version():
    arrays, rows, exc = _problem("storm", 11, 40)
    st, t = _shards(arrays, (4,), "LeastAllocated")
    ref, _ = _shards(arrays, (4,), "LeastAllocated")
    before = (twave.wave_eval.launches, twave.wave_resolve.launches)
    for wave in _waves(t, rows, exc, 8):
        out = torch.full((8,), -7, dtype=torch.int32)
        rep = torch.full((1,), -7, dtype=torch.int32)
        got = twave.wave_step(st, *wave, out=out, replayed=rep)
        want = twave.wave_step_reference(ref, *wave)
        assert got[0] is out and got[1] is rep
        assert torch.equal(out, want[0]) and torch.equal(rep, want[1])
    assert (twave.wave_eval.launches, twave.wave_resolve.launches) == before


def test_sharded_route_with_int64_rows():
    """The route takes rows and exceptions of any integer type."""
    arrays, rows, exc = _problem("hetero", 12, 50)
    t = {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in arrays.items()}
    args = (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
            t["used_nz_q"], t["alloc_q"], t["mask"], t["static_scores"],
            t["fit_col_w"], t["bal_col_mask"], t["shape_u"], t["shape_s"],
            1.0, 1.0, "LeastAllocated")
    mesh = tpar.build_mesh(4, device="cpu")
    a = tpar.sharded_greedy_assign(mesh, *args, rows=torch.from_numpy(rows),
                                   exc=torch.from_numpy(exc), wave_w=8)
    b = tpar.sharded_greedy_assign(
        mesh, *args, rows=torch.from_numpy(rows).long(),
        exc=torch.from_numpy(exc).long(), wave_w=8)
    assert torch.equal(a, b) and a.dtype == torch.int32
