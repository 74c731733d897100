"""The port's spread scans against the JAX package's on the CPU.

`solver.greedy_assign_rescoring_spread` (one pod per step) and
`solver.greedy_assign_rescoring_spread_wave` (W pods per wave, with the
structural replay rule) against the reference's scans of the same names,
on seeded union spread tables (`chip_smoke.spread_case`, which phase 10(a)
of the smoke also runs on the card): three constraints over two topology
keys,
keyless nodes, nodes ineligible for a constraint's template, a minDomains
deficit, pods a constraint gates but does not count (non-self-matching
selectors), pods it counts but does not gate, class rows with exception
pins, and uniform nodes with tied static scores. The reference takes the
table as float one-hot planes (`dom_onehot`, `cid_onehot`), the port as
the same table in index form (`solver.SpreadTable`) with int32 counts.

Assignments, final domain counts and the wave commits/replays are
identical: no tolerance (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SOLVE_ORDER, run_spread_scan, spread_case
from kubernetes_tpu.ops import solver as jsolver
from kubernetes_tpu_torch.ops import solver as tsolver

WAVES = (1, 2, 8, 31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def jax_table(table, counts, applies, contrib):
    """The reference's float one-hot form of an index-form table."""
    n, C = table["node_dom"].shape
    D = table["dom_cid"].shape[0]
    dom = np.zeros((n, D), np.float32)
    for c in range(C):
        hit = table["node_dom"][:, c] >= 0
        dom[np.nonzero(hit)[0], table["node_dom"][hit, c]] = 1.0
    cid = np.zeros((D, C), np.float32)
    cid[np.arange(D), table["dom_cid"]] = 1.0
    return (jnp.asarray(dom), jnp.asarray(cid),
            jnp.asarray(counts.astype(np.float32)),
            jnp.asarray(table["max_skew"].astype(np.float32)),
            jnp.asarray(table["min_ok"].astype(np.float32)),
            jnp.asarray(table["has_key"].astype(np.float32)),
            jnp.asarray(applies.astype(np.float32)),
            jnp.asarray(contrib.astype(np.float32)))


def run_both(case, strategy, wave_w):
    arrays, table, counts, applies, contrib, rows, exc = case
    jargs = [jnp.asarray(arrays[k]) for k in SOLVE_ORDER]
    jt = jax_table(table, counts, applies, contrib)
    got = run_spread_scan(torch, case, strategy, wave_w, "cpu")
    if wave_w == 1:
        ja, jc = jsolver.greedy_assign_rescoring_spread(
            *jargs, strategy, *jt, rows=jnp.asarray(rows),
            exc=jnp.asarray(exc))
        return (np.asarray(ja), np.asarray(jc), None), got
    ja, jc, jcom, jrep = jsolver.greedy_assign_rescoring_spread_wave(
        *jargs, strategy, wave_w, *jt, rows=jnp.asarray(rows),
        exc=jnp.asarray(exc))
    return (np.asarray(ja), np.asarray(jc), (int(jcom), int(jrep))), got


@pytest.mark.parametrize("wave_w", WAVES)
@pytest.mark.parametrize("seed,strategy", [(1, "LeastAllocated"),
                                           (2, "MostAllocated")])
def test_spread_scans_match_reference(seed, strategy, wave_w):
    case = spread_case(seed)
    (ja, jc, jw), (ta, tc, tw) = run_both(case, strategy, wave_w)
    np.testing.assert_array_equal(ta, ja)
    assert ta.dtype == np.int32 and tc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc.astype(np.int32))
    np.testing.assert_array_equal(jc, np.round(jc))   # integral counts
    assert tw == jw
    placed = (ta >= 0).sum()
    assert 0 < placed < len(ta)
    if jw is not None:
        assert sum(tw) == len(ta)


def test_every_wave_width_places_as_the_serial_scan():
    """The wavefront contract on this fixture: every W places exactly as
    W=1, and the fixture exercises both outcomes (commits and replays)."""
    case = spread_case(3)
    base = run_both(case, "LeastAllocated", 1)[1]
    seen = set()
    for w in WAVES[1:]:
        got = run_both(case, "LeastAllocated", w)[1]
        np.testing.assert_array_equal(got[0], base[0])
        np.testing.assert_array_equal(got[1], base[1])
        seen.update(k for k, v in zip(("commit", "replay"), got[2]) if v)
    assert seen == {"commit", "replay"}


def test_gate_matches_the_reference_rule():
    """`SpreadTable.gate` against a direct transcription of the host
    plugin's rule (keyless nodes reject; eligible domains hold the skew
    with the pod's selfMatch and the minDomains floor; keyed nodes
    outside every eligible domain are fresh)."""
    _, table, counts, applies, contrib, _, _ = spread_case(4)
    tab = tsolver.SpreadTable(*(torch.from_numpy(table[k]) for k in (
        "node_dom", "dom_cid", "max_skew", "min_ok", "has_key")))
    got = tab.gate(torch.from_numpy(counts), torch.from_numpy(contrib),
                   torch.from_numpy(applies)).numpy()
    node_dom, dom_cid = table["node_dom"], table["dom_cid"]
    n, C = node_dom.shape
    for p in range(applies.shape[0]):
        for j in range(n):
            ok = True
            for c in range(C):
                if not applies[p, c]:
                    continue
                if not table["has_key"][j, c]:
                    ok = False
                    continue
                d = node_dom[j, c]
                if d < 0:
                    continue
                doms = counts[dom_cid == c]
                mn = doms.min() if table["min_ok"][c] else 0
                if counts[d] + contrib[p, c] - mn > table["max_skew"][c]:
                    ok = False
            assert got[p, j] == ok, (p, j)
