"""The plain reference against placements worked out by hand, ties among
them."""

import numpy as np
import pytest

from schedbench.reference import placement as P
from schedbench.reference.quantity import milli

CPU_M = 1000          # 1 cpu
MEM_M = milli("4Gi")


def cluster(n, cpu=CPU_M, slots=110, mem=MEM_M):
    alloc = np.array([[cpu, mem]] * n, dtype=np.int64)
    return P.Cluster(alloc, np.full(n, slots, dtype=np.int64),
                     [f"n{i}" for i in range(n)])


POD = P.Template(np.array([milli("100m"), milli("250Mi")], dtype=np.int64))


def test_quantities_are_exact_milli_units():
    assert milli("100m") == 100
    assert milli("8") == 8000
    assert milli("250Mi") == 250 * 2 ** 20 * 1000
    assert milli("32Gi") == 32 * 2 ** 30 * 1000
    assert milli("1.5") == 1500


def test_greedy_spreads_over_equal_nodes_lowest_index_first():
    cl = cluster(4)
    start = np.zeros(4, dtype=np.int64)
    got = P.solve_dispatch(cl, POD, start, 6, chunk=1024)
    # LeastAllocated: an empty node outscores a used one; equal nodes tie
    # and the lowest index wins.
    assert got.tolist() == [0, 1, 2, 3, 0, 1]
    v = P.judge_dispatch(cl, POD, start, got, chunk=1024)
    assert (v.checked, v.misplaced) == (6, 0)


def test_a_higher_twin_is_misplaced():
    cl = cluster(4)
    start = np.zeros(4, dtype=np.int64)
    # Pod 0 on node 1 while node 0, its twin, is free: misplaced. Pods 1-3
    # then land where the reference would from that state.
    v = P.judge_dispatch(cl, POD, start, [1, 0, 2, 3], chunk=1024)
    assert v.misplaced == 1


def test_a_worse_node_is_misplaced_by_its_gap():
    cl = cluster(3)
    start = np.array([3, 0, 0], dtype=np.int64)
    v = P.judge_dispatch(cl, POD, start, [0], chunk=1024)
    assert v.misplaced == 1 and v.worst_gap > P.EPS_SCORE


def test_no_feasible_node_means_unassigned():
    cl = cluster(2, cpu=100)
    start = np.array([1, 1], dtype=np.int64)
    assert P.solve_dispatch(cl, POD, start, 1, chunk=1024).tolist() == [-1]
    assert P.judge_dispatch(cl, POD, start, [-1], chunk=1024).misplaced == 0
    free = np.array([1, 0], dtype=np.int64)
    assert P.judge_dispatch(cl, POD, free, [-1], chunk=1024).misplaced == 1


def test_optimal_route_fills_first_fit():
    cl = cluster(8)                       # 10 pods of 100m per node
    start = np.zeros(8, dtype=np.int64)
    got = P.solve_dispatch(cl, POD, start, 64, chunk=1024)
    assert np.bincount(got, minlength=8).tolist() == [10] * 6 + [4, 0]
    assert got[:10].tolist() == [0] * 10
    assert P.judge_dispatch(cl, POD, start, got, chunk=1024).misplaced == 0
    # The same pods spread one per node, as a greedy scan would: the plan
    # ties every empty node, so only the first-fit order is right.
    spread = np.arange(64) % 8
    assert P.judge_dispatch(cl, POD, start, spread, chunk=1024).misplaced > 0


def test_optimal_route_skips_a_partly_used_node():
    cl = cluster(4)
    start = np.array([4, 0, 0, 0], dtype=np.int64)
    got = P.solve_dispatch(cl, POD, start, 70, chunk=1024)
    # Node 0's chunk-start score is below the empty nodes': the plan puts
    # it last, so nodes 1-3 fill first and node 0 takes its six free
    # slots; the rest fit nowhere.
    assert got[:30].tolist() == [1] * 10 + [2] * 10 + [3] * 10
    assert got[30:36].tolist() == [0] * 6
    assert (got[36:] == -1).all()
    assert P.judge_dispatch(cl, POD, start, got, chunk=1024).misplaced == 0


def test_chunks_chain_the_used_state():
    cl = cluster(4)
    start = np.zeros(4, dtype=np.int64)
    one = P.solve_dispatch(cl, POD, start, 3, chunk=1)
    assert one.tolist() == [0, 1, 2]


def test_near_tie_within_eps_is_either_way():
    cl = cluster(2)
    tp = POD
    start = np.array([0, 0], dtype=np.int64)
    static = P.static_scores(cl, start)
    s = P.live_scores(cl, tp, start, static)
    assert s[0] == s[1]


def test_bfloat16_rounds_to_eight_bits():
    assert P.bf16(1.0) == 1.0
    assert P.bf16(257.0) == 256.0
    assert P.bf16(259.0) == 260.0
    assert P.bf16(100.3) == 100.5


def test_bfloat16_leaves_a_uniform_cluster_as_float64_does():
    # Upstream's widths: nodes of cpu 4, memory 32Gi; pods of 100m, 500Mi.
    pod = P.Template(np.array([milli("100m"), milli("500Mi")],
                              dtype=np.int64))
    cl = cluster(300, cpu=milli("4"), mem=milli("32Gi"))
    start = np.random.default_rng(5).integers(0, 41, size=300)
    ref = P.solve_dispatch(cl, pod, start, 1500, chunk=1024)
    low = P.solve_dispatch(cl, pod, start, 1500, chunk=1024,
                           precision="bfloat16")
    assert (ref == low).all()
    assert P.judge_dispatch(cl, pod, start, low, chunk=1024).misplaced == 0


def test_the_check_refuses_a_template_it_does_not_model():
    from schedbench import check
    check_in = {"nodes": [("n0", {})],
                "node_template": {"allocatable": {"cpu": "4", "memory":
                                                  "32Gi", "pods": "110"}},
                "pod_template": {"requests": {"cpu": "100m",
                                              "memory": "500Mi"},
                                 "topology_spread_constraints": []}}
    with pytest.raises(ValueError):
        check.reference_inputs(check_in)


def test_free_occupied_pct_by_hand():
    alloc = np.array([[1000, 1000], [1000, 1000], [1000, 1000]])
    counts = np.array([2, 0, 5])
    req = np.array([100, 50])
    # node 0: cpu 80% free, mem 90% -> 85; node 2: 50%, 75% -> 62.5
    assert abs(P.free_occupied_pct(alloc, counts, req) - 73.75) < 1e-12
    assert P.free_occupied_pct(alloc, np.zeros(3, int), req) == 0.0


def test_tie_control_takes_the_highest_twin():
    cl = cluster(8)
    start = np.zeros(8, dtype=np.int64)
    hi = P.solve_dispatch(cl, POD, start, 64, chunk=1024, ties="high")
    assert hi[:10].tolist() == [7] * 10
    assert P.judge_dispatch(cl, POD, start, hi, chunk=1024).misplaced == 64
