"""The launch plan of the `wave_solve` kernel (one thread-block cluster per
order, its carry in shared memory where a block's slice fits), checked on
the CPU: `wave_launch_plan` is a pure function of (N, R, W), so what it
promises the kernel — every node in exactly one block's slice, shared
memory within the card's limit, a cluster the card can form, the
global-carry form exactly where a slice does not fit — holds here without
a card. The kernel itself runs under these plans in tests/test_torch_cuda.py
and chip_smoke.py."""

import pytest

from kubernetes_tpu_torch.ops import wave_kernel
from kubernetes_tpu_torch.ops.wave_kernel import (
    MAX_CLUSTER, SMEM_PER_BLOCK, STATIC_SMEM_BUDGET, WavePlan, carry_bytes,
    wave_launch_plan)

SHAPES = [(1, 1), (3, 2), (48, 2), (64, 2), (640, 2), (641, 2), (1000, 3),
          (4093, 2), (5000, 2), (5120, 2), (8192, 4), (17000, 16),
          (20000, 16), (70000, 8), (1_000_003, 2)]
#: Shapes whose shared-form plan asks for more dynamic shared memory than
#: a kernel gets without opting in (48 KB less its static shared memory)
#: but no more than 48 KB: the launch must raise the limit for these too.
OPT_IN_WINDOW = [(320, 11), (256, 14), (5120, 10), (12000, 4), (24000, 2)]
SHAPES += OPT_IN_WINDOW


def _slices(plan: WavePlan, n: int) -> list[range]:
    return [range(min(b * plan.nodes_per_block, n),
                  min((b + 1) * plan.nodes_per_block, n))
            for b in range(plan.cluster)]


@pytest.mark.parametrize("n,r", SHAPES)
def test_slices_cover_every_node_once(n, r):
    plan = wave_launch_plan(n, r, 32)
    covered = [i for s in _slices(plan, n) for i in s]
    assert covered == list(range(n))


@pytest.mark.parametrize("n,r", SHAPES)
def test_shared_memory_within_the_card(n, r):
    plan = wave_launch_plan(n, r, 32)
    assert plan.smem_bytes + STATIC_SMEM_BUDGET <= SMEM_PER_BLOCK
    assert plan.smem_bytes <= 232_448
    if plan.carry == "shared":
        assert plan.smem_bytes == carry_bytes(plan.nodes_per_block, r)
    else:
        assert plan.smem_bytes == 0


@pytest.mark.parametrize("n,r", SHAPES)
def test_cluster_and_threads_in_range(n, r):
    plan = wave_launch_plan(n, r, 32)
    assert 1 <= plan.cluster <= 16
    assert plan.cluster & (plan.cluster - 1) == 0        # a power of two
    assert 32 <= plan.threads <= 256 and plan.threads % 32 == 0
    # The cluster is no larger than it needs to be: half of it would leave
    # a block more nodes than the plan allows, or a slice that overflows.
    if plan.cluster > 1:
        half = -(-n // (plan.cluster // 2))
        assert (half > wave_kernel.NODES_PER_BLOCK
                or carry_bytes(half, r) + STATIC_SMEM_BUDGET
                > SMEM_PER_BLOCK)


@pytest.mark.parametrize("n,r", SHAPES)
def test_global_carry_exactly_when_the_slice_does_not_fit(n, r):
    plan = wave_launch_plan(n, r, 32)
    per = -(-n // MAX_CLUSTER)
    overflows = carry_bytes(per, r) + STATIC_SMEM_BUDGET > SMEM_PER_BLOCK
    assert (plan.carry == "global") == overflows
    if plan.carry == "global":
        assert plan.cluster == MAX_CLUSTER


@pytest.mark.parametrize("n", [1, 2, 24, 48, 64, 256, 320])
def test_tiny_n_gets_one_block(n):
    for r in (1, 2, 3, 16):
        assert wave_launch_plan(n, r, 8).cluster == 1


@pytest.mark.parametrize("n,r", OPT_IN_WINDOW)
def test_plans_reach_the_opt_in_window(n, r):
    plan = wave_launch_plan(n, r, 32)
    assert plan.carry == "shared"
    assert 48 * 1024 - STATIC_SMEM_BUDGET < plan.smem_bytes <= 48 * 1024


def test_main_path_chunk_takes_a_cluster():
    plan = wave_launch_plan(5000, 2, 32)
    assert plan.cluster > 1 and plan.carry == "shared"
    assert wave_launch_plan(20000, 16, 32).carry == "global"


@pytest.mark.parametrize("n,r,w", [(0, 2, 8), (10, 0, 8), (10, 17, 8),
                                   (10, 2, 0), (10, 2, 65)])
def test_shapes_neither_form_takes_raise(n, r, w):
    with pytest.raises(ValueError, match=f"N={n}, R={r}"):
        wave_launch_plan(n, r, w)


@pytest.mark.parametrize("plan,ok", [
    (WavePlan(4, 1, 128, carry_bytes(1, 2), "shared"), True),   # N < CS
    (WavePlan(1, 3, 64, 0, "global"), True),
    (WavePlan(2, 1, 128, carry_bytes(1, 2), "shared"), False),  # 2 of 3
    (WavePlan(4, 1, 100, carry_bytes(1, 2), "shared"), False),  # not warps
    (WavePlan(4, 1, 512, carry_bytes(1, 2), "shared"), False),  # > 256
    (WavePlan(4, 1, 128, 0, "shared"), False),                  # bytes
    (WavePlan(4, 1, 128, 64, "global"), False),                 # bytes
    (WavePlan(32, 1, 128, carry_bytes(1, 2), "shared"), False),  # > 16
    (WavePlan(1, 20000, 256, carry_bytes(20000, 2), "shared"), False),
])
def test_explicit_plans_are_checked(plan, ok):
    if ok:
        wave_kernel._check_plan_shape(plan, 3, 2)
    else:
        with pytest.raises(ValueError, match="does not take"):
            wave_kernel._check_plan_shape(plan, 3, 2)
