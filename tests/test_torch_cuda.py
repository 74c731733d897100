"""The hand-written CUDA kernel against its plain PyTorch version, on the
card. Marked `cuda`: it skips without a CUDA device (the check runs inside
the test, so every test worker collects the same tests). It imports no JAX,
so it also runs where JAX is not installed:
`python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py`.

Contract: the kernel (`wave_solve` on CUDA tensors) and
`wave_solve_reference` on the same CUDA tensors give identical
assignments, commits, replays and poisoned flags, under the default launch
plan and under clusters of several blocks (heterogeneous chunks, a prime
node count, fewer nodes than blocks, the global-carry form); the probe kernel
returns x + 1; the `wave_eval` kernel and `wave_eval_reference` give
identical masked scores and gated masks; the two-launch wave step
(`wave_step`) and `wave_step_reference` give identical assignments,
commit/replay decisions and carries wave by wave, and a wave wider than
the kernels' top lists raises; the node-sharded solver with the kernel
on a 4-shard mesh of the card assigns exactly as the kernel-off route and
the single-device solver; the Sinkhorn plan on the card agrees with the
CPU's within the plan tolerance, with the same sanitization; and the
optimal mode's rounding (`wave_solve` at W=1, poison=False, on -1e30 rows
with zero live weights) equals its plain version; the serving fast path's
`solve_one` / `solve_one_fresh` on the card equal the CPU's and wait for
nothing, and its `SinglePodFastPath` places lone pods where the card's
`TorchBackend.assign([pi])` does; and the scheduler loop
(`Scheduler.run` with the serving tier) on the card binds a pre-created
heterogeneous workload exactly as on the CPU; gang chunks (Coscheduling in
the profile) place on the card exactly as on the CPU, and one bucket of the
preemption victim proposal (`propose_victims`) on the card, under sync
debug "error", equals the CPU's; and device-topology chunks (NUMA zones,
resource claims, host ports) place on the card exactly as on the CPU; and
the chunk stream (`assign_stream`) on the card equals `assign` on the card
and on the CPU, its wait for the card running beside another task's CUDA
graph captures; and the slice scan (`topology.device.device_scan`) on the
card equals the CPU's on phase 16(a)'s fixtures, its sharded winner equal
at 1, 4 and 8 shards, and the slice-gang chunks place on the card exactly
as on the CPU; and the descheduler's `consolidation_scores` on the card
equal the CPU's bit for bit on `chip_smoke.consolidation_case`'s fixtures,
and a `DeschedulerController` built with no device scores on the card and
evicts the pods a CPU one evicts.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (compare_solve_one, compare_wave_steps, fresh_pack,
                        hetero_chunk, lone_pods, serving_nodes, storm,
                        wave_eval_case)
from kubernetes_tpu_torch.ops import solver, wave_eval, wave_kernel
from kubernetes_tpu_torch.ops.wave_kernel import WavePlan, carry_bytes

STRATEGIES = ("LeastAllocated", "MostAllocated", "RequestedToCapacityRatio")
WIDTHS = (1, 2, 8, 31)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda:0")


def _on(args: dict, dev) -> dict:
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                if isinstance(v, np.ndarray) and v.ndim else float(v))
            for k, v in args.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_kernel_matches_plain_version(cuda, strategy):
    args, rows, exc, perms = storm(seed=50 + STRATEGIES.index(strategy),
                                   n=32, p=96, r=3)
    t = _on(dict(args, w_fit=np.float32(1.0), w_bal=np.float32(1.0)), cuda)
    rows_t = torch.from_numpy(rows).to(cuda)
    exc_t = torch.from_numpy(exc).to(cuda)
    perms_t = torch.from_numpy(perms).to(cuda)
    replays = 0
    for w in WIDTHS:
        for poison, pm in ((True, perms_t), (False, None)):
            kw = dict(strategy=strategy, wave_w=w, rows=rows_t, exc=exc_t,
                      poison=poison, perms=pm)
            before = wave_kernel.wave_solve.launches
            got = wave_kernel.wave_solve(**t, **kw)
            torch.cuda.synchronize()
            assert wave_kernel.wave_solve.launches == before + 1
            ref = wave_kernel.wave_solve_reference(**t, **kw)
            for name, g, r in zip(("assign", "commits", "replays",
                                   "poisoned"), got, ref):
                assert torch.equal(g.cpu(), r.cpu()), \
                    f"{strategy} W={w} poison={poison}: {name}"
            replays += int(got[2].sum())
    assert replays > 0                    # the storm drove the replay path


@pytest.mark.cuda
def test_backend_on_card_matches_cpu(cuda):
    """The whole batch cycle on the card places a small mixed cluster
    exactly as the CPU backend (the plain versions) does."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import (
        NodeInfo, PodInfo, Snapshot)
    from kubernetes_tpu_torch.utils import flags

    def snapshot():
        return Snapshot([NodeInfo(make_node(
            f"n{i}", allocatable={"cpu": str(2 + i % 5), "memory": "16Gi",
                                  "pods": str(4 + i % 3)}))
            for i in range(40)], 1)

    pods = [PodInfo(make_pod(f"p{i}", requests={
        "cpu": f"{300 + 100 * (i % 7)}m", "memory": "1Gi"}))
        for i in range(260)]
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    with flags.scoped_set("KTPU_WAVE_WIDTH", 8):
        on_card, _ = TorchBackend(device=cuda, max_batch=32).assign(
            pods, snapshot(), fwk)
        on_cpu, _ = TorchBackend(device="cpu", max_batch=32).assign(
            pods, snapshot(), fwk)
    assert on_card == on_cpu
    assert 0 < sum(v is not None for v in on_card.values()) < len(pods)


@pytest.mark.cuda
def test_probe_kernel(cuda):
    wave_kernel.probe_check()
    x = torch.randn(1000, device=cuda)
    assert torch.equal(wave_kernel.probe(x), x + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_wave_eval_kernel_matches_plain_version(cuda, strategy):
    for shards in (1, 4):
        for uniform in (False, True):
            case = _on(wave_eval_case(30 + shards, 1024, shards, uniform),
                       cuda)
            before = wave_eval.wave_eval.launches
            got = wave_eval.wave_eval(**case, strategy=strategy)
            torch.cuda.synchronize()
            assert wave_eval.wave_eval.launches == before + 1
            ref = wave_eval.wave_eval_reference(**case, strategy=strategy)
            assert torch.equal(got[0], ref[0]), (shards, uniform)
            assert torch.equal(got[1], ref[1]), (shards, uniform)
            assert torch.isfinite(ref[0]).any()
    with pytest.raises(ValueError, match="R=17"):
        big = _on(wave_eval_case(1, 256, 1, False, r=17), cuda)
        wave_eval.wave_eval(**big, strategy=strategy)


@pytest.mark.cuda
def test_sharded_route_on_card_matches_single_device(cuda):
    from kubernetes_tpu_torch.parallel import (
        build_mesh, sharded_greedy_assign)

    args, rows, exc, _ = storm(seed=62, n=64, p=96, r=2)   # replays
    t = _on(dict(args, w_fit=np.float32(1.0), w_bal=np.float32(1.0)), cuda)
    rows_t = torch.from_numpy(rows).to(cuda)
    exc_t = torch.from_numpy(exc).to(cuda)
    want = solver.greedy_assign_rescoring(
        **t, strategy="MostAllocated", rows=rows_t, exc=exc_t)
    for w in (8, 32):
        before = wave_eval.wave_eval.launches
        got = sharded_greedy_assign(
            build_mesh(4), **t, strategy="MostAllocated", rows=rows_t,
            exc=exc_t, wave_w=w, kernel=True)
        assert wave_eval.wave_eval.launches == before + -(-96 // w)
        assert torch.equal(got, want), w


def _step_case(kind: str, seed: int, dev, p: int = 200):
    """A conflict storm (64 identical nodes) or a heterogeneous chunk (1024
    nodes), with three pods of the empty class row 0 (no feasible node),
    as card tensors."""
    if kind == "storm":
        arrays, rows, exc, _ = storm(seed=seed, n=64, p=p, k=1)
    else:
        arrays, rows, exc, _ = hetero_chunk(seed=seed, n=1024, p=p, k=1)
    rows = rows.copy()
    rows[:3] = 0
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
         for k, v in arrays.items()}
    return t, torch.from_numpy(rows).to(dev), torch.from_numpy(exc).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["storm", "hetero"])
@pytest.mark.parametrize("shards", [1, 4])
def test_wave_step_kernel_matches_plain_version(cuda, kind, shards):
    t, rows, exc = _step_case(kind, 80 + shards, cuda)
    waves, replayed = compare_wave_steps(
        torch, t, rows, exc, (shards,), 32, 1.0, 1.0, "MostAllocated")
    assert waves == -(-200 // 32)
    if kind == "storm":
        assert replayed > 0                    # the replay ran on the card


@pytest.mark.cuda
def test_wave_step_wider_than_its_top_lists_raises(cuda):
    t, rows, exc = _step_case("storm", 90, cuda)
    with pytest.raises(ValueError, match="W=65"):
        compare_wave_steps(torch, t, rows, exc, (4,), 65, 1.0, 1.0,
                           "LeastAllocated")


@pytest.mark.cuda
def test_sharded_route_kernel_on_equals_kernel_off(cuda):
    """Two launches per wave with the kernel on, none with it off, and the
    same assignments."""
    from kubernetes_tpu_torch.parallel import (
        build_mesh, sharded_greedy_assign)

    for kind in ("storm", "hetero"):
        t, rows, exc = _step_case(kind, 91, cuda, p=300)
        got = {}
        for kernel in (True, False):
            before = (wave_eval.wave_eval.launches,
                      wave_eval.wave_resolve.launches)
            got[kernel] = sharded_greedy_assign(
                build_mesh(4), **t, w_fit=1.0, w_bal=1.0,
                strategy="LeastAllocated", rows=rows, exc=exc, wave_w=32,
                kernel=kernel)
            torch.cuda.synchronize()
            n = -(-300 // 32) if kernel else 0
            assert (wave_eval.wave_eval.launches,
                    wave_eval.wave_resolve.launches) == (before[0] + n,
                                                         before[1] + n)
        assert torch.equal(got[True], got[False]), kind


def _plans(n: int, r: int) -> list[WavePlan]:
    """The default plan and clusters of 2, 4 and 16 blocks over N nodes,
    with the carry in shared memory and in global scratch."""
    plans = [wave_kernel.wave_launch_plan(n, r, 32)]
    for cs, threads in ((2, 64), (4, 128), (16, 256)):
        per = -(-n // cs)
        plans.append(WavePlan(cs, per, threads, carry_bytes(per, r),
                              "shared"))
        plans.append(WavePlan(cs, per, threads, 0, "global"))
    return plans


def _compare_plans(t, rows, exc, perms, strategy, plans, dev):
    rows_t, exc_t, perms_t = (torch.from_numpy(a).to(dev)
                              for a in (rows, exc, perms))
    seen = {"poisoned": 0, "replays": 0}
    for poison, pm in ((True, perms_t), (False, None)):
        kw = dict(strategy=strategy, wave_w=32, rows=rows_t, exc=exc_t,
                  poison=poison, perms=pm)
        ref = wave_kernel.wave_solve_reference(**t, **kw)
        seen["poisoned"] += int(ref[3].sum())
        seen["replays"] += int(ref[2].sum())
        for plan in plans:
            got = wave_kernel.wave_solve(**t, plan=plan, **kw)
            torch.cuda.synchronize()
            for name, g, r in zip(("assign", "commits", "replays",
                                   "poisoned"), got, ref):
                assert torch.equal(g.cpu(), r.cpu()), \
                    f"{strategy} poison={poison} {plan}: {name}"
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_heterogeneous_chunk_across_cluster_blocks(cuda, strategy):
    """A small heterogeneous chunk (node shapes, near-ties, exceptions, an
    exhausted resource) at a prime node count, so the last slice is short,
    under clusters of 1 to 16 blocks in both carry forms."""
    n = 311
    args, rows, exc, perms = hetero_chunk(seed=70, n=n, p=160, r=3,
                                          groups=12)
    t = _on(dict(args, w_fit=np.float32(1.0), w_bal=np.float32(1.0)), cuda)
    seen = _compare_plans(t, rows, exc, perms, strategy, _plans(n, 3), cuda)
    assert seen["poisoned"] or seen["replays"]      # conflicts were met


@pytest.mark.cuda
@pytest.mark.parametrize("n,r", [(320, 11), (5120, 10)])
def test_default_plan_in_the_shared_memory_opt_in_window(cuda, n, r):
    """Default shared-form plans whose dynamic shared memory lies between
    the limit a kernel gets without opting in (48 KB less its static
    shared memory) and 48 KB: the launch raises the limit for them too."""
    plan = wave_kernel.wave_launch_plan(n, r, 32)
    assert plan.carry == "shared" and 39_312 < plan.smem_bytes <= 49_152
    args, rows, exc, perms = hetero_chunk(seed=72, n=n, p=128, r=r,
                                          groups=8, k=2)
    t = _on(dict(args, w_fit=np.float32(1.0), w_bal=np.float32(1.0)), cuda)
    _compare_plans(t, rows, exc, perms, "LeastAllocated", [plan], cuda)


@pytest.mark.cuda
def test_fewer_nodes_than_cluster_blocks(cuda):
    """N < CS: the blocks past the last node own empty slices and offer
    (-inf, N) to every reduction."""
    n = 3
    args, rows, exc, perms = hetero_chunk(seed=71, n=n, p=24, r=2, groups=2)
    t = _on(dict(args, w_fit=np.float32(1.0), w_bal=np.float32(1.0)), cuda)
    plans = [WavePlan(cs, 1, 128, carry_bytes(1, 2), "shared")
             for cs in (4, 16)] + [WavePlan(8, 1, 64, 0, "global")]
    for strategy in STRATEGIES:
        _compare_plans(t, rows, exc, perms, strategy, plans, cuda)


def _plan_case(seed: int, n: int, dev):
    """A heterogeneous chunk's transport problem (costs: its chunk-start
    scores) and its solve inputs, as card tensors."""
    from kubernetes_tpu_torch.ops import kernels

    arrays, rows, exc, perms = hetero_chunk(seed=seed, n=n, p=192)
    t = _on(arrays, dev)
    class_req = np.zeros((arrays["mask"].shape[0], 2), np.int32)
    class_req[rows] = arrays["req_q"]
    creq = torch.from_numpy(class_req).to(dev)
    feasible = t["mask"] & (t["free_pods"] >= 1)[None, :] & torch.all(
        creq[:, None, :] <= t["free_q"][None, :, :], dim=-1)
    cost = kernels.chunk_start_scores(
        t["alloc_q"], t["used_nz_q"], creq, t["static_scores"],
        t["fit_col_w"], t["bal_col_mask"], t["shape_u"], t["shape_s"],
        1.0, 1.0, "LeastAllocated")
    counts = torch.from_numpy(np.bincount(
        rows, minlength=class_req.shape[0]).astype(np.float32)).to(dev)
    return (feasible, cost, counts, t["free_pods"]), t, rows, exc, perms


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 4093])
def test_plan_on_card_matches_cpu(cuda, n):
    """`sinkhorn_plan` on the card against the port's plan on the CPU:
    within the plan tolerance of tests/test_torch_optimal.py, the same
    sanitization, one value per group of identical columns (raised
    otherwise by `chip_smoke.compare_plan`), with TF32 off."""
    from chip_smoke import compare_plan

    assert not torch.backends.cuda.matmul.allow_tf32
    assert torch.get_float32_matmul_precision() == "highest"
    problem = _plan_case(40 + n, n, cuda)[0]
    log_plan, err = compare_plan(torch, f"hetero N={n}", *problem, 24, 0.05)
    assert (log_plan == -1e30).any() and err <= 1e-2


@pytest.mark.cuda
def test_w1_rounding_on_sanitized_rows_matches_plain_version(cuda):
    """The optimal mode's rounding launch: `wave_solve` at W=1 with
    poison=False over K=4 orders, the log-plan (-1e30 where infeasible,
    the empty class row all -1e30) as static scores and w_fit = w_bal = 0,
    identical to `wave_solve_reference`."""
    from kubernetes_tpu_torch.ops import solver as tsolver

    problem, t, rows, exc, perms = _plan_case(45, 2000, cuda)
    log_plan, _ = tsolver.sinkhorn_plan(*problem, 24, 0.05)
    assert (log_plan[0] == -1e30).all()
    args = dict(t, static_scores=log_plan, w_fit=0.0, w_bal=0.0)
    kw = dict(strategy="LeastAllocated", wave_w=1,
              rows=torch.from_numpy(rows).to(cuda),
              exc=torch.from_numpy(exc).to(cuda), poison=False,
              perms=torch.from_numpy(perms).to(cuda))
    before = wave_kernel.wave_solve.launches
    got = wave_kernel.wave_solve(**args, **kw)
    torch.cuda.synchronize()
    assert wave_kernel.wave_solve.launches == before + 1
    ref = wave_kernel.wave_solve_reference(**args, **kw)
    for name, g, r in zip(("assign", "commits", "replays", "poisoned"),
                          got, ref):
        assert torch.equal(g, r), name
    assert (got[0] >= 0).any()


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_solve_one_on_card_matches_cpu(cuda, strategy):
    """The serving fast path's solve at N=5120: `solve_one` and
    `solve_one_fresh` (delta buckets of 1, 2 and 4 rows) on the card give
    the CPU's index and refreshed pack, on random and on tied nodes, and
    enqueue without waiting for the card (sync debug mode "error")."""
    picks = [compare_solve_one(torch, cuda, 70, 5120, strategy, uniform,
                               bucket)
             for uniform in (False, True) for bucket in (0, 1, 2, 4)]
    assert picks[4] == 0              # tied nodes: the lowest index wins
    assert all(p >= 0 for p in picks)


@pytest.mark.cuda
def test_sync_debug_mode_catches_a_device_read(cuda):
    """The guard `compare_solve_one` relies on is live: a read of a card
    value inside it raises."""
    x = torch.ones(4, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            x.sum().item()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.cuda
def test_fast_path_on_card_matches_batch_path(cuda):
    """Lone pods on a small heterogeneous cluster (three node shapes,
    taints, a cordoned node): the card's `SinglePodFastPath` places each
    eligible pod where `TorchBackend(cuda, max_batch=16).assign([pi])`
    does, leaves the others to the normal path, and its resident pack ends
    equal to a fresh pack."""
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.serving import (ResidentPlanes,
                                              SinglePodFastPath)

    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    cache = SchedulerCache()
    for nd in serving_nodes(21, n=200):
        cache.add_node(nd)
    backend = TorchBackend(device=cuda)
    fp = SinglePodFastPath(backend, ResidentPlanes(backend))
    batch = TorchBackend(device=cuda, max_batch=16)
    placed = 0
    for pi, kind in lone_pods(21, 96, n=200):
        snap = cache.update_snapshot()
        got = fp.try_schedule(pi, snap, fwk)
        if kind in ("plain", "huge"):
            want, _ = batch.assign([pi], snap, fwk)
            assert got == want[pi.key], (pi.key, kind)
        else:
            assert got is None, (pi.key, kind)
        if got is not None:
            placed += 1
            cache.assume_pod(pi, got)
    assert placed == fp.placed >= 48
    snap = cache.update_snapshot()
    ct = backend._tensors(snap)
    assert torch.equal(fp.resident.used_pack(ct, snap).cpu(),
                       fresh_pack(torch, ct))


@pytest.mark.cuda
def test_scheduler_loop_on_card_matches_cpu(cuda, monkeypatch):
    """Phase 9(a)'s pre-created shape (64 heterogeneous nodes, 300 pods,
    some that fit nowhere) through the port's `Scheduler.run` with serving
    on: `TorchBackend()` on the card binds every pod where
    `TorchBackend(device="cpu")` does, with the same FailedScheduling
    messages, and no node goes over capacity."""
    import asyncio

    from chip_smoke import (LOOP_BATCH, N_LOOP_NODES, N_LOOP_PODS,
                            loop_cluster, over_capacity, port_loop_api,
                            run_loop)
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    monkeypatch.setenv("KTPU_SERVING", "1")
    monkeypatch.delenv("KTPU_SOLVE_MODE", raising=False)
    api = port_loop_api()
    nodes, pods = loop_cluster(8, N_LOOP_NODES, N_LOOP_PODS)
    card = asyncio.run(run_loop(api, nodes, pods, TorchBackend(device=cuda),
                                LOOP_BATCH))
    cpu = asyncio.run(run_loop(api, nodes, pods, TorchBackend(device="cpu"),
                               LOOP_BATCH))
    assert card["assignments"] == cpu["assignments"]
    assert card["failed"] == cpu["failed"] != {}
    assert not over_capacity(card["nodes"], card["pods"])


@pytest.mark.cuda
@pytest.mark.parametrize("wave_w", [1, 32])
def test_spread_scan_on_card_matches_cpu(cuda, wave_w):
    """The spread scan (W=1, and its wave form at W=32) on the card, under
    sync debug "error", places, counts, commits and replays exactly as on
    the CPU on phase 10(a)'s seeded union tables."""
    from chip_smoke import no_host_sync_in_wave_loop, run_spread_scan, \
        spread_case

    for seed, strategy in ((10, "LeastAllocated"), (11, "MostAllocated")):
        case = spread_case(seed, n=300, p=128)
        with no_host_sync_in_wave_loop(torch):
            card = run_spread_scan(torch, case, strategy, wave_w, cuda)
        cpu = run_spread_scan(torch, case, strategy, wave_w, "cpu")
        np.testing.assert_array_equal(card[0], cpu[0])
        np.testing.assert_array_equal(card[1], cpu[1])
        assert card[2] == cpu[2]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "greedy"])
def test_constraint_chunk_on_card_matches_cpu(cuda, mode):
    """One chunk of every constraint template (anti-affinity, zone
    affinity, preferred terms, two hard spread templates, labeled plain
    pods) through `TorchBackend()` on the card and on the CPU: identical
    assignments, diagnostics' reasons, counters and spread counts."""
    from chip_smoke import (CONSTRAINT_KINDS, constraint_assign,
                            constraint_cluster, constraint_pods,
                            constraint_snapshot)
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import types
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)

    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    nodes, residents = constraint_cluster(9, 96)
    pods = [types.PodInfo(make_pod(n, **kw))
            for n, kw in constraint_pods(CONSTRAINT_KINDS, 192)]
    out = []
    for backend in (TorchBackend(device=cuda), TorchBackend(device="cpu")):
        snap = constraint_snapshot(types, make_node, make_pod, nodes,
                                   residents)
        ctx = constraint_assign(backend, snap, fwk, pods, mode)
        out.append((ctx.assignments,
                    {k: sorted(getattr(d, "reason_counts", {}).items())
                     for k, d in ctx.diagnostics.items()},
                    dict(backend.counters),
                    ctx.spread["dev_counts"].cpu().numpy().tolist()))
    assert out[0] == out[1]
    assert out[0][2]["spread_chunks"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "greedy"])
@pytest.mark.parametrize("kind", ["stranded", "assembled", "overflow",
                                  "spread"])
def test_gang_chunk_on_card_matches_cpu(cuda, kind, mode):
    """A gang chunk (`chip_smoke.gang_chunk`) through `TorchBackend()` on
    the card and on the CPU, Coscheduling in the profile: identical
    assignments, diagnostics, solver metrics, gang-overflow counts and
    spread counts."""
    from chip_smoke import (GANG_CHUNK, gang_chunk_view, port_gang_chunk)
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    card = gang_chunk_view(*port_gang_chunk(
        TorchBackend(device=cuda, max_batch=GANG_CHUNK), kind, mode))
    cpu = gang_chunk_view(*port_gang_chunk(
        TorchBackend(device="cpu", max_batch=GANG_CHUNK), kind, mode))
    assert card == cpu


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1000, 5000])
def test_propose_victims_on_card_matches_cpu(cuda, n):
    """One 128-preemptor `propose_victims` bucket on the card, under sync
    debug "error", equals the CPU port's: nodes, counts and the carry."""
    from chip_smoke import victim_case

    args = [torch.from_numpy(np.ascontiguousarray(a))
            for a in victim_case(n, n)]
    dev_args = [a.to(cuda) for a in args]
    torch.cuda.set_sync_debug_mode("error")
    try:
        card = solver.propose_victims(*dev_args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = solver.propose_victims(*args)
    for c, w in zip(card, want):
        assert torch.equal(c.cpu(), w)
    assert int((want[0] >= 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "greedy"])
@pytest.mark.parametrize("kind", ["nrt", "dra", "ports"])
def test_device_chunk_on_card_matches_cpu(cuda, kind, mode):
    """A device-topology chunk (`chip_smoke.device_case`: NUMA zones,
    resource claims, host ports) through `TorchBackend()` on the card and
    on the CPU: identical assignments, diagnostics, solver metrics,
    host-fallback counts and backend counters, and wave_solve launched on
    the card."""
    from chip_smoke import (DEVICE_CHUNK, device_chunk, device_chunk_view,
                            port_device_api)
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_device_api()
    wave_kernel.wave_solve.launches = 0
    on_card = TorchBackend(device=cuda, max_batch=DEVICE_CHUNK)
    card = device_chunk_view(*device_chunk(api, on_card, kind, 8, mode))
    assert wave_kernel.wave_solve.launches > 0
    on_cpu = TorchBackend(device="cpu", max_batch=DEVICE_CHUNK)
    cpu = device_chunk_view(*device_chunk(api, on_cpu, kind, 8, mode))
    assert card == cpu
    assert on_card.counters == on_cpu.counters


@pytest.mark.cuda
@pytest.mark.parametrize("kind,mode", [("storm", "greedy"),
                                       ("failures", "auto"),
                                       ("failures", "greedy")])
def test_stream_on_card_matches_assign(cuda, kind, mode):
    """`assign_stream` on the card against `assign` on the card and on the
    CPU (phase 15(a)'s `compare_stream`, which raises on any difference)."""
    import copy

    from chip_smoke import compare_stream, stamped_snapshot, stream_case
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

    nodes, pods, batch = stream_case(kind)
    gen = [0]

    def snapshot():
        gen[0] += 1
        return stamped_snapshot([NodeInfo(copy.deepcopy(n)) for n in nodes],
                                gen[0])

    compare_stream(torch, kind, snapshot, [PodInfo(p) for p in pods],
                   Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS), batch,
                   mode, "replays" if kind == "storm" else "failures")


@pytest.mark.cuda
def test_stream_wait_beside_graph_captures(cuda):
    """The stream's wait for the card polls its event on the loop's
    thread, so another task capturing and replaying CUDA graphs (default
    global capture mode) between its polls neither raises nor spoils a
    capture, and the stream's result is `assign`'s."""
    import asyncio

    from chip_smoke import stamped_snapshot, stream_case
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

    nodes, pods, batch = stream_case("failures")
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    want, _ = TorchBackend(max_batch=batch).assign(
        [PodInfo(p) for p in pods],
        stamped_snapshot([NodeInfo(n) for n in nodes], 1), fwk)
    x = torch.arange(4096, dtype=torch.float32, device=cuda)

    async def main():
        done = []

        async def capturer():
            captures = 0
            while not done:
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    y = x * 2 + 1
                g.replay()
                torch.cuda.synchronize()
                assert torch.equal(y, x * 2 + 1)
                captures += 1
                await asyncio.sleep(0)
            return captures

        task = asyncio.ensure_future(capturer())
        backend = TorchBackend(max_batch=batch)
        ctx = None
        async for _, ctx in backend.assign_stream(
                [PodInfo(p) for p in pods],
                stamped_snapshot([NodeInfo(n) for n in nodes], 2), fwk):
            # Between chunks the capturer runs while later chunks' passes
            # and copies are still queued behind their events.
            await asyncio.sleep(0)
        done.append(True)
        return dict(ctx.assignments), await task

    got, captures = asyncio.run(main())
    assert got == want
    assert captures > 0


@pytest.mark.cuda
@pytest.mark.parametrize("raw,n", [("4x4", 16), ("4x8:mesh", 32),
                                   ("3x5x2", 30), ("auto", 5000),
                                   ("8x8x16", 1024)])
def test_slice_scan_on_card_matches_cpu(cuda, raw, n):
    from chip_smoke import mesh_spec, scan_masks, scan_shapes, scan_view
    from kubernetes_tpu_torch.topology import device as topo

    spec = mesh_spec(raw, n)
    for shape in scan_shapes(spec):
        for name, mask in scan_masks(spec, 8):
            card = topo.device_scan(mask, spec, shape, "cuda:0")
            assert scan_view(card) == scan_view(
                topo.device_scan(mask, spec, shape, "cpu")), (shape, name)
            if card is not None:
                want = topo.best_key(card[0])
                assert [topo.best_key(card[0], s, "cuda:0")
                        for s in (1, 4, 8)] == [want] * 3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["auto", "greedy"])
@pytest.mark.parametrize("kind", ["torus-2x2", "mesh-2x2x2",
                                  "impossible-1x3"])
def test_slice_chunk_on_card_matches_cpu(cuda, kind, mode):
    from chip_smoke import port_slice_api, slice_chunk
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_slice_api()
    assert slice_chunk(api, TorchBackend(max_batch=64), kind, mode) == \
        slice_chunk(api, TorchBackend(device="cpu", max_batch=64), kind,
                    mode)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["uniform", "at-threshold", "zero-alloc",
                                  "empty", "invalid", "random"])
def test_consolidation_scores_on_card_match_cpu(cuda, kind):
    from chip_smoke import consolidation_case

    free, alloc, used, valid, thr = consolidation_case(kind, 5, 5000)
    args = tuple(map(torch.from_numpy, (free, alloc, used, valid)))
    want = solver.consolidation_scores(*args, thr)
    got = solver.consolidation_scores(*(a.to(cuda) for a in args), thr)
    assert got.device.type == "cuda"
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


async def _rebalance(device) -> tuple:
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.controllers import DeschedulerController
    from kubernetes_tpu_torch.store import new_cluster_store

    store = new_cluster_store()
    try:
        for i in range(24):
            await store.create("nodes", make_node(f"n{i}", allocatable={
                "cpu": "4", "memory": "16Gi", "pods": "16"}))
            for k in range(1 + i % 5):
                await store.create("pods", make_pod(
                    f"p{i}-{k}", requests={"cpu": "500m", "memory": "1Gi"},
                    node_name=f"n{i}", phase="Running", uid=f"u{i}-{k}"))
        factory = InformerFactory(store)
        d = DeschedulerController(store, budget=6, threshold=0.4,
                                  device=device)
        d.setup(factory)
        factory.start()
        await factory.wait_for_sync()
        seen = []
        scores = solver.consolidation_scores

        def recorded(*args):
            seen.append(args[0].device.type)
            return scores(*args)

        solver.consolidation_scores = recorded
        try:
            evicted = await d.rebalance_once()
        finally:
            solver.consolidation_scores = scores
        names = sorted(p["metadata"]["name"]
                       for p in (await store.list("pods")).items)
        factory.stop()
        return d.device.type, seen, evicted, names
    finally:
        store.stop()


@pytest.mark.cuda
def test_descheduler_scores_on_the_card(cuda):
    import asyncio

    card = asyncio.run(_rebalance(None))
    cpu = asyncio.run(_rebalance("cpu"))
    assert card[:2] == ("cuda", ["cuda"]) and cpu[:2] == ("cpu", ["cpu"])
    assert card[2:] == cpu[2:] and card[2] > 0
