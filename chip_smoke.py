#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one GPU.

Drives the port's five paths at scheduler_perf SchedulingBasic/5000Nodes
size (5000 nodes of cpu 8 / memory 32Gi / pods 110, 1000 init pods, then
10000 measured pods of cpu 100m / memory 250Mi in 1024-pod chunks, K=4
orders): `TorchBackend.assign` with KTPU_SOLVE_MODE=greedy pinned (the
greedy wavefront batch solve, W=32), the node-sharded solver of
`kubernetes_tpu_torch.parallel` on a 1-shard and a 4-shard mesh of cuda:0
(each wave two kernel launches, no host sync), flagless
`TorchBackend.assign` (KTPU_SOLVE_MODE=auto, the reference's default:
every chunk through the Sinkhorn plan, rounded by one W=1 launch of
wave_solve), and the serving fast path (2000 lone pods, one at a time,
through `SinglePodFastPath.try_schedule` over a `SchedulerCache`), and the
scheduler loop (`Scheduler.run` through the port's scheduler_perf
`PerfRunner`, pods created in a store and bound through informers, the
queue and the serving tier) — after
building the hand-written kernels from
`kubernetes_tpu_torch/csrc/` with nvcc and holding each against its plain
PyTorch version on the card.

Phases (any failure raises and the script exits non-zero with no result):
  1. build csrc/wave_solve.cu and csrc/wave_eval.cu for sm_90a, one nvcc
     each, started together, into one library (nvcc's -Xptxas -v report
     printed);
  2. the probe kernel against x + 1 (vector and scalar forms), timed back
     to back in turns with x + 1 and per launch under torch.profiler;
  3. wave_solve against wave_solve_reference, identical assignments and
     counters required, each case printing the launch plan it took: on
     the class planes the port's own prep builds for a 1024-pod chunk
     over 5000 nodes (K=4 poison=True and K=1 poison=False at W=32); on
     seeded heterogeneous chunks (several node shapes, near-ties,
     exception columns, an exhausted resource) at N=5000 and N=4093
     under each strategy, K=4 poison and K=1 replay, at R=16, N=20000
     in the global-carry form, and at N=320 R=11 and N=5120 R=10, whose
     shared memory lies just under 48 KB; and on a seeded conflict storm
     that drives the in-wave replay, the poisoned chunk and its W=1
     rerun; plus the whole CUDA backend against the CPU backend on a
     small cluster;
  4. the main path, with every launch counter set to 0 just before it:
     every pod placed, no node over capacity on a host re-check, the
     kernels launched;
  5. timings (CUDA events), the device's busy share and wave_solve's
     device time per launch (torch.profiler), and the launch-plan sweep
     (clusters of 4, 8, 16 blocks x 128, 256 threads);
  6. the sharded path: (a) wave_eval against wave_eval_reference, masked
     scores and gated mask identical, at W=32, R=2, C=2, local_n 5120 and
     1280, each strategy, with pinned members whose column lies in
     another shard, padding members, an all-infeasible class row and
     uniform nodes; (a') the two-launch wave step (wave_step) against
     wave_step_reference wave by wave, assignments, commit/replay decision
     and carry identical: the first uniform 5k chunk at 1 and 4 shards,
     heterogeneous chunks (W = 1, 8, 32, 64), storms that replay, a 2 x 2
     multislice mesh, members with no feasible node, padding members and
     exception columns; and W=65 raising; (b) the conflict storm through
     the 4-shard route, identical to the one-pod-per-step solver; (c) the
     10000 measured pods through sharded_masks_scores and
     sharded_greedy_assign(wave_w=32, kernel=True) on a 1-shard and a
     4-shard mesh, the used state chained from chunk to chunk, every wave
     loop under torch.cuda.set_sync_debug_mode("error"), every launch
     counter set to 0 just before each and read just after: every pod
     placed, no node over capacity, assignments identical to the
     kernel-off route, the single-device wave scan and TorchBackend.assign,
     exactly two launches per wave (none with the kernel off); (d) pods/s,
     one profiled chunk (device busy, idle share, kernel count, launch A's
     and B's device time), the wave step's ms per wave back to back, plain
     ms and bound, and the standalone wave_eval's ms, plain ms and bound;
  7. the flagless route, under a scoped KTPU_SOLVE_MODE=auto: (a) with
     TF32 off asserted, `sinkhorn_plan` on the card against the port's
     plan on the CPU — on the first flagless measured chunk's planes and on
     three heterogeneous chunks — within the tests' plan tolerance, the
     -1e30 sanitization identical, and one value per group of identical
     columns; (b) `wave_solve` at W=1, poison=False, K=4 on those
     log-plans with w_fit = w_bal = 0 (rows of -1e30 included) identical
     to wave_solve_reference; (c) the 1000 init and 10000 measured pods
     through `TorchBackend()`, every launch counter set to 0 just before
     it and every device pass under torch.cuda.set_sync_debug_mode("error"):
     every pod placed, no node over capacity on a host re-check, every
     chunk an optimal solve, exactly one wave_solve launch per chunk, and
     the first measured chunk placed identically by
     `TorchBackend(device="cpu")` from the same snapshot; (d) pods/s and the
     prep / device / verify split, the device's busy and idle share over a
     profiled repeat of the phase, the plan's ms per chunk (CUDA events),
     its host enqueue time, device kernels and device time (profiler) and
     bound, the W=1 wave_solve's ms and device time per chunk and bound,
     and fragmentation_occupied (%) after the greedy and the flagless
     measured phases; (e) `sharded_sinkhorn_plan` on 1- and 4-shard meshes
     of cuda:0 against the single-device plan;
  8. the serving fast path (`SinglePodFastPath` over `ResidentPlanes` and a
     `SchedulerCache`), under a scoped KTPU_SOLVE_MODE=auto: (a) on 5000
     heterogeneous nodes from `--seed` (three shapes, NoSchedule and
     PreferNoSchedule taints, one cordoned node), 256 lone pods (random
     requests, tolerations, hostname selectors, a few shapes the fast path
     must not take) each through the card's fast path, the CPU port's and,
     when eligible, `TorchBackend(max_batch=16).assign([pi])` on the card —
     all the same node or all None — then assumed; every solve under
     torch.cuda.set_sync_debug_mode("error"); the resident pack equal to a
     fresh pack and the placed/ineligible/no_fit counts equal to the
     CPU's; (b) SchedulingBasic/5000Nodes: the 1000 init pods by flagless
     `TorchBackend.assign`, assumed, `warm`, then 2000 lone pods of the
     measured template through light_snapshot -> try_schedule ->
     assume_pod, every placement equal to the CPU port's over the same
     sequence and every 50th to `TorchBackend.assign([pi])`; the
     per-placement wall (p50/p90/p99/max), serial pods/s, the split of a
     placement, host syncs per placement, and under torch.profiler over 100
     placements the device kernels, device time and idle share;
  9. the scheduler loop (`Scheduler.run` over a port store, informers,
     the SchedulingQueue and the serving tier), under a scoped
     KTPU_SOLVE_MODE=auto with serving on: (a) a heterogeneous cluster
     from `--seed` (64 nodes of three shapes, taints, a zone label, a
     cordoned node) and 300 pre-created pods (random requests and
     priorities, tolerations, zone selectors, preferred node affinity,
     pods that fit nowhere) through `TorchBackend()` on the card and
     through `TorchBackend(device="cpu")`: the same nodeName for every
     pod, the same unschedulable set and FailedScheduling messages, no
     node over capacity; then 64 lone pods trickled, each awaited until
     bound: all bound, some through the fast path, no node over
     capacity; (b) SchedulingBasic/5000Nodes through the port's
     `PerfRunner` (`Scheduler.run`, `TorchBackend()`, batch_size 16384),
     the launch counters set to 0 just before the measured createPods and
     read just after: all 11000 pods bound, no node over capacity on an
     exact host re-check of the store, more pods through the card (backend
     dispatches and the fast path) than through the host path, wave_solve
     launched; printed: SchedulingThroughput, measured_seconds, the exact
     attempt p50/p90/p99/p999, fragmentation_pct and
     fragmentation_occupied_pct, the route counts, `TorchBackend.timings`
     over the window, events emitted and dropped, over a repeat under
     torch.profiler the device's busy time and idle share, and over a
     repeat under cProfile the host's own time by area, the busiest
     functions and the cumulative time of the loop's stages;
 10. the result lines: a `kernels` JSON line (wave_solve's entry also
     carries the flagless path's W=1 launches, ms, device ms, plain ms and
     bound, and the loop's launches in phase 9(b)'s measured window; the
     probe's, its launches over phase 9(b)'s run), the card's name and
     power limit from nvidia-smi, and last {"ok": true, "device": {...}}.

Run from the repository root: `python3 chip_smoke.py [--seed N]`. It needs
one CUDA device; without one, or outside a checkout of the repository, it
exits non-zero.
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

#: NVIDIA H100 SXM published peaks (data sheet; dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

N_NODES, N_INIT, N_MEASURED = 5000, 1000, 10000
POD_REQUESTS = {"cpu": "100m", "memory": "250Mi"}


def stamped_snapshot(nodes, generation: int):
    """A Snapshot of hand-built NodeInfos, every node stamped with the
    snapshot's generation. A backend that built an earlier snapshot
    re-quantizes only the nodes whose generation moved (the incremental
    ClusterTensors build, as in the reference), and these nodes gain pods
    with no SchedulerCache to bump their generations."""
    from kubernetes_tpu_torch.scheduler.types import Snapshot

    for ni in nodes:
        ni.generation = generation
    return Snapshot(nodes, generation)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean milliseconds per call over `reps` calls, CUDA events, after a
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(event) -> float:
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0.0))


def kernel_ms_from(prof, match: str) -> float | None:
    """Mean device milliseconds per launch of the kernels whose name holds
    `match` in a torch.profiler session, or None if it recorded none."""
    hits = [(device_us(e), e.count) for e in prof.key_averages()
            if match in e.key and device_us(e) > 0]
    if not hits:
        return None
    return sum(t for t, _ in hits) / sum(c for _, c in hits) / 1e3


def profiled_kernel_ms(torch, fn, reps: int, match: str) -> float | None:
    """`kernel_ms_from` over `reps` calls of fn under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_ms_from(prof, match)


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def wave_bound_ms(p: int, n: int, r: int, c: int, k: int, s: int,
                  feasible_evals: int) -> tuple[float, str]:
    """Least time for one wave_solve launch: the larger of its bytes (each
    input read once, each output — assign and the counters — written once)
    over HBM bandwidth and its float operations over the fp32 peak. The
    operations are one live score per (order, pod, feasible node) — the
    serial algorithm's own work,
    `feasible_evals` summed over orders and pods — at 9R + 10 float ops
    each (fit: 2 converts, sub/mul, div, compare, mul, 2 adds per column
    plus the mean; balanced: div, min, add, sub, mul, add per column plus
    two divides, sqrt, sub, mul; 4 for the static + weighted sum)."""
    bytes_in = 4 * (2 * p * r + 2 * p + k * p + 3 * n * r + n) \
        + c * math.ceil(n / 8) + 4 * c * n + 5 * r + 8 * s
    bytes_out = 4 * (k * p + 4 * k)
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = feasible_evals * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def wave_eval_bound_ms(shards: int, local_n: int, c: int, r: int, w: int,
                       pts: int) -> tuple[float, str]:
    """Least time for one wave_eval launch over `shards` shards: the larger
    of its bytes (each input read once — class mask and static planes,
    node state, member vectors, parameters — and the (W, L) score and mask
    outputs written once) over HBM bandwidth, and its float operations,
    one live score per (shard, member, node) at 9R + 10 each (see
    `wave_bound_ms`), over the fp32 peak."""
    bytes_in = shards * (5 * c * local_n + 4 * (3 * r + 1) * local_n
                         + 4 * w) + w * (8 * r + 13) + 5 * r + 8 * pts
    bytes_out = 5 * shards * w * local_n
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = shards * w * local_n * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def wave_step_bound_ms(n: int, r: int, w: int, rows_read: int,
                       pts: int) -> tuple[float, str]:
    """Least time for one wave step over n nodes (all shards together): the
    larger of its bytes — the node state read once (alloc, free_q, used_nz:
    R ints each, and free_pods), the mask byte and static float of each of
    the `rows_read` distinct plane rows the wave's members read, the member
    vectors and parameters, the picks' node state and the (W,) assignments
    written — over HBM bandwidth, and its float operations — one live score
    per (member, node) and one per (member, earlier pick) of the conflict
    check, 9R + 10 each (see `wave_bound_ms`) — over the fp32 peak."""
    bytes_in = 4 * (3 * r + 1) * n + 5 * rows_read * n + w * (8 * r + 9) \
        + 5 * r + 8 * pts
    bytes_out = 4 * w * (2 * r + 1) + 4 * w + 4
    t_bytes = (bytes_in + bytes_out) / HBM_BYTES_PER_S
    t_ops = (w * n + w * w) * (9 * r + 10) / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def compare_wave_steps(torch, t: dict, rows, exc, sizes, w: int,
                       w_fit: float, w_bal: float,
                       strategy: str) -> tuple[int, int]:
    """The wave step kernel against `wave_step_reference` on the card,
    wave by wave from one carry: the (W,) assignments, the commit/replay
    decision and the carry (free_q, free_pods, used_nz) after each wave
    must be identical. `t` holds the solve's tensors on the card (the
    names of `storm`'s arrays), `sizes` the mesh axes. Returns (waves,
    waves replayed); raises at the first difference."""
    from kubernetes_tpu_torch.ops import solver, wave_eval

    def shards():
        return wave_eval.Shards(
            sizes, t["free_q"], t["free_pods"], t["used_nz_q"], t["alloc_q"],
            t["mask"], t["static_scores"], t["fit_col_w"], t["bal_col_mask"],
            t["shape_u"], t["shape_s"], w_fit, w_bal, strategy)
    kern, plain = shards(), shards()
    (req_w, req_nz_w, rows_w, ex_w), real_w = solver._wave_split(
        w, (t["req_q"], t["req_nz_q"], rows, exc))
    replayed = 0
    for i in range(req_w.shape[0]):
        wave = (req_w[i], req_nz_w[i], rows_w[i], ex_w[i], real_w[i])
        before = (wave_eval.wave_eval.launches,
                  wave_eval.wave_resolve.launches)
        got = wave_eval.wave_step(kern, *wave)
        if (wave_eval.wave_eval.launches, wave_eval.wave_resolve.launches) \
                != (before[0] + 1, before[1] + 1):
            raise RuntimeError("the wave step did not launch its kernels")
        want = wave_eval.wave_step_reference(plain, *wave)
        torch.cuda.synchronize()
        same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        carry = all(torch.equal(a, b)
                    for a, b in zip(kern.carry(), plain.carry()))
        if not (same and carry):
            raise RuntimeError(
                f"wave step kernel differs from wave_step_reference at wave "
                f"{i}: assignments {got[0].tolist()} vs {want[0].tolist()}, "
                f"replayed {got[1].tolist()} vs {want[1].tolist()}, carry "
                f"{'identical' if carry else 'DIFFERS'}")
        replayed += int(want[1])
    return req_w.shape[0], replayed


def wave_eval_case(seed: int, n: int, shards: int, uniform: bool,
                   w: int = 32, r: int = 2, c: int = 2) -> dict:
    """Seeded arguments of one wave_eval launch over `shards` shards of
    n / shards nodes (numpy, shard axis leading). Class row 0 is
    infeasible everywhere; the last three members are padding; member 1 is
    pinned to a column of the last shard and member 2 to one of shard 0,
    so their local column lies outside [0, n / shards) on every other
    shard; `uniform` makes every node identical, so every score ties."""
    rng = np.random.default_rng(seed)
    local_n = n // shards
    if uniform:
        alloc = np.tile(rng.integers(4, 9, size=(1, r)) * 1000, (n, 1))
    else:
        alloc = rng.integers(2, 9, size=(n, r)) * 1000
    alloc = alloc.astype(np.int32)
    used = (alloc * rng.uniform(0, 0.7, size=(n, r))).astype(np.int32)
    free_pods = rng.integers(0, 4, size=(n,)).astype(np.int32)
    if uniform:
        used[:] = used[0]
        free_pods[:] = 3
    mask = rng.random((c, n)) > 0.1
    mask[0] = False
    static = (np.repeat(rng.integers(0, 3, size=(c, 1)), n, axis=1)
              if uniform else rng.uniform(0, 4, size=(c, n)))
    req = rng.integers(100, 2500, size=(w, r)).astype(np.int32)
    e = np.full((w,), -1, np.int32)
    e[1], e[2] = n - 3, 5
    base = np.arange(shards, dtype=np.int32) * local_n

    def by_shard(x, axis):                 # node axis → (shards, ..., L)
        rest = x.shape[:axis] + x.shape[axis + 1:]
        x = np.moveaxis(x, axis, 0).reshape((shards, local_n) + rest)
        return np.ascontiguousarray(np.moveaxis(x, 1, 1 + axis))
    return dict(
        mask=by_shard(mask, 1), static_sc=by_shard(static.astype(
            np.float32), 1),
        alloc_q=by_shard(alloc, 0), free_q=by_shard(alloc - used, 0),
        free_pods=by_shard(free_pods, 0), used_nz=by_shard(used, 0),
        req=req, req_nz=req,
        row=rng.integers(0, c, size=(w,)).astype(np.int32),
        e=e, el=(e[None, :] - base[:, None]).astype(np.int32),
        real=np.arange(w) < w - 3,
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32),
        w_fit=1.0, w_bal=1.0)


def storm(seed: int, n: int = 64, p: int = 256, r: int = 2, k: int = 4):
    """Seeded conflict storm over class planes: identical small nodes
    (every score ties), contested capacity and pod slots, exception
    columns, k pod orders."""
    rng = np.random.default_rng(seed)
    alloc = np.tile(rng.integers(3, 6, size=(1, r)) * 1000,
                    (n, 1)).astype(np.int32)
    used = np.zeros((n, r), np.int32)
    used[n // 2:] = alloc[n // 2:] // 4
    class_req = rng.integers(400, 1800, size=(4, r)).astype(np.int32)
    rows = rng.integers(1, 4, size=(p,)).astype(np.int32)
    mask = rng.random((4, n)) > 0.1
    mask[0] = False
    exc = np.full((p,), -1, np.int32)
    exc[rng.choice(p, size=16, replace=False)] = rng.integers(
        0, n, size=16).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(k - 1)])
    arrays = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used,
        free_pods=rng.integers(1, 3, size=(n,)).astype(np.int32),
        used_nz_q=used, alloc_q=alloc, mask=mask,
        static_scores=np.repeat(rng.integers(0, 3, size=(4, 1)), n,
                                axis=1).astype(np.float32),
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32))
    return arrays, rows, exc, perms


def hetero_chunk(seed: int, n: int, p: int = 1024, r: int = 2,
                 classes: int = 10, k: int = 4, groups: int = 24):
    """Seeded heterogeneous chunk over class planes, for comparisons that a
    wrong reduction across the blocks of a cluster cannot pass: nodes of
    four allocatable shapes in `groups` groups of identical nodes (equal
    state and static scores, so picks tie inside a group: near-ties), one
    resource near exhaustion on a third of the groups, few pod slots, pods
    of `classes - 1` classes of mixed requests (row 0 is the reserved
    empty class), 24 exception columns, and k pod orders. Same return as
    `storm`."""
    rng = np.random.default_rng(seed)
    shapes = np.stack([np.array([4000, 8000, 16000, 32000]) * (1 + (i % 3))
                       for i in range(r)], axis=1)            # (4, r)
    group = rng.integers(0, groups, size=(n,))
    alloc = shapes[rng.integers(0, 4, size=(groups,))][group].astype(
        np.int32)
    used = (alloc * rng.uniform(0, 0.6, size=(groups, r))[group]).astype(
        np.int32)
    tight = rng.random(groups) < 1 / 3                        # exhaustion
    used[tight[group], r - 1] = alloc[tight[group], r - 1] - 600
    free_pods = rng.integers(1, 4, size=(groups,))[group].astype(np.int32)
    class_req = np.concatenate([
        rng.integers(50, 400, size=(classes // 2, r)),
        rng.integers(300, 3000, size=(classes - classes // 2, r))])
    class_req = class_req.astype(np.int32)
    rows = rng.integers(1, classes, size=(p,)).astype(np.int32)
    mask = rng.random((classes, n)) > 0.2
    mask[0] = False
    static = rng.integers(0, 4, size=(classes, groups))[:, group]
    exc = np.full((p,), -1, np.int32)
    exc[rng.choice(p, size=24, replace=False)] = rng.integers(
        0, n, size=24).astype(np.int32)
    perms = np.stack([np.arange(p, dtype=np.int32)]
                     + [rng.permutation(p).astype(np.int32)
                        for _ in range(k - 1)])
    arrays = dict(
        req_q=class_req[rows], req_nz_q=class_req[rows],
        free_q=alloc - used, free_pods=free_pods, used_nz_q=used,
        alloc_q=alloc, mask=mask,
        static_scores=np.ascontiguousarray(static, dtype=np.float32),
        fit_col_w=np.ones((r,), np.float32),
        bal_col_mask=np.ones((r,), np.bool_),
        shape_u=np.array([0.0, 50.0, 100.0], np.float32),
        shape_s=np.array([0.0, 4.0, 10.0], np.float32))
    return arrays, rows, exc, perms


@contextlib.contextmanager
def no_host_sync_in_wave_loop(torch):
    """Run every wave loop of the sharded route
    (`parallel.sharded._wave_body`) under
    `torch.cuda.set_sync_debug_mode("error")`: a torch operation that
    synchronises the host with the card inside the loop raises."""
    from kubernetes_tpu_torch.parallel import sharded

    body = sharded._wave_body

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return body(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sharded._wave_body = guarded
    try:
        yield
    finally:
        sharded._wave_body = body


def sharded_phase(torch, dev, fwk, init_pods, init_assign, measured,
                  main_assignments, node_infos) -> list[dict]:
    """Phase 6, the node-sharded solver on the card; see the module
    docstring. Returns the `wave_eval` and `wave_step` entries of the
    kernels line."""
    from kubernetes_tpu_torch.ops import solver, wave_eval, wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend, chunk_planes
    from kubernetes_tpu_torch.ops.tensorize import NODE_PAD
    from kubernetes_tpu_torch.parallel import (
        build_mesh, build_mesh_2d, sharded, sharded_greedy_assign,
        sharded_masks_scores)

    def on_card(case):
        return {k: torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray)
                else v for k, v in case.items()}

    # -- (a) the kernel against its plain version ---------------------------
    n_pad = math.ceil(N_NODES / NODE_PAD) * NODE_PAD       # 5120
    max_err = 0.0
    for shards in (1, 4):
        local_n = n_pad // shards
        for strategy in wave_kernel.STRATEGIES:
            for uniform in (False, True):
                case = on_card(wave_eval_case(
                    7 + shards, n_pad, shards, uniform))
                before = wave_eval.wave_eval.launches
                got = wave_eval.wave_eval(**case, strategy=strategy)
                ref = wave_eval.wave_eval_reference(**case,
                                                    strategy=strategy)
                torch.cuda.synchronize()
                if wave_eval.wave_eval.launches != before + 1:
                    raise RuntimeError("wave_eval did not launch")
                finite = torch.isfinite(ref[0])
                err = float((got[0] - ref[0])[finite].abs().max())
                same = torch.equal(got[0], ref[0]) and torch.equal(
                    got[1], ref[1])
                max_err = max(max_err, err)
                feasible = int(finite.sum())
                nodes_kind = "uniform" if uniform else "random"
                print(f"compare wave_eval local_n={local_n} shards="
                      f"{shards} {strategy} {nodes_kind} nodes: "
                      f"{'identical' if same else 'DIFFER'}, max |masked "
                      f"diff| {err}, {feasible} feasible of "
                      f"{finite.numel()}")
                if not same:
                    raise RuntimeError("wave_eval differs from its plain "
                                       "version")
                m = got[1].cpu()
                if m[:, -3:].any() or m[:, 1].sum() > 1 or m[:, 2].sum() > 1:
                    raise RuntimeError("wave_eval gated a padding member "
                                       "or a foreign pinned column")

    # -- (b) the conflict storm at 4 shards (before the full-width path: it
    # also warms up every op of the route before that is timed) ---------------
    arrays, rows, exc, _ = storm(seed=1)
    t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
    rows_t, exc_t = torch.from_numpy(rows).to(dev), torch.from_numpy(
        exc).to(dev)
    storm_args = (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                  t["used_nz_q"], t["alloc_q"], t["mask"],
                  t["static_scores"], t["fit_col_w"], t["bal_col_mask"],
                  t["shape_u"], t["shape_s"], 1.0, 1.0, "LeastAllocated")
    want = solver.greedy_assign_rescoring(*storm_args, rows=rows_t,
                                          exc=exc_t)
    _, _, replays = solver.greedy_assign_rescoring_wave(
        *storm_args, 32, rows=rows_t, exc=exc_t)
    for kernel in (True, False):
        got = sharded_greedy_assign(build_mesh(4, device=dev), *storm_args,
                                    rows=rows_t, exc=exc_t, wave_w=32,
                                    kernel=kernel)
        same = torch.equal(got, want)
        print(f"compare storm, 4-shard route (kernel "
              f"{'on' if kernel else 'off'}) vs one pod per step: "
              f"{'identical' if same else 'DIFFER'} "
              f"({int((got >= 0).sum())}/{got.numel()} placed, {replays} "
              f"pods replayed by the single-device wave scan)")
        if not same:
            raise RuntimeError("sharded storm differs")

    # -- the full-width chunks -------------------------------------------------
    nodes = node_infos()
    by_name = {ni.name: ni for ni in nodes}
    for pi in init_pods:
        by_name[init_assign[pi.key]].add_pod(pi)
    host = TorchBackend(device=dev)         # its host prep: class planes
    ctx = host._start(measured, stamped_snapshot(nodes, 4), fwk)
    preps = [host._prep_chunk(chunk, ctx) for chunk in ctx.chunks]
    st, prm = host.ensure_static(ctx.ct), ctx.params
    used0 = host.used.pack.clone()
    r = st["alloc_q"].shape[1]
    tf = st["taint_f"].shape[1]
    n = st["alloc_q"].shape[0]
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    score_args = (prm["fit_col_w"], prm["bal_col_mask"], prm["shape_u"],
                  prm["shape_s"], prm["w_fit"], prm["w_bal"],
                  prm["strategy"])

    def chain(used, req_q, req_nz_q, assign):
        hit = assign >= 0
        inc = torch.cat([req_q, req_nz_q, hit.to(torch.int32)[:, None]], 1)
        return used + torch.zeros((n + 1, used.shape[1]), dtype=used.dtype,
                                  device=dev).index_add_(
            0, torch.where(hit, assign, n).long(),
            torch.where(hit[:, None], inc, 0))[:n]

    def solve_inputs(prep, used, mesh2d):
        """The chunk's mask/score phase on `mesh2d`; returns the solver's
        tensors under `storm`'s names, the rows and the exceptions."""
        pack, cls = prep["dev_pack"], prep["dev_cls"]
        cmask = ((prep["dev_mask"][:, :, None] >> shifts) & 1).reshape(
            pack.shape[0], -1).to(torch.bool)[:, :n]
        mask, _, static = sharded_masks_scores(
            mesh2d, st["alloc_q"], used[:, :r], used[:, r:2 * r],
            st["alloc_pods"], used[:, 2 * r], pack[:, :r],
            pack[:, r:2 * r], pack[:, 2 * r:2 * r + tf].to(torch.bool),
            pack[:, 2 * r + tf:].to(torch.bool), st["taint_f"],
            st["taint_p"], cmask, prep["dev_scores"].to(torch.float32),
            prm["w_taint"], prm["taint_filter_on"], prm["strategy"])
        return dict(
            req_q=pack[:, :r][cls.long()],
            req_nz_q=pack[:, r:2 * r][cls.long()],
            free_q=st["alloc_q"] - used[:, :r],
            free_pods=st["alloc_pods"] - used[:, 2 * r],
            used_nz_q=used[:, r:2 * r], alloc_q=st["alloc_q"], mask=mask,
            static_scores=static, fit_col_w=prm["fit_col_w"],
            bal_col_mask=prm["bal_col_mask"], shape_u=prm["shape_u"],
            shape_s=prm["shape_s"]), cls, prep["dev_exc"]

    def sharded_route(shards: int, kernel: bool, chunks=preps):
        mesh2d = build_mesh_2d(shards, device=dev)
        mesh = build_mesh(shards, device=dev)
        used, out = used0, []
        for prep in chunks:
            t, cls, exc = solve_inputs(prep, used, mesh2d)
            assign = sharded_greedy_assign(
                mesh, *t.values(), *score_args[4:], rows=cls, exc=exc,
                row_req_q=prep["dev_pack"][:, :r],
                row_req_nz_q=prep["dev_pack"][:, r:2 * r], wave_w=32,
                kernel=kernel)
            used = chain(used, t["req_q"], t["req_nz_q"], assign)
            out.append(assign[:prep["batch"].p_real])
        return torch.cat(out)

    def single_device_route():
        used, out = used0, []
        for prep in preps:
            pl = chunk_planes(st["alloc_q"], used, st["alloc_pods"],
                              prep["dev_pack"], prep["dev_cls"],
                              st["taint_f"], st["taint_p"], prep["dev_mask"],
                              prep["dev_scores"], prm["w_taint"],
                              prm["taint_filter_on"])
            assign, _, _ = solver.greedy_assign_rescoring_wave(
                pl["req_q"], pl["req_nz_q"], pl["free_q"], pl["free_pods"],
                pl["used_nz_q"], st["alloc_q"], pl["mask"],
                pl["static_scores"], *score_args, 32, rows=prep["dev_cls"],
                exc=prep["dev_exc"])
            used = chain(used, pl["req_q"], pl["req_nz_q"], assign)
            out.append(assign[:prep["batch"].p_real])
        return torch.cat(out)

    # -- (a') the wave step kernels against wave_step_reference ---------------
    step_cases = []
    t5k, cls5k, exc5k = solve_inputs(preps[0], used0, build_mesh_2d(
        1, device=dev))
    for shards in (1, 4):
        step_cases.append((f"uniform 5k chunk, {shards} shard(s), W=32",
                           t5k, cls5k, exc5k, (shards,), 32,
                           prm["w_fit"], prm["w_bal"], prm["strategy"]))

    def seeded(builder, what, seed, sizes, w, strategy, empty_rows=3,
               **kw):
        arrays, rows, exc, _ = builder(seed=seed, k=1, **kw)
        rows = rows.copy()
        rows[:empty_rows] = 0              # members with no feasible node
        step_cases.append((
            what, {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                   for k, v in arrays.items()},
            torch.from_numpy(rows).to(dev), torch.from_numpy(exc).to(dev),
            sizes, w, 1.0, 1.0, strategy))
    for shards in (1, 4):
        seeded(hetero_chunk, f"hetero 5120 nodes, {shards} shard(s), W=32",
               5120 + shards, (shards,), 32, "LeastAllocated", n=5120,
               p=500)
    seeded(hetero_chunk, "hetero 5120 nodes, 4 shards, W=64", 11, (4,), 64,
           "MostAllocated", n=5120, p=500)
    seeded(hetero_chunk, "hetero 1024 nodes, 4 shards, W=8", 12, (4,), 8,
           "RequestedToCapacityRatio", n=1024, p=250)
    seeded(hetero_chunk, "hetero 1024 nodes, 1 shard, W=1", 13, (1,), 1,
           "LeastAllocated", n=1024, p=60)
    seeded(storm, "storm (PR 4's seed), 4 shards, W=32", 1, (4,), 32,
           "LeastAllocated", empty_rows=0)
    seeded(storm, "storm, 4 shards, W=64", 2, (4,), 64, "MostAllocated",
           p=250)
    seeded(storm, "storm, 2 x 2 multislice mesh, W=32", 3, (2, 2), 32,
           "RequestedToCapacityRatio", p=250)
    step_replays = 0
    for what, t, rows_c, exc_c, sizes, w, w_fit, w_bal, strategy \
            in step_cases:
        waves, replayed = compare_wave_steps(torch, t, rows_c, exc_c, sizes,
                                             w, w_fit, w_bal, strategy)
        step_replays += replayed if what.startswith("storm") else 0
        print(f"compare wave step {what}, {rows_c.numel()} pods, "
              f"{strategy}: identical (assignments, commit/replay, carry) "
              f"over {waves} waves, {replayed} replayed")
    if not step_replays:
        raise RuntimeError("the storms replayed no wave on the card")
    t, rows_c, exc_c = step_cases[0][1:4]
    try:
        compare_wave_steps(torch, t, rows_c, exc_c, (4,), 65, 1.0, 1.0,
                           "LeastAllocated")
    except ValueError as err:
        print(f"wave step at W=65 raises: {err}")
    else:
        raise RuntimeError("a wave step wider than its top lists ran")

    # -- (c) the full-width path ---------------------------------------------
    waves = sum(math.ceil(prep["batch"].req_q.shape[0] / 32)
                for prep in preps)
    routes, launches, rates = {}, {}, {}
    with no_host_sync_in_wave_loop(torch):
        for shards in (1, 4):
            torch.cuda.synchronize()
            wave_eval.wave_eval.launches = 0
            wave_eval.wave_resolve.launches = 0
            t0 = time.perf_counter()
            routes[shards] = sharded_route(shards, kernel=True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches[shards] = (wave_eval.wave_eval.launches,
                                wave_eval.wave_resolve.launches)
            rates[shards] = N_MEASURED / wall
            print(f"sharded route, {shards} shard(s) of {dev}, kernel on: "
                  f"{N_MEASURED} pods in {wall:.3f} s = {rates[shards]:.1f} "
                  f"pods/s; launches: wave_eval (A) {launches[shards][0]}, "
                  f"wave_resolve (B) {launches[shards][1]} ({waves} waves "
                  f"in {len(preps)} chunks), no host sync in the wave loop")
            if launches[shards] != (waves, waves):
                raise RuntimeError(f"{launches[shards]} launches for "
                                   f"{waves} waves, not 2 per wave")
    wave_eval.wave_eval.launches = 0
    wave_eval.wave_resolve.launches = 0
    off = {shards: sharded_route(shards, kernel=False) for shards in (1, 4)}
    single = single_device_route()
    off_launches = (wave_eval.wave_eval.launches,
                    wave_eval.wave_resolve.launches)
    print(f"kernel-off routes and the single-device wave scan: launches "
          f"wave_eval {off_launches[0]}, wave_resolve {off_launches[1]}")
    if any(off_launches):
        raise RuntimeError("the kernel-off route launched a wave kernel")
    for shards in (1, 4):
        for what, other in (("kernel off", off[shards]),
                            ("single-device wave scan", single)):
            same = torch.equal(routes[shards], other)
            print(f"compare sharded {shards}-shard route vs {what}: "
                  f"{'identical' if same else 'DIFFER'}")
            if not same:
                raise RuntimeError(f"sharded route differs from {what}")
    assign = routes[4].cpu().numpy()
    if len(assign) != N_MEASURED or (assign < 0).any():
        raise RuntimeError(f"{int((assign < 0).sum())} pods unplaced by "
                           "the sharded route")
    names = ctx.ct.node_names
    for pi, j in zip(measured, assign):
        by_name[names[j]].add_pod(pi)
    for ni in nodes:
        over = [q for q, v in ni.requested.res.items()
                if v > ni.allocatable.get(q)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    differ = sum(main_assignments[pi.key] != names[j]
                 for pi, j in zip(measured, assign))
    print(f"compare sharded route vs TorchBackend.assign (phase 4): "
          f"{differ} of {N_MEASURED} placements differ")
    if differ:
        raise RuntimeError("the sharded route places differently from "
                           "TorchBackend.assign")

    # -- (d) numbers ----------------------------------------------------------
    # One chunk of the 4-shard route, kernel on, under torch.profiler: the
    # device's busy share and the kernels it launched.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sharded_route(4, kernel=True, chunks=preps[:1])
        torch.cuda.synchronize()
        chunk_wall = time.perf_counter() - t0
    busy_us = sum(device_us(e) for e in prof.key_averages())
    device_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                         for e in prof.events())
    a_dev_ms = kernel_ms_from(prof, "wave_eval_kernel<true>")
    b_dev_ms = kernel_ms_from(prof, "wave_resolve_kernel")
    print(f"profiled 4-shard chunk: wall {chunk_wall:.4f} s, device busy "
          f"{busy_us / 1e6:.4f} s, idle share "
          f"{1 - busy_us / 1e6 / chunk_wall:.4f}, {device_kernels} device "
          f"kernels; device time per launch: A (wave_eval, top lists) "
          f"{fmt_ms(a_dev_ms)}, B (wave_resolve) {fmt_ms(b_dev_ms)}")

    # The wave step back to back: the first chunk's waves through
    # `_wave_body` on a fresh copy of its node state each time (CUDA
    # events, the state built outside the timed window).
    (req_w, req_nz_w, rows_w, ex_w), _ = solver._wave_split(
        32, (t5k["req_q"], t5k["req_nz_q"], cls5k, exc5k))
    n_waves = req_w.shape[0]
    rows_read = int(torch.unique(cls5k).numel())

    def fresh(shards):
        return wave_eval.Shards(
            (shards,), t5k["free_q"], t5k["free_pods"], t5k["used_nz_q"],
            t5k["alloc_q"], t5k["mask"], t5k["static_scores"],
            *score_args)

    step_ms, step_plain_ms, host_ms = {}, {}, {}
    for shards in (1, 4):
        times, host = [], []
        for state in [fresh(shards) for _ in range(6)]:
            t0e = torch.cuda.Event(enable_timing=True)
            t1e = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            t0e.record()
            t0 = time.perf_counter()
            sharded._wave_body(state, t5k["req_q"], t5k["req_nz_q"], cls5k,
                               exc5k, 32, True)
            host.append((time.perf_counter() - t0) * 1e3 / n_waves)
            t1e.record()
            torch.cuda.synchronize()
            times.append(t0e.elapsed_time(t1e) / n_waves)
        # The first run is the warm-up; `host` is the time the host takes
        # to enqueue a wave (the loop returns before the card finishes).
        step_ms[shards] = sum(times[1:]) / len(times[1:])
        host_ms[shards] = sum(host[1:]) / len(host[1:])
        state = fresh(shards)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded._wave_body(state, t5k["req_q"], t5k["req_nz_q"], cls5k,
                           exc5k, 32, False)
        torch.cuda.synchronize()
        step_plain_ms[shards] = (time.perf_counter() - t0) * 1e3 / n_waves
    pts = prm["shape_u"].shape[0]
    step_bound, step_bound_by = wave_step_bound_ms(n, r, 32, rows_read, pts)
    print(f"wave step per wave at W=32, N={n}, R={r}, {rows_read} plane "
          f"row(s) read: {step_ms[1]:.4f} ms (1 shard), {step_ms[4]:.4f} ms "
          f"(4 shards) back to back over the first chunk's {n_waves} waves "
          f"(CUDA events, 5 runs); the host enqueues a wave in "
          f"{host_ms[1]:.4f} / {host_ms[4]:.4f} ms; plain "
          f"{step_plain_ms[1]:.4f} / "
          f"{step_plain_ms[4]:.4f} ms; bound {step_bound:.6f} ms "
          f"({step_bound_by}) per wave, {step_bound * n_waves:.6f} ms per "
          f"chunk")

    case = on_card(wave_eval_case(8, n_pad, 1, False))
    ms = cuda_ms(torch, lambda: wave_eval.wave_eval(
        **case, strategy="LeastAllocated"), 200)
    dev_ms = profiled_kernel_ms(torch, lambda: wave_eval.wave_eval(
        **case, strategy="LeastAllocated"), 50, "wave_eval_kernel<false>")
    plain_ms = cuda_ms(torch, lambda: wave_eval.wave_eval_reference(
        **case, strategy="LeastAllocated"), 20)
    bound_ms, bound_by = wave_eval_bound_ms(1, n_pad, 2, r, 32,
                                            case["shape_u"].shape[0])
    print(f"wave_eval (standalone) per launch at W=32, local_n={n_pad}, "
          f"R={r}, C=2: {ms:.4f} ms back to back (CUDA events), "
          f"{fmt_ms(dev_ms)} of device time (profiler); plain "
          f"{plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}); "
          f"sharded route {rates[1]:.1f} pods/s at 1 shard, {rates[4]:.1f} "
          f"at 4")
    src = "kubernetes_tpu_torch/csrc/wave_eval.cu"
    replaces = "kubernetes_tpu/ops/pallas_kernel.py:434"
    return [
        {"name": "wave_eval", "route": "cuda", "source": src,
         "replaces": replaces,
         "launches": launches[1][0] + launches[4][0], "max_abs_err": max_err,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None},
        {"name": "wave_step", "route": "cuda", "source": src,
         "replaces": replaces,
         "launches": launches[1][1] + launches[4][1], "max_abs_err": 0.0,
         "ms": step_ms[4], "plain_ms": step_plain_ms[4],
         "bound_ms": step_bound, "bound_by": step_bound_by,
         "library_ms": None},
    ]


#: The port's plan tolerance, stated in tests/test_torch_optimal.py (the
#: reference's own parity tolerance): on the plan and the log-plan.
PLAN_RTOL, PLAN_ATOL = 1e-4, 1e-5


def plan_bound_ms(c: int, n: int, iters: int) -> tuple[float, str]:
    """Least time for one `sinkhorn_plan` over (C, N) planes: the larger of
    its bytes (feasible, cost, row counts and capacities read once, the
    log-plan and the plan written once) over HBM bandwidth, and its float
    operations over the fp32 peak: per iteration 4CN (the row marginal's
    and the column sums' products and adds) + 2C + 3N (the two clamps and
    divides and the column min), plus 18CN to set up (row max, shift,
    three stage kernels of divide, exp, flush and mask) and 6CN to finish
    (two products, add, log, the sanitization)."""
    bytes_io = c * n + 4 * c * n + 4 * c + 4 * n + 8 * c * n
    ops = iters * (4 * c * n + 2 * c + 3 * n) + 24 * c * n
    t_bytes, t_ops = bytes_io / HBM_BYTES_PER_S, ops / FP32_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes")


def identical_column_groups(torch, feasible, cost, cap, log_plan) -> int:
    """Raise unless every group of identical columns (feasibility, cost and
    capacity equal in every class row) has bit-identical log-plan columns;
    return the number of groups."""
    key = torch.cat([feasible.to(torch.float32), cost.to(torch.float32),
                     cap.to(torch.float32)[None, :]])
    _, inv = torch.unique(key, dim=1, return_inverse=True)
    groups = int(inv.max()) + 1
    idx = inv[None, :].expand_as(log_plan)
    shape = (log_plan.shape[0], groups)
    lo = torch.full(shape, math.inf, device=log_plan.device).scatter_reduce(
        1, idx, log_plan, "amin")
    hi = torch.full(shape, -math.inf, device=log_plan.device).scatter_reduce(
        1, idx, log_plan, "amax")
    if not torch.equal(lo, hi):
        raise RuntimeError("identical columns got different log-plan values")
    return groups


def compare_plan(torch, what, feasible, cost, counts, cap, iters, temp):
    """The plan on the card against the port's plan on the CPU: the
    log-plan and the plan within (PLAN_RTOL, PLAN_ATOL), the sanitization
    mask identical, identical columns bit-identical on the card. Returns
    (the card's log-plan, max |log-plan diff| on feasible entries)."""
    from kubernetes_tpu_torch.ops import solver

    got = solver.sinkhorn_plan(feasible, cost, counts, cap, iters, temp)
    want = solver.sinkhorn_plan(feasible.cpu(), cost.cpu(), counts.cpu(),
                                cap.cpu(), iters, temp)
    torch.cuda.synchronize()
    close = all(bool(((g.cpu() - w).abs()
                      <= PLAN_ATOL + PLAN_RTOL * w.abs()).all())
                for g, w in zip(got, want))
    same_mask = torch.equal(got[0].cpu() == -1e30, want[0] == -1e30)
    feas = feasible.cpu()
    err = float((got[0].cpu() - want[0])[feas].abs().max()) \
        if bool(feas.any()) else 0.0
    groups = identical_column_groups(torch, feasible, cost, cap, got[0])
    print(f"compare plan {what}: C={cost.shape[0]} N={cost.shape[1]}, "
          f"card vs CPU max |log-plan diff| {err} (tolerance rtol "
          f"{PLAN_RTOL}, atol {PLAN_ATOL}: {'within' if close else 'OUT'}), "
          f"sanitization {'identical' if same_mask else 'DIFFERS'}, "
          f"{groups} groups of identical columns, one value each")
    if not (close and same_mask):
        raise RuntimeError(f"the plan on the card differs from the CPU's: "
                           f"{what}")
    return got[0], err


@contextlib.contextmanager
def no_host_sync_in_device_pass(torch):
    """Run every `TorchBackend` device pass (`backend.mask_solve_update`:
    masks, the plan, the rounding launch, the state update) under
    `torch.cuda.set_sync_debug_mode("error")`: a torch operation that
    waits for the card inside it raises."""
    from kubernetes_tpu_torch.ops import backend

    fn = backend.mask_solve_update

    def guarded(*args, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    backend.mask_solve_update = guarded
    try:
        yield
    finally:
        backend.mask_solve_update = fn


def occupied_fragmentation(torch, backend) -> float:
    """`solver.fragmentation_occupied` (%) of a backend's chained used
    state over the real nodes."""
    from kubernetes_tpu_torch.ops import solver

    st = backend.ensure_static(backend._ct)
    pack = backend.used.pack
    r = st["alloc_q"].shape[1]
    valid = torch.arange(pack.shape[0], device=pack.device) \
        < backend._ct.n_real
    return float(solver.fragmentation_occupied(
        st["alloc_q"] - pack[:, :r], st["alloc_q"], pack[:, 2 * r], valid))


def optimal_phase(torch, dev, fwk, init_pods, measured, node_infos,
                  greedy_frag: float) -> dict:
    """Phase 7, the flagless route (`KTPU_SOLVE_MODE=auto`, which the
    caller scopes: every chunk of 64 or more pods to the Sinkhorn plan and
    its W=1 rounding); see the module docstring. Returns the flagless keys
    of wave_solve's entry in the kernels line."""
    from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel
    from kubernetes_tpu_torch.ops.backend import (
        TorchBackend, chunk_planes, plan_inputs)
    from kubernetes_tpu_torch.parallel import (
        build_mesh, sharded_sinkhorn_plan)
    from kubernetes_tpu_torch.scheduler.types import Snapshot
    from kubernetes_tpu_torch.utils import flags

    if flags.get("KTPU_SOLVE_MODE") != "auto":
        raise RuntimeError("the flagless phase runs under the default "
                           "KTPU_SOLVE_MODE=auto")
    if torch.backends.cuda.matmul.allow_tf32 \
            or torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("float32 products may run in TF32 here")
    print("TF32: torch.backends.cuda.matmul.allow_tf32 False, "
          "float32 matmul precision 'highest'")
    iters = max(1, flags.get("KTPU_SINKHORN_ITERS"))
    temp = float(np.float32(flags.get("KTPU_SINKHORN_TEMP")))

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def init_nodes(assign):
        nodes = node_infos()
        by_name = {ni.name: ni for ni in nodes}
        for pi in init_pods:
            by_name[assign[pi.key]].add_pod(pi)
        return nodes

    # -- (a) the plan on the card against the CPU's -------------------------
    # The first flagless measured chunk: its class planes after a flagless
    # init, from the backend's own prep.
    host = TorchBackend(device=dev)
    first_init, _ = host.assign(init_pods, stamped_snapshot(node_infos(), 1),
                               fwk)
    ctx = host._start(measured, stamped_snapshot(init_nodes(first_init), 2),
                      fwk)
    prep = host._prep_chunk(ctx.chunks[0], ctx)
    if prep["solve_mode"] != "optimal" or prep["wave_w"] != 0:
        raise RuntimeError(f"the first flagless chunk routed "
                           f"{prep['solve_mode']} at W={prep['wave_w']}")
    st, prm = host.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], host.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    problem = plan_inputs(pl, st["alloc_q"], prep["dev_pack"],
                          prep["dev_cls"], prm["fit_col_w"],
                          prm["bal_col_mask"], prm["shape_u"],
                          prm["shape_s"], prm["w_fit"], prm["w_bal"],
                          prm["strategy"])
    log_plan, plan_err = compare_plan(torch, "first flagless 5k chunk",
                                      *problem, iters, temp)
    hetero = []
    for seed, n in ((31, 5000), (32, 4093), (33, 5120)):
        arrays, rows, exc, perms = hetero_chunk(seed=seed, n=n, p=256)
        t = {k: put(v) for k, v in arrays.items()}
        r = arrays["req_q"].shape[1]
        class_req = np.zeros((arrays["mask"].shape[0], r), np.int32)
        class_req[rows] = arrays["req_q"]
        creq = put(class_req)
        fit0 = (t["free_pods"] >= 1)[None, :] & torch.all(
            creq[:, None, :] <= t["free_q"][None, :, :], dim=-1)
        cost = kernels.chunk_start_scores(
            t["alloc_q"], t["used_nz_q"], creq, t["static_scores"],
            t["fit_col_w"], t["bal_col_mask"], t["shape_u"], t["shape_s"],
            1.0, 1.0, "LeastAllocated")
        counts = put(np.bincount(rows, minlength=class_req.shape[0]).astype(
            np.float32))
        lp, err = compare_plan(torch, f"hetero N={n} seed {seed}",
                               t["mask"] & fit0, cost, counts,
                               t["free_pods"], iters, temp)
        plan_err = max(plan_err, err)
        hetero.append((f"hetero N={n} seed {seed}", t, lp, put(rows),
                       put(exc), put(perms)))

    # -- (b) the rounding: wave_solve at W=1 against its plain version ------
    def rounding_args(t, static):
        return (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                t["used_nz_q"], t["alloc_q"], t["mask"], static,
                t["fit_col_w"], t["bal_col_mask"], t["shape_u"],
                t["shape_s"], 0.0, 0.0, prm["strategy"])
    chunk_t = dict(req_q=pl["req_q"], req_nz_q=pl["req_nz_q"],
                   free_q=pl["free_q"], free_pods=pl["free_pods"],
                   used_nz_q=pl["used_nz_q"], alloc_q=st["alloc_q"],
                   mask=pl["mask"], fit_col_w=prm["fit_col_w"],
                   bal_col_mask=prm["bal_col_mask"],
                   shape_u=prm["shape_u"], shape_s=prm["shape_s"])
    cases = [("first flagless 5k chunk", chunk_t, log_plan, prep["dev_cls"],
              prep["dev_exc"], prep["dev_perms"])] + hetero
    w1_plain_ms = None
    for what, t, lp, rows_t, exc_t, perms_t in cases:
        args = rounding_args(t, lp)
        kw = dict(rows=rows_t, exc=exc_t, poison=False, perms=perms_t)
        before = wave_kernel.wave_solve.launches
        got = wave_kernel.wave_solve(*args, 1, **kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wave_kernel.wave_solve_reference(*args, 1, **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        if w1_plain_ms is None:
            w1_plain_ms = plain_ms
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        sanitized = int((lp == -1e30).sum())
        print(f"compare rounding {what}: wave_solve W=1 poison=False "
              f"K={perms_t.shape[0]}, w_fit = w_bal = 0, {sanitized} "
              f"entries at -1e30: {'identical' if same else 'DIFFER'} to "
              f"wave_solve_reference ({int((got[0] >= 0).sum())} of "
              f"{got[0].numel()} placed; plain {plain_ms:.1f} ms)")
        if not same or wave_kernel.wave_solve.launches != before + 1:
            raise RuntimeError(f"W=1 rounding differs: {what}")

    # -- (c) the flagless measured phase at full width -----------------------
    with no_host_sync_in_device_pass(torch):
        torch.cuda.synchronize()
        wave_kernel.wave_solve.launches = 0
        wave_kernel.probe.launches = 0
        backend = TorchBackend()
        init_assign, _ = backend.assign(
            init_pods, stamped_snapshot(node_infos(), 1), fwk)
        if any(v is None for v in init_assign.values()):
            raise RuntimeError("flagless init pods unplaced")
        nodes = init_nodes(init_assign)
        cpu_nodes = init_nodes(init_assign)
        before_t = dict(backend.timings)
        before_c = dict(backend.counters)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        assignments, _ = backend.assign(measured, stamped_snapshot(nodes, 2),
                                        fwk)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    phases = {k: round(v - before_t[k], 6)
              for k, v in backend.timings.items()}
    chunks = backend.counters["chunks"] - before_c["chunks"]
    solves = backend.counters["optimal_solves"] - before_c["optimal_solves"]
    unplaced = [k for k, v in assignments.items() if v is None]
    if len(assignments) != N_MEASURED or unplaced:
        raise RuntimeError(f"{len(unplaced)} flagless pods unplaced")
    by_name = {ni.name: ni for ni in nodes}
    for pi in measured:
        by_name[assignments[pi.key]].add_pod(pi)
    for ni in nodes:
        over = [q for q, v in ni.requested.res.items()
                if v > ni.allocatable.get(q)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    total_chunks = backend.counters["chunks"]
    if solves != chunks or backend.counters["optimal_solves"] \
            != total_chunks:
        raise RuntimeError(f"{solves} optimal solves for {chunks} chunks")
    if launches["wave_solve"] != total_chunks or launches["probe"] < 1:
        raise RuntimeError(f"launches {launches} for {total_chunks} chunks "
                           "(init included), not one wave_solve each")
    flag_frag = occupied_fragmentation(torch, backend)
    rate = N_MEASURED / wall
    print(f"flagless path (KTPU_SOLVE_MODE=auto): {N_MEASURED} measured pods "
          f"in {wall:.3f} s = {rate:.1f} pods/s; {chunks} chunks, "
          f"{solves} optimal solves, Sinkhorn iterations "
          f"{backend.counters['sinkhorn_iterations']}; launches {launches} "
          f"({total_chunks} chunks with the init); no host sync in any "
          f"device pass")
    print(f"flagless measured phase host-clock seconds: {json.dumps(phases)}")
    # The device's busy share: the same measured phase again, on a fresh
    # copy of the post-init cluster, under torch.profiler.
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        again, _ = backend.assign(
            measured, stamped_snapshot(init_nodes(init_assign), 4), fwk)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t2
    if again != assignments:
        raise RuntimeError("a repeated flagless phase placed pods differently")
    busy_us = sum(device_us(e) for e in prof.key_averages())
    print(f"profiled flagless measured phase: wall {prof_wall:.3f} s, device "
          f"busy {busy_us / 1e6:.4f} s" + (
              f", idle share {1 - busy_us / 1e6 / prof_wall:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; wave_solve device time per launch "
          f"{fmt_ms(kernel_ms_from(prof, 'wave_solve_kernel'))}")
    cpu_assign, _ = TorchBackend(device="cpu").assign(
        measured[:1024], Snapshot(cpu_nodes, 3), fwk)
    differ = sum(cpu_assign[pi.key] != assignments[pi.key]
                 for pi in measured[:1024])
    print(f"compare flagless first chunk, card vs TorchBackend(device='cpu') "
          f"from the same snapshot: {differ} of 1024 placements differ")
    if differ:
        raise RuntimeError("the flagless first chunk places differently on "
                           "the card and on the CPU")

    # -- (d) numbers ---------------------------------------------------------
    def plan_call():
        return solver.sinkhorn_plan(*problem, iters, temp)
    plan_ms = cuda_ms(torch, plan_call, 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        plan_call()
    enqueue_ms = (time.perf_counter() - t0) * 1e3 / 20
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        plan_call()
        torch.cuda.synchronize()
    plan_kernels = sum(e.device_type == torch.autograd.DeviceType.CUDA
                       for e in prof.events())
    plan_dev_ms = sum(device_us(e) for e in prof.key_averages()) / 1e3
    c, n = problem[1].shape
    pbound, pbound_by = plan_bound_ms(c, n, iters)
    print(f"sinkhorn_plan per chunk, C={c} N={n}, {iters} iterations: "
          f"{plan_ms:.4f} ms back to back (CUDA events, 20 calls), the host "
          f"enqueues one in {enqueue_ms:.4f} ms, {plan_kernels} device "
          f"kernels and {plan_dev_ms:.5f} ms of device time per plan "
          f"(profiler); bound {pbound:.6f} ms ({pbound_by})")
    w1_args = rounding_args(chunk_t, log_plan)
    w1_kw = dict(rows=prep["dev_cls"], exc=prep["dev_exc"], poison=False,
                 perms=prep["dev_perms"])
    w1_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *w1_args, 1, **w1_kw), 10)
    w1_dev_ms = profiled_kernel_ms(torch, lambda: wave_kernel.wave_solve(
        *w1_args, 1, **w1_kw), 5, "wave_solve_kernel")
    p, r = pl["req_q"].shape
    k = prep["dev_perms"].shape[0]
    class_req = prep["dev_pack"][:, :r]
    feasible = pl["mask"] & (pl["free_pods"] >= 1)[None, :] & torch.all(
        class_req[:, None, :] <= pl["free_q"][None, :, :], dim=-1)
    evals = k * int(feasible.sum(dim=1)[prep["dev_cls"].long()].sum())
    w1_bound, w1_bound_by = wave_bound_ms(
        p, n, r, c, k, prm["shape_u"].shape[0], evals)
    print(f"wave_solve W=1 (the rounding) per 1024-pod chunk: {w1_ms:.4f} ms "
          f"back to back (CUDA events), {fmt_ms(w1_dev_ms)} of device time "
          f"(profiler), plan {wave_kernel.wave_launch_plan(n, r, 1)}; plain "
          f"{w1_plain_ms:.1f} ms; bound {w1_bound:.6f} ms ({w1_bound_by})")
    print(f"fragmentation_occupied after the measured phase: greedy "
          f"{greedy_frag:.4f} %, flagless {flag_frag:.4f} %")

    # -- (e) the sharded plan -----------------------------------------------
    for shards in (1, 4):
        got = sharded_sinkhorn_plan(build_mesh(shards, device=dev),
                                    *problem, iters, temp)
        want = plan_call()
        torch.cuda.synchronize()
        close = all(bool(((g - w).abs()
                          <= PLAN_ATOL + PLAN_RTOL * w.abs()).all())
                    for g, w in zip(got, want))
        same_mask = torch.equal(got[0] == -1e30, want[0] == -1e30)
        print(f"compare sharded_sinkhorn_plan, {shards} shard(s) of {dev}, vs "
              f"the single-device plan: max |log-plan diff| "
              f"{float((got[0] - want[0])[problem[0]].abs().max())}, "
              f"{'within' if close else 'OUT OF'} tolerance, sanitization "
              f"{'identical' if same_mask else 'DIFFERS'}")
        if not (close and same_mask):
            raise RuntimeError("the sharded plan differs")
    return {"flagless_launches": launches["wave_solve"],
            "flagless_ms": w1_ms, "flagless_device_ms": w1_dev_ms,
            "flagless_plain_ms": w1_plain_ms, "flagless_bound_ms": w1_bound,
            "flagless_bound_by": w1_bound_by,
            "flagless_plan_max_abs_err": plan_err}


SERVING_SHAPES = ({"cpu": "8", "memory": "32Gi", "pods": "110"},
                  {"cpu": "16", "memory": "64Gi", "pods": "110"},
                  {"cpu": "4", "memory": "16Gi", "pods": "32"})
N_LONE_CHECKED, N_TRICKLE, N_PROFILED = 256, 2000, 100


def solve_one_case(torch, seed: int, n: int, strategy: str,
                   uniform: bool = False, bucket: int = 0) -> tuple:
    """Seeded positional arguments of `solver.solve_one` on the CPU (or,
    with `bucket` > 0, of `solve_one_fresh`, with `bucket` delta rows
    padded by repeating the first): n nodes of random capacity and usage,
    or identical ones (`uniform`: every score ties), random taint
    membership, a 90%-dense base mask, an f16 host score row."""
    rng = np.random.default_rng(seed)
    r, tf, tp = 2, 3, 2
    if uniform:
        alloc_q = np.tile(np.array([8000, 32768], np.int32), (n, 1))
        used_q = alloc_q // 4
    else:
        alloc_q = rng.choice([4000, 8000, 16000], size=(n, r)).astype(
            np.int32)
        used_q = (alloc_q * rng.uniform(0, 1.05, size=(n, r))).astype(
            np.int32)
    used_pods = rng.integers(0, 12, size=n).astype(np.int32)
    pack = np.concatenate([used_q, used_q, used_pods[:, None]], axis=1)
    m = rng.random(((n + 7) // 8) * 8) < 0.9
    m[n:] = False
    req = rng.integers(100, 1200, size=r).astype(np.int32)
    arrays = [alloc_q, pack.astype(np.int32),
              rng.choice([10, 110], size=n).astype(np.int32),
              rng.random((n, tf)) < (0 if uniform else 0.15),
              rng.random((n, tp)) < (0 if uniform else 0.3), np.packbits(m),
              rng.choice([0.0, 12.5, 50.0], size=n).astype(np.float16)
              * (not uniform),
              np.concatenate([req, req, (rng.random(tf) < 0.5),
                              (rng.random(tp) < 0.6)]).astype(np.int32)]
    if bucket:
        real = max(1, bucket - 1)
        rows = np.sort(rng.choice(n, size=real, replace=False))
        rows = np.concatenate([rows, rows[:1].repeat(bucket - real)])
        vals = rng.integers(0, 40, size=(real, 2 * r + 1))
        vals = np.concatenate([vals, vals[:1].repeat(bucket - real, 0)])
        arrays[2:2] = [rows.astype(np.int32), vals.astype(np.int32)]
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]
    params = [torch.tensor([1.0, 2.0]), torch.ones(r, dtype=torch.bool),
              torch.tensor([0.0, 50.0, 100.0]), torch.tensor([10.0, 3.0, 0.0])]
    return (*tensors, *params, 1.0, 1.0, 3.0, True, strategy)


def serving_nodes(seed: int, n: int = N_NODES) -> list[dict]:
    """Phase 8(a)'s cluster: n nodes of three allocatable shapes drawn
    from `seed`, a NoSchedule taint on every 7th node, a PreferNoSchedule
    taint on every 11th, and node 13 cordoned."""
    from kubernetes_tpu_torch.api.types import make_node

    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        out.append(make_node(
            f"node-{i}", allocatable=dict(
                SERVING_SHAPES[int(rng.integers(0, 3))]),
            taints=taints or None, unschedulable=(i == 13)))
    return out


def lone_pods(seed: int, count: int, n: int = N_NODES) -> list[tuple]:
    """Phase 8(a)'s traffic: (PodInfo, kind) with random requests, ~30%
    tolerating the NoSchedule taint, ~25% pinned by a hostname
    nodeSelector, and a few of each shape the fast path must not take
    (kind != "plain"): inter-pod affinity, host ports, preferred node
    affinity, a nominated node; and pods that fit nowhere ("huge")."""
    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.scheduler.types import PodInfo

    rng = np.random.default_rng(seed + 1)
    out = []
    for t in range(count):
        kw = {"requests": {
            "cpu": f"{int(rng.choice([100, 250, 500, 900, 1700]))}m",
            "memory": f"{int(rng.choice([128, 512, 1024, 3000]))}Mi"}}
        if rng.random() < 0.3:
            kw["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        if rng.random() < 0.25:
            kw["node_selector"] = {
                "kubernetes.io/hostname": f"node-{rng.integers(0, n)}"}
        kind, u = "plain", rng.random()
        if u < 0.02:
            kind, kw["requests"] = "huge", {"cpu": "64"}
        elif u < 0.04:
            kind, kw["affinity"] = "affinity", {"podAffinity": {
                "requiredDuringSchedulingIgnoredDuringExecution": [{
                    "topologyKey": "kubernetes.io/hostname",
                    "labelSelector": {"matchLabels": {"app": "x"}}}]}}
        elif u < 0.05:
            kind, kw["host_ports"] = "ports", [8080]
        elif u < 0.06:
            kind, kw["affinity"] = "preferred", {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": "kubernetes.io/hostname", "operator": "In",
                        "values": ["node-1"]}]}}]}}
        elif u < 0.07:
            kind = "nominated"
        pi = PodInfo(make_pod(f"lone-{t}", uid=f"lone-{t}", **kw))
        if kind == "nominated":
            pi.nominated_node = "node-0"
        out.append((pi, kind))
    return out


@contextlib.contextmanager
def counted_solves(torch, sync_error: bool):
    """Count the fast path's `solver.solve_one` (plain) and
    `solve_one_fresh` (fused) calls; with `sync_error`, each runs under
    `torch.cuda.set_sync_debug_mode("error")`, so a torch operation that
    waits for the card inside the solve raises."""
    from kubernetes_tpu_torch.ops import solver

    counts = {"plain": 0, "fused": 0}
    fns = {"plain": solver.solve_one, "fused": solver.solve_one_fresh}

    def wrap(kind):
        def call(*args, **kw):
            counts[kind] += 1
            if sync_error:
                torch.cuda.set_sync_debug_mode("error")
            try:
                return fns[kind](*args, **kw)
            finally:
                if sync_error:
                    torch.cuda.set_sync_debug_mode("default")
        return call
    solver.solve_one, solver.solve_one_fresh = wrap("plain"), wrap("fused")
    try:
        yield counts
    finally:
        solver.solve_one, solver.solve_one_fresh = fns["plain"], fns["fused"]


def compare_solve_one(torch, dev, seed: int, n: int, strategy: str,
                      uniform: bool = False, bucket: int = 0) -> int:
    """`solver.solve_one` (or, with `bucket`, `solve_one_fresh`) on the
    card against the same call on the CPU, on `solve_one_case`'s inputs:
    the index (and the refreshed pack) must be identical, the card's call
    must not wait for the card (sync debug mode "error"), and the input
    pack must be left as it was. Returns the index."""
    from kubernetes_tpu_torch.ops import solver

    args = solve_one_case(torch, seed, n, strategy, uniform, bucket)
    on_card = tuple(a.to(dev) if isinstance(a, torch.Tensor) else a
                    for a in args)
    fn = solver.solve_one_fresh if bucket else solver.solve_one
    want = fn(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn(*on_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want, got = (want, got) if bucket else ((want,), (got,))
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    if not same or not torch.equal(on_card[1].cpu(), args[1]):
        raise RuntimeError(f"solve_one{'_fresh' if bucket else ''} on the "
                           f"card differs from the CPU: seed {seed}, n {n}, "
                           f"{strategy}, uniform {uniform}, bucket {bucket}")
    return int(want[0])


def fresh_pack(torch, ct):
    return torch.from_numpy(np.concatenate(
        [ct.used_q, ct.used_nz_q, ct.used_pods.astype(np.int32)[:, None]],
        axis=1))


def serving_phase(torch, fwk, init_pods, seed: int) -> None:
    """Phase 8, the serving fast path; see the module docstring."""
    import warnings

    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
    from kubernetes_tpu_torch.scheduler.types import PodInfo
    from kubernetes_tpu_torch.serving import ResidentPlanes, SinglePodFastPath

    def fast_path(device=None):
        backend = TorchBackend(device=device)
        return SinglePodFastPath(backend, ResidentPlanes(backend))

    # -- (a) solve_one on the card against the CPU, then the whole path ----
    dev = torch.device("cuda:0")
    picks = [compare_solve_one(torch, dev, seed + k, 5120, strategy,
                               uniform=uniform, bucket=bucket)
             for k, strategy in enumerate(wave_kernel.STRATEGIES)
             for uniform in (False, True) for bucket in (0, 1, 2, 4)]
    print(f"compare solve_one / solve_one_fresh, card vs CPU at N=5120 "
          f"(each strategy, random and tied nodes, buckets 0/1/2/4): "
          f"{len(picks)} identical, none waiting for the card; picks "
          f"{picks}")

    # -- (a) the card, the batch path's first step and the CPU port --------
    t0 = time.perf_counter()
    cache = SchedulerCache()
    for nd in serving_nodes(seed):
        cache.add_node(nd)
    card, cpu = fast_path(), fast_path("cpu")
    batch = TorchBackend(max_batch=16)
    batch_checked = 0
    kinds: dict[str, int] = {}
    with counted_solves(torch, sync_error=True) as solves:
        for pi, kind in lone_pods(seed, N_LONE_CHECKED):
            kinds[kind] = kinds.get(kind, 0) + 1
            snap = cache.update_snapshot()
            got = card.try_schedule(pi, snap, fwk)
            want = cpu.try_schedule(pi, snap, fwk)
            if got != want:
                raise RuntimeError(f"{pi.key} ({kind}): the card's fast path "
                                   f"says {got}, the CPU port's {want}")
            if kind in ("plain", "huge"):
                first, _ = batch.assign([pi], snap, fwk)
                batch_checked += 1
                if first[pi.key] != got:
                    raise RuntimeError(
                        f"{pi.key} ({kind}): fast path {got}, "
                        f"TorchBackend(max_batch=16).assign {first[pi.key]}")
            elif got is not None:
                raise RuntimeError(f"{pi.key} ({kind}) took the fast path")
            if got is not None:
                cache.assume_pod(pi, got)
                cache.finish_binding(pi.key)
    snap = cache.update_snapshot()
    ct = card.backend._tensors(snap)
    if not torch.equal(card.resident.used_pack(ct, snap).cpu(),
                       fresh_pack(torch, ct)):
        raise RuntimeError("the card's resident pack differs from a fresh "
                           "pack of the final ClusterTensors")
    counts = (card.placed, card.ineligible, card.no_fit)
    if counts != (cpu.placed, cpu.ineligible, cpu.no_fit):
        raise RuntimeError(f"placed/ineligible/no_fit {counts} on the card, "
                           f"{(cpu.placed, cpu.ineligible, cpu.no_fit)} on "
                           "the CPU")
    print(f"compare serving fast path, {N_LONE_CHECKED} lone pods at "
          f"{N_NODES} heterogeneous nodes (seed {seed}; kinds {kinds}): card "
          f"= CPU port on all, = TorchBackend(max_batch=16).assign on "
          f"{batch_checked} eligible; placed/ineligible/no_fit {counts} "
          f"on both; solves {solves['plain']} plain, {solves['fused']} "
          f"fused, none waiting for the card; resident pack = fresh pack "
          f"({card.resident.full_rebuilds} full rebuilds, "
          f"{card.resident.row_refreshes} row refreshes); "
          f"{time.perf_counter() - t0:.1f} s")

    # -- (b) the full-width trickle ------------------------------------------
    t0 = time.perf_counter()

    def basic_cluster(init_assign=None):
        c = SchedulerCache()
        for i in range(N_NODES):
            c.add_node(make_node(f"node-{i}"))
        if init_assign is not None:
            for pi in init_pods:
                c.assume_pod(pi, init_assign[pi.key])
                c.finish_binding(pi.key)
        return c

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_kernel.wave_solve.launches = 0
    wave_kernel.probe.launches = 0
    cache = basic_cluster()
    fp = fast_path()
    init_assign, _ = fp.backend.assign(init_pods, cache.update_snapshot(),
                                       fwk)
    if any(v is None for v in init_assign.values()):
        raise RuntimeError("serving init pods unplaced")
    for pi in init_pods:
        cache.assume_pod(pi, init_assign[pi.key])
        cache.finish_binding(pi.key)
    trickle = [PodInfo(make_pod(f"trickle-{i}", uid=f"trickle-{i}",
                                requests=POD_REQUESTS))
               for i in range(N_TRICKLE + N_PROFILED + 20)]
    fp.warm(PodInfo(make_pod("warm", requests=POD_REQUESTS)),
            cache.light_snapshot(), fwk)
    check = TorchBackend(max_batch=16)
    walls, snap_s, placed = [], 0.0, []
    before = dict(fp.timings)
    with counted_solves(torch, sync_error=False) as solves:
        for i, pi in enumerate(trickle[:N_TRICKLE]):
            if i % 50 == 0:
                first, _ = check.assign([pi], cache.update_snapshot(), fwk)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            snap = cache.light_snapshot()
            t2 = time.perf_counter()
            node = fp.try_schedule(pi, snap, fwk)
            if node is not None:
                cache.assume_pod(pi, node)
            walls.append(time.perf_counter() - t1)
            snap_s += t2 - t1
            if node is None:
                raise RuntimeError(f"trickle pod {i} unplaced")
            if i % 50 == 0 and first[pi.key] != node:
                raise RuntimeError(
                    f"trickle pod {i}: fast path {node}, "
                    f"TorchBackend.assign {first[pi.key]}")
            placed.append(node)
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    split = {"snapshot_s": snap_s, **{
        k: v - before[k] for k, v in fp.timings.items()}}
    peak = torch.cuda.max_memory_allocated()
    w = np.sort(np.array(walls)) * 1e3
    pct = {q: float(np.percentile(w, q)) for q in (50, 90, 99)}
    rate = N_TRICKLE / float(np.sum(walls))
    # Host syncs of one placement: torch warns at each operation that
    # waits for the card.
    syncs = []
    for pi in trickle[N_TRICKLE:N_TRICKLE + 20]:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                node = fp.try_schedule(pi, cache.light_snapshot(), fwk)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        cache.assume_pod(pi, node)
        syncs.append(sum("synchroniz" in str(c.message) for c in caught))
    # Device kernels, device time and idle share over N_PROFILED
    # placements.
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for pi in trickle[N_TRICKLE + 20:]:
            node = fp.try_schedule(pi, cache.light_snapshot(), fwk)
            cache.assume_pod(pi, node)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t1
    busy_us = sum(device_us(e) for e in prof.key_averages())
    on_card = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    h2d = sum("HtoD" in k for k in on_card)
    d2h = sum("DtoH" in k for k in on_card)
    n_kernels = sum(not k.startswith(("Memcpy", "Memset")) for k in on_card)
    by_name: dict[str, int] = {}
    for k in on_card:
        k = k.replace("void ", "").replace("(anonymous namespace)::", "")
        k = k.split("<")[0].split("(")[0].strip()
        by_name[k] = by_name.get(k, 0) + 1
    # The CPU port over the same sequence.
    cpu_cache = basic_cluster(init_assign)
    cpu_fp = fast_path("cpu")
    cpu_fp.warm(PodInfo(make_pod("warm", requests=POD_REQUESTS)),
                cpu_cache.light_snapshot(), fwk)
    for i, pi in enumerate(trickle[:N_TRICKLE]):
        got = cpu_fp.try_schedule(pi, cpu_cache.light_snapshot(), fwk)
        if got != placed[i]:
            raise RuntimeError(f"trickle pod {i}: card {placed[i]}, CPU "
                               f"port {got}")
        cpu_cache.assume_pod(pi, got)
    print(f"serving trickle (SchedulingBasic/{N_NODES}Nodes, {N_INIT} init "
          f"pods by flagless TorchBackend.assign, then {N_TRICKLE} lone pods "
          f"of {POD_REQUESTS} through light_snapshot -> try_schedule -> "
          f"assume_pod): all placed, identical to the CPU port on all "
          f"{N_TRICKLE} and to TorchBackend.assign on every 50th; solves "
          f"{solves['plain']} plain, {solves['fused']} fused; launches "
          f"{launches}; resident {fp.resident.full_rebuilds} full rebuilds, "
          f"{fp.resident.row_refreshes} row refreshes; "
          f"max_memory_allocated {peak} bytes")
    print(f"serving per-placement wall (host clock): p50 {pct[50]:.4f} ms, "
          f"p90 {pct[90]:.4f} ms, p99 {pct[99]:.4f} ms, max "
          f"{float(w[-1]):.4f} ms; serial {rate:.1f} lone pods/s")
    print(f"serving placement split, ms per placement: " + json.dumps(
        {k: round(v * 1e3 / N_TRICKLE, 5) for k, v in split.items()}))
    print(f"serving host syncs per placement (set_sync_debug_mode warn, "
          f"{len(syncs)} placements): {syncs}")
    print(f"profiled serving placements ({N_PROFILED}): wall "
          f"{prof_wall:.4f} s, device kernels {n_kernels} "
          f"({n_kernels / N_PROFILED:.1f} per placement), device busy "
          f"{busy_us / 1e3:.4f} ms ({busy_us / 1e3 / N_PROFILED:.5f} ms per "
          f"placement), idle share {1 - busy_us / 1e6 / prof_wall:.4f}; "
          f"copies host->device {h2d} ({h2d / N_PROFILED:.2f} per "
          f"placement), device->host {d2h} ({d2h / N_PROFILED:.2f} per "
          f"placement); phase 8(b) {time.perf_counter() - t0:.1f} s")
    print("serving device launches per placement by kernel: " + json.dumps(
        {k: v / N_PROFILED for k, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])}))


# -- phase 9: the scheduler loop -----------------------------------------

#: Phase 9(a)'s cluster and traffic sizes, and 9(b)'s super-batch (the
#: reference bench's default --batch-size).
N_LOOP_NODES, N_LOOP_PODS, N_LOOP_TRICKLE = 64, 300, 64
LOOP_BATCH = 16384


def port_loop_api():
    """This package's store, informer factory, scheduler and object
    constructors, as the `api` run_loop takes (a test builds the JAX
    package's counterpart and drives both through the same code)."""
    from types import SimpleNamespace

    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store import (install_core_validation,
                                            new_cluster_store)
    return SimpleNamespace(
        make_node=make_node, make_pod=make_pod,
        InformerFactory=InformerFactory, Scheduler=Scheduler,
        install_core_validation=install_core_validation,
        new_cluster_store=new_cluster_store)


def loop_cluster(seed: int, n_nodes: int, n_pods: int,
                 prefix: str = "p") -> tuple[list, list]:
    """A seeded heterogeneous workload for the scheduler loop, as
    (name, make_node kwargs) and (name, make_pod kwargs) pairs, so each
    package builds its own objects: nodes of SERVING_SHAPES, a NoSchedule
    taint on every 7th, a PreferNoSchedule taint on every 11th, a zone
    label on every 3rd and node 5 cordoned; pods with random requests and
    priorities 0-3, ~30% tolerating the NoSchedule taint, ~10% selecting
    the zone, ~3% preferring a node (the fast path does not take them),
    and ~5% that fit nowhere (too big, or a zone no node has). The
    preferring pods get priority 0 and the misfits -1, so a pre-created
    dispatch pops them last."""
    rng = np.random.default_rng(seed)
    nodes = []
    for i in range(n_nodes):
        taints = []
        if i % 7 == 0:
            taints.append({"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"})
        if i % 11 == 0:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        kw = {"allocatable": dict(SERVING_SHAPES[int(rng.integers(0, 3))])}
        if taints:
            kw["taints"] = taints
        if i % 3 == 0:
            kw["labels"] = {"zone": "a"}
        if i == 5:
            kw["unschedulable"] = True
        nodes.append((f"node-{i}", kw))
    pods = []
    for t in range(n_pods):
        kw = {"requests": {
            "cpu": f"{int(rng.choice([100, 250, 500, 900, 1700]))}m",
            "memory": f"{int(rng.choice([128, 512, 1024, 3000]))}Mi"},
            "priority": int(rng.integers(0, 4))}
        if rng.random() < 0.3:
            kw["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
        u = rng.random()
        if u < 0.1:
            kw["node_selector"] = {"zone": "a"}
        elif u < 0.13:
            kw["affinity"] = {"nodeAffinity": {
                "preferredDuringSchedulingIgnoredDuringExecution": [{
                    "weight": 5, "preference": {"matchExpressions": [{
                        "key": "kubernetes.io/hostname", "operator": "In",
                        "values": [f"node-{int(rng.integers(0, n_nodes))}"]
                    }]}}]}}
            kw["priority"] = 0
        elif u < 0.16:
            kw["requests"], kw["priority"] = {"cpu": "64"}, -1
        elif u < 0.18:
            kw["node_selector"], kw["priority"] = {"zone": "nowhere"}, -1
        pods.append((f"{prefix}-{t}", kw))
    return nodes, pods


async def start_scheduler(api, store, seed: int = 42, **kw):
    """The scheduler bootstrap of run_loop and LoopRun: a Scheduler over
    `store` with its informers started and synced."""
    sched = api.Scheduler(store, seed=seed, **kw)
    factory = api.InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    await factory.wait_for_sync()
    return sched, factory


class LoopRun:
    """One scheduler loop over a fresh store of `api`'s package."""

    def __init__(self, api, backend, batch_size: int):
        self.api, self.backend, self.batch_size = api, backend, batch_size
        self.store = self.sched = self.factory = self.task = None

    async def start(self, nodes) -> None:
        api = self.api
        self.store = api.new_cluster_store()
        api.install_core_validation(self.store)
        for name, kw in nodes:
            await self.store.create("nodes", api.make_node(name, **kw))
        self.sched, self.factory = await start_scheduler(
            api, self.store, backend=self.backend)

    async def create(self, pods) -> None:
        for name, kw in pods:
            await self.store.create("pods", self.api.make_pod(name, **kw))

    def open(self) -> None:
        """Start `Scheduler.run`."""
        self.task = asyncio.ensure_future(
            self.sched.run(batch_size=self.batch_size))

    async def wait(self, cond, what: str, timeout: float = 300.0) -> None:
        """Poll `cond` until it holds; raises the loop's own exception if
        `run` ended with one, TimeoutError after `timeout` s."""
        deadline = time.monotonic() + timeout
        while not cond():
            if self.task is not None and self.task.done() \
                    and not self.task.cancelled() \
                    and self.task.exception() is not None:
                raise self.task.exception()
            if time.monotonic() > deadline:
                raise TimeoutError(f"scheduler loop: {what}")
            await asyncio.sleep(0.005)

    def queued(self) -> int:
        st = self.sched.queue.stats()
        return st["active"] + st["gated"]

    def settled(self, names) -> bool:
        """Every pod bound or parked unschedulable, no cycle or binding
        in flight, the event buffer drained."""
        q, rec = self.sched.queue, self.sched.recorder
        st = q.stats()
        if st["active"] or st["backoff"] or st["in_flight"] \
                or self.sched._binding_tasks or rec._pending \
                or rec._draining:
            return False
        table = self.store._table("pods")
        return all((table[f"default/{n}"].get("spec") or {}).get("nodeName")
                   or f"default/{n}" in q._unschedulable for n in names)

    async def results(self) -> tuple[dict, dict, list, list]:
        """({pod name: node or None}, {pod name: FailedScheduling
        messages}, node objects, pod objects) from the store."""
        pods = (await self.store.list("pods")).items
        nodes = (await self.store.list("nodes")).items
        assignments = {p["metadata"]["name"]:
                       (p.get("spec") or {}).get("nodeName") or None
                       for p in pods}
        failed: dict[str, set] = {}
        for ev in (await self.store.list("events")).items:
            if ev.get("reason") == "FailedScheduling":
                failed.setdefault(ev["involvedObject"]["name"], set()).add(
                    ev["message"])
        return assignments, failed, nodes, pods

    async def close(self) -> None:
        if self.sched is not None:
            await self.sched.stop()
        if self.task is not None:
            self.task.cancel()
            await asyncio.gather(self.task, return_exceptions=True)
        if self.factory is not None:
            self.factory.stop()
        if self.store is not None:
            self.store.stop()


async def run_loop(api, nodes, pods, backend, batch_size: int,
                   trickle: bool = False) -> dict:
    """Schedule `pods` on `nodes` through `api`'s Scheduler and `backend`.
    Pre-created (trickle False): every pod is created and queued before
    `run` opens the loop. Trickle: each pod is created once the one
    before it is bound or parked unschedulable. Returns the assignments,
    the FailedScheduling messages per pod, the store's objects, the
    metrics and the serving tier."""
    lr = LoopRun(api, backend, batch_size)
    await lr.start(nodes)
    names = [name for name, _ in pods]
    try:
        if not trickle:
            await lr.create(pods)
            await lr.wait(lambda: lr.queued() == len(pods), "pods queued")
            lr.open()
        else:
            lr.open()
            for k, pod in enumerate(pods):
                await lr.create([pod])
                await lr.wait(lambda: lr.settled(names[:k + 1]),
                              f"pod {pod[0]} placed")
        await lr.wait(lambda: lr.settled(names), "pods placed")
        assignments, failed, node_objs, pod_objs = await lr.results()
        return {"assignments": assignments, "failed": failed,
                "nodes": node_objs, "pods": pod_objs,
                "metrics": lr.sched.metrics, "serving": lr.sched.serving}
    finally:
        await lr.close()


def over_capacity(nodes, pods) -> list[str]:
    """Nodes whose bound pods exceed their allocatable: an exact host
    re-check of a store's objects with NodeInfo's integer arithmetic."""
    from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

    infos = {n["metadata"]["name"]: NodeInfo(n) for n in nodes}
    for p in pods:
        node = (p.get("spec") or {}).get("nodeName")
        if node:
            infos[node].add_pod(PodInfo(p))
    return [ni.name for ni in infos.values()
            if any(v > ni.allocatable.get(r)
                   for r, v in ni.requested.res.items())
            or ni.requested.pods > ni.allocatable.pods]


def loop_equality_phase(torch, seed: int) -> None:
    """Phase 9(a): the loop on the card against the loop on the CPU."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend

    api = port_loop_api()
    nodes, pods = loop_cluster(seed, N_LOOP_NODES, N_LOOP_PODS)
    t0 = time.perf_counter()
    wave_kernel.wave_solve.launches = 0
    card = asyncio.run(run_loop(api, nodes, pods, TorchBackend(), LOOP_BATCH))
    launches = wave_kernel.wave_solve.launches
    cpu = asyncio.run(run_loop(api, nodes, pods, TorchBackend(device="cpu"),
                               LOOP_BATCH))
    placed = sum(v is not None for v in card["assignments"].values())
    unsched = sorted(k for k, v in card["assignments"].items() if v is None)
    same = (card["assignments"] == cpu["assignments"],
            card["failed"] == cpu["failed"])
    print(f"compare scheduler loop, pre-created ({N_LOOP_NODES} nodes, "
          f"{N_LOOP_PODS} pods, batch_size {LOOP_BATCH}), card vs CPU: "
          f"nodeName {'identical' if same[0] else 'DIFFER'}, "
          f"FailedScheduling messages "
          f"{'identical' if same[1] else 'DIFFER'}; {placed} bound, "
          f"{len(unsched)} unschedulable, fast-path pods "
          f"{int(card['metrics'].serving_fast_path_pods.value())}, "
          f"wave_solve launches {launches}")
    if not all(same):
        raise RuntimeError("the scheduler loop on the card placed pods "
                           "differently from the CPU")
    if not unsched or set(unsched) != set(card["failed"]):
        raise RuntimeError(f"unschedulable pods {unsched} and their "
                           f"FailedScheduling events {sorted(card['failed'])}"
                           " do not match")
    bad = over_capacity(card["nodes"], card["pods"])
    if bad:
        raise RuntimeError(f"nodes over capacity: {bad}")
    _, lone = loop_cluster(seed + 1, N_LOOP_NODES, N_LOOP_TRICKLE, "lone")
    lone = [(n, kw) for n, kw in lone if kw["priority"] >= 0]
    trickle = asyncio.run(run_loop(api, nodes, lone, TorchBackend(),
                                   LOOP_BATCH, trickle=True))
    fast = int(trickle["metrics"].serving_fast_path_pods.value())
    unbound = [k for k, v in trickle["assignments"].items() if v is None]
    bad = over_capacity(trickle["nodes"], trickle["pods"])
    print(f"scheduler loop trickle: {len(lone)} lone pods, each awaited, "
          f"{len(lone) - len(unbound)} bound, fast-path pods {fast}; nodes "
          f"over capacity: {len(bad)}; phase 9(a) "
          f"{time.perf_counter() - t0:.1f} s")
    if unbound or fast == 0 or bad:
        raise RuntimeError(f"trickle: unbound {unbound}, fast-path pods "
                           f"{fast}, over capacity {bad}")


#: Functions whose cumulative host time phase 9(b)'s host profile prints:
#: the harness's create, the store's commit and watch fan-out, the
#: informers, the queue, the serving tier's dispatch, the batch backend,
#: assume, the binding cycle and its write, and the event drain.
LOOP_STAGES = ("create", "_record", "_dispatch", "_apply", "add",
               "schedule_next", "_schedule_pods", "assign",
               "_assume_and_bind", "_binding_cycle_traced",
               "binding_subresource", "_drain", "update_snapshot")


def host_breakdown(prof) -> tuple[dict, list, dict]:
    """A cProfile of the loop's measured window: own seconds by area (the
    port's subpackages, asyncio, torch, numpy, builtins), the ten functions
    with the most own time, and the cumulative seconds of LOOP_STAGES."""
    import pstats

    areas: dict[str, float] = {}
    top, cum = [], {}
    for (path, line, fn), (_, calls, own, total, _) in \
            pstats.Stats(prof).stats.items():
        if "kubernetes_tpu_torch/" in path:
            sub = path.split("kubernetes_tpu_torch/")[1].split("/")[0]
            area, where = sub.removesuffix(".py"), \
                path.split("kubernetes_tpu_torch/")[1]
        else:
            area = next((a for a in ("asyncio", "torch", "numpy")
                         if f"/{a}/" in path), "builtins" if path == "~"
                        else "other")
            where = path.rsplit("/", 1)[-1]
        areas[area] = round(areas.get(area, 0.0) + own, 6)
        top.append((round(own, 6), f"{where}:{line}({fn})", calls))
        if fn in LOOP_STAGES and "kubernetes_tpu_torch/" in path:
            key = f"{where}:{fn}"
            cum[key] = round(cum.get(key, 0.0) + total, 6)
    top.sort(reverse=True)
    return dict(sorted(areas.items(), key=lambda kv: -kv[1])), top[:10], \
        dict(sorted(cum.items(), key=lambda kv: -kv[1]))


def scheduler_perf_phase(torch) -> dict:
    """Phase 9(b): SchedulingBasic/5000Nodes through the port's PerfRunner
    and `Scheduler.run`; returns the kernels line's loop entries."""
    from kubernetes_tpu_torch.ops import wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.perf.scheduler_perf import (PerfRunner,
                                                         SCHEDULING_BASIC)

    class CountingRunner(PerfRunner):
        """PerfRunner that counts each route's pods over the measured
        window, sets the launch counters to 0 just before the measured
        createPods and reads them just after, and, when asked, profiles
        that window: `profile` "device" (torch.profiler) or "host"
        (cProfile)."""

        def __init__(self, backend, profile: str | None):
            super().__init__(backend=backend, batch_size=LOOP_BATCH)
            self.profile = profile
            self.routes = dict.fromkeys(
                ("backend_dispatches", "backend_pods", "host_path_pods"), 0)
            self.window: dict = {}

        async def _drive(self, template_ops, params, timeout, store,
                         metrics, sched, factory):
            self.store = store
            assign, host = sched.backend.assign, sched._schedule_host_path

            def counted_assign(pods, snapshot, fwk):
                self.routes["backend_dispatches"] += 1
                self.routes["backend_pods"] += len(pods)
                return assign(pods, snapshot, fwk)

            async def counted_host(pi, snapshot):
                self.routes["host_path_pods"] += 1
                return await host(pi, snapshot)

            sched.backend.assign = counted_assign
            sched._schedule_host_path = counted_host
            return await super()._drive(template_ops, params, timeout,
                                        store, metrics, sched, factory)

        def _begin_measure(self, metrics, backing):
            torch.cuda.synchronize()
            self.routes = dict.fromkeys(self.routes, 0)
            wave_kernel.wave_solve.launches = 0
            self.window = {"timings": dict(self.backend.timings),
                           "counters": dict(self.backend.counters)}
            if self.profile == "device":
                self.prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                self.prof.start()
            elif self.profile == "host":
                import cProfile
                self.prof = cProfile.Profile()
                self.prof.enable()
            self.window["t0"] = time.perf_counter()
            return super()._begin_measure(metrics, backing)

        def _end_measure(self, result, metrics, backing, base, count):
            super()._end_measure(result, metrics, backing, base, count)
            torch.cuda.synchronize()
            w = self.window
            w["wall"] = time.perf_counter() - w["t0"]
            if self.profile == "device":
                self.prof.stop()
            elif self.profile == "host":
                self.prof.disable()
            w["launches"] = wave_kernel.wave_solve.launches
            w["routes"] = dict(self.routes)
            w["timings"] = {k: round(v - w["timings"][k], 6)
                            for k, v in self.backend.timings.items()}
            w["counters"] = {k: v - w["counters"][k]
                             for k, v in self.backend.counters.items()
                             if k != "sinkhorn_iterations"}

    template = SCHEDULING_BASIC["workloadTemplate"]
    params = next(w["params"] for w in SCHEDULING_BASIC["workloads"]
                  if w["name"] == "5000Nodes")
    want = params["initPods"] + params["measurePods"]

    def one_run(profile: str | None):
        wave_kernel.probe.launches = 0
        runner = CountingRunner(TorchBackend(), profile)
        result = asyncio.run(runner.run(template, params, timeout=900.0))
        pods = asyncio.run(runner.store.list("pods")).items
        nodes = asyncio.run(runner.store.list("nodes")).items
        bound = sum(bool((p.get("spec") or {}).get("nodeName")) for p in pods)
        bad = over_capacity(nodes, pods)
        if bound != want or len(pods) != want or bad:
            raise RuntimeError(f"SchedulingBasic/5000Nodes: {bound}/{want} "
                               f"bound, nodes over capacity: {bad[:5]}")
        return runner, result, wave_kernel.probe.launches

    t0 = time.perf_counter()
    runner, result, probe_launches = one_run(profile=None)
    w, r = runner.window, result.as_dict()
    routes = w["routes"]
    card_pods = routes["backend_pods"] + r["serving_fast_path_pods_total"]
    print(f"scheduler loop SchedulingBasic/5000Nodes (PerfRunner, "
          f"Scheduler.run, TorchBackend(), batch_size {LOOP_BATCH}): "
          f"SchedulingThroughput {r['throughput_pods_per_sec']} pods/s, "
          f"measured_seconds {result.measured_seconds:.6f}, attempt ms "
          f"p50 {r['attempt_p50_ms']} p90 {r['attempt_p90_ms']} p99 "
          f"{r['attempt_p99_ms']} p999 {r['attempt_p999_ms']} (exact "
          f"{r['attempt_percentiles_exact']}), fragmentation_pct "
          f"{r['fragmentation_pct']}, fragmentation_occupied_pct "
          f"{r['fragmentation_occupied_pct']}; {want} pods bound, no node "
          f"over capacity")
    print(f"scheduler loop routes over the measured window: fast-path pods "
          f"{r['serving_fast_path_pods_total']}, backend dispatches "
          f"{routes['backend_dispatches']} with {routes['backend_pods']} "
          f"pods, host-path pods {routes['host_path_pods']}, optimal_solves "
          f"{w['counters']['optimal_solves']}, chunks "
          f"{w['counters']['chunks']}, wave_solve launches {w['launches']}; "
          f"probe launches over the run {probe_launches}")
    print(f"scheduler loop TorchBackend.timings over the measured window: "
          f"{json.dumps(w['timings'])}; window wall {w['wall']:.6f} s")
    print(f"scheduler loop events: emitted {result.events_emitted_total}, "
          f"dropped {result.events_dropped_total}")
    if card_pods <= routes["host_path_pods"] or w["launches"] == 0 \
            or probe_launches == 0:
        raise RuntimeError(f"the measured window did not run on the card: "
                           f"routes {routes}, fast-path pods "
                           f"{r['serving_fast_path_pods_total']}, wave_solve "
                           f"launches {w['launches']}, probe launches "
                           f"{probe_launches}")
    prof_runner, prof_result, _ = one_run(profile="device")
    pw = prof_runner.window
    busy_us = sum(device_us(e) for e in prof_runner.prof.key_averages())
    print(f"profiled scheduler loop measured window: wall {pw['wall']:.6f} "
          f"s, throughput {prof_result.throughput:.1f} pods/s, device busy "
          f"{busy_us / 1e6:.6f} s" + (
              f", idle share {1 - busy_us / 1e6 / pw['wall']:.4f}"
              if busy_us else ", device time not measured by the profiler")
          )
    host_runner, host_result, _ = one_run(profile="host")
    areas, top, cum = host_breakdown(host_runner.prof)
    print(f"host profile of the scheduler loop measured window (cProfile, "
          f"wall {host_runner.window['wall']:.6f} s, throughput "
          f"{host_result.throughput:.1f} pods/s): own seconds by area "
          f"{json.dumps(areas)}; cumulative seconds {json.dumps(cum)}")
    print(f"host profile top functions by own seconds: {json.dumps(top)}; "
          f"phase 9(b) {time.perf_counter() - t0:.1f} s")
    return {"loop_launches": w["launches"],
            "loop_probe_launches": probe_launches}


def main() -> int:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=8,
                        help="seed of phase 8(a)'s cluster and lone pods")
    seed = parser.parse_args().seed
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from kubernetes_tpu_torch.utils import flags

    # Phases 1-6 run the reference's documented greedy configuration,
    # pinned: with no flag the solve-mode policy sends every chunk of 64
    # or more pods to the Sinkhorn route, which phase 7 drives.
    with flags.scoped_set("KTPU_SOLVE_MODE", "greedy"):
        return smoke(torch, seed)


def smoke(torch, seed: int) -> int:
    """Phases 1-10 (see the module docstring)."""
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.ops import solver, wave_kernel
    from kubernetes_tpu_torch.ops.backend import TorchBackend, chunk_planes
    from kubernetes_tpu_torch.scheduler.framework import Framework
    from kubernetes_tpu_torch.scheduler.plugins.registry import (
        DEFAULT_SCORE_WEIGHTS, build_plugins)
    from kubernetes_tpu_torch.scheduler.types import (
        NodeInfo, PodInfo, Snapshot)
    from kubernetes_tpu_torch.utils import flags

    dev = torch.device("cuda:0")
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    lib = wave_kernel.LIBRARY.build()
    print(f"build: {time.perf_counter() - t0:.3f} s ({lib.path.name})")
    for line in lib.ptxas_info.splitlines():
        if "ptxas info" in line:
            print(line.strip())

    # -- 2. probe ---------------------------------------------------------
    x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
    probe_err = float((wave_kernel.probe(x) - (x + 1)).abs().max())
    # The scalar forms: a length that is not a multiple of 4, and a view
    # whose pointer is not 16-byte aligned.
    odd = torch.randn(1001, device=dev)
    for what, t in (("n=1001", odd), ("unaligned view", odd[1:])):
        if not torch.equal(wave_kernel.probe(t), t + 1):
            raise RuntimeError(f"probe kernel wrong on {what}")
    if probe_err != 0.0:
        raise RuntimeError(f"probe kernel off by {probe_err}")
    # Back to back in turns: probe, x + 1, x + 1, probe.
    turns = [cuda_ms(torch, fn, 1000) for fn in (
        lambda: wave_kernel.probe(x), lambda: x + 1, lambda: x + 1,
        lambda: wave_kernel.probe(x))]
    probe_ms = (turns[0] + turns[3]) / 2
    probe_plain_ms = (turns[1] + turns[2]) / 2
    probe_dev_ms = profiled_kernel_ms(
        torch, lambda: wave_kernel.probe(x), 50, "probe_kernel")
    plus_dev_ms = profiled_kernel_ms(torch, lambda: x + 1, 50, "elementwise")
    print(f"probe per launch, (8,128) f32, back to back in turns (probe, "
          f"x+1, x+1, probe): {turns} ms; device time per launch "
          f"(profiler): probe {fmt_ms(probe_dev_ms)}, x + 1 "
          f"{fmt_ms(plus_dev_ms)}; probe "
          f"{'no slower than' if probe_ms <= probe_plain_ms else 'SLOWER than'}"
          f" x + 1 back to back")

    # -- 3. kernel vs plain -------------------------------------------------
    def node_infos():
        return [NodeInfo(make_node(f"node-{i}")) for i in range(N_NODES)]

    init_pods = [PodInfo(make_pod(f"init-{i}", requests=POD_REQUESTS))
                 for i in range(N_INIT)]
    measured = [PodInfo(make_pod(f"pod-{i}", requests=POD_REQUESTS))
                for i in range(N_MEASURED)]

    mismatches = 0
    max_err = 0.0

    def compare(what, args, plan=None, **kw):
        nonlocal mismatches, max_err
        (p, r), n = args[0].shape, args[2].shape[0]
        if plan is None:
            plan = wave_kernel.wave_launch_plan(
                n, r, max(1, min(kw["wave_w"], p)))
        got = wave_kernel.wave_solve(*args, plan=plan, **kw)
        ref = wave_kernel.wave_solve_reference(*args, **kw)
        torch.cuda.synchronize()
        diff = int((got[0] - ref[0]).abs().max())
        max_err = max(max_err, float(diff))
        same = all(torch.equal(g, r) for g, r in zip(got[1:], ref[1:]))
        print(f"compare {what}: max |assign diff| {diff}, counters "
              f"{'identical' if same else 'DIFFER'} (commits "
              f"{got[1].tolist()}, replays {got[2].tolist()}, poisoned "
              f"{got[3].tolist()}); plan {plan}")
        if diff or not same:
            mismatches += 1
        return got

    def chunk_on_card(arrays, rows, exc, perms, strategy):
        t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        args = (t["req_q"], t["req_nz_q"], t["free_q"], t["free_pods"],
                t["used_nz_q"], t["alloc_q"], t["mask"], t["static_scores"],
                t["fit_col_w"], t["bal_col_mask"], t["shape_u"],
                t["shape_s"], 1.0, 1.0, strategy)
        return args, *(torch.from_numpy(a).to(dev) for a in (rows, exc,
                                                             perms))

    b = TorchBackend(device=dev)
    snap0 = Snapshot(node_infos(), 1)
    ctx = b._start(measured[:1024], snap0, fwk)
    prep = b._prep_chunk(ctx.chunks[0], ctx)
    st, prm = b.ensure_static(ctx.ct), ctx.params
    pl = chunk_planes(st["alloc_q"], b.used.pack, st["alloc_pods"],
                      prep["dev_pack"], prep["dev_cls"], st["taint_f"],
                      st["taint_p"], prep["dev_mask"], prep["dev_scores"],
                      prm["w_taint"], prm["taint_filter_on"])
    chunk_args = (pl["req_q"], pl["req_nz_q"], pl["free_q"],
                  pl["free_pods"], pl["used_nz_q"], st["alloc_q"],
                  pl["mask"], pl["static_scores"], prm["fit_col_w"],
                  prm["bal_col_mask"], prm["shape_u"], prm["shape_s"],
                  prm["w_fit"], prm["w_bal"], prm["strategy"])
    main_kw = dict(wave_w=prep["wave_w"], rows=prep["dev_cls"],
                   exc=prep["dev_exc"], poison=True, perms=prep["dev_perms"])
    compare("5k chunk K=4 poison", chunk_args, **main_kw)
    compare("5k chunk K=1 replay", chunk_args, wave_w=prep["wave_w"],
            rows=prep["dev_cls"], exc=prep["dev_exc"], poison=False)

    # Heterogeneous chunks: several node shapes, near-ties, exceptions and
    # an exhausted resource, at N divisible by the cluster and at a prime N
    # (short last slice), every strategy; then the global-carry form.
    poisoned = replayed = 0
    for n in (5000, 4093):
        for strategy in wave_kernel.STRATEGIES:
            args, rows_t, exc_t, perms_t = chunk_on_card(
                *hetero_chunk(seed=n, n=n), strategy)
            got = compare(f"hetero N={n} {strategy} K=4 poison", args,
                          wave_w=32, rows=rows_t, exc=exc_t, poison=True,
                          perms=perms_t)
            poisoned += int(got[3].sum())
            got = compare(f"hetero N={n} {strategy} K=1 replay", args,
                          wave_w=32, rows=rows_t, exc=exc_t, poison=False)
            replayed += int(got[2].sum())
    if not (poisoned and replayed):
        raise RuntimeError(f"the heterogeneous chunks poisoned {poisoned} "
                           f"orders and replayed {replayed} pods; both "
                           "paths must run")
    big = hetero_chunk(seed=3, n=20000, p=256, r=16, k=1)
    args, rows_t, exc_t, _ = chunk_on_card(*big, "MostAllocated")
    plan = wave_kernel.wave_launch_plan(20000, 16, 32)
    if plan.carry != "global":
        raise RuntimeError(f"R=16 at N=20000 did not take the global-carry "
                           f"form: {plan}")
    compare("hetero N=20000 R=16 P=256 K=1 replay (global carry)", args,
            wave_w=32, rows=rows_t, exc=exc_t, poison=False)

    # Default shared-form plans whose dynamic shared memory needs the
    # opt-in above the kernel's default limit (48 KB less its static
    # shared memory) yet stays at or below 48 KB.
    for n, r in ((320, 11), (5120, 10)):
        plan = wave_kernel.wave_launch_plan(n, r, 32)
        if not (plan.carry == "shared"
                and 48 * 1024 - wave_kernel.STATIC_SMEM_BUDGET
                < plan.smem_bytes <= 48 * 1024):
            raise RuntimeError(f"N={n} R={r} is outside the opt-in "
                               f"window: {plan}")
        args, rows_t, exc_t, perms_t = chunk_on_card(
            *hetero_chunk(seed=n, n=n, p=256, r=r), "LeastAllocated")
        compare(f"hetero N={n} R={r} P=256 K=4 poison (opt-in window)",
                args, wave_w=32, rows=rows_t, exc=exc_t, poison=True,
                perms=perms_t)

    storm_args, rows_t, exc_t, perms_t = chunk_on_card(*storm(seed=1),
                                                 "LeastAllocated")
    got = compare("storm K=4 poison", storm_args, wave_w=32, rows=rows_t,
                  exc=exc_t, poison=True, perms=perms_t)
    if not bool(got[3].any()):
        raise RuntimeError("the storm did not poison any order")
    got = compare("storm K=1 replay", storm_args, wave_w=32, rows=rows_t,
                  exc=exc_t, poison=False)
    if int(got[2].sum()) == 0:
        raise RuntimeError("the storm did not replay any wave")
    compare("storm K=4 W=1 rerun", storm_args, wave_w=1, rows=rows_t,
            exc=exc_t, poison=False, perms=perms_t)
    gang = (torch.zeros((256, 16), device=dev),
            torch.zeros((16,), device=dev))
    kern = solver.multistart_greedy_assign_wave_kernel(
        *storm_args, 32, perms_t, *gang, rows=rows_t, exc=exc_t)
    plain = solver.multistart_greedy_assign_wave(
        *storm_args, 32, perms_t, *gang, rows=rows_t, exc=exc_t)
    same = torch.equal(kern[0], plain[0]) and kern[1:] == plain[1:]
    print(f"compare storm multistart wrapper: {'identical' if same else 'DIFFER'}"
          f" (commits, replays {kern[1:]})")
    mismatches += 0 if same else 1

    small = [NodeInfo(make_node(
        f"small-{i}", allocatable={"cpu": str(2 + i % 5), "memory": "16Gi",
                                   "pods": str(4 + i % 3)}))
             for i in range(64)]
    small_pods = [PodInfo(make_pod(
        f"sp-{i}", requests={"cpu": f"{300 + 100 * (i % 7)}m",
                             "memory": "1Gi"})) for i in range(200)]
    with flags.scoped_set("KTPU_WAVE_WIDTH", 8):
        on_card, _ = TorchBackend(device=dev, max_batch=64).assign(
            small_pods, Snapshot(small, 1), fwk)
        on_cpu, _ = TorchBackend(device="cpu", max_batch=64).assign(
            small_pods, Snapshot(small, 1), fwk)
    print(f"compare small cluster, CUDA vs CPU backend: "
          f"{'identical' if on_card == on_cpu else 'DIFFER'} "
          f"({sum(v is not None for v in on_card.values())}/200 placed)")
    mismatches += 0 if on_card == on_cpu else 1
    if mismatches:
        raise RuntimeError(f"{mismatches} kernel/plain comparisons differ")

    # -- 4. the main path -----------------------------------------------------
    nodes = node_infos()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wave_kernel.wave_solve.launches = 0
    wave_kernel.probe.launches = 0
    backend = TorchBackend()
    init_assign, _ = backend.assign(init_pods, stamped_snapshot(nodes, 1), fwk)
    if any(v is None for v in init_assign.values()):
        raise RuntimeError("init pods unplaced")
    by_name = {ni.name: ni for ni in nodes}
    for pi in init_pods:
        by_name[init_assign[pi.key]].add_pod(pi)
    torch.cuda.synchronize()
    before = dict(backend.timings)
    t1 = time.perf_counter()
    assignments, _ = backend.assign(measured, stamped_snapshot(nodes, 2), fwk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    phases = {k: round(v - before[k], 6) for k, v in backend.timings.items()}
    launches = {"wave_solve": wave_kernel.wave_solve.launches,
                "probe": wave_kernel.probe.launches}
    peak_bytes = torch.cuda.max_memory_allocated()

    unplaced = [k for k, v in assignments.items() if v is None]
    if len(assignments) != N_MEASURED or unplaced:
        raise RuntimeError(f"{len(unplaced)} measured pods unplaced")
    for pi in measured:
        by_name[assignments[pi.key]].add_pod(pi)
    for ni in nodes:
        over = [r for r, v in ni.requested.res.items()
                if v > ni.allocatable.get(r)]
        if over or ni.requested.pods > ni.allocatable.pods:
            raise RuntimeError(f"{ni.name} over capacity: {over}")
    chunks = backend.counters["chunks"]
    if launches["wave_solve"] < chunks or launches["probe"] < 1:
        raise RuntimeError(f"kernels not on the main path: {launches}, "
                           f"{chunks} chunks")
    print(f"main path: {N_MEASURED} measured pods in {wall:.3f} s = "
          f"{N_MEASURED / wall:.1f} pods/s; {chunks} chunks (init "
          f"included), {backend.counters['wave_commits']} commits, "
          f"{backend.counters['wave_replays']} replays; launches {launches}; "
          f"max_memory_allocated {peak_bytes} bytes")
    print(f"measured phase host-clock seconds: {json.dumps(phases)}")
    greedy_frag = occupied_fragmentation(torch, backend)

    # -- 5. timings ---------------------------------------------------------
    # Device busy share of the measured phase: the same assign() again on a
    # fresh copy of the post-init cluster, under torch.profiler.
    nodes2 = node_infos()
    by_name2 = {ni.name: ni for ni in nodes2}
    for pi in init_pods:
        by_name2[init_assign[pi.key]].add_pod(pi)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t2 = time.perf_counter()
        again, _ = backend.assign(measured, stamped_snapshot(nodes2, 3), fwk)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t2
    if again != assignments:
        raise RuntimeError("a repeated measured phase placed pods differently")
    busy_us = sum(device_us(e) for e in prof.key_averages())
    solve_dev_ms = kernel_ms_from(prof, "wave_solve_kernel")
    print(f"profiled measured phase: wall {prof_wall:.3f} s, device busy "
          f"{busy_us / 1e6:.4f} s" + (
              f", idle share {1 - busy_us / 1e6 / prof_wall:.4f}"
              if busy_us else ", device time not measured by the profiler")
          + f"; wave_solve device time per launch {fmt_ms(solve_dev_ms)}")
    kernel_ms = cuda_ms(
        torch, lambda: wave_kernel.wave_solve(*chunk_args, **main_kw), 20)
    # The launch-plan sweep at the main path's chunk: clusters of 4, 8 and
    # 16 blocks x 128 and 256 threads, in two rounds (forward, reversed),
    # each plan's output identical to the default plan's.
    p, r = pl["req_q"].shape
    n = pl["free_q"].shape[0]
    default_plan = wave_kernel.wave_launch_plan(n, r, prep["wave_w"])
    want = wave_kernel.wave_solve(*chunk_args, **main_kw)
    sweep_plans = [wave_kernel.WavePlan(
        cs, -(-n // cs), threads, wave_kernel.carry_bytes(-(-n // cs), r),
        "shared") for cs in (4, 8, 16) for threads in (128, 256)]
    sweep = {plan: [] for plan in sweep_plans}
    for order in (sweep_plans, sweep_plans[::-1]):
        for plan in order:
            got = wave_kernel.wave_solve(*chunk_args, plan=plan, **main_kw)
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise RuntimeError(f"wave_solve under {plan} differs from "
                                   f"{default_plan}")
            sweep[plan].append(cuda_ms(torch, lambda: wave_kernel.wave_solve(
                *chunk_args, plan=plan, **main_kw), 10))
    for plan, times in sweep.items():
        print(f"sweep wave_solve 1024-pod chunk, cluster {plan.cluster} x "
              f"{plan.threads} threads ({plan.nodes_per_block} nodes, "
              f"{plan.smem_bytes} B per block): {times} ms")
    # The exchange's floor: the same chunk with an empty class mask, so a
    # pick reads one mask byte per node and scores nothing; what is left is
    # the block argmax, the cluster barrier and the slot reads.
    empty_args = list(chunk_args)
    empty_args[6] = torch.zeros_like(pl["mask"])
    floor_ms = cuda_ms(torch, lambda: wave_kernel.wave_solve(
        *empty_args, **main_kw), 20)
    print(f"wave_solve floor, empty mask, plan {default_plan}: {floor_ms:.4f}"
          f" ms per chunk ({floor_ms / p * 1e3:.3f} us per pick)")
    plain_ms = cuda_ms(
        torch, lambda: wave_kernel.wave_solve_reference(*chunk_args,
                                                        **main_kw), 2)
    # Score evaluations the chunk needs: each pod against every node
    # feasible for its class at chunk start, in each of the k orders.
    k = main_kw["perms"].shape[0]
    class_req = prep["dev_pack"][:, :r]
    feasible = pl["mask"] & (pl["free_pods"] >= 1)[None, :] & torch.all(
        class_req[:, None, :] <= pl["free_q"][None, :, :], dim=-1)
    evals = k * int(feasible.sum(dim=1)[prep["dev_cls"].long()].sum())
    bound_ms, bound_by = wave_bound_ms(
        p, pl["free_q"].shape[0], r, pl["mask"].shape[0], k,
        prm["shape_u"].shape[0], evals)
    print(f"wave_solve per 1024-pod chunk: kernel {kernel_ms:.4f} ms "
          f"({kernel_ms / p * 1e3:.3f} us per pick, {p} picks per order), "
          f"plan {default_plan}, plain {plain_ms:.3f} ms, bound "
          f"{bound_ms:.6f} ms ({bound_by}); probe {probe_ms:.4f} ms, plain "
          f"{probe_plain_ms:.4f} ms")

    # -- 6. the sharded path ------------------------------------------------
    sharded_entries = sharded_phase(torch, dev, fwk, init_pods, init_assign,
                                    measured, assignments, node_infos)

    # -- 7. the flagless route ------------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"):
        flagless = optimal_phase(torch, dev, fwk, init_pods, measured,
                                 node_infos, greedy_frag)

    # -- 8. the serving fast path ---------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"):
        serving_phase(torch, fwk, init_pods, seed)

    # -- 9. the scheduler loop --------------------------------------------------
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        loop_equality_phase(torch, seed)
        loop = scheduler_perf_phase(torch)

    # -- 10. result --------------------------------------------------------
    src = "kubernetes_tpu_torch/csrc/wave_solve.cu"
    probe_bound = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(json.dumps({"kernels": [
        {"name": "wave_solve", "route": "cuda", "source": src,
         "replaces": "kubernetes_tpu/ops/pallas_kernel.py:134",
         "launches": launches["wave_solve"], "max_abs_err": max_err,
         "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
         "bound_by": bound_by, "library_ms": None, **flagless,
         "loop_launches": loop["loop_launches"]},
        {"name": "probe", "route": "cuda", "source": src,
         "replaces": "kubernetes_tpu/ops/pallas_kernel.py:111",
         "launches": launches["probe"], "max_abs_err": probe_err,
         "ms": probe_ms, "plain_ms": probe_plain_ms, "bound_ms": probe_bound,
         "bound_by": "bytes", "library_ms": probe_plain_ms,
         "loop_launches": loop["loop_probe_launches"]},
        *sharded_entries,
    ]}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
