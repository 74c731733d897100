"""Plain NumPy reference of where the scheduler places each pod.

It states the placement semantics of the batched scheduler and nothing of
its code: a dispatch (the pods one scheduling cycle hands the backend, in
order) is cut into chunks of `chunk` pods; each chunk is solved against the
used state the previous chunk left, and

- a chunk of `OPTIMAL_MIN_PODS` pods or more takes the batch-optimal
  route: an entropic transport plan (Sinkhorn, annealed 4T -> 2T -> T) from
  the chunk's pods to the nodes, costed by the chunk-start live scores and
  bounded by each node's free pod slots, is rounded pod by pod: the node of
  the highest plan value where the pod still fits, ties to the lowest index;
- a smaller chunk is solved pod by pod in dispatch order: among the nodes
  where the pod fits (every resource column and a pod slot), the node of
  the highest live score, ties to the lowest node index.

The live score of a node is the default profile's: TaintToleration (weight
3; 100 on every node of a cluster without PreferNoSchedule taints),
NodeResourcesFit LeastAllocated over cpu and memory (weight 1),
NodeResourcesBalancedAllocation over cpu and memory (weight 1). The pod
template has no affinity, spread constraint, selector or toleration: the
reference models none. Quantities are exact integers (milli-cpu,
milli-bytes), scores float64.

A cell runs one pod template, so the state of a node is the number of the
template's pods on it. Two nodes with equal allocatable and equal counts are
interchangeable: the scheduler must take the lower-indexed one. Nodes whose
scores differ by less than `eps` (score points; log-plan units on the
optimal route) are near-ties, and either is right: the scheduler quantizes
memory (2^25 milli-byte quanta), which moves a score by less.

`judge_dispatch` follows a dispatch pod by pod with the placements under
test as they were made (teacher forcing: pod i is judged against the state
after pods 0..i-1 landed where they did) and counts the pods placed where
the semantics would not put them. `solve_dispatch` makes the placements
itself, in float64 or, for the controls, with ties to the highest index
or in bfloat16.

Imports NumPy only.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

MAX_NODE_SCORE = 100.0
OPTIMAL_MIN_PODS = 64
SINKHORN_ITERS = 24
SINKHORN_TEMP = 0.05
SINKHORN_STAGES = 3
_EPS = 1e-12
_F32_TINY = float(np.finfo(np.float32).tiny)
W_FIT, W_BAL, W_TAINT = 1.0, 1.0, 3.0
#: score points (live routes) and log-plan units (optimal route) within
#: which two different node states are a near-tie.
EPS_SCORE = 0.1
EPS_PLAN = 1e-3
#: upstream's non-zero request defaults for scoring a pod that asks for 0.
NONZERO_CPU_MILLI = 100
NONZERO_MEMORY_MILLI = 200 * 2 ** 20 * 1000


def bf16(x):
    """Round to bfloat16 (nearest, ties to even), held in float64."""
    a = np.asarray(x, dtype=np.float32)
    u = a.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    out = u.astype(np.uint32).view(np.float32).astype(np.float64)
    return np.where(np.isfinite(a), out, a.astype(np.float64))


def f64(x):
    return np.asarray(x, dtype=np.float64)


@dataclass
class Cluster:
    """Nodes in the scheduler's index order."""
    alloc: np.ndarray          # (N, 2) int64: milli-cpu, milli-bytes
    pod_slots: np.ndarray      # (N,) int64
    names: list = field(default_factory=list)


@dataclass
class Template:
    """The cell's one pod template."""
    req: np.ndarray            # (2,) int64: milli-cpu, milli-bytes

    @property
    def req_nz(self) -> np.ndarray:
        cpu, mem = (int(v) for v in self.req)
        return np.array([cpu or NONZERO_CPU_MILLI,
                         mem or NONZERO_MEMORY_MILLI], dtype=np.int64)


def live_scores(cl: Cluster, tp: Template, counts, static, rnd=f64):
    """(N,) static + fit + balanced at `counts` pods of the template per
    node, for one more pod of it."""
    alloc = rnd(cl.alloc.astype(np.float64))
    used = rnd((counts[:, None] + 1) * tp.req_nz[None, :]).astype(np.float64)
    safe = np.where(alloc > 0, alloc, 1.0)
    s = rnd(rnd(MAX_NODE_SCORE * rnd(alloc - used)) / safe)
    s = np.where(used > alloc, 0.0, s)
    fit = rnd(rnd(s[:, 0] + s[:, 1]) / 2.0)
    frac = np.minimum(rnd(used / safe), 1.0)
    mean = rnd(rnd(frac[:, 0] + frac[:, 1]) / 2.0)
    d = rnd(frac - mean[:, None])
    var = rnd(rnd(rnd(d[:, 0] * d[:, 0]) + rnd(d[:, 1] * d[:, 1])) / 2.0)
    bal = rnd(rnd(1.0 - rnd(np.sqrt(var))) * MAX_NODE_SCORE)
    return rnd(rnd(static + rnd(W_FIT * fit)) + rnd(W_BAL * bal))


def static_scores(cl: Cluster, start_counts, rnd=f64):
    """(N,) the capacity-independent part, fixed for a dispatch:
    TaintToleration's, the same on every node of an untainted cluster."""
    return rnd(np.full(len(cl.pod_slots), W_TAINT * MAX_NODE_SCORE))


def fits(cl: Cluster, tp: Template, counts, rnd=f64):
    """(N,) bool: one more pod fits every resource column and a slot."""
    if rnd is f64:
        used = (counts[:, None] + 1) * tp.req[None, :]
        res_ok = np.all(used <= cl.alloc, axis=1)
    else:
        used = rnd(rnd(counts[:, None] * tp.req[None, :]) + tp.req[None, :])
        res_ok = np.all(used <= rnd(cl.alloc), axis=1)
    return res_ok & (counts + 1 <= cl.pod_slots)


def sinkhorn_log_plan(cl: Cluster, tp: Template, counts, static, p_real,
                      rnd=f64):
    """(N,) log plan of the chunk's class row: the chunk's `p_real` pods
    (the chunk's padding rides an empty, all-infeasible row)."""
    feasible = fits(cl, tp, counts, rnd)
    cost = live_scores(cl, tp, counts, static, rnd)
    b = rnd(np.maximum(cl.pod_slots - counts, 0).astype(np.float64))
    if not feasible.any():
        return np.full(len(counts), -1e30)
    sc = np.where(feasible, rnd(cost - cost[feasible].max()), 0.0)
    kmask = feasible.astype(np.float64)
    kernels = {}

    def kernel(stage):
        if stage not in kernels:
            t = max(SINKHORN_TEMP * 2.0 ** (SINKHORN_STAGES - 1 - stage),
                    _EPS)
            e = rnd(np.exp(rnd(sc / rnd(t))))
            e = np.where(e < _F32_TINY, 0.0, e)
            kernels[stage] = kmask * e
        return kernels[stage]

    a = float(p_real)
    v = np.ones(len(counts))
    for i in range(SINKHORN_ITERS):
        k = kernel(min(SINKHORN_STAGES * i // SINKHORN_ITERS,
                       SINKHORN_STAGES - 1))
        u = rnd(a / max(float(rnd(np.sum(rnd(k * v)))), _EPS))
        col = rnd(u * k)
        v = np.minimum(rnd(b / np.maximum(col, _EPS)), 1.0)
    plan = rnd(rnd(u * kernel(SINKHORN_STAGES - 1)) * v)
    with np.errstate(divide="ignore"):
        lp = rnd(np.log(plan + 1e-30))
    return np.where(np.isfinite(lp) & feasible, lp, -1e30)


@dataclass
class Verdict:
    checked: int = 0
    misplaced: int = 0
    infeasible: int = 0
    worst_gap: float = 0.0
    #: the first misplaced pods, each with what the reference saw
    detail: list = field(default_factory=list)
    #: per chunk: (route, real pods, feasible (pod, node) pairs)
    chunks: list = field(default_factory=list)

    def add(self, other: "Verdict") -> None:
        self.checked += other.checked
        self.misplaced += other.misplaced
        self.infeasible += other.infeasible
        self.worst_gap = max(self.worst_gap, other.worst_gap)
        self.chunks.extend(other.chunks)
        self.detail.extend(other.detail[:max(0, 20 - len(self.detail))])


def _route(p_real: int) -> str:
    return "optimal" if p_real >= OPTIMAL_MIN_PODS else "greedy"


def _walk(cl: Cluster, tp: Template, start_counts, n_pods: int, chunk: int,
          forced=None, rnd=f64, ties: str = "low"):
    """Solve (forced None; ties to the lowest or, for a control, the
    highest index) or judge (forced: (n_pods,) node index, -1 for none)
    one dispatch. Returns (placements, Verdict)."""
    counts = np.array(start_counts, dtype=np.int64)
    start = counts.copy()
    n = len(counts)
    static = static_scores(cl, start, rnd)
    alloc_id = np.unique(np.concatenate(
        [cl.alloc, cl.pod_slots[:, None]], axis=1), axis=0,
        return_inverse=True)[1].reshape(-1)
    out = np.full(n_pods, -1, dtype=np.int64)
    verdict = Verdict()
    cap_ok = fits(cl, tp, counts, rnd)
    for lo in range(0, n_pods, chunk):
        p_real = min(chunk, n_pods - lo)
        route = _route(p_real)
        if route == "optimal":
            score = sinkhorn_log_plan(cl, tp, counts, static, p_real, rnd)
            eps = EPS_PLAN
        else:
            score = live_scores(cl, tp, counts, static, rnd)
            eps = EPS_SCORE
        # Nodes of one key are twins: the same allocatable and the same
        # pod count (at the chunk's start on the optimal route).
        key = alloc_id * (1 << 20) + counts
        evals = 0
        for i in range(lo, lo + p_real):
            n_ok = int(np.count_nonzero(cap_ok))
            evals += n_ok
            masked = np.where(cap_ok, score, -np.inf)
            best = masked.max() if n_ok else None
            if forced is None and ties == "high":
                pick = n - 1 - int(np.argmax(masked[::-1])) if n_ok else -1
            elif forced is None:
                pick = int(np.argmax(masked)) if n_ok else -1
            else:
                pick = int(forced[i])
                verdict.checked += 1
                if pick < 0:
                    verdict.misplaced += int(n_ok > 0)
                elif not cap_ok[pick]:
                    verdict.misplaced += 1
                    verdict.infeasible += 1
                else:
                    gap = float(best - score[pick])
                    verdict.worst_gap = max(verdict.worst_gap, gap)
                    twin = cap_ok[:pick] & (key[:pick] == key[pick])
                    if gap > eps or twin.any():
                        verdict.misplaced += 1
                        if len(verdict.detail) < 20:
                            b = int(np.argmax(masked))
                            verdict.detail.append({
                                "pod": i, "chunk": lo // chunk,
                                "route": route, "gap": gap,
                                "twin": bool(twin.any()),
                                "pick": [pick, int(start[pick]),
                                         int(counts[pick]),
                                         float(score[pick])],
                                "best": [b, int(start[b]), int(counts[b]),
                                         float(score[b])]})
            out[i] = pick
            if pick < 0:
                continue
            counts[pick] += 1
            one = slice(pick, pick + 1)
            sub = Cluster(cl.alloc[one], cl.pod_slots[one])
            cap_ok[pick] = fits(sub, tp, counts[one], rnd)[0]
            if route != "optimal":
                score[pick] = live_scores(sub, tp, counts[one], static[one],
                                          rnd)[0]
                key[pick] = alloc_id[pick] * (1 << 20) + counts[pick]
        verdict.chunks.append((route, p_real, evals))
    return out, verdict


def judge_dispatch(cl: Cluster, tp: Template, start_counts, placements,
                   chunk: int) -> Verdict:
    """Judge the placements of one dispatch, in dispatch order."""
    forced = np.asarray(placements, dtype=np.int64)
    return _walk(cl, tp, start_counts, len(forced), chunk, forced=forced)[1]


def solve_dispatch(cl: Cluster, tp: Template, start_counts, n_pods: int,
                   chunk: int, precision: str = "float64",
                   ties: str = "low") -> np.ndarray:
    """Place one dispatch of `n_pods` pods: (n_pods,) node index or -1.
    `ties` "high" (equal scores to the highest index, as an unordered
    atomic argmax would leave them) is the check's control; `precision`
    "bfloat16" is read beside it."""
    rnd = {"float64": f64, "bfloat16": bf16}[precision]
    return _walk(cl, tp, start_counts, n_pods, chunk, rnd=rnd, ties=ties)[0]


def free_occupied_pct(alloc, counts, req) -> float:
    """Mean over nodes holding a pod of the mean free share of allocatable
    cpu and memory, in % (0 for an empty cluster)."""
    occ = counts > 0
    if not occ.any():
        return 0.0
    used = counts[occ, None] * req[None, :]
    a = alloc[occ].astype(np.float64)
    free = np.maximum(0.0, (a - used) / np.where(a > 0, a, 1.0))
    return float(100.0 * free.mean(axis=1).mean())
