"""What decides `correct`: the run's result against the plain reference.

Every number compared has its limit here (see PERF.md for the readings
each limit was set from):

- store: `unbound` (pods created and never bound, a minute past the close),
  `rebinds` (a pod seen bound to a second node), `store_vs_dispatch` (a
  pod whose node in the store is not the one its dispatch assigned) and
  `state_breaks` (node entries where a dispatch's starting state does not
  follow from the store: more pods on a node than the store ends with, or
  fewer than the previous dispatch left);
- filter: `over_capacity` (nodes over allocatable cpu, memory or pod
  slots in the store's final state);
- score: `misplaced_per_kpod` (per 1,000 judged pods, those the reference
  would not put where they went; `reference/placement.py`), judged over
  every recorded dispatch, and `free_occupied_diff` (the harness's
  `free_occupied_pct` against the reference's own from the store).

The reference is NumPy and reads the program's outputs only to judge them;
its starting state per dispatch is the count of pods per node of the
snapshot the dispatch was given (the program's own state, checked by
`state_breaks`). Pods the scheduler placed outside a dispatch (its
single-pod fast path) are checked by the store and filter numbers only.
"""

from __future__ import annotations

import numpy as np

from schedbench.reference import placement
from schedbench.reference.quantity import milli

#: pod template fields the reference models; any other is refused.
MODELLED = {"requests", "limits", "labels"}
LIMITS = {
    "unbound": 0,
    "rebinds": 0,
    "store_vs_dispatch": 0,
    "state_breaks": 0,
    "node_order": 0,
    "over_capacity": 0,
    "misplaced_per_kpod": 50,
    "free_occupied_diff": 1e-9,
}


def reference_inputs(check_in: dict):
    """The reference's cluster (nodes in creation order) and template,
    worked out from the benchmark's own inputs."""
    nodes = check_in["nodes"]
    alloc = check_in["node_template"]["allocatable"]
    a = np.array([[milli(alloc["cpu"]), milli(alloc["memory"])]] * len(nodes),
                 dtype=np.int64)
    slots = np.full(len(nodes), int(alloc["pods"]), dtype=np.int64)
    cl = placement.Cluster(a, slots, [n for n, _l in nodes])
    pt = check_in["pod_template"]
    if set(pt) - MODELLED:
        raise ValueError(f"no reference for {sorted(set(pt) - MODELLED)}")
    req = np.array([milli(pt["requests"]["cpu"]),
                    milli(pt["requests"]["memory"])], dtype=np.int64)
    return cl, placement.Template(req)


def judge(check_in: dict, dispatches=None, placements=None) -> dict:
    """Numbers of the run. `placements`, when given, replaces each
    dispatch's assignments (list of (n,) node-index arrays): the control."""
    cl, tp = reference_inputs(check_in)
    name_idx = {n: i for i, n in enumerate(cl.names)}
    final = check_in["final"]
    created = check_in["created"]
    dispatches = check_in["dispatches"] if dispatches is None else dispatches
    out = {k: 0 for k in LIMITS}
    out["unbound"] = sum(1 for k in created if not final.get(k))
    out["rebinds"] = int(check_in["rebinds"])
    # Filter: the store's final state.
    counts = np.zeros(len(cl.names), dtype=np.int64)
    for k in created:
        node = final.get(k)
        if node:
            counts[name_idx[node]] += 1
    used = counts[:, None] * tp.req[None, :]
    out["over_capacity"] = int(np.sum(np.any(used > cl.alloc, axis=1)
                                      | (counts > cl.pod_slots)))
    # Score: every recorded dispatch, from its own starting state.
    verdict = placement.Verdict()
    per_dispatch = []
    prev_end = None
    for di, d in enumerate(dispatches):
        if len(d.counts) != len(cl.names) or d.first_node != cl.names[0] \
                or d.last_node != cl.names[-1]:
            out["node_order"] += 1
            per_dispatch.append([])
            continue
        out["state_breaks"] += int(np.sum(d.counts > counts))
        if prev_end is not None:
            out["state_breaks"] += int(np.sum(d.counts < prev_end))
        if placements is None:
            got = np.array([name_idx.get(d.assignments.get(k) or "", -1)
                            for k in d.keys], dtype=np.int64)
            out["store_vs_dispatch"] += sum(
                1 for k in d.keys if d.assignments.get(k)
                and final.get(k) != d.assignments[k])
        else:
            got = placements[di]
        v = placement.judge_dispatch(cl, tp, d.counts, got,
                                     int(check_in["chunk"]))
        for x in v.detail:
            x["dispatch"] = di
            x["dispatch_pods"] = len(d.keys)
        verdict.add(v)
        per_dispatch.append(v.chunks)
        prev_end = d.counts + np.bincount(got[got >= 0],
                                          minlength=len(cl.names))
    out["judged"] = verdict.checked
    out["misplaced"] = verdict.misplaced
    out["misplaced_per_kpod"] = 1e3 * verdict.misplaced / max(1,
                                                              verdict.checked)
    out["worst_gap"] = verdict.worst_gap
    out["detail"] = verdict.detail
    out["dispatch_chunks"] = per_dispatch
    return out


def control_placements(check_in: dict, precision: str = "float64",
                       ties: str = "high"):
    """The reference in the program's place, at `precision` and with
    `ties` (by default the check's control, ties to the highest index):
    its own placements of every recorded dispatch from that dispatch's
    state."""
    cl, tp = reference_inputs(check_in)
    return [placement.solve_dispatch(cl, tp, d.counts, len(d.keys),
                                     int(check_in["chunk"]), precision, ties)
            for d in check_in["dispatches"]]


def compared(numbers: dict) -> list[tuple[str, float, float]]:
    return [(k, float(numbers[k]), LIMITS[k]) for k in LIMITS
            if k in numbers]


def is_correct(rows) -> bool:
    return all(v <= lim for _k, v, lim in rows)
