"""The port's scheduling queue on the CPU against the JAX package's.

One seeded sequence of adds (random priorities, some pods gated by
SchedulingGates), pops (blocking and non-blocking), failures parked
unschedulable (with the plugins that rejected them), backoffs, cluster
events (QueueingHints registered from the plugins' EVENTS, as the
scheduler registers them), gate removals, deletes, completions and clock
advances, under an injected clock, through both packages' SchedulingQueue
with PrioritySort and SchedulingGates: the same pods pop in the same
order, and `stats()`, the pods' attempt counts and the moved counts are
the same after every step.

Tolerance: none.
"""

import asyncio

import numpy as np
import pytest

from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import queue as jqueue
from kubernetes_tpu.scheduler import types as jsched_types
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import queue as tqueue
from kubernetes_tpu_torch.scheduler import types as tsched_types
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry

PACKAGES = {"jax": (jtypes, jframework, jqueue, jsched_types, jregistry),
            "port": (ttypes, tframework, tqueue, tsched_types, tregistry)}
PROFILE = ["PrioritySort", "SchedulingGates", "NodeUnschedulable",
           "TaintToleration", "NodeResourcesFit"]
EVENTS = ["Node/Add", "Node/Update", "Pod/Delete", "Pod/Add", "Pod/Update"]
PLUGINS = ["NodeResourcesFit", "TaintToleration", "NodeUnschedulable"]


def script(seed: int, steps: int = 400) -> list[tuple]:
    rng = np.random.default_rng(seed)
    ops = []
    for step in range(steps):
        u = rng.random()
        if u < 0.3:
            ops.append(("add", f"p{step}", int(rng.integers(0, 4)),
                        bool(rng.random() < 0.15)))
        elif u < 0.45:
            ops.append(("pop", int(rng.integers(1, 6))))
        elif u < 0.55:
            ops.append(("fail", str(rng.choice(PLUGINS))))
        elif u < 0.6:
            ops.append(("backoff",))
        elif u < 0.67:
            ops.append(("done",))
        elif u < 0.75:
            ops.append(("event", [str(e) for e in rng.choice(
                EVENTS, size=int(rng.integers(1, 3)), replace=False)]))
        elif u < 0.8:
            ops.append(("ungate",))
        elif u < 0.85:
            ops.append(("delete",))
        elif u < 0.9:
            ops.append(("flush",))
        else:
            ops.append(("tick", float(rng.choice([0.3, 1.1, 4.0, 70.0]))))
    return ops


async def play(pkg, ops, seed: int) -> list:
    types, framework, queue, sched_types, registry = PACKAGES[pkg]
    fwk = framework.Framework(registry.build_plugins(PROFILE),
                              registry.DEFAULT_SCORE_WEIGHTS)
    now = [100.0]
    q = queue.SchedulingQueue(fwk, clock=lambda: now[0])
    for plugin in fwk.plugins:  # Scheduler._register_default_hints
        for label in getattr(plugin, "EVENTS", []):
            q.register_hint(label, plugin.NAME, lambda pi, ev: "Queue")
    rng = np.random.default_rng(seed + 1000)  # picks among live pods
    popped: list = []        # in flight, in pop order
    gated: dict = {}
    out = []
    for op in ops:
        kind = op[0]
        if kind == "add":
            _, name, prio, gate = op
            pod = types.make_pod(name, priority=prio, scheduling_gates=(
                ["wait"] if gate else None))
            pi = sched_types.PodInfo(pod)
            if gate:
                gated[name] = pod
            await q.add(pi)
            res = None
        elif kind == "pop":
            if q.stats()["active"]:
                got = await q.pop_batch(op[1])
            else:
                got = await q.pop_now(op[1])
            popped.extend(got)
            res = [(p.key, p.attempts) for p in got]
        elif kind in ("fail", "backoff", "done") and popped:
            pi = popped.pop(int(rng.integers(0, len(popped))))
            if kind == "fail":
                pi.unschedulable_plugins = {op[1]}
                await q.add_unschedulable(pi)
            elif kind == "backoff":
                await q.move_to_backoff(pi)
            else:
                await q.done(pi.key)
            res = pi.key
        elif kind == "event":
            res = await q.move_all_batch(
                [queue.ClusterEvent(*e.split("/")) for e in op[1]])
        elif kind == "ungate" and gated:
            name = sorted(gated)[int(rng.integers(0, len(gated)))]
            pod = gated.pop(name)
            pod["spec"].pop("schedulingGates")
            await q.update(sched_types.PodInfo(pod))
            res = name
        elif kind == "delete":
            keys = sorted(set(q._active_keys) | set(q._backoff_keys)
                          | set(q._unschedulable))
            res = None
            if keys:
                key = keys[int(rng.integers(0, len(keys)))]
                await q.delete(key)
                res = key
        elif kind == "flush":
            res = await q.flush_unschedulable_leftover()
        elif kind == "tick":
            now[0] += op[1]
            res = op[1]
        else:
            res = "skip"
        out.append((op, res, q.stats(), q.has_parked(), q.backlog_depth()))
    await q.close()
    out.append([p.key for p in await q.pop_batch(5)])
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_queue_sequence_matches_reference(seed):
    ops = script(seed)
    want = asyncio.run(play("jax", ops, seed))
    got = asyncio.run(play("port", ops, seed))
    assert got == want
    pops = [r for op, r, *_ in want[:-1] if op[0] == "pop" and r]
    assert len(pops) > 20
    assert any(a > 1 for batch in pops for _, a in batch)  # retries
    assert max(s["gated"] for *_, s, _, _ in want[:-1]) > 0
    assert max(s["unschedulable"] for *_, s, _, _ in want[:-1]) > 0
    assert max(s["backoff"] for *_, s, _, _ in want[:-1]) > 0
