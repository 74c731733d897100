"""Deterministic fault scheduler for the churn battery (SURVEY §5.3).

Faults are TIMELINE events, fixed before the run starts:
`build_fault_timeline(specs, seed)` resolves every randomizable choice
(which node dies, which pods roll) at build time with a seeded rng, so
the timeline — offsets, kinds, victims — is bit-identical across runs
with the same seed (the kwok-style hollow-node approach: faults are
staged data, not emergent races).

Kinds (performance-config.yaml `faults:` entries / bench --churn-fault):

- nodeDeath   — kill a NodeAgent (stop(graceful=False): tasks cancelled,
  no further writes, Node + Lease left to go STALE) and let the
  nodelifecycle controller's grace period notice, taint unreachable and
  evict. The injector recreates one replacement per displaced pod (the
  ReplicaSet's job in the reference) and measures time-to-recovery:
  every replacement bound AND queue backlog back under threshold.
- drain       — cordon (spec.unschedulable) + evict the node's pods
  (kubectl drain lifecycle), replacements recreated, recovery measured;
  uncordons at recovery.
- cordon / uncordon — lifecycle-only store writes (no recovery clock).
- rolloutWave — delete `count` bound pods and recreate them stamped with
  a new revision label (a deployment rollout wave's shape mid-churn).
- gangArrival — create `count` pods AT ONCE from `podTemplate` (e.g.
  high-priority, colliding with the r6 preemption and r9 policy paths);
  recovery = the whole gang bound. With `sliceShape: [s0, s1(, s2)]`
  the gang is SLICE-SHAPED (topology/): a PodGroup with that shape is
  created first, every pod carries its group label, count defaults to
  prod(shape), and recovery means the whole gang bound as one
  contiguous sub-mesh (Coscheduling Permit enforces the contiguity).
- sliceDeath — kill a member node out from under a bound slice gang
  (`group` names the gang — a prior gangArrival's `slice-<at_ms>`):
  cordon + agent-kill the first member's node, delete the gang's pods
  and PodGroup, then recreate the gang under `<group>-r<at_ms>` with
  the same `sliceShape`; recovery = the replacement gang RE-COALESCED
  on a fresh contiguous sub-mesh that avoids the dead cell — the
  ChurnSlicePacking family's time-to-re-coalesce headline.
- killLeader  — SIGKILL the ACTIVE scheduler process mid-wave
  (multi-process runs only: multiproc/controlplane.py). The standby must win the lease
  by EXPIRY, rebuild its assume-cache from fresh informer LISTs, and
  resume; recovery = `count` canary pods created at kill time all
  bound + backlog under threshold — the end-to-end failover
  time-to-recovery the r22 ChurnDay row records.

Each fault runs as its own task so recovery tracking never delays later
timeline events; `churn_faults_injected_total{kind}` counts injections
in the metrics registry (ChurnMetrics).

Copy of `kubernetes_tpu/perf/churn/faults.py`, with these departures:

- no fallback: where the reference logs an exception of a fault handler
  (or an unknown kind) and records `recovered: False`, here the first
  such exception propagates out of `drain()` once every handler has
  ended; a handler's own store errors are still absorbed as in the
  reference (a create or delete that races the run);
- not here yet: `killLeader` needs the multi-process control plane
  (`multiproc/`), ROADMAP queue 1 item 9; its handler raises
  NotImplementedError. `build_fault_timeline` resolves every kind as the
  reference does.
"""

from __future__ import annotations

import asyncio
import copy
import logging
import math
import random
import time
from typing import Any, Callable, Mapping

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.perf.churn.arrivals import stable_seed
from kubernetes_tpu_torch.store.mvcc import StoreError

logger = logging.getLogger(__name__)

#: recovery polling tick (coarse enough to stay off the hot path, fine
#: enough that sub-second recoveries resolve).
_POLL = 0.02


class FaultEvent:
    """One scheduled fault: `at` seconds after phase start."""

    __slots__ = ("at", "kind", "params")

    def __init__(self, at: float, kind: str, params: dict | None = None):
        self.at = float(at)
        self.kind = kind
        self.params = dict(params or {})

    def signature(self) -> tuple:
        """Deterministic identity (the timeline-equality contract tests
        compare): offset, kind, and the sorted resolved params."""
        return (round(self.at, 9), self.kind,
                tuple(sorted((k, str(v)) for k, v in self.params.items())))

    def __repr__(self) -> str:  # debugging/log readability
        return f"FaultEvent(at={self.at:.3f}, kind={self.kind}, " \
               f"params={self.params})"


def build_fault_timeline(specs: list[Mapping], seed: int = 0,
                         node_names: list[str] | None = None,
                         ) -> list[FaultEvent]:
    """Resolve `faults:` specs into a sorted, fully-determined timeline.

    Randomizable choices (a nodeDeath/drain with no explicit `node`, a
    rolloutWave's victim offset) are fixed HERE with a seeded rng so the
    run replays; `node_names` is the candidate pool (agent-backed node
    names, in boot order)."""
    rng = random.Random(stable_seed("faults", seed,
                                    len(specs), len(node_names or [])))
    events: list[FaultEvent] = []
    for i, spec in enumerate(specs):
        kind = str(spec.get("kind", ""))
        params = {k: v for k, v in spec.items()
                  if k not in ("at", "kind")}
        if kind in ("nodeDeath", "drain", "cordon", "uncordon") \
                and "node" not in params:
            pool = node_names or []
            if not pool:
                raise ValueError(
                    f"fault #{i} ({kind}) needs a node: no agent-backed "
                    "nodes to pick from and no explicit 'node'")
            params["node"] = pool[rng.randrange(len(pool))]
        if kind == "rolloutWave":
            params.setdefault("count", 10)
            # Victim selection offset into the sorted bound set, fixed
            # now so two runs roll the same slice.
            params.setdefault("offset", rng.randrange(1 << 16))
        if kind == "gangArrival":
            shape = params.get("sliceShape")
            params.setdefault(
                "count", math.prod(int(s) for s in shape) if shape else 8)
        if kind == "sliceDeath":
            # Both are identity, not chance: the timeline must say WHICH
            # gang dies and what shape re-coalesces.
            for req in ("group", "sliceShape"):
                if req not in params:
                    raise ValueError(
                        f"fault #{i} (sliceDeath) needs {req!r}")
        if kind == "killLeader":
            # Canary pods probing scheduling liveness across failover.
            params.setdefault("count", 8)
        events.append(FaultEvent(float(spec.get("at", 0.0)), kind, params))
    events.sort(key=lambda e: (e.at, e.kind))
    return events


class FaultInjector:
    """Executes a fault timeline against a live churn run.

    The harness (perf/scheduler_perf.py churnOpenLoop) supplies the run's
    seams: the store, the agent fleet (node death's kill target), the
    informer-fed bound-key set, a replacement-pod factory that rides the
    run's accounting, and the scheduler queue's backlog gauge."""

    def __init__(self, *, store, agents: list,
                 bound_keys: set[str],
                 create_pod: Callable[..., Any],
                 backlog_fn: Callable[[], int],
                 metrics=None,
                 pod_template: Mapping | None = None,
                 recovery_threshold: int = 10,
                 recovery_timeout: float = 60.0,
                 namespace: str = "default",
                 clock: Callable[[], float] = time.monotonic):
        self.store = store
        self.agents = {a.node_name: a for a in agents}
        self.bound_keys = bound_keys
        self.create_pod = create_pod
        self.backlog_fn = backlog_fn
        self.metrics = metrics
        self.pod_template = dict(pod_template or {})
        self.recovery_threshold = int(recovery_threshold)
        self.recovery_timeout = float(recovery_timeout)
        self.namespace = namespace
        self.clock = clock
        #: one record per injected fault, timeline order:
        #: {kind, at, node?, displaced_pods, replacements, recovery_s,
        #:  recovered}
        self.results: list[dict] = []
        self._tasks: list[asyncio.Task] = []
        #: net pods created minus deleted by fault handlers (the runner
        #: folds this into its created_total so later barriers balance).
        self.net_created = 0

    # -- lifecycle ---------------------------------------------------------

    async def run(self, timeline: list[FaultEvent], t0: float) -> None:
        """Fire every event at its offset (absolute clock anchored at
        t0); handlers run as tasks so one fault's recovery wait never
        delays the next injection. Await `drain()` for the results."""
        for ev in timeline:
            delay = (t0 + ev.at) - self.clock()
            if delay > 0:
                await asyncio.sleep(delay)
            rec = {"kind": ev.kind, "at": round(ev.at, 3),
                   "displaced_pods": 0, "replacements": 0,
                   "recovery_s": None, "recovered": None}
            if "node" in ev.params:
                rec["node"] = ev.params["node"]
            self.results.append(rec)
            if self.metrics is not None:
                self.metrics.faults_injected.inc(kind=ev.kind)
            self._tasks.append(asyncio.ensure_future(
                self._fire(ev, rec)))

    async def drain(self) -> None:
        """Wait for every in-flight fault handler (recovery clocks
        included) — bounded by each handler's own recovery_timeout —
        then raise the first exception a handler ended with."""
        outcomes = []
        if self._tasks:
            outcomes = await asyncio.gather(*self._tasks,
                                            return_exceptions=True)
        self._tasks.clear()
        for out in outcomes:
            if isinstance(out, Exception):
                raise out

    async def cancel(self) -> None:
        """Cancel every in-flight handler and wait for them; raises
        nothing (the run that cancels is already ending)."""
        for t in self._tasks:
            t.cancel()
        if self._tasks:
            await asyncio.gather(*self._tasks, return_exceptions=True)
        self._tasks.clear()

    async def _fire(self, ev: FaultEvent, rec: dict) -> None:
        handler = getattr(self, f"_do_{ev.kind}", None)
        if handler is None:
            rec["recovered"] = False
            raise ValueError(f"unknown fault kind {ev.kind!r}")
        try:
            await handler(ev, rec)
        except Exception:
            rec["recovered"] = False
            raise

    # -- kinds -------------------------------------------------------------

    async def _do_nodeDeath(self, ev: FaultEvent, rec: dict) -> None:
        node = ev.params["node"]
        displaced = await self._pods_on(node)
        agent = self.agents.get(node)
        t_kill = self.clock()
        if agent is not None:
            # The death itself: tasks cancelled, no further writes; the
            # Lease goes stale and the nodelifecycle controller's grace
            # period decides when the cluster notices.
            await agent.stop(graceful=False)
        else:
            # createNodes staging (no agent to kill): the closest honest
            # analog is deleting the Node object outright.
            try:
                await self.store.delete("nodes", node)
            except StoreError:
                pass
        rec["displaced_pods"] = len(displaced)
        await self._replace_and_recover(
            ev, rec, displaced, t_kill,
            wait_eviction=agent is not None)

    async def _do_drain(self, ev: FaultEvent, rec: dict) -> None:
        node = ev.params["node"]
        t0 = self.clock()
        await self._set_unschedulable(node, True)
        displaced = await self._pods_on(node)
        rec["displaced_pods"] = len(displaced)
        for p in displaced:
            try:
                await self.store.delete("pods", namespaced_name(p))
                self.net_created -= 1
            except StoreError:
                pass
        await self._replace_and_recover(ev, rec, displaced, t0,
                                        wait_eviction=False)
        if ev.params.get("uncordon", True):
            await self._set_unschedulable(node, False)

    async def _do_cordon(self, ev: FaultEvent, rec: dict) -> None:
        await self._set_unschedulable(ev.params["node"], True)
        rec["recovered"] = True

    async def _do_uncordon(self, ev: FaultEvent, rec: dict) -> None:
        await self._set_unschedulable(ev.params["node"], False)
        rec["recovered"] = True

    async def _do_rolloutWave(self, ev: FaultEvent, rec: dict) -> None:
        count = int(ev.params["count"])
        bound = sorted(self.bound_keys)
        if not bound:
            rec["recovered"] = True
            return
        start = int(ev.params.get("offset", 0)) % len(bound)
        # stride > 1 scatters the victims across the sorted bound set —
        # name order tracks packing order, so a strided slice punches
        # holes in MANY nodes instead of emptying a contiguous few. With
        # replace=false that is the descheduler's adversary: a canceled
        # rollout (scale-down) stranding survivors on half-empty nodes
        # that arrival-order placement never revisits.
        stride = max(1, int(ev.params.get("stride", 1)))
        victims = list(dict.fromkeys(
            bound[(start + i * stride) % len(bound)]
            for i in range(min(count, len(bound)))))
        t0 = self.clock()
        rec["displaced_pods"] = len(victims)
        for key in victims:
            try:
                await self.store.delete("pods", key)
                self.net_created -= 1
            except StoreError:
                pass
        if not ev.params.get("replace", True):
            rec["replacements"] = 0
            rec["recovered"] = True
            return
        tmpl = {**self.pod_template,
                "labels": {**(self.pod_template.get("labels") or {}),
                           "rollout": f"wave-{round(ev.at * 1e3)}"}}
        names = [f"roll-{round(ev.at * 1e3)}-{i}"
                 for i in range(len(victims))]
        await self._create_many(names, tmpl)
        rec["replacements"] = len(names)
        await self._await_bound(names, rec, t0)

    async def _do_gangArrival(self, ev: FaultEvent, rec: dict) -> None:
        count = int(ev.params["count"])
        tmpl = {**self.pod_template, **(ev.params.get("podTemplate") or {})}
        ns = tmpl.get("namespace", self.namespace)
        shape = ev.params.get("sliceShape")
        if shape:
            # Slice-shaped gang: the PodGroup (with sliceShape) must
            # exist BEFORE the pods so Coscheduling/TopologySlice see a
            # resolvable group from the first attempt.
            group = str(ev.params.get("group",
                                      f"slice-{round(ev.at * 1e3)}"))
            tmpl = await self._create_slice_group(group, shape, tmpl, ns)
            names = [f"{group}-{i}" for i in range(count)]
        else:
            names = [f"gang-{round(ev.at * 1e3)}-{i}" for i in range(count)]
        t0 = self.clock()
        await self._create_many(names, tmpl)
        rec["replacements"] = count
        # The gang may land in the fault template's own namespace — the
        # bound-key wait must watch THAT one, not the injector default.
        await self._await_bound(names, rec, t0, namespace=ns)

    async def _do_sliceDeath(self, ev: FaultEvent, rec: dict) -> None:
        from kubernetes_tpu_torch.scheduler.plugins.coscheduling import (
            POD_GROUP_LABEL,
        )
        group = str(ev.params["group"])
        shape = [int(s) for s in ev.params["sliceShape"]]
        tmpl = {**self.pod_template, **(ev.params.get("podTemplate") or {})}
        ns = tmpl.get("namespace", self.namespace)
        try:
            pods = (await self.store.list("pods")).items
        except StoreError:
            pods = []
        members = sorted(
            (p for p in pods
             if (p.get("metadata", {}).get("labels") or {})
             .get(POD_GROUP_LABEL) == group
             and p.get("metadata", {}).get("namespace", "default") == ns),
            key=lambda p: p["metadata"]["name"])
        if not members:
            logger.error("sliceDeath: gang %s has no pods — skipped", group)
            rec["recovered"] = False
            return
        # Kill the first member's node: cordon (the scheduler must not
        # re-place onto the corpse — the bench has no kubelet ack, so an
        # un-cordoned dead node would still "bind") and stop its agent.
        victim = next((p["spec"].get("nodeName") for p in members
                       if p["spec"].get("nodeName")), None)
        t_kill = self.clock()
        if victim is not None:
            rec["node"] = victim
            await self._set_unschedulable(victim, True)
            agent = self.agents.get(victim)
            if agent is not None:
                await agent.stop(graceful=False)
        rec["displaced_pods"] = len(members)
        for p in members:
            try:
                await self.store.delete("pods", namespaced_name(p))
                self.net_created -= 1
            except StoreError:
                pass
        try:
            await self.store.delete("podgroups", f"{ns}/{group}")
        except StoreError:
            pass
        # Re-coalesce: the same shape under a fresh group name must find
        # a contiguous sub-mesh that routes around the dead cell.
        regroup = f"{group}-r{round(ev.at * 1e3)}"
        tmpl = await self._create_slice_group(regroup, shape, tmpl, ns)
        names = [f"{regroup}-{i}" for i in range(math.prod(shape))]
        await self._create_many(names, tmpl)
        rec["replacements"] = len(names)
        await self._await_bound(names, rec, t_kill, namespace=ns)

    async def _create_slice_group(self, group: str, shape, tmpl: Mapping,
                                  ns: str) -> dict:
        """Create the slice-shaped PodGroup and return the pod template
        stamped with its membership label."""
        from kubernetes_tpu_torch.scheduler.plugins.coscheduling import (
            POD_GROUP_LABEL,
            make_pod_group,
        )
        count = math.prod(int(s) for s in shape)
        try:
            await self.store.create("podgroups", make_pod_group(
                group, min_member=count, namespace=ns, slice_shape=shape))
        except StoreError:
            logger.warning("slice gang PodGroup %s create failed", group)
        return {**tmpl,
                "labels": {**(tmpl.get("labels") or {}),
                           POD_GROUP_LABEL: group}}

    async def _do_killLeader(self, ev: FaultEvent, rec: dict) -> None:
        raise NotImplementedError(
            "killLeader needs the multi-process control plane "
            "(multiproc/), which is not ported (ROADMAP queue 1 item 9)")

    async def _pods_on(self, node: str) -> list[dict]:
        try:
            lst = await self.store.list(
                "pods", fields={"spec.nodeName": node})
            return list(lst.items)
        except StoreError:
            return []

    async def _set_unschedulable(self, node: str, value: bool) -> None:
        def mutate(obj):
            if value:
                obj.setdefault("spec", {})["unschedulable"] = True
            else:
                obj.get("spec", {}).pop("unschedulable", None)
            return obj
        try:
            await self.store.guaranteed_update(
                "nodes", node, mutate, return_copy=False)
        except StoreError:
            pass

    async def _create_many(self, names: list[str], tmpl: Mapping) -> None:
        for name in names:
            try:
                await self.create_pod(name, copy.deepcopy(dict(tmpl)))
                self.net_created += 1
            except StoreError:
                logger.warning("fault replacement create %s failed", name)

    async def _replace_and_recover(self, ev: FaultEvent, rec: dict,
                                   displaced: list[dict],
                                   t0: float, *,
                                   wait_eviction: bool) -> None:
        """The ReplicaSet's half of recovery: once a displaced pod's
        eviction delete lands (observed via the bound-key set), recreate
        a replacement; recovery = every replacement bound + backlog back
        under threshold."""
        keys = [namespaced_name(p) for p in displaced]
        deadline = t0 + self.recovery_timeout
        if wait_eviction and keys:
            # Node death: eviction is the lifecycle controller's move
            # (taint after grace, evict after tolerationSeconds).
            while any(k in self.bound_keys for k in keys) \
                    and self.clock() < deadline:
                await asyncio.sleep(_POLL)
            self.net_created -= sum(
                1 for k in keys if k not in self.bound_keys)
        suffix = f"r{round(ev.at * 1e3)}"
        names = [f"{k.rsplit('/', 1)[-1]}-{suffix}" for k in keys]
        await self._create_many(names, self.pod_template)
        rec["replacements"] = len(names)
        await self._await_bound(names, rec, t0, deadline=deadline)

    async def _await_bound(self, names: list[str], rec: dict,
                           t0: float, deadline: float | None = None,
                           namespace: str | None = None) -> None:
        want = {f"{namespace or self.namespace}/{n}" for n in names}
        if deadline is None:
            deadline = t0 + self.recovery_timeout
        while self.clock() < deadline:
            if want <= self.bound_keys \
                    and self.backlog_fn() <= self.recovery_threshold:
                dt = self.clock() - t0
                rec["recovery_s"] = round(dt, 3)
                rec["recovered"] = True
                if self.metrics is not None:
                    self.metrics.recovery_seconds.inc(dt, kind=rec["kind"])
                return
            await asyncio.sleep(_POLL)
        rec["recovered"] = False
