"""The scheduler: queue → cycle → assume → (async) bind.

Parity target: pkg/scheduler/scheduler.go + schedule_one.go
(`Scheduler.Run` → `ScheduleOne`; `schedulingCycle` (synchronous hot path:
snapshot → PreFilter → findNodesThatFitPod → prioritizeNodes → selectHost →
assume → Reserve → Permit) and `bindingCycle` (async task: WaitOnPermit →
PreBind → Bind → PostBind)); eventhandlers.go (`addAllEventHandlers`).

Two execution modes share every seam:

- `run_one()` — the reference-shaped one-pod-per-cycle loop (the oracle).
- `run_batched(max_batch=P)` — drains up to P pods per cycle and hands the
  whole batch to a backend (host greedy or the batched device solver); intra-batch
  resource contention is resolved by the backend before any assume happens.

`percentageOfNodesToScore` is honored on the host path for parity
(numFeasibleNodesToFind: adaptive 50 - N/125, floor 5%); the batched
backend scores every node because full-N is one tensor op (SURVEY §2.8).

Copy of `kubernetes_tpu/scheduler/scheduler.py`, with these departures:

- no fallback: the reference catches any backend exception, including
  one of its chunk stream (`assign_stream`) before or after the first
  chunk, runs the batch's pods not yet yielded through the host path and
  opens a circuit after three failures; here a backend or stream
  exception propagates out of `run` (a failure of the card or a kernel
  must not be hidden), the pods of chunks not yet yielded are not re-run,
  and the `backend_fallback` attempt result is never counted. Nor does
  the stream's failure wave move a pod to backoff when `_handle_failure`
  raises: that propagates too. The host path itself is here: a one-pod
  dispatch takes it by design, as in the reference.
- no fallback for the batched victim proposal either: the reference logs
  a `DefaultPreemption.prime_wave` failure and goes on with the per-pod
  candidate search; here it propagates out of `run` like any other
  failure of the card.
- the preemptor's and the slice plan's device: DefaultPreemption's
  `prime_wave` and TopologySlice's scan run on the attached backend's
  device (cuda:0 when the plugin has none set).
- a batched placement of a pod with PersistentVolumeClaims binds with
  VolumeBinding's PreFilter state (`_bind_state`): the reference binds
  every batched placement with an empty CycleState, so its VolumeBinding
  PreBind never writes the selected node nor waits, and a
  WaitForFirstConsumer claim of a pod the backend placed is never
  provisioned (a fault of the reference, ROADMAP queue 3).
"""

from __future__ import annotations

import asyncio
import logging
import random
import time
from typing import Mapping

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.api.types import pod_is_terminal
from kubernetes_tpu_torch.client import EventRecorder, InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.metrics.registry import (
    ReadCounter,
    RecorderSummary,
    SchedulerMetrics,
)
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.utils import flags
from kubernetes_tpu_torch.scheduler.framework import (
    CycleState,
    Framework,
    Status,
    UNSCHEDULABLE_AND_UNRESOLVABLE,
)
from kubernetes_tpu_torch.scheduler.plugins.defaultpreemption import (
    DefaultPreemption,
)
from kubernetes_tpu_torch.scheduler.plugins.topologyslice import (
    TopologySlice,
)
from kubernetes_tpu_torch.scheduler.plugins.registry import (
    DEFAULT_SCORE_WEIGHTS,
    build_plugins,
)
from kubernetes_tpu_torch.scheduler.queue import (
    ClusterEvent,
    SchedulingQueue,
    wait_start,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot
from kubernetes_tpu_torch.utils.trace import Trace
from kubernetes_tpu_torch.utils.tracing import (
    range_end,
    range_start,
    traceparent_of,
)

logger = logging.getLogger(__name__)


class FitError(Exception):
    def __init__(self, pod: PodInfo, num_nodes: int, statuses: Mapping[str, Status]):
        self.pod = pod
        self.num_nodes = num_nodes
        self.statuses = statuses
        # The batched backend's DiagMap precomputes the counts (re-counting
        # N-entry maps per failed pod dominated dense failure waves).
        reasons = getattr(statuses, "reason_counts", None)
        if reasons is None:
            reasons = {}
            for st in statuses.values():
                for r in st.reasons:
                    reasons[r] = reasons.get(r, 0) + 1
        msg = ", ".join(f"{n} {r}" for r, n in sorted(reasons.items()))
        super().__init__(
            f"0/{num_nodes} nodes are available: {msg}" if msg
            else f"0/{num_nodes} nodes are available")


class ScheduleResult:
    __slots__ = ("node", "evaluated", "feasible")

    def __init__(self, node: str, evaluated: int, feasible: int):
        self.node = node
        self.evaluated = evaluated
        self.feasible = feasible


class Scheduler:
    def __init__(
        self,
        store,
        profiles: Mapping[str, Framework] | None = None,
        percentage_of_nodes_to_score: int = 0,
        seed: int = 0,
        metrics: SchedulerMetrics | None = None,
        backend=None,
        pod_initial_backoff: float = 1.0,
        pod_max_backoff: float = 10.0,
        trace_threshold_ms: float | None = None,
        tracer=None,
    ):
        self.store = store
        self.metrics = metrics or SchedulerMetrics()
        #: OTel-style spans (§5.1); same default process tracer as the
        #: apiserver so one tracer assembles the whole pod journey.
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        self.tracer = tracer if tracer is not None else DEFAULT_TRACER
        if profiles is None:
            plugins = build_plugins(store=store)
            fwk = Framework(plugins, DEFAULT_SCORE_WEIGHTS, metrics=self.metrics)
            profiles = {"default-scheduler": fwk}
        self.profiles = dict(profiles)
        for fwk in self.profiles.values():
            if fwk.metrics is None:
                fwk.metrics = self.metrics
            if getattr(fwk, "tracer", None) is None:
                fwk.tracer = self.tracer
            for p in fwk.plugins:
                # Plugins needing the frameworkHandle analog (Permit
                # allow/reject — e.g. Coscheduling) get the scheduler.
                if hasattr(p, "set_scheduler"):
                    p.set_scheduler(self)
            for p in fwk.post_filter_plugins:
                if isinstance(p, DefaultPreemption):
                    p.framework = fwk
                    if p.evict is None:
                        p.evict = self._preemption_evict
        self.cache = SchedulerCache()
        default_fwk = next(iter(self.profiles.values()))
        self.queue = SchedulingQueue(
            default_fwk, initial_backoff=pod_initial_backoff,
            max_backoff=pod_max_backoff)
        self.percentage_of_nodes_to_score = percentage_of_nodes_to_score
        #: utiltrace threshold: scheduling attempts slower than this log a
        #: step-by-step latency trace (SURVEY §5.1). None defaults from
        #: KTPU_TRACE_THRESHOLD_MS (the tracer's tree-dump threshold
        #: reads the same variable), else the reference's 100ms.
        if trace_threshold_ms is None:
            env = flags.get("KTPU_TRACE_THRESHOLD_MS")
            trace_threshold_ms = env if env is not None else 100.0
        self.trace_threshold_ms = trace_threshold_ms
        self.rng = random.Random(seed)
        self.backend = None  # batched backend; None = host path
        if backend is not None:
            self.attach_backend(backend)
        #: Profiles the batched backend serves (per-profile gate);
        #: None = all profiles (constructor-injected backend, old behavior).
        self.backend_profiles: set[str] | None = None
        self.extenders: list = []
        #: serving.ServingTier (admission window + resident planes +
        #: single-pod fast path), attached lazily at run()-loop entry by
        #: serving.maybe_attach_serving — flagless when a batched
        #: backend is present; KTPU_SERVING=0 keeps it None and the
        #: loop structurally identical to the pre-serving shape.
        self.serving = None
        self.recorder = EventRecorder(store, "default-scheduler")
        #: cumulative host seconds of the cycle path's snapshots
        #: (`snapshot_s`), of assume + Reserve + Permit + the binding
        #: task's spawn per pod (`assume_s`), and of the binding cycles
        #: from PreBind to `queue.done` (`bind_s`: the bind's store write
        #: and the "Scheduled" event's buffering included); `bound`
        #: counts the pods bound. The sections never nest in one another,
        #: nor in the informers' `apply_s` or the recorder's `drain_s`.
        #: `bind_s` and `drain_s` are wall time across awaits: they are
        #: the sections' own only while those awaits do not suspend, as
        #: with a store in this process and an uncontended queue; over a
        #: wire the store write suspends, and they also count what other
        #: tasks ran meanwhile. Rendered through `metrics.registry`
        #: (`_register_clocks`).
        self.timings = {"snapshot_s": 0.0, "assume_s": 0.0, "bind_s": 0.0,
                        "bound": 0}
        self._register_clocks()
        self._informer_factory: InformerFactory | None = None
        self._binding_tasks: set[asyncio.Task] = set()
        self._permit_waiters: dict[str, asyncio.Future] = {}
        self._stop = False
        #: consecutive nominee-check failures per preemptor retry: the
        #: first few failures requeue cheaply (victim deletes are still
        #: landing); persistent failure falls to the full batch path,
        #: which can re-preempt (the nominee may have been stolen).
        self._nominee_fails: dict[str, int] = {}
        #: tick-coalesced cluster events (label-deduped) for ONE
        #: move_all_batch scan per loop tick — see _move_all_soon.
        self._pending_moves: dict[str, ClusterEvent] = {}
        self._move_scheduled = False
        self._register_default_hints(default_fwk)

    def _register_clocks(self) -> None:
        """Render the host clocks and the pod-stage recorders through the
        scheduler's metrics registry, read at render time:
        `scheduler_host_seconds_total{section}` (the informers' `apply_s`
        summed, `snapshot_s`, `assume_s`, `bind_s`, the recorder's
        `drain_s`: sections that never nest, so they sum against the
        wall), `scheduler_pods_bound_total`, and the summaries
        `scheduler_queue_wait_seconds` and
        `scheduler_informer_watch_lag_seconds{resource}`."""
        tm, drain = self.timings, self.recorder.timings

        def informers():
            f = self._informer_factory
            return list(f._informers.values()) if f is not None else []

        r = self.metrics.registry
        ReadCounter(
            "scheduler_host_seconds_total",
            "Host seconds of the scheduler's sections (wall across awaits: "
            "the section's own with a store in this process)",
            lambda: {"informer_apply": sum(i.timings["apply_s"]
                                           for i in informers()),
                     "snapshot": tm["snapshot_s"], "assume": tm["assume_s"],
                     "bind": tm["bind_s"], "event_drain": drain["drain_s"]},
            label="section").register_into(r)
        ReadCounter("scheduler_pods_bound_total",
                    "Pods the binding cycle bound",
                    lambda: {"": tm["bound"]}).register_into(r)
        RecorderSummary(
            "scheduler_queue_wait_seconds",
            "Wait in activeQ of each pop, over the recorder's retained pops",
            lambda: {"": self.queue.wait}).register_into(r)
        RecorderSummary(
            "scheduler_informer_watch_lag_seconds",
            "From the store's record of an event to the informer's "
            "handlers' return, over the retained events (a store in this "
            "process)",
            lambda: {i.resource: i.lag for i in informers()},
            label="resource").register_into(r)

    def _snapshot(self) -> Snapshot:
        """`cache.update_snapshot()`, timed into `timings["snapshot_s"]`."""
        rng = range_start("scheduler.snapshot")
        t0 = time.perf_counter()
        try:
            return self.cache.update_snapshot()
        finally:
            self.timings["snapshot_s"] += time.perf_counter() - t0
            range_end(rng)

    def _move_all_soon(self, event: ClusterEvent) -> None:
        """Coalesce same-tick cluster events into one queue scan: an
        informer burst (e.g. a preemption wave's victim deletes) fires
        one move_all_batch instead of one full-parked-set scan per event."""
        self._pending_moves[event.label] = event
        if not self._move_scheduled:
            self._move_scheduled = True
            asyncio.get_event_loop().call_soon(self._drain_moves)

    def _drain_moves(self) -> None:
        self._move_scheduled = False
        events = list(self._pending_moves.values())
        self._pending_moves.clear()
        if events:
            asyncio.ensure_future(self.queue.move_all_batch(events))

    # ------------------------------------------------------------------
    # wiring (eventhandlers.go addAllEventHandlers)
    # ------------------------------------------------------------------

    def _register_default_hints(self, fwk: Framework) -> None:
        for plugin in fwk.plugins:
            for label in getattr(plugin, "EVENTS", []):
                self.queue.register_hint(
                    label, plugin.NAME, lambda pi, ev: "Queue")

    async def setup_informers(self, factory: InformerFactory) -> None:
        self._informer_factory = factory
        if self.backend is not None \
                and getattr(self.backend, "control_shards", 0) is None:
            # Remote store: ask the server for the control-plane shape
            # so the host prep's shard accounting matches the backing
            # store instead of re-deriving it from node count.
            probe = getattr(self.store, "control_topology", None)
            if probe is not None:
                try:
                    topo = await probe()
                    self.backend.control_shards = int(
                        topo.get("nodeShards", 1) or 1)
                except Exception:
                    logger.warning("control-plane topology probe failed; "
                                   "shard accounting falls back to the "
                                   "flagless policy", exc_info=True)
        pods = factory.informer("pods")
        nodes = factory.informer("nodes")
        for fwk in self.profiles.values():
            for p in fwk.plugins:
                if hasattr(p, "set_informers"):
                    p.set_informers(factory)

        def on_pod_add(obj):
            pi = PodInfo(obj)
            if pod_is_terminal(obj):
                return
            if pi.node_name:
                self.cache.add_pod(pi)
                self._move_all_soon(ClusterEvent("Pod", "Add"))
            elif self._responsible(pi):
                asyncio.ensure_future(self.queue.add(pi))
                # A new PENDING pod can lift gates of other pods (e.g.
                # Coscheduling's minMember gate counts siblings). Only poke
                # the queue when something is actually parked — at perf
                # scale this fires once per created pod.
                if self.queue.has_parked():
                    self._move_all_soon(ClusterEvent("Pod", "Add"))

        def on_pod_update(old, new):
            pi = PodInfo(new)
            if pod_is_terminal(new):
                on_pod_delete(new)
                return
            if pi.node_name:
                self.cache.update_pod(pi)
            elif self._responsible(pi):
                # Covers the SchedulingGates-removal path too: queue.update
                # re-runs PreEnqueue on the fresh object.
                asyncio.ensure_future(self.queue.update(pi))

        def on_pod_delete(obj):
            key = namespaced_name(obj)
            if obj.get("spec", {}).get("nodeName") or self.cache.is_assumed(key):
                self.cache.remove_pod(key)
            self._nominee_fails.pop(key, None)
            asyncio.ensure_future(self.queue.delete(key))
            self._move_all_soon(ClusterEvent("Pod", "Delete"))

        def on_node_add(obj):
            self.cache.add_node(obj)
            self._move_all_soon(ClusterEvent("Node", "Add"))

        def on_node_update(old, new):
            self.cache.update_node(new)
            self._move_all_soon(ClusterEvent("Node", "Update"))

        def on_node_delete(obj):
            self.cache.remove_node(obj["metadata"]["name"])

        pods.add_event_handler(ResourceEventHandler(
            on_add=on_pod_add, on_update=on_pod_update, on_delete=on_pod_delete))
        nodes.add_event_handler(ResourceEventHandler(
            on_add=on_node_add, on_update=on_node_update, on_delete=on_node_delete))

        # Secondary resources plugins declared EVENTS for (addAllEventHandlers
        # registers an informer per EventResource): PVC/PV/StorageClass churn
        # must re-activate pods parked for volume reasons. Only the declared
        # (kind, action) labels get handlers, and move_all runs even with
        # nothing parked so in-flight cycles are marked for backoff
        # (_moved_while_in_flight) when the event races their failure.
        labels = {label
                  for fwk in self.profiles.values()
                  for p in fwk.plugins
                  for label in getattr(p, "EVENTS", [])}
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        resource_of = {k: KIND_TO_RESOURCE[k] for k in (
            "PersistentVolumeClaim", "PersistentVolume", "StorageClass",
            "NodeResourceTopology", "ResourceClaim", "ResourceSlice",
            "DeviceClass")}
        for kind, resource in resource_of.items():

            def poke(action, kind=kind):
                def handler(*_args):
                    self._move_all_soon(ClusterEvent(kind, action))
                return handler

            handlers = {}
            if f"{kind}/Add" in labels:
                handlers["on_add"] = poke("Add")
            if f"{kind}/Update" in labels:
                handlers["on_update"] = poke("Update")
            if f"{kind}/Delete" in labels:
                handlers["on_delete"] = poke("Delete")
            if handlers:
                factory.informer(resource).add_event_handler(
                    ResourceEventHandler(**handlers))

    def attach_backend(self, backend) -> None:
        """Attach the batched backend — the ONE place its cross-wiring
        (degradation metrics + tracer, §5.5/§5.1) happens, for both
        constructor injection and config-built schedulers."""
        self.backend = backend
        if backend is not None:
            # The batched victim proposal and the slice plan's scan run
            # where the backend runs.
            for fwk in self.profiles.values():
                for p in fwk.plugins:
                    if isinstance(p, (DefaultPreemption, TopologySlice)) \
                            and p.device is None:
                        p.device = backend.device
        if backend is not None and hasattr(backend, "metrics"):
            backend.metrics = self.metrics
        if backend is not None and hasattr(backend, "tracer"):
            backend.tracer = self.tracer
        if backend is not None and hasattr(backend, "control_shards"):
            # Thread the backing store's ACTUAL shard count into the
            # host prep's per-shard accounting: a ShardedNodeStore
            # advertises node_shards, a plain in-process MVCCStore is
            # known unsharded (1). Remote stores resolve via the async
            # topology probe in setup_informers; until something
            # answers, the flagless policy is the fallback.
            from kubernetes_tpu_torch.store.mvcc import MVCCStore
            shards = getattr(self.store, "node_shards", None)
            if shards is not None:
                backend.control_shards = int(shards)
            elif isinstance(self.store, MVCCStore):
                backend.control_shards = 1

    def _responsible(self, pi: PodInfo) -> bool:
        return pi.scheduler_name in self.profiles

    # ------------------------------------------------------------------
    # scheduling cycle (host path)
    # ------------------------------------------------------------------

    def _num_feasible_nodes_to_find(self, num_nodes: int,
                                    pct_override: int | None = None) -> int:
        """numFeasibleNodesToFind: adaptive percentage sampling; a profile
        may override the global percentage (reference scopes the field)."""
        pct = self.percentage_of_nodes_to_score if pct_override is None \
            else pct_override
        if num_nodes < 100 or pct >= 100:
            return num_nodes
        if pct <= 0:
            pct = max(50 - num_nodes // 125, 5)
        return max(num_nodes * pct // 100, 100)

    async def find_nodes_that_fit(
        self, fwk: Framework, state: CycleState, pod: PodInfo, snapshot: Snapshot,
    ) -> tuple[list[NodeInfo], dict[str, Status]]:
        """findNodesThatFitPod: PreFilter → Filter each node (+ extenders)."""
        statuses: dict[str, Status] = {}
        st = fwk.run_pre_filter(state, pod, snapshot)
        if not st.is_success():
            if st.is_unschedulable():
                for n in snapshot:
                    statuses[n.name] = st
                return [], statuses
            raise RuntimeError(f"PreFilter error: {st.message()}")

        # Nominated-node fast path (preemptor pods retry their nominee first).
        if pod.nominated_node:
            ni = snapshot.get(pod.nominated_node)
            if ni is not None and fwk.run_filters(state, pod, ni).is_success():
                return [ni], statuses

        want = self._num_feasible_nodes_to_find(
            len(snapshot),
            getattr(fwk, "percentage_of_nodes_to_score", None))
        feasible: list[NodeInfo] = []
        # Round-robin start offset mirrors nextStartNodeIndex fairness.
        start = self.rng.randrange(len(snapshot)) if len(snapshot) else 0
        nodes = snapshot.nodes
        # One Filter span over the whole node scan (per-node spans would
        # be N per attempt); run_filters keeps its per-plugin metrics.
        with fwk.ep_span("Filter"):
            for i in range(len(nodes)):
                node = nodes[(start + i) % len(nodes)]
                st = fwk.run_filters(state, pod, node)
                if st.is_success():
                    feasible.append(node)
                    if len(feasible) >= want:
                        break
                else:
                    statuses[node.name] = st
        # findNodesThatPassExtenders: HTTP webhooks narrow the feasible set.
        for ext in self.extenders:
            if not feasible:
                break
            feasible, failed, failed_unresolvable = \
                await ext.filter(pod, feasible)
            for name, reason in failed.items():
                statuses[name] = Status.unschedulable(
                    reason).with_plugin(ext.name)
            for name, reason in failed_unresolvable.items():
                statuses[name] = Status.unschedulable(
                    reason, resolvable=False).with_plugin(ext.name)
        return feasible, statuses

    async def prioritize_nodes(
        self, fwk: Framework, state: CycleState, pod: PodInfo,
        nodes: list[NodeInfo],
    ) -> dict[str, float]:
        st = fwk.run_pre_score(state, pod, nodes)
        if not st.is_success():
            raise RuntimeError(f"PreScore error: {st.message()}")
        scores = fwk.run_scores(state, pod, nodes)
        if self.extenders:
            # Parallel fan-out like extender.go's Prioritize goroutines;
            # scores are summed so order doesn't matter.
            results = await asyncio.gather(
                *(ext.prioritize(pod, nodes) for ext in self.extenders))
            for ext_scores in results:
                for name, s in ext_scores.items():
                    scores[name] = scores.get(name, 0.0) + s
        return scores

    def select_host(self, scores: Mapping[str, float]) -> str:
        """selectHost: max score with reservoir-sampled random tiebreak
        (seeded rng — SURVEY §4 carry-in #5)."""
        best = None
        best_score = float("-inf")
        count = 0
        for name, s in scores.items():
            if s > best_score:
                best, best_score, count = name, s, 1
            elif s == best_score:
                count += 1
                if self.rng.randrange(count) == 0:
                    best = name
        return best or ""

    async def schedule_pod(self, fwk: Framework, state: CycleState,
                           pod: PodInfo, snapshot: Snapshot) -> ScheduleResult:
        if len(snapshot) == 0:
            raise FitError(pod, 0, {})
        feasible, statuses = await self.find_nodes_that_fit(
            fwk, state, pod, snapshot)
        if not feasible:
            raise FitError(pod, len(snapshot), statuses)
        if len(feasible) == 1:
            return ScheduleResult(feasible[0].name,
                                  len(statuses) + 1, 1)
        scores = await self.prioritize_nodes(fwk, state, pod, feasible)
        host = self.select_host(scores)
        return ScheduleResult(host, len(statuses) + len(feasible), len(feasible))

    # ------------------------------------------------------------------
    # the loop
    # ------------------------------------------------------------------

    async def schedule_one(self) -> bool:
        """One pod, full cycle. Returns False when queue closed."""
        pods = await self.queue.pop_batch(1)
        if not pods:
            return False
        await self._schedule_pods(pods)
        return True

    async def schedule_batch(self, max_batch: int) -> bool:
        pods = await self.queue.pop_batch(max_batch)
        if not pods:
            return False
        await self._schedule_pods(pods)
        return True

    async def _schedule_pods(self, pods: list[PodInfo]) -> None:
        with Trace("Scheduling", threshold_ms=self.trace_threshold_ms,
                   pods=len(pods)) as tr:
            await self._schedule_pods_traced(pods, tr)

    async def _schedule_pods_traced(self, pods: list[PodInfo],
                                    tr) -> None:
        snapshot = self._snapshot()
        tr.step("snapshot")
        # Extenders are per-pod HTTP webhooks whose round-trips dominate any
        # batch win, and their filter verdicts must precede assignment — so
        # configured extenders route pods through the (extender-aware) host
        # path, exactly the reference's control flow.
        if self.backend is not None and len(pods) > 1 and not self.extenders:
            # Pods are batched per profile: each batch runs under its own
            # plugin set/weights (profiles are keyed by schedulerName), and
            # the per-profile gate selects the backend PER PROFILE
            # (backend_profiles; None = all).
            # Preemptor retries ride a nominated-node fast check FIRST,
            # across every profile (schedule_one.go evaluates the nominee
            # before anything else): the batch solve has no nominee bias,
            # so any batch processed earlier could steal the freed node
            # and force a re-preemption — eviction churn. The check is
            # nominee-ONLY: a preemptor whose nominee is not yet feasible
            # (victims still terminating) REJOINS the batch instead of
            # burning a full per-pod host scan — per-retry O(N·plugins)
            # scans were the dominant cost of 1k-preemptor waves
            # (BASELINE.md r6), and the failure wave's preemption guard
            # re-nominates without re-evicting.
            nominated = [pi for pi in pods if pi.nominated_node]
            rejoin: set[str] = set()
            if nominated:
                placed = 0
                for pi in nominated:
                    if await self._try_nominated(pi, snapshot):
                        snapshot = self._snapshot()
                        self._nominee_fails.pop(pi.key, None)
                        placed += 1
                        continue
                    fails = self._nominee_fails.get(pi.key, 0) + 1
                    # Waiting is only right while victim deletes are
                    # still in flight — i.e. the nominee still hosts
                    # lower-priority pods whose Delete events will
                    # re-activate us. A nominee with none left was
                    # STOLEN by equal/higher-priority pods: no event is
                    # coming, so go re-preempt now instead of idling
                    # until the unschedulable flush.
                    ni = snapshot.get(pi.nominated_node)
                    victims_pending = ni is not None and any(
                        p.priority < pi.priority for p in ni.pods)
                    if fails >= 3 or not victims_pending:
                        # Full batch path, which can re-preempt.
                        self._nominee_fails.pop(pi.key, None)
                        rejoin.add(pi.key)
                    else:
                        # Victim deletes are still landing: requeue and
                        # let their Delete events re-activate the pod —
                        # a full solve for a not-yet-free nominee is the
                        # wave's dominant retry cost.
                        self._nominee_fails[pi.key] = fails
                        await self.queue.add_unschedulable(pi)
                tr.step(
                    f"nominated fast path ({placed}/{len(nominated)} pods)")
            by_profile: dict[str, list[PodInfo]] = {}
            for pi in pods:
                if pi.nominated_node and pi.key not in rejoin:
                    continue
                by_profile.setdefault(pi.scheduler_name, []).append(pi)
            # The backend chunks to its own batch capacity internally and
            # PIPELINES the chunks (device state chains on device; chunk
            # k+1's solve overlaps chunk k's host verify) — SURVEY §2.8.
            for sname, group in by_profile.items():
                if self.backend_profiles is None or \
                        sname in self.backend_profiles:
                    await self._schedule_via_backend(group, snapshot)
                    tr.step(f"backend assign [{sname}] ({len(group)} pods)")
                    snapshot = self._snapshot()
                else:
                    for pi in group:
                        await self._schedule_host_path(pi, snapshot)
                        snapshot = self._snapshot()
                    tr.step(f"host path [{sname}] ({len(group)} pods)")
            return
        for pi in pods:
            await self._schedule_host_path(pi, snapshot)
            # Re-snapshot so pods later in the batch see earlier assumes.
            snapshot = self._snapshot()
        tr.step(f"host path ({len(pods)} pods)")

    async def _try_nominated(self, pi: PodInfo, snapshot) -> bool:
        """Nominee-only evaluation of a preemptor retry: PreFilter + Filter
        on the nominated node alone. True = assumed and binding. False =
        nominee not (yet) feasible; the caller batches the pod instead of
        scanning the rest of the cluster pod-by-pod."""
        fwk = self.profiles.get(pi.scheduler_name)
        if fwk is None:
            logger.error("no profile for schedulerName=%s", pi.scheduler_name)
            await self.queue.done(pi.key)
            return True  # consumed; nothing else can schedule it
        ni = snapshot.get(pi.nominated_node)
        if ni is None:
            return False
        state = CycleState()
        t0 = time.perf_counter()
        if not fwk.run_pre_filter(state, pi, snapshot).is_success():
            return False
        if not fwk.run_filters(state, pi, ni).is_success():
            return False
        self.metrics.observe_attempt("scheduled", fwk.profile_name,
                                     time.perf_counter() - t0)
        await self._assume_and_bind(fwk, state, pi, ni.name)
        return True

    async def _schedule_via_backend(self, pods: list[PodInfo], snapshot) -> None:
        """Batched path: the backend returns {pod_key: node_name | None}.

        A backend exception propagates: no host-path fallback, no
        circuit breaker (see the module docstring)."""
        fwk = self.profiles.get(pods[0].scheduler_name) or next(iter(self.profiles.values()))
        t0 = time.perf_counter()
        if self.tracer.enabled:
            # One attempt span per backend batch: the device solve is a
            # joint decision over the whole batch, so per-pod spans would
            # invent a serialization that never happened. A single-pod
            # batch parents to its create request (stamped traceparent)
            # and carries the pod key.
            attrs = {"pods": len(pods), "profile": fwk.profile_name}
            tp = None
            if len(pods) == 1:
                attrs["pod"] = pods[0].key
                tp = traceparent_of(pods[0].pod)
            with self.tracer.span("scheduler.attempt", traceparent=tp,
                                  **attrs):
                for pi in pods:
                    self._record_queue_wait(pi)
                return await self._backend_cycle(pods, snapshot, fwk, t0)
        await self._backend_cycle(pods, snapshot, fwk, t0)

    async def _backend_cycle(self, pods: list[PodInfo], snapshot, fwk,
                             t0: float) -> None:
        """The reference's order: the backend's chunk stream when it has
        one (`_schedule_via_backend_stream`), else `assign_async`, else
        `assign`. An exception of any of them propagates."""
        if hasattr(self.backend, "assign_stream"):
            # Bindings for chunk k start while chunk k+1 still solves.
            return await self._schedule_via_backend_stream(
                pods, snapshot, fwk, t0)
        if hasattr(self.backend, "assign_async"):
            assignments, diagnostics = await self.backend.assign_async(
                pods, snapshot, fwk)
        else:
            assignments, diagnostics = self.backend.assign(
                pods, snapshot, fwk)
        elapsed = time.perf_counter() - t0
        # Assigned pods bind FIRST so the failure wave below sees every
        # in-batch assume in ONE snapshot; per-failure re-snapshots were
        # an O(N) walk per preemptor (the wave tensors already account
        # for in-wave claims — preemption.go's nominated-pod charge).
        failed: list[PodInfo] = []
        for pi in pods:
            node = assignments.get(pi.key)
            if node:
                self.metrics.observe_attempt("scheduled", fwk.profile_name, elapsed / len(pods))
                await self._assume_and_bind(
                    fwk, self._bind_state(fwk, pi, snapshot), pi, node)
            else:
                failed.append(pi)
        live = self._snapshot() if failed else None
        if failed:
            self._prime_preemption(fwk, failed, live, diagnostics)
        for pi in failed:
            self.metrics.observe_attempt("unschedulable", fwk.profile_name,
                                         elapsed / len(pods))
            statuses = diagnostics.get(pi.key, {})
            # state+snapshot enable the PostFilter (preemption) branch
            # — without them the batched path could never preempt.
            # PreFilter runs first so the dry-run's filters see the
            # pod's affinity/spread/volume prefilter state (an empty
            # CycleState would make those filters vacuously pass and
            # evict victims on nodes the pod can never land on).
            state = CycleState()
            fwk.run_pre_filter(state, pi, live)
            await self._handle_failure(
                fwk, pi, FitError(pi, len(snapshot), statuses),
                statuses, state=state, snapshot=live)

    async def _schedule_via_backend_stream(self, pods: list[PodInfo],
                                           snapshot, fwk, t0: float) -> None:
        """Consume the backend's per-chunk assignment stream: each chunk's
        assume / Reserve / binding cycle starts as soon as its host verify
        lands, overlapping the next chunks' device passes. A stream
        exception propagates (no host-path rerun of the pods not yet
        yielded; see the module docstring)."""
        last_t = t0
        async for chunk_pods, ctx in self.backend.assign_stream(
                pods, snapshot, fwk):
            # Per-chunk delta (not since-batch-start): summed per-pod
            # observations track wall time, as on the non-stream path.
            now = time.perf_counter()
            elapsed, last_t = now - last_t, now
            n = max(1, len(chunk_pods))
            # Binds first, then the chunk's failure wave against ONE live
            # snapshot (see _backend_cycle).
            failed: list[PodInfo] = []
            for pi in chunk_pods:
                node = ctx.assignments.get(pi.key)
                if node:
                    self.metrics.observe_attempt(
                        "scheduled", fwk.profile_name, elapsed / n)
                    await self._assume_and_bind(
                    fwk, self._bind_state(fwk, pi, snapshot), pi, node)
                else:
                    failed.append(pi)
            live = self._snapshot() if failed else None
            if failed:
                self._prime_preemption(fwk, failed, live, ctx.diagnostics)
            for pi in failed:
                self.metrics.observe_attempt(
                    "unschedulable", fwk.profile_name, elapsed / n)
                statuses = ctx.diagnostics.get(pi.key, {})
                state = CycleState()
                fwk.run_pre_filter(state, pi, live)
                await self._handle_failure(
                    fwk, pi, FitError(pi, len(snapshot), statuses),
                    statuses, state=state, snapshot=live)

    @staticmethod
    def _bind_state(fwk: Framework, pi: PodInfo, snapshot) -> CycleState:
        """The CycleState a batched placement binds with: empty, as in the
        reference, but for a pod with PersistentVolumeClaims, for which
        VolumeBinding's PreFilter runs first, so that its Unreserve and its
        PreBind (the selected-node annotation, the wait for the claims to
        bind) see the pod's claims. The reference binds such a pod with an
        empty state: its PreBind returns at once and a WaitForFirstConsumer
        claim is never provisioned (see the module docstring)."""
        state = CycleState()
        if pi.pvc_names:
            for p in fwk.pre_filter_plugins:
                if p.NAME == "VolumeBinding":
                    p.pre_filter(state, pi, snapshot)
        return state

    def _prime_preemption(self, fwk: Framework, failed: list[PodInfo],
                          snapshot, diagnostics: Mapping) -> None:
        """Hand the whole failure wave to preemption's batched device
        proposal (DefaultPreemption.prime_wave) before the per-pod
        PostFilter loop. A prime failure propagates (no fallback to the
        per-pod candidate search; see the module docstring)."""
        if snapshot is None:
            return
        for p in fwk.post_filter_plugins:
            prime = getattr(p, "prime_wave", None)
            if prime is not None:
                prime(failed, snapshot, diagnostics)

    def _record_queue_wait(self, pi: PodInfo) -> None:
        """Retroactive queue-wait child span: the informer→queue→cycle
        hop crosses tasks no context can follow, so the span is rebuilt
        from the queue's own stamps (same monotonic clock), the interval
        the queue observed into its `wait` recorder at the pop."""
        start = wait_start(pi)
        if start and pi.dequeued_at >= start > 0.0:
            self.tracer.record("scheduler.queue.wait", start,
                               pi.dequeued_at, pod=pi.key,
                               attempts=pi.attempts)

    async def _schedule_host_path(self, pi: PodInfo, snapshot) -> None:
        fwk = self.profiles.get(pi.scheduler_name)
        if fwk is None:
            logger.error("no profile for schedulerName=%s", pi.scheduler_name)
            await self.queue.done(pi.key)
            return
        if self.tracer.enabled:
            # traceparent stamped by the creating request (any wire)
            # parents this attempt into the pod's create trace.
            with self.tracer.span("scheduler.attempt", pod=pi.key,
                                  profile=fwk.profile_name,
                                  traceparent=traceparent_of(pi.pod)):
                self._record_queue_wait(pi)
                return await self._schedule_host_path_traced(
                    pi, snapshot, fwk)
        await self._schedule_host_path_traced(pi, snapshot, fwk)

    async def _schedule_host_path_traced(self, pi: PodInfo, snapshot,
                                         fwk) -> None:
        state = CycleState()
        t0 = time.perf_counter()
        try:
            result = await self.schedule_pod(fwk, state, pi, snapshot)
        except FitError as fe:
            self.metrics.observe_attempt("unschedulable", fwk.profile_name,
                                         time.perf_counter() - t0)
            await self._handle_failure(fwk, pi, fe, fe.statuses, state=state,
                                       snapshot=snapshot)
            return
        except Exception as e:  # infrastructure error
            logger.exception("scheduling cycle error for %s", pi.key)
            self.metrics.observe_attempt("error", fwk.profile_name,
                                         time.perf_counter() - t0)
            await self.queue.move_to_backoff(pi)
            return
        self.metrics.observe_attempt("scheduled", fwk.profile_name,
                                     time.perf_counter() - t0)
        await self._assume_and_bind(fwk, state, pi, result.node)

    async def _assume_and_bind(self, fwk: Framework, state: CycleState,
                               pi: PodInfo, node_name: str) -> None:
        """assume → Reserve → Permit → async bindingCycle."""
        rng = range_start("scheduler.assume")
        t0 = time.perf_counter()
        try:
            try:
                self.cache.assume_pod(pi, node_name)
            except (KeyError, ValueError) as e:
                logger.error("assume failed for %s: %s", pi.key, e)
                await self.queue.move_to_backoff(pi)
                return
            st = fwk.run_reserve(state, pi, node_name)
            if not st.is_success():
                self.cache.forget_pod(pi.key)
                await self._requeue_unschedulable(pi, st)
                return
            permit_status, timeout = fwk.run_permit(state, pi, node_name)
            if not permit_status.is_success() and not permit_status.is_wait():
                fwk.run_unreserve(state, pi, node_name)
                self.cache.forget_pod(pi.key)
                await self._requeue_unschedulable(pi, permit_status)
                return
            if permit_status.is_wait():
                # Register the waiter SYNCHRONOUSLY (frameworkImpl stores
                # waitingPods inside RunPermitPlugins): a sibling's permit may
                # allow/reject this pod before the async binding cycle starts.
                self._permit_waiters[pi.key] = \
                    asyncio.get_event_loop().create_future()
            task = asyncio.ensure_future(
                self._binding_cycle(fwk, state, pi, node_name, permit_status, timeout))
            self._binding_tasks.add(task)
            task.add_done_callback(self._binding_tasks.discard)
            self.metrics.goroutines.set(len(self._binding_tasks), operation="binding")
        finally:
            self.timings["assume_s"] += time.perf_counter() - t0
            range_end(rng)

    async def _binding_cycle(self, fwk: Framework, state: CycleState, pi: PodInfo,
                             node_name: str, permit_status: Status,
                             timeout: float) -> None:
        if self.tracer.enabled:
            with self.tracer.span("scheduler.bind", pod=pi.key,
                                  node=node_name):
                return await self._binding_cycle_traced(
                    fwk, state, pi, node_name, permit_status, timeout)
        await self._binding_cycle_traced(
            fwk, state, pi, node_name, permit_status, timeout)

    async def _binding_cycle_traced(self, fwk: Framework, state: CycleState,
                                    pi: PodInfo, node_name: str,
                                    permit_status: Status,
                                    timeout: float) -> None:
        bound = False
        try:
            if permit_status.is_wait():
                ok = await self._wait_on_permit(fwk, pi, timeout)
                if not ok:
                    fwk.run_unreserve(state, pi, node_name)
                    self.cache.forget_pod(pi.key)
                    await self._requeue_unschedulable(
                        pi, Status.unschedulable("rejected at Permit"))
                    return
            rng = range_start("scheduler.bind")
            t0 = time.perf_counter()
            try:
                st = await fwk.run_pre_bind(state, pi, node_name)
                if not st.is_success():
                    fwk.run_unreserve(state, pi, node_name)
                    self.cache.forget_pod(pi.key)
                    await self._requeue_unschedulable(pi, st)
                    return
                st = await self._bind(fwk, state, pi, node_name)
                if not st.is_success():
                    fwk.run_unreserve(state, pi, node_name)
                    self.cache.forget_pod(pi.key)
                    await self._requeue_unschedulable(pi, st)
                    return
                # The pod is durably bound in the API from here on: failures
                # below must NOT forget/requeue it (it is genuinely scheduled).
                bound = True
                self.timings["bound"] += 1
                if pi.queued_at:
                    self.metrics.e2e_sli_duration.observe(
                        self.queue.clock() - pi.queued_at,
                        attempts=str(pi.attempts) if pi.attempts < 15
                        else "15+")
                self.cache.finish_binding(pi.key)
                fwk.run_post_bind(state, pi, node_name)
                self.recorder.event(pi.pod, "Normal", "Scheduled",
                                    f"Successfully assigned {pi.key} to {node_name}")
                await self.queue.done(pi.key)
            finally:
                self.timings["bind_s"] += time.perf_counter() - t0
                range_end(rng)
        except Exception:
            logger.exception("binding cycle crashed for %s", pi.key)
            if bound:
                await self.queue.done(pi.key)
                return
            self.cache.forget_pod(pi.key)
            await self.queue.move_to_backoff(pi)

    async def _bind(self, fwk: Framework, state: CycleState, pi: PodInfo,
                    node_name: str) -> Status:
        """schedule_one.go bind: a bind-capable extender interested in the
        pod binds INSTEAD of the framework's Bind plugins."""
        for ext in self.extenders:
            if getattr(ext, "is_binder", lambda: False)() \
                    and ext.is_interested(pi):
                try:
                    await ext.bind(pi, node_name)
                    return Status.success()
                except Exception as e:
                    return Status.error(f"extender bind failed: {e}")
        return await fwk.run_bind(state, pi, node_name)

    # Permit wait support (gang scheduling parks here) ------------------

    def allow_waiting_pod(self, pod_key: str) -> None:
        fut = self._permit_waiters.get(pod_key)
        if fut and not fut.done():
            fut.set_result(True)

    def reject_waiting_pod(self, pod_key: str) -> None:
        fut = self._permit_waiters.get(pod_key)
        if fut and not fut.done():
            fut.set_result(False)

    async def _wait_on_permit(self, fwk: Framework, pi: PodInfo,
                              timeout: float) -> bool:
        fut = self._permit_waiters.get(pi.key)
        if fut is None:
            fut = asyncio.get_event_loop().create_future()
            self._permit_waiters[pi.key] = fut
        try:
            return await asyncio.wait_for(fut, timeout if timeout > 0 else None)
        except asyncio.TimeoutError:
            return False
        finally:
            self._permit_waiters.pop(pi.key, None)

    # Failure handling --------------------------------------------------

    async def _handle_failure(self, fwk: Framework, pi: PodInfo, err: FitError,
                              statuses: Mapping[str, Status],
                              state: CycleState | None = None,
                              snapshot=None) -> None:
        """handleSchedulingFailure: record reasons, try preemption, requeue."""
        pi.last_failure = str(err)
        plugins = getattr(statuses, "plugins", None)
        pi.unschedulable_plugins = plugins if plugins is not None else {
            st.plugin for st in statuses.values() if st.plugin}
        self.recorder.event(pi.pod, "Warning", "FailedScheduling", str(err))
        resolvable = getattr(statuses, "resolvable", None)
        if resolvable is None:
            resolvable = any(
                st.code != UNSCHEDULABLE_AND_UNRESOLVABLE
                for st in statuses.values()) or not statuses
        if resolvable and state is not None and snapshot is not None \
                and fwk.post_filter_plugins:
            nominated, st = fwk.run_post_filters(state, pi, snapshot, statuses)
            if st.is_success() and nominated:
                pi.nominated_node = nominated
                self.metrics.schedule_attempts.inc(
                    result="preemption", profile=fwk.profile_name)
        await self.queue.add_unschedulable(pi)

    async def _requeue_unschedulable(self, pi: PodInfo, st: Status) -> None:
        pi.last_failure = st.message()
        self.recorder.event(pi.pod, "Warning", "FailedScheduling", st.message())
        await self.queue.add_unschedulable(pi)

    def _preemption_evict(self, pod: PodInfo, victim_keys: list[str],
                          node_name: str) -> None:
        """DefaultPreemption side-effects: API-delete victims + record."""
        self.metrics.preemption_victims.observe(len(victim_keys))

        async def do():
            from kubernetes_tpu_torch.store.mvcc import StoreError
            # A victim already gone (deleted by an earlier eviction or by
            # its owner) is store semantics, not a failure.
            for vk in victim_keys:
                try:
                    await self.store.delete("pods", vk)
                except StoreError:
                    pass

            def set_nominated(p):
                p.setdefault("status", {})["nominatedNodeName"] = node_name
                return p
            try:
                await self.store.guaranteed_update("pods", pod.key, set_nominated)
            except StoreError:
                pass
        asyncio.ensure_future(do())

    # ------------------------------------------------------------------

    async def _cache_janitor(self) -> None:
        """Periodic expiry of assumed-but-never-confirmed pods
        (cache.run → cleanupAssumedPods every 1s in the reference)."""
        try:
            while not self._stop:
                await asyncio.sleep(5.0)
                self.cache.cleanup_expired()
        except asyncio.CancelledError:
            return

    async def run(self, batch_size: int = 1) -> None:
        """wait.UntilWithContext(sched.ScheduleOne) — plus flushers.

        With a batched backend attached the loop runs through the
        serving tier (admission window + single-pod fast path —
        kubernetes_tpu_torch/serving); KTPU_SERVING=0 degrades structurally
        to the plain schedule_batch loop below."""
        flusher = asyncio.ensure_future(self.queue.run_flushers())
        janitor = asyncio.ensure_future(self._cache_janitor())
        from kubernetes_tpu_torch.serving import maybe_attach_serving
        serving = maybe_attach_serving(self)
        try:
            while not self._stop:
                if serving is not None:
                    more = await serving.schedule_next(batch_size)
                else:
                    more = await self.schedule_batch(batch_size)
                if not more:
                    break
                self.metrics.set_pending(self.queue.stats())
        finally:
            flusher.cancel()
            janitor.cancel()

    async def run_with_leader_election(self, elector,
                                       batch_size: int = 1) -> None:
        """Leader-elected run (cmd/kube-scheduler app/server.go `Run`):
        schedule only while holding the lease. Losing it stops the loop
        AND awaits stop() — which cancels in-flight binding tasks — before
        returning (fencing: a deposed leader must not write stale binds
        while the standby schedules the same pods)."""
        async def lead():
            await self.run(batch_size=batch_size)

        def lost():
            self._stop = True

        try:
            await elector.run(on_started_leading=lead,
                              on_stopped_leading=lost)
        finally:
            await self.stop()

    async def stop(self) -> None:
        self._stop = True
        await self.queue.close()
        for t in list(self._binding_tasks):
            t.cancel()
        await asyncio.gather(*self._binding_tasks, return_exceptions=True)
        for ext in self.extenders:
            close = getattr(ext, "close", None)
            if close is not None:
                try:
                    await close()
                except Exception:
                    pass
