"""The scheduling framework: extension points, Status codes, CycleState.

Parity target: pkg/scheduler/framework/interface.go (`Plugin`,
`PreEnqueuePlugin`, `QueueSortPlugin`, `PreFilterPlugin`, `FilterPlugin`,
`PostFilterPlugin`, `PreScorePlugin`, `ScorePlugin` + `ScoreExtensions`,
`ReservePlugin`, `PermitPlugin`, `PreBindPlugin`, `BindPlugin`,
`PostBindPlugin`; `Status`/`Code`) and framework/runtime/framework.go
(`frameworkImpl.RunFilterPlugins` / `RunScorePlugins` / ... with per-plugin
duration metrics).

The state machine per scheduling attempt (schedule_one.go):

    PreEnqueue -> [queue] -> PreFilter -> Filter -> (PostFilter on failure)
      -> PreScore -> Score -> NormalizeScore -> Reserve -> Permit
      -> [async] WaitOnPermit -> PreBind -> Bind -> PostBind

Copy of `kubernetes_tpu/scheduler/framework.py`. The batched backend
(ops/backend.py) computes the Filter and Score points of the plugins it
models on the device, so the reference's per-plugin batch-kernel hooks
(`filter_batch` / `score_batch`) are not here.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any, Callable, Iterable, Mapping

from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

#: shared no-op context manager (stateless, safe to re-enter): the
#: disabled-tracer fast path of ep_span costs one attribute check + this.
_NULL_CM = contextlib.nullcontext()

# --- Status codes (framework.Code) -----------------------------------------

SUCCESS = 0
ERROR = 1
UNSCHEDULABLE = 2
UNSCHEDULABLE_AND_UNRESOLVABLE = 3  # preemption won't help
WAIT = 4   # Permit parked the pod (gang scheduling)
SKIP = 5

MAX_NODE_SCORE = 100
MIN_NODE_SCORE = 0


class Status:
    __slots__ = ("code", "reasons", "plugin")

    def __init__(self, code: int = SUCCESS, reasons: Iterable[str] = (), plugin: str = ""):
        self.code = code
        self.reasons = list(reasons)
        self.plugin = plugin

    @classmethod
    def success(cls) -> "Status":
        return cls(SUCCESS)

    @classmethod
    def unschedulable(cls, *reasons: str, resolvable: bool = True) -> "Status":
        return cls(UNSCHEDULABLE if resolvable else UNSCHEDULABLE_AND_UNRESOLVABLE, reasons)

    @classmethod
    def error(cls, *reasons: str) -> "Status":
        return cls(ERROR, reasons)

    @classmethod
    def skip(cls) -> "Status":
        return cls(SKIP)

    @classmethod
    def wait(cls) -> "Status":
        return cls(WAIT)

    def is_success(self) -> bool:
        return self.code == SUCCESS

    def is_skip(self) -> bool:
        return self.code == SKIP

    def is_wait(self) -> bool:
        return self.code == WAIT

    def is_unschedulable(self) -> bool:
        return self.code in (UNSCHEDULABLE, UNSCHEDULABLE_AND_UNRESOLVABLE)

    def message(self) -> str:
        return "; ".join(self.reasons)

    def with_plugin(self, name: str) -> "Status":
        self.plugin = self.plugin or name
        return self

    def __repr__(self) -> str:
        names = {0: "Success", 1: "Error", 2: "Unschedulable",
                 3: "UnschedulableAndUnresolvable", 4: "Wait", 5: "Skip"}
        return f"Status({names[self.code]}, {self.reasons!r}, plugin={self.plugin!r})"


class CycleState:
    """Per-attempt scratch space (framework/cycle_state.go): plugins stash
    PreFilter/PreScore precomputation under their own keys."""

    def __init__(self):
        self._data: dict[str, Any] = {}
        self.skip_filter_plugins: set[str] = set()
        self.skip_score_plugins: set[str] = set()

    def write(self, key: str, value: Any) -> None:
        self._data[key] = value

    def read(self, key: str) -> Any:
        return self._data.get(key)

    def clone(self) -> "CycleState":
        cs = CycleState()
        cs._data = dict(self._data)
        cs.skip_filter_plugins = set(self.skip_filter_plugins)
        cs.skip_score_plugins = set(self.skip_score_plugins)
        return cs


# --- Plugin base -----------------------------------------------------------

class Plugin:
    """Base plugin. Subclasses override the extension points they implement
    and declare them in EXTENSION_POINTS. Args come from the per-plugin
    config (KubeSchedulerConfiguration pluginConfig)."""

    NAME = "Plugin"
    EXTENSION_POINTS: tuple[str, ...] = ()

    def __init__(self, args: Mapping | None = None):
        self.args = dict(args or {})

    # PreEnqueue: gate pods out of the active queue entirely.
    def pre_enqueue(self, pod: PodInfo) -> Status:
        return Status.success()

    # QueueSort: less(a, b) ordering for the active queue.
    def less(self, a: PodInfo, b: PodInfo) -> bool:
        raise NotImplementedError

    # PreFilter: per-pod precompute; may narrow candidate nodes or Skip.
    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        return Status.success()

    # Filter: feasibility of pod on one node.
    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        return Status.success()

    # PostFilter: runs when no node passed Filter (preemption lives here).
    def post_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot,
                    filtered_status: Mapping[str, Status]) -> tuple[str, Status]:
        return "", Status.unschedulable()

    # PreScore
    def pre_score(self, state: CycleState, pod: PodInfo,
                  nodes: list[NodeInfo]) -> Status:
        return Status.success()

    # Score: 0..100 per node.
    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        return 0.0

    # NormalizeScore (ScoreExtensions): rescale this plugin's raw scores.
    def normalize_scores(self, state: CycleState, pod: PodInfo,
                         scores: dict[str, float]) -> None:
        return None

    # Reserve / Unreserve
    def reserve(self, state: CycleState, pod: PodInfo, node_name: str) -> Status:
        return Status.success()

    def unreserve(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        return None

    # Permit: may return Wait (gang scheduling parks here) with a timeout.
    def permit(self, state: CycleState, pod: PodInfo,
               node_name: str) -> tuple[Status, float]:
        return Status.success(), 0.0

    # PreBind / Bind / PostBind
    async def pre_bind(self, state: CycleState, pod: PodInfo, node_name: str) -> Status:
        return Status.success()

    async def bind(self, state: CycleState, pod: PodInfo, node_name: str) -> Status:
        return Status.skip()

    def post_bind(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        return None


class EnqueueExtensions:
    """Which cluster events may make a pod schedulable again
    (framework.EnqueueExtensions.EventsToRegister → QueueingHint).
    Event strings: "Node/Add", "Node/Update", "Pod/Delete", "Pod/Add", ..."""

    @staticmethod
    def events_for(plugin: Plugin) -> list[str]:
        return getattr(plugin, "EVENTS", ["Node/Add", "Node/Update", "Pod/Delete"])


# --- Framework runner ------------------------------------------------------

class Framework:
    """frameworkImpl: a configured set of plugins per profile, with
    per-plugin/per-extension-point timing recorded for metrics parity."""

    def __init__(
        self,
        plugins: list[Plugin],
        score_weights: Mapping[str, int] | None = None,
        profile_name: str = "default-scheduler",
        metrics=None,
        disabled: Mapping[str, Iterable[str]] | None = None,
    ):
        self.profile_name = profile_name
        self.plugins = plugins
        self.score_weights = dict(score_weights or {})
        self.metrics = metrics
        #: utils/tracing.Tracer injected by the Scheduler (like metrics):
        #: each extension-point run_* becomes a child span of the attempt
        #: when tracing is on; a None/disabled tracer costs one check.
        self.tracer = None
        disabled = {k: set(v) for k, v in (disabled or {}).items()}

        def enabled(point: str) -> list[Plugin]:
            off = disabled.get(point, set()) | disabled.get("*", set())
            return [p for p in plugins
                    if point in p.EXTENSION_POINTS and p.NAME not in off]

        self.pre_enqueue_plugins = enabled("PreEnqueue")
        self.queue_sort_plugins = enabled("QueueSort")
        self.pre_filter_plugins = enabled("PreFilter")
        self.filter_plugins = enabled("Filter")
        self.post_filter_plugins = enabled("PostFilter")
        self.pre_score_plugins = enabled("PreScore")
        self.score_plugins = enabled("Score")
        self.reserve_plugins = enabled("Reserve")
        self.permit_plugins = enabled("Permit")
        self.pre_bind_plugins = enabled("PreBind")
        self.bind_plugins = enabled("Bind")
        self.post_bind_plugins = enabled("PostBind")

    def ep_span(self, point: str):
        """Context manager for one extension point's span (a no-op unless
        the injected tracer is enabled) — the utiltrace step analog at
        span granularity; per-plugin timing stays on the metrics path."""
        t = self.tracer
        if t is not None and t.enabled:
            return t.span(f"framework.{point}", profile=self.profile_name)
        return _NULL_CM

    def _timed(self, plugin: Plugin, point: str, fn: Callable, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            if self.metrics is not None:
                self.metrics.observe_plugin(plugin.NAME, point,
                                            time.perf_counter() - t0)

    # -- queue hooks --

    def run_pre_enqueue(self, pod: PodInfo) -> Status:
        for p in self.pre_enqueue_plugins:
            st = self._timed(p, "PreEnqueue", p.pre_enqueue, pod)
            if not st.is_success():
                return st.with_plugin(p.NAME)
        return Status.success()

    def less(self, a: PodInfo, b: PodInfo) -> bool:
        for p in self.queue_sort_plugins:
            return p.less(a, b)
        return a.queued_at < b.queued_at

    # -- scheduling cycle --

    def run_pre_filter(self, state: CycleState, pod: PodInfo,
                       snapshot: Snapshot) -> Status:
        with self.ep_span("PreFilter"):
            for p in self.pre_filter_plugins:
                st = self._timed(p, "PreFilter", p.pre_filter, state, pod,
                                 snapshot)
                if st.is_skip():
                    state.skip_filter_plugins.add(p.NAME)
                    continue
                if not st.is_success():
                    return st.with_plugin(p.NAME)
            return Status.success()

    def run_filters(self, state: CycleState, pod: PodInfo,
                    node: NodeInfo) -> Status:
        for p in self.filter_plugins:
            if p.NAME in state.skip_filter_plugins:
                continue
            st = self._timed(p, "Filter", p.filter, state, pod, node)
            if not st.is_success():
                return st.with_plugin(p.NAME)
        return Status.success()

    def run_post_filters(self, state: CycleState, pod: PodInfo,
                         snapshot: Snapshot,
                         statuses: Mapping[str, Status]) -> tuple[str, Status]:
        with self.ep_span("PostFilter"):
            for p in self.post_filter_plugins:
                nominated, st = self._timed(
                    p, "PostFilter", p.post_filter, state, pod, snapshot,
                    statuses)
                if st.is_success() or not st.is_unschedulable():
                    return nominated, st.with_plugin(p.NAME)
            return "", Status.unschedulable()

    def run_pre_score(self, state: CycleState, pod: PodInfo,
                      nodes: list[NodeInfo]) -> Status:
        with self.ep_span("PreScore"):
            for p in self.pre_score_plugins:
                st = self._timed(p, "PreScore", p.pre_score, state, pod, nodes)
                if st.is_skip():
                    state.skip_score_plugins.add(p.NAME)
                    continue
                if not st.is_success():
                    return st.with_plugin(p.NAME)
            return Status.success()

    def run_scores(self, state: CycleState, pod: PodInfo,
                   nodes: list[NodeInfo]) -> dict[str, float]:
        """Weighted sum over score plugins (RunScorePlugins + NormalizeScore +
        plugin weight application)."""
        with self.ep_span("Score"):
            totals = {n.name: 0.0 for n in nodes}
            for p in self.score_plugins:
                if p.NAME in state.skip_score_plugins:
                    continue
                raw = {}
                for n in nodes:
                    raw[n.name] = self._timed(p, "Score", p.score, state,
                                              pod, n)
                self._timed(p, "NormalizeScore", p.normalize_scores, state,
                            pod, raw)
                w = self.score_weights.get(p.NAME, 1)
                for name, s in raw.items():
                    totals[name] += w * s
            return totals

    # -- reserve / permit / bind --

    def run_reserve(self, state: CycleState, pod: PodInfo, node_name: str) -> Status:
        with self.ep_span("Reserve"):
            done: list[Plugin] = []
            for p in self.reserve_plugins:
                st = self._timed(p, "Reserve", p.reserve, state, pod,
                                 node_name)
                if not st.is_success():
                    for q in done:
                        q.unreserve(state, pod, node_name)
                    return st.with_plugin(p.NAME)
                done.append(p)
            return Status.success()

    def run_unreserve(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        for p in reversed(self.reserve_plugins):
            self._timed(p, "Unreserve", p.unreserve, state, pod, node_name)

    def run_permit(self, state: CycleState, pod: PodInfo,
                   node_name: str) -> tuple[Status, float]:
        with self.ep_span("Permit"):
            max_timeout = 0.0
            waiting = False
            for p in self.permit_plugins:
                st, timeout = self._timed(p, "Permit", p.permit, state, pod,
                                          node_name)
                if st.is_wait():
                    waiting = True
                    max_timeout = max(max_timeout, timeout)
                elif not st.is_success():
                    return st.with_plugin(p.NAME), 0.0
            return (Status.wait(), max_timeout) if waiting \
                else (Status.success(), 0.0)

    async def run_pre_bind(self, state: CycleState, pod: PodInfo,
                           node_name: str) -> Status:
        with self.ep_span("PreBind"):
            for p in self.pre_bind_plugins:
                t0 = time.perf_counter()
                st = await p.pre_bind(state, pod, node_name)
                if self.metrics is not None:
                    self.metrics.observe_plugin(p.NAME, "PreBind",
                                                time.perf_counter() - t0)
                if not st.is_success():
                    return st.with_plugin(p.NAME)
            return Status.success()

    async def run_bind(self, state: CycleState, pod: PodInfo,
                       node_name: str) -> Status:
        with self.ep_span("Bind"):
            for p in self.bind_plugins:
                t0 = time.perf_counter()
                st = await p.bind(state, pod, node_name)
                if self.metrics is not None:
                    self.metrics.observe_plugin(p.NAME, "Bind",
                                                time.perf_counter() - t0)
                if st.is_skip():
                    continue
                return st.with_plugin(p.NAME)
            return Status.error("no bind plugin handled the pod")

    def run_post_bind(self, state: CycleState, pod: PodInfo, node_name: str) -> None:
        with self.ep_span("PostBind"):
            for p in self.post_bind_plugins:
                self._timed(p, "PostBind", p.post_bind, state, pod, node_name)
