"""Metrics: Prometheus-compatible counters/histograms with stability levels.

Parity target: staging/src/k8s.io/component-base/metrics (registry, stability
levels) + pkg/scheduler/metrics/metrics.go — the scheduler metric NAMES are a
contract for dashboard parity (SURVEY §5.5) and are preserved verbatim.

No prometheus_client dependency: a registry that renders the text exposition
format is ~100 lines and keeps the zero-install constraint.

Copy of `kubernetes_tpu/metrics/registry.py`, cut to the families the store,
the watch cache, the scheduler loop, the churn harness, the
descheduler, the apiserver, the write-ahead log and leader election fill.
The scheduler's family keeps every reference name, the device-solve ones
included, so the exposition text is the reference's.
"""

from __future__ import annotations

import bisect
import itertools
import math
from collections import defaultdict
from typing import Iterable, Mapping

from kubernetes_tpu_torch.utils.locking import new_lock


def _esc_label(value) -> str:
    """Prometheus text-format label-value escaping (backslash, quote,
    newline) — exposition-format.md's only three escapes."""
    return str(value).replace("\\", "\\\\").replace('"', '\\"') \
        .replace("\n", "\\n")


def _esc_help(text: str) -> str:
    """HELP-line escaping: backslash and newline (quotes are legal there)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


class Counter:
    def __init__(self, name: str, help_: str = "", labels: Iterable[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self._values: dict[tuple, float] = defaultdict(float)
        self._lock = new_lock(f"metrics.{name}")

    def inc(self, amount: float = 1.0, **labels: str) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] += amount

    def inc_key(self, key: tuple, amount: float = 1.0) -> None:
        """Hot-path increment with a caller-cached label tuple (skips
        per-call label-kwarg resolution; the policy engine incs once per
        expression per admitted request)."""
        with self._lock:
            self._values[key] += amount

    def value(self, **labels: str) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        return self._values.get(key, 0.0)

    def _render(self, type_: str) -> str:
        # The TYPE line is written explicitly per metric type: deriving it
        # by string replacement corrupted the HELP line whenever the help
        # text itself contained the word "counter".
        lines = [f"# HELP {self.name} {_esc_help(self.help)}",
                 f"# TYPE {self.name} {type_}"]
        # Snapshot under the lock: inc() runs in worker threads (the
        # backend's to_thread solve fetch observes metrics), and
        # iterating the live dict while one lands a NEW label key raises
        # "dictionary changed size during iteration" — the lock-hygiene
        # pass (LK205) caught this unlocked iteration.
        with self._lock:
            items = sorted(self._values.items())
        for key, v in items:
            lbl = ",".join(f'{n}="{_esc_label(val)}"'
                           for n, val in zip(self.label_names, key))
            lines.append(f"{self.name}{{{lbl}}} {v}" if lbl else f"{self.name} {v}")
        return "\n".join(lines)

    def render(self) -> str:
        return self._render("counter")


class Gauge(Counter):
    def set(self, value: float, **labels: str) -> None:
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            self._values[key] = value

    def set_key(self, key: tuple, value: float) -> None:
        """Hot-path set with a caller-cached label tuple (the Counter
        inc_key idiom; the watch cache sets ring length per event)."""
        with self._lock:
            self._values[key] = value

    def render(self) -> str:
        return self._render("gauge")


_DEFAULT_BUCKETS = tuple(0.001 * (2 ** i) for i in range(16))  # 1ms .. ~32s


class Histogram:
    def __init__(self, name: str, help_: str = "", labels: Iterable[str] = (),
                 buckets: tuple[float, ...] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.label_names = tuple(labels)
        self.buckets = buckets
        self._counts: dict[tuple, list[int]] = {}
        self._sums: dict[tuple, float] = defaultdict(float)
        self._totals: dict[tuple, int] = defaultdict(int)
        self._lock = new_lock(f"metrics.{name}")

    def observe(self, value: float, **labels: str) -> None:
        # Single-bucket increment (bisect); cumulative "le" semantics are
        # materialized at read time. The per-bucket loop here was measurable
        # at scheduler_perf scale (2-3 observes per pod x 16 buckets).
        key = tuple(labels.get(n, "") for n in self.label_names)
        i = bisect.bisect_left(self.buckets, value)
        with self._lock:
            counts = self._counts.get(key)
            if counts is None:
                counts = self._counts[key] = [0] * len(self.buckets)
            if i < len(counts):
                counts[i] += 1
            self._sums[key] += value
            self._totals[key] += 1

    def _cumulative(self, key: tuple) -> list[int]:
        counts = self._counts.get(key)
        if counts is None:
            return [0] * len(self.buckets)
        return list(itertools.accumulate(counts))

    def snapshot(self, **labels: str) -> tuple[list[int], int]:
        """(cumulative bucket counts, total) at this instant — pair with
        percentile_since for windowed percentiles (bench measured phase).
        Read under the lock: observe() runs in worker threads (the solve
        fetch), and a half-updated (counts, total) pair would misreport
        the window (the LK205 unlocked-read family)."""
        key = tuple(labels.get(n, "") for n in self.label_names)
        with self._lock:
            return self._cumulative(key), self._totals.get(key, 0)

    def percentile(self, q: float, **labels: str) -> float:
        """Approximate percentile from bucket counts (for reports/bench)."""
        return self.percentile_since(
            q, ([0] * len(self.buckets), 0), **labels)

    def percentile_since(self, q: float, base: tuple[list[int], int],
                         **labels: str) -> float:
        """Percentile over observations made after `base = snapshot()`.

        Bucket counts are cumulative (observe() increments every bucket
        ≥ value), so the first bucket whose delta reaches the rank is the
        answer directly."""
        key = tuple(labels.get(n, "") for n in self.label_names)
        base_counts, base_total = base
        with self._lock:
            total = self._totals.get(key, 0) - base_total
            if key not in self._counts or total <= 0:
                return math.nan
            counts = self._cumulative(key)
        rank = q * total
        for i, (c, b) in enumerate(zip(counts, base_counts)):
            if c - b >= rank:
                return self.buckets[i]
        return self.buckets[-1]

    def count(self, **labels: str) -> int:
        key = tuple(labels.get(n, "") for n in self.label_names)
        return self._totals.get(key, 0)

    def sum(self, **labels: str) -> float:
        key = tuple(labels.get(n, "") for n in self.label_names)
        return self._sums.get(key, 0.0)

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_esc_help(self.help)}",
                 f"# TYPE {self.name} histogram"]
        # Consistent snapshot under the lock (see Counter._render): a
        # worker-thread observe() landing a new key mid-iteration raised,
        # and a sum/count torn across an observe misstates the series.
        with self._lock:
            series = [(key, self._cumulative(key), self._totals[key],
                       self._sums[key]) for key in sorted(self._totals)]
        for key, counts, total, sum_ in series:
            base = ",".join(f'{n}="{_esc_label(v)}"'
                            for n, v in zip(self.label_names, key))
            for b, c in zip(self.buckets, counts):
                sep = "," if base else ""
                lines.append(f'{self.name}_bucket{{{base}{sep}le="{b}"}} {c}')
            sep = "," if base else ""
            lines.append(f'{self.name}_bucket{{{base}{sep}le="+Inf"}} {total}')
            lines.append(f"{self.name}_sum{{{base}}} {sum_}")
            lines.append(f"{self.name}_count{{{base}}} {total}")
        return "\n".join(lines)


class WindowedLatencyRecorder:
    """Exact windowed percentiles from raw observations (ROADMAP #3's
    p999 prerequisite): a bounded ring of the last `capacity` values,
    read by (mark, percentiles_since) pairs the way the bench uses
    Histogram.snapshot/percentile_since — but returning TRUE order
    statistics instead of bucket edges, which a 16-bucket power-of-two
    histogram cannot resolve at p999.

    observe() is deliberately lock-free — one slot write + one integer
    increment, GIL-atomic in practice — so the recorder stays off the
    histogram lock's hot path; a racing observer can at worst overwrite
    one sample, never corrupt the ring. Windows larger than the capacity
    degrade to the newest `capacity` observations (the tail is what the
    high quantiles need)."""

    __slots__ = ("capacity", "_buf", "_n")

    def __init__(self, capacity: int = 1 << 17):
        self.capacity = capacity
        self._buf = [0.0] * capacity
        self._n = 0

    def observe(self, value: float) -> None:
        i = self._n
        self._buf[i % self.capacity] = value
        self._n = i + 1

    def mark(self) -> int:
        """Window-start marker; pass to percentiles_since."""
        return self._n

    def count_since(self, mark: int) -> int:
        return self._n - mark

    def percentiles_since(self, mark: int,
                          qs: Iterable[float]) -> dict[float, float]:
        """Exact percentiles over observations after `mark` (nearest-rank
        on the sorted window). NaN when the window is empty; windows
        beyond capacity use the newest `capacity` values."""
        n = self._n
        window = n - mark
        if window <= 0:
            return {q: math.nan for q in qs}
        take = min(window, self.capacity)
        cap = self.capacity
        if n <= cap:
            vals = self._buf[n - take:n]
        else:
            lo = (n - take) % cap
            hi = n % cap
            vals = self._buf[lo:] + self._buf[:hi] if lo >= hi \
                else self._buf[lo:hi]
        vals.sort()
        return {q: vals[min(max(math.ceil(q * take) - 1, 0), take - 1)]
                for q in qs}


class Registry:
    def __init__(self):
        self._metrics: dict[str, object] = {}

    def counter(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Counter:
        if name not in self._metrics:
            self._metrics[name] = Counter(name, help_, labels)
        return self._metrics[name]  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", labels: Iterable[str] = ()) -> Gauge:
        if name not in self._metrics:
            self._metrics[name] = Gauge(name, help_, labels)
        return self._metrics[name]  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", labels: Iterable[str] = (),
                  **kw) -> Histogram:
        if name not in self._metrics:
            self._metrics[name] = Histogram(name, help_, labels, **kw)
        return self._metrics[name]  # type: ignore[return-value]

    def render(self) -> str:
        return "\n".join(m.render() for m in self._metrics.values()) + "\n"


class WatchMetrics:
    """Watch-dispatch efficiency counters (the apiserver's
    `apiserver_watch_cache_*` family analog, SURVEY §3.3).

    The interned selector index (store/mvcc.py `_ResourceWatchers`) makes
    dispatch O(matching watchers); these counters are the evidence:
    `watch_predicate_checks_total` staying O(events) while watcher count
    grows is the regression guard, and dispatched/checks is the fan-out
    efficiency the bench detail JSON reports per run.
    """

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.events_dispatched = r.counter(
            "watch_events_dispatched_total",
            "Watch events delivered to watcher channels")
        self.predicate_checks = r.counter(
            "watch_predicate_checks_total",
            "Selector/field predicate evaluations during watch dispatch "
            "(one per interned selector group, one per index candidate)")
        self.index_hits = r.counter(
            "watch_index_hits_total",
            "Events routed through the tracked-field exact-value index")

    def register_into(self, registry: Registry) -> None:
        """Expose these counters through another registry's render: the
        store owns its WatchMetrics (private registry), the apiserver
        surfaces them at /metrics — same Counter objects, one source of
        truth."""
        for c in (self.events_dispatched, self.predicate_checks,
                  self.index_hits):
            registry._metrics.setdefault(c.name, c)


class WatchCacheMetrics:
    """Watch-cache serving-tier counters (the reference's
    `apiserver_watch_cache_*` / `apiserver_cache_list_*` families,
    SURVEY §L0): hits are LIST/watch-establishment requests answered
    from the RV-snapshotted cache, misses are requests the tier had to
    hand to the mvcc core (cold per-resource seed, backfill older than
    the ring), and `watch_cache_ring_len` is the per-resource replay
    ring depth — the "how much backfill can I serve" gauge. The bench
    detail JSON reports hit/miss deltas per measured phase; a relist
    storm that stays all-hits is the tier working."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.hits = r.counter(
            "watch_cache_hits_total",
            "LIST/watch requests served from the watch-cache tier "
            "without touching the mvcc core")
        self.misses = r.counter(
            "watch_cache_misses_total",
            "LIST/watch requests the watch-cache tier handed to the "
            "mvcc core (cold resource seed, pre-ring backfill)")
        self.ring_len = r.gauge(
            "watch_cache_ring_len",
            "Retained events in the per-resource watch-cache replay ring",
            labels=("resource",))

    def register_into(self, registry: Registry) -> None:
        """Surface these through a server registry's render (the
        WatchMetrics register_into pattern: same objects, one truth)."""
        for m in (self.hits, self.misses, self.ring_len):
            registry._metrics.setdefault(m.name, m)


class ChurnMetrics:
    """Churn-battery counters (perf/churn — ROADMAP #2's scenario
    battery): open-loop arrivals enqueued per model, fault-timeline
    events injected per kind, and summed time-to-recovery per kind.
    FaultInjector and ChurnDriver increment these; the bench detail JSON reports
    the per-phase deltas, and `register_into` surfaces them through a
    server registry's /metrics render (the WatchMetrics pattern: same
    objects, one truth)."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.arrivals = r.counter(
            "churn_arrivals_total",
            "Open-loop pod arrivals enqueued by the churn driver",
            labels=("model",))
        self.faults_injected = r.counter(
            "churn_faults_injected_total",
            "Fault-timeline events injected by the churn battery",
            labels=("kind",))
        self.recovery_seconds = r.counter(
            "churn_recovery_seconds_total",
            "Summed time-to-recovery of disruptive injected faults "
            "(displaced pods rescheduled, backlog under threshold)",
            labels=("kind",))
        self.backlog_peak = r.gauge(
            "churn_queue_backlog_peak",
            "Peak scheduler queue backlog observed during the latest "
            "open-loop churn phase")

    def register_into(self, registry: Registry) -> None:
        for m in (self.arrivals, self.faults_injected,
                  self.recovery_seconds, self.backlog_peak):
            registry._metrics.setdefault(m.name, m)


class DurabilityMetrics:
    """WAL + recovery counters (store/durable.py — SURVEY §5.4): events
    appended to the write-ahead log, fsync wall per group commit (the
    durability tax the fsync policy trades), and events replayed from
    WAL segments on recovery."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.appends = r.counter(
            "wal_appends_total",
            "Committed events appended to the write-ahead log")
        self.fsync_seconds = r.histogram(
            "wal_fsync_seconds",
            "Wall time of each WAL fsync (per commit under "
            "fsync=always, per group-commit flush under fsync=batch)")
        self.replayed = r.counter(
            "wal_replay_entries_total",
            "WAL events replayed into a store during crash recovery")

    def register_into(self, registry: Registry) -> None:
        for m in (self.appends, self.fsync_seconds, self.replayed):
            registry._metrics.setdefault(m.name, m)


class HAMetrics:
    """Leader-election observability (client/leaderelection.py — SURVEY
    §5.3): elections won by this process and whether it currently holds
    the lease. An active/standby scheduler pair exposes these so a
    failover (standby's elections counter incrementing, the old
    leader's gauge dropping) is data, not log noise."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.elections = r.counter(
            "leader_elections_total",
            "Lease acquisitions won by this elector (first acquisition "
            "and every re-acquisition after losing the lease)")
        self.is_leader = r.gauge(
            "scheduler_is_leader",
            "1 while this scheduler process holds the leader lease, "
            "else 0")

    def register_into(self, registry: Registry) -> None:
        for m in (self.elections, self.is_leader):
            registry._metrics.setdefault(m.name, m)


class DeschedulerMetrics:
    """Rebalance-descheduler counters (controllers/descheduler.py):
    evict-and-replace consolidation moves actually issued. The
    disruption budget bounds the per-cycle delta; the ChurnRebalance
    family reports the phase total next to the fragmentation-over-time
    curve."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.evictions = r.counter(
            "descheduler_evictions_total",
            "Pods evicted (and re-created unbound) by the rebalance "
            "descheduler's consolidation moves")

    def register_into(self, registry: Registry) -> None:
        registry._metrics.setdefault(self.evictions.name, self.evictions)


#: verbs counted as mutating for apiserver_current_inflight_requests'
#: request_kind label (the reference's mutating/readOnly split).
_MUTATING_VERBS = frozenset(("create", "update", "patch", "delete"))


class APIServerMetrics:
    """The apiserver request metric families (SURVEY §5.5's dashboard
    contract): request latency by verb/resource/code and the in-flight
    gauge by request kind. Emitted from BOTH serving paths — the HTTP
    middleware chain and the KTPU wire's frame handler — into one shared
    instance, so /metrics shows the server's whole request load no matter
    which wire carried it. Long-running requests (watches) are excluded
    from both families: inflight like the reference, and duration
    because a watch's "latency" is its stream lifetime (and the two
    wires would otherwise report incompatible views of the same verb)."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.request_duration = r.histogram(
            "apiserver_request_duration_seconds",
            "Response latency distribution by verb, resource and "
            "HTTP-equivalent status code",
            labels=("verb", "resource", "code"))
        self.inflight = r.gauge(
            "apiserver_current_inflight_requests",
            "Currently executing (non-long-running) requests",
            labels=("request_kind",))

    def register_into(self, registry: Registry) -> None:
        for m in (self.request_duration, self.inflight):
            registry._metrics.setdefault(m.name, m)

    @staticmethod
    def _kind(verb: str) -> str:
        return "mutating" if verb in _MUTATING_VERBS else "readOnly"

    def observe(self, verb: str, resource: str, code: int,
                seconds: float) -> None:
        self.request_duration.observe(
            seconds, verb=verb, resource=resource, code=str(code))

    def inc_inflight(self, verb: str) -> None:
        self.inflight.inc(1, request_kind=self._kind(verb))

    def dec_inflight(self, verb: str) -> None:
        self.inflight.inc(-1, request_kind=self._kind(verb))


class SchedulerMetrics:
    """The scheduler's metric contract (pkg/scheduler/metrics/metrics.go)."""

    def __init__(self, registry: Registry | None = None):
        r = registry or Registry()
        self.registry = r
        self.schedule_attempts = r.counter(
            "scheduler_schedule_attempts_total",
            "Number of attempts to schedule pods, by result",
            labels=("result", "profile"))
        self.attempt_duration = r.histogram(
            "scheduler_scheduling_attempt_duration_seconds",
            "Scheduling attempt latency", labels=("result", "profile"))
        self.e2e_sli_duration = r.histogram(
            "scheduler_pod_scheduling_sli_duration_seconds",
            "E2E pod scheduling latency incl. queue time", labels=("attempts",))
        self.pending_pods = r.gauge(
            "scheduler_pending_pods", "Pending pods by queue",
            labels=("queue",))
        self.plugin_duration = r.histogram(
            "scheduler_plugin_execution_duration_seconds",
            "Per-plugin execution time",
            labels=("plugin", "extension_point"))
        self.extension_point_duration = r.histogram(
            "scheduler_framework_extension_point_duration_seconds",
            "Per-extension-point time", labels=("extension_point", "profile"))
        self.preemption_victims = r.histogram(
            "scheduler_preemption_victims", "Victims per preemption",
            buckets=(1, 2, 4, 8, 16, 32, 64))
        self.queue_incoming = r.counter(
            "scheduler_queue_incoming_pods_total",
            "Pods added to queues", labels=("event", "queue"))
        self.goroutines = r.gauge(
            "scheduler_goroutines", "Concurrent binding tasks", labels=("operation",))
        #: §5.5 explainability for the TPU backend's degraded modes, one
        #: increment per affected pod/gang: kind="spread_poisoned"
        #: (spread pod missed the union scan table — steady-state zero),
        #: kind="host_fallback" (pod took a per-pod host plugin row),
        #: kind="gang_overflow" (gangs beyond the solver's capacity
        #: degrade to Permit-barrier-only atomicity).
        self.backend_degradations = r.counter(
            "scheduler_tpu_backend_degradations_total",
            "TPU backend fallbacks to degraded modes", labels=("kind",))
        #: Solve-side observability (the r8 50k profile's blind spot: the
        #: device solve runs in XLA's compute threads, invisible to a
        #: main-thread sampler). Per-chunk wall of the fused solve as the
        #: consumer sees it, the width of the solver's per-step reduce
        #: (K + P when the shortlist prunes, N when it doesn't), and the
        #: shortlist's exactness-fallback accounting — hit rate is
        #: 1 - fallbacks/pods.
        self.solve_duration = r.histogram(
            "scheduler_tpu_solve_seconds",
            "Device-solve wall time per chunk (dispatch to fetched)")
        self.solver_scan_width = r.gauge(
            "scheduler_tpu_solver_scan_width",
            "Per-step candidate width of the latest chunk's solve")
        self.solver_shortlist_pods = r.counter(
            "scheduler_tpu_solver_shortlist_pods_total",
            "Pods solved through the shortlist-pruned scan")
        self.solver_shortlist_fallbacks = r.counter(
            "scheduler_tpu_solver_shortlist_fallbacks_total",
            "Pods whose shortlist bound check fell back to the full row")
        #: Block-sparse index observability: the two-pass prefilter's
        #: O(C·B) bound scan always walks every (class, block) pair —
        #: that is `scanned`; `pruned` counts the pairs whose columns
        #: the gather pass then NEVER touched because the block's score
        #: upper bound provably lost to the (K+1)-th shortlist value
        #: (prune rate = pruned/scanned; 0 on chunks where the
        #: exactness predicate forced the full-width prefilter). The
        #: refresh histogram is the serving tier's incremental
        #: per-block aggregate maintenance wall — O(changed blocks)
        #: per snapshot refresh, same dirty set as the resident planes.
        self.solver_blocks_scanned = r.counter(
            "scheduler_tpu_solver_blocks_scanned_total",
            "(class, block) pairs walked by the block-bound prefilter "
            "scan")
        self.solver_blocks_pruned = r.counter(
            "scheduler_tpu_solver_blocks_pruned_total",
            "(class, block) pairs the bound scan proved losers — their "
            "columns skipped the chunk-start score pass")
        self.solver_block_refresh = r.histogram(
            "scheduler_tpu_solver_block_refresh_seconds",
            "Wall time of one incremental block-aggregate refresh "
            "(dirty blocks only) on the resident planes")
        #: Wavefront-solve observability (r18): the wave width the latest
        #: chunk solved at (1 = serial scan — kill switch or narrowed
        #: policy), pods committed speculatively, and pods that fell
        #: into the exact serial replay. The replay fraction
        #: replays/(commits+replays) is the signal the AdaptiveTuner's
        #: width-narrowing rule keys on — recorded data, not a guess.
        self.solver_wave_width = r.gauge(
            "scheduler_tpu_solver_wave_width",
            "Pods evaluated per scan step by the latest chunk's solve")
        self.solver_wave_commits = r.counter(
            "scheduler_tpu_solver_wave_commits_total",
            "Pods committed speculatively by the wavefront solve")
        self.solver_wave_replays = r.counter(
            "scheduler_tpu_solver_wave_replays_total",
            "Pods placed through the wavefront solve's exact serial "
            "replay")
        #: Global-assignment observability (r20): chunks solved through
        #: the Sinkhorn transport plan + feasible rounding, chunks the
        #: tuner WANTED optimal but degraded to greedy (spread strategy
        #: or per-pod planes make the C x N plan ineligible), the
        #: iteration budget the latest optimal solve ran, and the
        #: cluster fragmentation the placement left behind — mean free
        #: fraction over OCCUPIED nodes, the quantity optimal mode
        #: packs down and the descheduler consolidates.
        self.solver_optimal_solves = r.counter(
            "solver_optimal_mode_solves_total",
            "Chunks solved through the Sinkhorn optimal-assignment mode")
        self.solver_optimal_fallbacks = r.counter(
            "solver_optimal_fallbacks_total",
            "Chunks routed to optimal mode that degraded to the greedy "
            "wavefront scan (ineligible planes or spread strategy)")
        self.solver_sinkhorn_iterations = r.gauge(
            "solver_sinkhorn_iterations",
            "Sinkhorn iteration budget of the latest optimal-mode solve")
        #: Pallas fused-kernel observability: chunks whose wavefront
        #: solve ran the fused kernel (interpret or compiled), and
        #: chunks where the router WANTED the kernel (KTPU_PALLAS
        #: resolved on) but fell back to the lax.scan reference — the
        #: reason label separates structural shapes the kernel does not
        #: fuse (spread/shortlist/optimal/wave_off/shape) from a
        #: backend without a pallas lowering (unavailable). The kill
        #: switch (KTPU_PALLAS=off) and the CPU auto default do NOT
        #: count: off-by-policy is not a fallback.
        self.solver_pallas_solves = r.counter(
            "solver_pallas_solves_total",
            "Chunks solved through the fused Pallas wavefront kernel")
        self.solver_pallas_fallbacks = r.counter(
            "solver_pallas_fallbacks_total",
            "Chunks routed to the Pallas kernel that fell back to the "
            "lax.scan reference", labels=("reason",))
        self.fragmentation_pct = r.gauge(
            "scheduler_fragmentation_pct",
            "Mean stranded-capacity fraction (pct) across occupied "
            "nodes after the latest measured run")
        #: Topology-slice observability (kubernetes_tpu/topology —
        #: ROADMAP #5's shaped-gang direction): gangs whose Permit
        #: contiguity check released a whole slice, the
        #: stranded-for-shape free capacity the latest slice plan saw
        #: (free cells NO feasible placement of the requested shape
        #: covers — the mesh analog of scheduler_fragmentation_pct),
        #: and coordinate-plane rebuilds (steady state: reuse, zero).
        self.slice_gangs_bound = r.counter(
            "scheduler_slice_gangs_bound_total",
            "Slice-shaped gangs released by Permit as one contiguous "
            "sub-mesh")
        self.slice_fragmentation_pct = r.gauge(
            "scheduler_slice_fragmentation_pct",
            "Free mesh cells covered by NO feasible placement of the "
            "most recently planned slice shape (pct)")
        self.topology_plane_rebuilds = r.counter(
            "topology_plane_rebuilds_total",
            "Rebuilds of the tensorized interconnect coordinate planes "
            "(mesh flags or node set moved; reuse does not count)")
        #: Sharded-control-plane observability (ROADMAP #5): per-shard
        #: host-prep rebuild counts (a shard increments only when its
        #: rows were actually rewritten — the incremental path's
        #: witness), the device-solve wall attributed to the sharded
        #: path (one fused program spans every shard on this hardware,
        #: so the label carries the shard COUNT the solve ran under,
        #: not a shard id), and the top-level cross-shard argmax
        #: reductions (one per pod step when S > 1).
        #: Class-dictionary device-plane observability (r14): host prep
        #: wall per chunk (the 200k bound the class planes attack — the
        #: prep-vs-solve split per family), real pod-equivalence classes
        #: behind the latest chunk's (C,N) planes (P on a per-pod
        #: fallback), bytes of plane payloads actually device_put
        #: (mask + score planes including cache fills, plus the per-chunk
        #: class index / exception / rep-row pack), and pods that rode a
        #: per-pod fallback because their chunk's distinct classes
        #: overflowed KTPU_CLASS_PAD (the kill switch does NOT count —
        #: only genuine class splits).
        self.prep_duration = r.histogram(
            "scheduler_tpu_prep_seconds",
            "Host-side chunk prep wall time (rows, classes, uploads)")
        self.plane_classes = r.gauge(
            "scheduler_tpu_plane_classes_per_chunk",
            "Pod equivalence classes behind the latest chunk's planes")
        self.plane_bytes = r.counter(
            "scheduler_tpu_plane_bytes_uploaded_total",
            "Bytes of mask/score plane payloads uploaded to the device")
        self.class_split_fallbacks = r.counter(
            "scheduler_tpu_class_split_fallbacks_total",
            "Pods solved through per-pod fallback planes after class "
            "overflow")
        self.shard_tensor_rebuilds = r.counter(
            "scheduler_tpu_shard_tensor_rebuilds_total",
            "Host-prep tensor rebuilds per control-plane shard",
            labels=("shard",))
        self.shard_solve_seconds = r.counter(
            "scheduler_tpu_shard_solve_seconds_total",
            "Device-solve wall under the sharded control plane",
            labels=("shards",))
        self.cross_shard_reductions = r.counter(
            "scheduler_tpu_cross_shard_reductions_total",
            "Top-level cross-shard argmax reductions (pod steps)")
        #: Serving-tier observability (kubernetes_tpu/serving, ROADMAP
        #: #3): the admission window's current coalesce hold (0 =
        #: dispatch-immediately), lone pods placed through the pinned
        #: C=1 fast path, dispatches whose window merged extra pods,
        #: and the resident device-plane refresh accounting (count +
        #: wall of the O(changed) delta requantize/scatter that
        #: replaces the per-assign full used-state upload).
        self.admission_window = r.gauge(
            "scheduler_admission_window_seconds",
            "Serving admission coalesce window applied to the latest "
            "dispatch (0 = immediate)")
        self.serving_fast_path_pods = r.counter(
            "serving_fast_path_pods_total",
            "Pods placed through the pinned single-pod fast path")
        self.serving_coalesced_batches = r.counter(
            "serving_coalesced_batches_total",
            "Dispatches whose admission window merged extra pods")
        self.resident_plane_refreshes = r.counter(
            "resident_plane_refreshes_total",
            "Refreshes of the device-resident used-state planes "
            "(incremental scatter or full rebuild)")
        self.resident_plane_refresh = r.histogram(
            "resident_plane_refresh_seconds",
            "Wall time of one resident-plane refresh (delta "
            "re-quantize + device scatter)")

        #: exact windowed percentile recorders riding attempt_duration's
        #: observe path, keyed by (result, profile) — the same population
        #: split as the histogram's labels, so the bench's exact
        #: percentiles replace the bucket-edge values one-for-one.
        #: Lock-free ring appends (see WindowedLatencyRecorder).
        self.attempt_windows: dict[
            tuple[str, str], WindowedLatencyRecorder] = {}

    def attempt_window(self, result: str = "scheduled",
                       profile: str = "default-scheduler") \
            -> WindowedLatencyRecorder:
        key = (result, profile)
        w = self.attempt_windows.get(key)
        if w is None:
            w = self.attempt_windows[key] = WindowedLatencyRecorder()
        return w

    def observe_plugin(self, plugin: str, point: str, seconds: float) -> None:
        self.plugin_duration.observe(seconds, plugin=plugin, extension_point=point)

    def observe_attempt(self, result: str, profile: str, seconds: float) -> None:
        self.schedule_attempts.inc(result=result, profile=profile)
        self.attempt_duration.observe(seconds, result=result, profile=profile)
        key = (result, profile)
        w = self.attempt_windows.get(key)
        if w is None:
            w = self.attempt_windows[key] = WindowedLatencyRecorder()
        w.observe(seconds)

    def set_pending(self, stats: Mapping[str, int]) -> None:
        for queue, n in stats.items():
            self.pending_pods.set(n, queue=queue)
