"""scheduler_perf: the reference's scale benchmark harness, in process.

Parity target: test/integration/scheduler_perf/ (scheduler_perf.go,
config/performance-config.yaml — SURVEY §3.5). Same trick: in-process
control plane, **no kubelets** — Node objects are data, pods "run" because
nothing contradicts Bind. Same workload shape:

    - name: SchedulingBasic
      workloadTemplate:
      - opcode: createNodes
        countParam: $initNodes
        nodeTemplate: {...}            # make_node kwargs
      - opcode: createPods
        countParam: $initPods
        podTemplate: {...}             # make_pod kwargs
      - opcode: createPods
        countParam: $measurePods
        collectMetrics: true           # the measured phase
      - opcode: barrier                # wait until all created pods scheduled
      workloads:
      - name: 5000Nodes
        params: {initNodes: 5000, initPods: 1000, measurePods: 10000}

Copy of `kubernetes_tpu/perf/scheduler_perf.py`, cut to the in-process run
(no apiserver, multi-process control plane, node agents or policy chain)
and the opcodes createNodes, createPods (without resource claims), barrier
and sleep. `WorkloadResult` keeps the fields this path fills, under the
reference's names. A barrier raises the scheduler loop's own exception as
soon as `Scheduler.run` ends with one (the port has no backend fallback),
where the reference's would wait out its deadline. SchedulingBasic's
workload is a constant here (`SCHEDULING_BASIC`, equal to the reference's
YAML entry), so the harness needs no YAML parser unless `load_config` is
given a path.

Metrics over the measured phase: SchedulingThroughput (pods/s),
scheduling_attempt_duration percentiles (exact order statistics of the
measured window, p50/p90/p99/p999), node fragmentation % (all nodes and
occupied nodes), the event broadcaster's emitted/dropped counts, and the
backend's and serving tier's counters.

Run: `python -m kubernetes_tpu_torch.perf.scheduler_perf [config.yaml]
--filter SchedulingBasic/5000Nodes` runs TorchBackend on cuda:0 with
16384-pod pops (the reference bench's); `--device cpu` runs the kernels'
plain versions and `--backend host` the host path alone.
"""

from __future__ import annotations

import asyncio
import copy
import json
import math
import time
from typing import Any, Mapping

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store import (
    install_core_validation, new_cluster_store)

#: SchedulingBasic of the reference's performance-config.yaml.
SCHEDULING_BASIC = {
    "name": "SchedulingBasic",
    "workloadTemplate": [
        {"opcode": "createNodes", "countParam": "$initNodes"},
        {"opcode": "createPods", "countParam": "$initPods"},
        {"opcode": "createPods", "countParam": "$measurePods",
         "collectMetrics": True},
        {"opcode": "barrier"},
    ],
    "workloads": [
        {"name": "100Nodes",
         "params": {"initNodes": 100, "initPods": 500, "measurePods": 1000}},
        {"name": "1000Nodes",
         "params": {"initNodes": 1000, "initPods": 1000,
                    "measurePods": 3000}},
        {"name": "5000Nodes",
         "params": {"initNodes": 5000, "initPods": 1000,
                    "measurePods": 10000}},
    ],
}

#: Per-family runner settings of the reference's suite that this harness
#: does not have; a config naming one is refused, not run differently.
_UNSUPPORTED_CASE_KEYS = ("schedulerConfig", "throughApiserver",
                          "policyCount", "policyTenants", "auditLevel")


def _subst(value: Any, params: Mapping[str, Any]) -> Any:
    """$param substitution (countParam etc.)."""
    if isinstance(value, str) and value.startswith("$"):
        return params[value[1:]]
    return value


def _resolve_count(op: Mapping, params: Mapping[str, Any]) -> int:
    if "countParam" in op:
        return int(_subst(op["countParam"], params))
    return int(op.get("count", 0))


class WorkloadResult:
    """One workload's result: the reference's fields that this path fills."""

    def __init__(self):
        self.throughput = 0.0          # pods/s over the measured phase
        self.measured_pods = 0
        self.measured_seconds = 0.0
        self.attempt_p50 = 0.0
        self.attempt_p90 = 0.0
        self.attempt_p99 = 0.0
        #: exact-only (the 16-bucket histogram cannot resolve it): true
        #: p999 attempt latency over the measured window.
        self.attempt_p999 = float("nan")
        #: True when p50/p90/p99/p999 came from the exact windowed
        #: recorder (raw order statistics) rather than bucket edges.
        self.attempt_percentiles_exact = False
        self.fragmentation_pct = 0.0
        #: mean free fraction over OCCUPIED nodes (the packing metric the
        #: optimal mode lowers; the all-nodes figure above is
        #: placement-invariant once every pod places).
        self.fragmentation_occupied_pct = 0.0
        self.scheduled_total = 0
        self.unschedulable_total = 0
        #: DropIfChannelFull accounting (bounded event broadcaster).
        self.events_emitted_total = 0
        self.events_dropped_total = 0
        #: watch dispatch and watch-cache counters over the measured phase.
        self.watch_events_dispatched_total = 0
        self.watch_predicate_checks_total = 0
        self.watch_cache_hits_total = 0
        self.watch_cache_misses_total = 0
        #: solve-side accounting over the measured phase: chunk count and
        #: total solve wall (scheduler_tpu_solve_seconds), the latest
        #: chunk's scan and wave widths, commits and replays, and the
        #: optimal-mode solves and fallbacks.
        self.solver_solve_chunks = 0
        self.solver_solve_seconds_total = 0.0
        self.solver_scan_width = 0
        self.solver_wave_width = 0
        self.solver_wave_commits_total = 0
        self.solver_wave_replays_total = 0
        self.solver_optimal_solves_total = 0
        self.solver_optimal_fallbacks_total = 0
        #: serving-tier accounting over the measured phase (zeros under
        #: KTPU_SERVING=0).
        self.serving_fast_path_pods_total = 0
        self.serving_coalesced_batches_total = 0
        self.resident_plane_refreshes_total = 0
        self.resident_plane_refresh_seconds_total = 0.0
        self.admission_window_ms = 0.0
        #: createNodes opcode wall (data staging).
        self.staging_seconds = 0.0

    def as_dict(self) -> dict:
        def ms(v: float):
            return None if math.isnan(v) else round(v * 1e3, 3)

        return {
            "throughput_pods_per_sec": round(self.throughput, 2),
            "measured_pods": self.measured_pods,
            "measured_seconds": round(self.measured_seconds, 3),
            "attempt_p50_ms": ms(self.attempt_p50),
            "attempt_p90_ms": ms(self.attempt_p90),
            "attempt_p99_ms": ms(self.attempt_p99),
            "attempt_p999_ms": ms(self.attempt_p999),
            "attempt_percentiles_exact": self.attempt_percentiles_exact,
            "fragmentation_pct": round(self.fragmentation_pct, 2),
            "fragmentation_occupied_pct": round(
                self.fragmentation_occupied_pct, 2),
            "scheduled_total": self.scheduled_total,
            "unschedulable_total": self.unschedulable_total,
            "events_dropped_total": self.events_dropped_total,
            "events_dropped_pct": round(
                100.0 * self.events_dropped_total
                / self.events_emitted_total, 2)
            if self.events_emitted_total else 0.0,
            "watch_events_dispatched_total":
                self.watch_events_dispatched_total,
            "watch_predicate_checks_total":
                self.watch_predicate_checks_total,
            "watch_cache_hits_total": self.watch_cache_hits_total,
            "watch_cache_misses_total": self.watch_cache_misses_total,
            "solver_solve_chunks": self.solver_solve_chunks,
            "solver_solve_seconds_total": round(
                self.solver_solve_seconds_total, 3),
            "solver_scan_width": self.solver_scan_width,
            "solver_wave_width": self.solver_wave_width,
            "solver_wave_commits_total": self.solver_wave_commits_total,
            "solver_wave_replays_total": self.solver_wave_replays_total,
            "solver_wave_replay_pct": round(
                100.0 * self.solver_wave_replays_total
                / (self.solver_wave_commits_total
                   + self.solver_wave_replays_total), 2)
            if (self.solver_wave_commits_total
                + self.solver_wave_replays_total) else None,
            "solver_optimal_solves_total": self.solver_optimal_solves_total,
            "solver_optimal_fallbacks_total":
                self.solver_optimal_fallbacks_total,
            "serving_fast_path_pods_total": self.serving_fast_path_pods_total,
            "serving_coalesced_batches_total":
                self.serving_coalesced_batches_total,
            "resident_plane_refreshes_total":
                self.resident_plane_refreshes_total,
            "resident_plane_refresh_seconds_total": round(
                self.resident_plane_refresh_seconds_total, 4),
            "admission_window_ms": self.admission_window_ms,
            "staging_seconds": round(self.staging_seconds, 3),
        }


DEFAULT_NODE_TEMPLATE = {
    "allocatable": {"cpu": "8", "memory": "32Gi", "pods": "110"}}
DEFAULT_POD_TEMPLATE = {
    "requests": {"cpu": "100m", "memory": "250Mi"}}


class PerfRunner:
    """Executes one workload (template ops + params) against an in-process
    store + scheduler, mirroring mustSetupCluster → runWorkload."""

    def __init__(self, backend=None, batch_size: int = 1,
                 scheduler_kwargs: Mapping | None = None):
        self.backend = backend
        self.batch_size = batch_size
        self.scheduler_kwargs = dict(scheduler_kwargs or {})

    async def run(self, template_ops: list, params: Mapping[str, Any],
                  timeout: float = 600.0) -> WorkloadResult:
        backing = new_cluster_store(shards=1)
        install_core_validation(backing)
        try:
            metrics = SchedulerMetrics()
            sched = Scheduler(backing, seed=42, backend=self.backend,
                              metrics=metrics, **self.scheduler_kwargs)
            factory = InformerFactory(backing)
            await sched.setup_informers(factory)
        except BaseException:
            backing.stop()
            raise
        return await self._drive(template_ops, params, timeout, backing,
                                 metrics, sched, factory)

    async def _drive(self, template_ops: list, params: Mapping[str, Any],
                     timeout: float, store, metrics: SchedulerMetrics,
                     sched: Scheduler, factory) -> WorkloadResult:
        """The opcode loop."""
        # Bound-pod accounting via watch events, not store LISTs: a LIST
        # deep-copies every object and was the harness's own hot spot.
        bound_keys: set[str] = set()

        def _track(obj):
            if obj.get("spec", {}).get("nodeName"):
                bound_keys.add(namespaced_name(obj))

        factory.informer("pods").add_event_handler(ResourceEventHandler(
            on_add=_track, on_update=lambda old, new: _track(new),
            on_delete=lambda obj: bound_keys.discard(namespaced_name(obj))))

        factory.start()
        await factory.wait_for_sync()
        run_task = asyncio.ensure_future(
            sched.run(batch_size=self.batch_size))

        result = WorkloadResult()
        node_count = 0
        pod_seq = 0
        created_total = 0
        deadline = time.monotonic() + timeout
        try:
            for op in template_ops:
                opcode = op["opcode"]
                if opcode == "createNodes":
                    count = _resolve_count(op, params)
                    tmpl = {**DEFAULT_NODE_TEMPLATE,
                            **(op.get("nodeTemplate") or {})}
                    t0 = time.monotonic()

                    async def stage_node(i):
                        await store.create("nodes", make_node(
                            f"node-{node_count + i}",
                            **copy.deepcopy(tmpl)))

                    for lo in range(0, count, 512):
                        await asyncio.gather(*(
                            stage_node(i)
                            for i in range(lo, min(lo + 512, count))))
                    result.staging_seconds += time.monotonic() - t0
                    node_count += count

                elif opcode == "createPods":
                    count = _resolve_count(op, params)
                    tmpl = {**DEFAULT_POD_TEMPLATE,
                            **(op.get("podTemplate") or {})}
                    if "claim" in tmpl:
                        raise NotImplementedError(
                            "createPods with resource claims is not ported")
                    measured = bool(op.get("collectMetrics"))
                    if measured:
                        window = self._begin_measure(metrics, store)
                    names = [f"pod-{pod_seq + i}" for i in range(count)]
                    for lo in range(0, count, 512):
                        await asyncio.gather(*(
                            store.create("pods", make_pod(
                                name, **copy.deepcopy(tmpl)))
                            for name in names[lo:lo + 512]))
                    pod_seq += count
                    created_total += count
                    if op.get("scopedBarrier") or measured:
                        pod_ns = tmpl.get("namespace", "default")
                        want = {f"{pod_ns}/{n}" for n in names}
                        await self._wait_keys(bound_keys, want, deadline,
                                              run_task)
                    if measured:
                        self._end_measure(result, metrics, store, window,
                                          count)

                elif opcode == "barrier":
                    await self._wait_bound(bound_keys, created_total,
                                           deadline, run_task)

                elif opcode == "sleep":
                    await asyncio.sleep(float(
                        _subst(op.get("duration", 0), params)))

                else:
                    raise ValueError(f"unknown opcode {opcode!r}")
        finally:
            await sched.stop()
            run_task.cancel()
            factory.stop()
            store.stop()
        if run_task.done() and not run_task.cancelled() \
                and run_task.exception() is not None:
            raise run_task.exception()

        if result.measured_pods == 0:
            h = metrics.attempt_duration
            labels = {"result": "scheduled",
                      "profile": "default-scheduler"}
            result.attempt_p50 = h.percentile(0.50, **labels)
            result.attempt_p90 = h.percentile(0.90, **labels)
            result.attempt_p99 = h.percentile(0.99, **labels)
        result.scheduled_total = _result_count(metrics, "scheduled")
        result.unschedulable_total = _result_count(metrics, "unschedulable")
        result.fragmentation_pct = self._fragmentation(sched)
        result.fragmentation_occupied_pct = \
            self._fragmentation_occupied(sched)
        metrics.fragmentation_pct.set(result.fragmentation_occupied_pct)
        result.events_emitted_total = sched.recorder.emitted
        result.events_dropped_total = sched.recorder.dropped
        return result

    @staticmethod
    def _cache_totals(backing) -> tuple[float, float]:
        """(hits, misses) of the store's watch-cache tier (0s when the
        KTPU_WATCH_CACHE=0 kill switch disabled it)."""
        cacher = getattr(backing, "cacher", None)
        if cacher is None:
            return 0.0, 0.0
        return cacher.metrics.hits.value(), cacher.metrics.misses.value()

    def _begin_measure(self, metrics: SchedulerMetrics, backing) -> dict:
        wm = backing.watch_metrics
        hits, misses = self._cache_totals(backing)
        return {
            "hist": metrics.attempt_duration.snapshot(
                result="scheduled", profile="default-scheduler"),
            "t0": time.monotonic(),
            "dispatched": wm.events_dispatched.value(),
            "checks": wm.predicate_checks.value(),
            "cache_hits": hits, "cache_misses": misses,
            "solve_chunks": metrics.solve_duration.count(),
            "solve_s": metrics.solve_duration.sum(),
            "wave_commits": metrics.solver_wave_commits.value(),
            "wave_replays": metrics.solver_wave_replays.value(),
            "optimal": metrics.solver_optimal_solves.value(),
            "optimal_fallbacks": metrics.solver_optimal_fallbacks.value(),
            "fast": metrics.serving_fast_path_pods.value(),
            "coalesced": metrics.serving_coalesced_batches.value(),
            "refreshes": metrics.resident_plane_refreshes.value(),
            "refresh_s": metrics.resident_plane_refresh.sum(),
            "window": metrics.attempt_window().mark(),
        }

    def _end_measure(self, result: WorkloadResult,
                     metrics: SchedulerMetrics,
                     backing, base: dict, count: int) -> None:
        dt = time.monotonic() - base["t0"]
        result.measured_pods = count
        result.measured_seconds = dt
        result.throughput = count / dt if dt > 0 else 0.0
        h = metrics.attempt_duration
        labels = {"result": "scheduled", "profile": "default-scheduler"}
        result.attempt_p50 = h.percentile_since(0.50, base["hist"], **labels)
        result.attempt_p90 = h.percentile_since(0.90, base["hist"], **labels)
        result.attempt_p99 = h.percentile_since(0.99, base["hist"], **labels)
        # TRUE order-statistic percentiles over the measured window (the
        # exact recorder riding attempt_duration's observe path); the
        # bucket-edge values above remain only as the fallback when no
        # scheduled attempt landed in the window.
        exact = metrics.attempt_window().percentiles_since(
            base["window"], (0.50, 0.90, 0.99, 0.999))
        if not math.isnan(exact[0.50]):
            result.attempt_p50 = exact[0.50]
            result.attempt_p90 = exact[0.90]
            result.attempt_p99 = exact[0.99]
            result.attempt_p999 = exact[0.999]
            result.attempt_percentiles_exact = True
        wm = backing.watch_metrics
        result.watch_events_dispatched_total = int(
            wm.events_dispatched.value() - base["dispatched"])
        result.watch_predicate_checks_total = int(
            wm.predicate_checks.value() - base["checks"])
        hits, misses = self._cache_totals(backing)
        result.watch_cache_hits_total = int(hits - base["cache_hits"])
        result.watch_cache_misses_total = int(misses - base["cache_misses"])
        result.solver_solve_chunks = int(
            metrics.solve_duration.count() - base["solve_chunks"])
        result.solver_solve_seconds_total = \
            metrics.solve_duration.sum() - base["solve_s"]
        result.solver_scan_width = int(metrics.solver_scan_width.value())
        result.solver_wave_width = int(metrics.solver_wave_width.value())
        result.solver_wave_commits_total = int(
            metrics.solver_wave_commits.value() - base["wave_commits"])
        result.solver_wave_replays_total = int(
            metrics.solver_wave_replays.value() - base["wave_replays"])
        result.solver_optimal_solves_total = int(
            metrics.solver_optimal_solves.value() - base["optimal"])
        result.solver_optimal_fallbacks_total = int(
            metrics.solver_optimal_fallbacks.value()
            - base["optimal_fallbacks"])
        result.serving_fast_path_pods_total = int(
            metrics.serving_fast_path_pods.value() - base["fast"])
        result.serving_coalesced_batches_total = int(
            metrics.serving_coalesced_batches.value() - base["coalesced"])
        result.resident_plane_refreshes_total = int(
            metrics.resident_plane_refreshes.value() - base["refreshes"])
        result.resident_plane_refresh_seconds_total = \
            metrics.resident_plane_refresh.sum() - base["refresh_s"]
        # Gauge is base-unit seconds; the field keeps its ms name.
        result.admission_window_ms = 1e3 * metrics.admission_window.value()

    @staticmethod
    async def _wait_bound(bound_keys: set, want: int, deadline: float,
                          run_task: asyncio.Task) -> None:
        """barrierOp: block until every created pod has a nodeName."""
        while time.monotonic() < deadline:
            if len(bound_keys) >= want:
                return
            _raise_if_loop_died(run_task)
            await asyncio.sleep(0.01)
        raise TimeoutError(
            f"barrier: {len(bound_keys)}/{want} pods bound at timeout")

    @staticmethod
    async def _wait_keys(bound_keys: set, want: set, deadline: float,
                         run_task: asyncio.Task) -> None:
        """Scoped barrier: block until a specific key set is bound."""
        while time.monotonic() < deadline:
            if want <= bound_keys:
                return
            _raise_if_loop_died(run_task)
            await asyncio.sleep(0.01)
        missing = len(want - bound_keys)
        raise TimeoutError(
            f"scoped barrier: {missing} pods unbound at timeout")

    @staticmethod
    def _fragmentation(sched: Scheduler) -> float:
        """Mean free-capacity fraction across nodes (%, lower = tighter)."""
        snapshot = sched.cache.update_snapshot()
        if not len(snapshot):
            return 0.0
        total = 0.0
        for ni in snapshot:
            fracs = []
            for r, alloc in ni.allocatable.res.items():
                if alloc > 0:
                    fracs.append(
                        max(0.0, (alloc - ni.requested.get(r)) / alloc))
            total += sum(fracs) / len(fracs) if fracs else 1.0
        return 100.0 * total / len(snapshot)

    @staticmethod
    def _fragmentation_occupied(sched: Scheduler) -> float:
        """Mean free-capacity fraction across OCCUPIED nodes (%, the
        packing metric — ops/solver.fragmentation_occupied's host twin).
        Empty cluster → 0.0."""
        snapshot = sched.cache.update_snapshot()
        total = 0.0
        occupied = 0
        for ni in snapshot:
            if not ni.pods:
                continue
            occupied += 1
            fracs = []
            for r, alloc in ni.allocatable.res.items():
                if alloc > 0:
                    fracs.append(
                        max(0.0, (alloc - ni.requested.get(r)) / alloc))
            total += sum(fracs) / len(fracs) if fracs else 1.0
        return 100.0 * total / occupied if occupied else 0.0


def _raise_if_loop_died(run_task: asyncio.Task) -> None:
    """A barrier must not wait out its deadline on a scheduler loop that
    already raised (a backend or fast-path exception ends `run`)."""
    if run_task.done() and not run_task.cancelled() \
            and run_task.exception() is not None:
        raise run_task.exception()


def _result_count(metrics: SchedulerMetrics, result: str) -> int:
    return int(metrics.schedule_attempts.value(
        result=result, profile="default-scheduler"))


def load_config(path: str | None = None) -> list[dict]:
    """The workload suite: a YAML file in the reference's format, or, with
    no path, SchedulingBasic alone (no YAML parser needed)."""
    if path is None:
        return [copy.deepcopy(SCHEDULING_BASIC)]
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


def run_suite(config: list[dict], backend_factory=None, batch_size: int = 1,
              filter_name: str | None = None,
              timeout: float = 600.0) -> dict[str, dict]:
    """Run every (testcase × workload) pair, like BenchmarkPerfScheduling."""
    out: dict[str, dict] = {}
    for case in config:
        for wl in case.get("workloads") or [{"name": "default", "params": {}}]:
            full = f"{case['name']}/{wl['name']}"
            if filter_name and filter_name not in full:
                continue
            bad = [k for k in _UNSUPPORTED_CASE_KEYS if case.get(k)]
            if bad:
                raise NotImplementedError(
                    f"{full}: {bad} are not ported (in-process runs only)")
            backend = backend_factory() if backend_factory else None
            runner = PerfRunner(backend=backend, batch_size=batch_size)
            res = asyncio.run(runner.run(
                case["workloadTemplate"], wl.get("params") or {},
                timeout=timeout))
            out[full] = res.as_dict()
    return out


DEFAULT_BATCH_SIZE = 16384  # the reference bench's --batch-size


def main(argv: list[str] | None = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("config", nargs="?", default=None,
                    help="workload YAML (default: SchedulingBasic)")
    ap.add_argument("--backend", choices=["host", "torch"], default="torch",
                    help="torch (default): TorchBackend on the card; host: "
                         "the pure-Python host path only")
    ap.add_argument("--device", default=None,
                    help="TorchBackend device (default cuda:0; `cpu` runs "
                         "the kernels' plain versions)")
    ap.add_argument("--batch-size", type=int, default=None,
                    help=f"pods per pop (default {DEFAULT_BATCH_SIZE} with "
                         "--backend torch, 1 with --backend host)")
    ap.add_argument("--chunk", type=int, default=None,
                    help="OVERRIDE the backend solve chunk")
    ap.add_argument("--filter", default=None)
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="per-workload deadline in seconds")
    args = ap.parse_args(argv)

    factory = None
    batch = args.batch_size
    if batch is None:
        batch = DEFAULT_BATCH_SIZE if args.backend == "torch" else 1
    if args.backend == "torch":
        from kubernetes_tpu_torch.ops.backend import TorchBackend
        batch = max(batch, 128)
        chunk = None if args.chunk is None \
            else max(min(args.chunk, batch), 2)
        factory = lambda: TorchBackend(  # noqa: E731
            device=args.device, max_batch=chunk)
    results = run_suite(load_config(args.config), backend_factory=factory,
                        batch_size=batch, filter_name=args.filter,
                        timeout=args.timeout)
    print(json.dumps(results, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
