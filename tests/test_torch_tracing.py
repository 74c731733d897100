"""The port's tracing on the CPU: its ranges on torch.profiler's clock and
the host layers' clocks and pod-stage recorders.

- With a CPU `torch.profiler` recording, a layer section (the store's
  `store.record` and `store.fanout`, and one opened by the test) appears
  in the profiler's events as a range of its name, and a `Tracer.span`
  opens none; the Tracer's spans, live and retroactive (`Tracer.record`),
  exported by `to_perfetto` in epoch µs, start and end within 1 ms of the
  ranges around the same intervals. With none recording, no
  `record_function` range is made at all.
- A 50-node in-process loop of 200 pods (`TorchBackend` on the CPU): the
  top-level sections (the test's own creates, the informers' `apply_s`,
  the scheduler's `snapshot_s`, `assume_s` and `bind_s`, the recorder's
  `drain_s`) plus the backend's `assign_s` stay within the wall; with a
  profiler on, no two of their ranges overlap and every store section
  lies inside one of them. The queue's wait recorder has one observation
  per pod, the pods informer's lag recorder one per pod event, `bound`
  counts the 200 pods, and `scheduler_pod_scheduling_sli_duration_seconds`
  counts 200 observations. The scheduler's registry renders the clocks
  and the recorders as they read.
- The store's clocks render through a registry as the apiserver's
  /metrics shows them.
- `WindowedLatencyRecorder.values_between` reads a window that ended
  before now, the ring wrapped or not.
"""

import asyncio
import json
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.metrics.registry import (
    Registry,
    StoreClockMetrics,
    WindowedLatencyRecorder,
)
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.scheduler import Scheduler
from kubernetes_tpu_torch.store import (install_core_validation,
                                        new_cluster_store)
from kubernetes_tpu_torch.utils import tracing

TOP_LEVEL = ("test.create", "informer.apply", "scheduler.snapshot",
             "scheduler.assume", "scheduler.bind", "recorder.drain")
STORE = ("store.record", "store.fanout")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _ranges(prof, names) -> dict:
    """name -> [(start, end)] of the profiler's CPU ranges, epoch ns."""
    base = prof.profiler.kineto_results.trace_start_ns()
    out = {n: [] for n in names}
    for e in prof.events():
        if e.name in out:
            out[e.name].append((base + e.time_range.start * 1e3,
                                base + e.time_range.end * 1e3))
    return out


async def _traced_work(tracer):
    store = new_cluster_store()
    with tracer.span("demo.span"):
        rng = tracing.range_start("demo.section")
        time.sleep(0.005)
        tracing.range_end(rng)
    t0 = time.monotonic()
    with torch.autograd.profiler.record_function("demo.retro"):
        time.sleep(0.005)
    tracer.record("demo.retro", t0, time.monotonic())
    await store.create("pods", make_pod("p0"))
    store.stop()


@pytest.mark.parametrize("profiling", [True, False])
def test_ranges_only_while_a_profiler_records(monkeypatch, profiling):
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a, **kw):
        made.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    tracer = tracing.Tracer(enabled=True)
    if not profiling:
        asyncio.run(_traced_work(tracer))
        assert made == ["demo.retro"]       # the test's own range
        assert tracing.range_start("x") is None
        return
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        asyncio.run(_traced_work(tracer))
    assert sorted(made) == sorted(["demo.section", "demo.retro", *STORE])
    got = _ranges(prof, ("demo.section", "demo.retro", *STORE))
    for name in ("demo.section", *STORE):
        assert len(got[name]) == 1, name
    exported = {e["name"]: e for e in
                json.loads(tracer.to_perfetto())["traceEvents"]}
    for span, rng in (("demo.span", "demo.section"),
                      ("demo.retro", "demo.retro")):
        (s, e), = got[rng]
        ev = exported[span]
        assert abs(ev["ts"] * 1e3 - s) < 1e6
        assert abs((ev["ts"] + ev["dur"]) * 1e3 - e) < 1e6


async def _loop(n_nodes: int, n_pods: int) -> dict:
    t_wall = time.perf_counter()
    store = new_cluster_store()
    install_core_validation(store)
    backend = TorchBackend(device="cpu")
    sched = Scheduler(store, seed=7, backend=backend)
    factory = InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    await factory.wait_for_sync()
    create_s = 0.0

    async def create(resource, objs):
        nonlocal create_s
        with torch.autograd.profiler.record_function("test.create"):
            t0 = time.perf_counter()
            for o in objs:
                await store.create(resource, o)
            create_s += time.perf_counter() - t0
        await asyncio.sleep(0)

    await create("nodes", [make_node(
        f"n{i}", allocatable={"cpu": "4", "memory": "32Gi", "pods": "110"})
        for i in range(n_nodes)])
    run = asyncio.ensure_future(sched.run(batch_size=1024))
    await create("pods", [make_pod(
        f"p{i}", requests={"cpu": "100m", "memory": "500Mi"})
        for i in range(n_pods)])
    pods_informer = factory.informer("pods")

    def settled():
        events = sum(1 for res, _ev in store._events if res == "pods")
        return sched.timings["bound"] == n_pods \
            and pods_informer.lag.count_since(0) == events

    deadline = time.monotonic() + 60
    while not settled() and time.monotonic() < deadline:
        await asyncio.sleep(0.01)
    await sched.recorder.flush()
    wall = time.perf_counter() - t_wall
    run.cancel()
    await asyncio.gather(run, return_exceptions=True)
    await sched.stop()
    factory.stop()
    store.stop()
    informers = factory._informers.values()
    exposition = sched.metrics.registry.render()
    return {
        "exposition": exposition,
        "sections": {
            "informer_apply": sum(i.timings["apply_s"] for i in informers),
            "snapshot": sched.timings["snapshot_s"],
            "assume": sched.timings["assume_s"],
            "bind": sched.timings["bind_s"],
            "event_drain": sched.recorder.timings["drain_s"]},
        "wall": wall,
        "named": create_s + sum(i.timings["apply_s"] for i in informers)
        + sched.timings["snapshot_s"] + sched.timings["assume_s"]
        + sched.timings["bind_s"] + sched.recorder.timings["drain_s"]
        + backend.timings["assign_s"],
        "bound": sched.timings["bound"],
        "waits": sched.queue.wait.count_since(0),
        "lags": pods_informer.lag.count_since(0),
        "pod_events": sum(1 for res, _ev in store._events if res == "pods"),
        "sli": sched.metrics.e2e_sli_duration.count(attempts="1"),
    }


@pytest.mark.parametrize("profiled", [False, True])
def test_layer_clocks_and_stage_recorders_on_a_small_loop(profiled):
    if profiled:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            got = asyncio.run(_loop(50, 200))
    else:
        got = asyncio.run(_loop(50, 200))
    assert got["bound"] == 200
    assert 0 < got["named"] <= got["wall"]
    assert got["waits"] == 200
    assert got["pod_events"] >= 400          # a create and a bind a pod
    assert got["lags"] == got["pod_events"]
    assert got["sli"] == 200
    text = got["exposition"]
    for section, v in got["sections"].items():
        assert f'scheduler_host_seconds_total{{section="{section}"}} {v}' \
            in text
    assert "scheduler_pods_bound_total 200\n" in text
    assert "scheduler_queue_wait_seconds_count 200\n" in text
    assert 'scheduler_queue_wait_seconds{quantile="0.99"}' in text
    assert 'scheduler_informer_watch_lag_seconds_count{resource="pods"} ' \
        f'{got["lags"]}\n' in text
    if not profiled:
        return
    ranges = _ranges(prof, TOP_LEVEL + STORE)
    top = sorted(iv for n in TOP_LEVEL for iv in ranges[n])
    assert len(ranges["scheduler.bind"]) == 200
    assert len(ranges["scheduler.assume"]) == 200
    for (_s0, e0), (s1, _e1) in zip(top, top[1:]):
        assert e0 <= s1
    for n in STORE:
        for s, e in ranges[n]:
            assert any(ts <= s and e <= te for ts, te in top), n


def test_store_clocks_render_as_counters():
    store = new_cluster_store()
    registry = Registry()
    StoreClockMetrics(store.timings).register_into(registry)
    asyncio.run(store.create("pods", make_pod("p0")))
    store.stop()
    tm = store.timings
    assert tm["events"] == 1 and tm["record_s"] > 0 and tm["fanout_s"] > 0
    text = registry.render()
    assert "# TYPE apiserver_storage_host_seconds_total counter" in text
    for section in ("record", "fanout"):
        assert ('apiserver_storage_host_seconds_total{section="%s"} %r'
                % (section, tm[f"{section}_s"])) in text
    assert "apiserver_storage_events_recorded_total 1\n" in text


def test_values_between_reads_a_past_window():
    rec = WindowedLatencyRecorder(capacity=8)
    for v in range(5):
        rec.observe(float(v))
    m0 = rec.mark()
    for v in range(5, 9):
        rec.observe(float(v))
    m1 = rec.mark()
    rec.observe(9.0)
    assert rec.values_between(m0, m1) == [5.0, 6.0, 7.0, 8.0]
    assert rec.values_between(0, m1) == [2.0, 3.0, 4.0, 5.0, 6.0, 7.0,
                                         8.0]
