"""One run of one cell of the scheduler benchmark.

The cell's configuration (`schedbench/configs/`) gives the cluster and the
pod template, its traffic (`schedbench/traffic/`) the arrivals. The run
builds the port's control plane in process: the store from
`new_cluster_store`, the informers, and `Scheduler.run` with the default
profile and a `TorchBackend` on the device, handed over through
`probe.BackendProbe`. Set-up creates the nodes and schedules the
configuration's initial pods through the loop, which warms up the shapes
the cell uses; then the window creates the traffic's pods through the
store's API for `seconds` seconds and sees the binds through its own watch.
The per-layer numbers (`RunRecord.layer`) are taken over the whole rounds
that begin in the window before its last `trace_tail_s` seconds (the
traffic's), in a traced run and an untraced one alike; a traced run starts
the profiler only after them, at its first dispatch in those last seconds,
so no per-layer number holds the profiler's start, stall or residue. After
the window the run waits up to `LATE_S` seconds for every created pod to
bind, stops the control plane, and checks the result against the plain
reference (`check.py`).
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import importlib.util
import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from schedbench import traffic as traffic_mod
from schedbench.trace import Slicer, summarize

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BATCH_SIZE = 16384
#: the port pads its node axis to a multiple of this (ops/tensorize.py).
NODE_PAD = 256
LATE_S = 60.0
SETUP_TIMEOUT_S = 300.0


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(bench: dict, name: str, root: Path = REPO,
              traffic_dir: Path = traffic_mod.TRAFFIC_DIR) -> dict:
    """The workload entry, its configuration (loaded from its file under
    `root`), its traffic mix (from `traffic_dir`) and the metrics the cell
    reports."""
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise SystemExit(f"unknown workload {name!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    with open(root / cfg_entry["file"]) as f:
        cfg = json.load(f)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]
    return {
        "workload": wl, "config": cfg,
        "traffic": traffic_mod.load(wl["traffic"], traffic_dir),
        "end_to_end": [m for m in bench["end_to_end"] if mine(m)],
        "per_layer": [m for m in bench["per_layer"] if mine(m)],
    }


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def node_plan(cfg: dict, rng: np.random.Generator) -> list[tuple[str, dict]]:
    """(name, labels) of every node in creation order: the node groups'
    nodes, named node-0.., shuffled by the seed."""
    nodes = []
    for grp in cfg["nodeGroups"]:
        for _ in range(int(grp["count"])):
            nodes.append(dict(grp.get("labels") or {}))
    order = rng.permutation(len(nodes))
    return [(f"node-{i}", nodes[j]) for i, j in enumerate(order)]


class BindWatch:
    """The benchmark's own watch on pods: the first time each tracked pod
    is seen bound, its node, and every later bind to another node."""

    def __init__(self, store):
        self.store = store
        self.created: dict[str, float] = {}
        self.bound: dict[str, tuple[float, str]] = {}
        self.rebinds = 0
        self._waiters: list[tuple[set, asyncio.Event]] = []
        self._task = None

    async def start(self) -> None:
        it = await self.store.watch("pods")
        self._task = asyncio.ensure_future(self._consume(it))

    async def _consume(self, it) -> None:
        async for ev in it:
            obj = ev.object
            node = (obj.get("spec") or {}).get("nodeName")
            if not node:
                continue
            md = obj["metadata"]
            key = f"{md.get('namespace', 'default')}/{md['name']}"
            seen = self.bound.get(key)
            if seen is None:
                self.bound[key] = (time.monotonic(), node)
                for waiting, done in self._waiters:
                    if key in waiting:
                        waiting.discard(key)
                        if not waiting:
                            done.set()
            elif seen[1] != node:
                self.rebinds += 1

    async def wait_bound(self, keys, deadline: float) -> bool:
        waiting = {k for k in keys if k not in self.bound}
        if not waiting:
            return True
        entry = (waiting, asyncio.Event())
        self._waiters.append(entry)
        try:
            await asyncio.wait_for(entry[1].wait(),
                                   max(0.0, deadline - time.monotonic()))
        except asyncio.TimeoutError:
            return False
        finally:
            self._waiters.remove(entry)
        return True

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            await asyncio.gather(self._task, return_exceptions=True)


@dataclass
class Mark:
    """Where a round began: the time, the creator's pod sequence number
    and create seconds so far, and the backend's timings then."""
    t: float
    seq: int
    create_s: float
    timings: dict


class Creator:
    """Creates the template's pods through the store's API, timing its own
    create calls and stamping each pod's create time."""

    def __init__(self, store, watch: BindWatch, template: dict, tag: str,
                 make_pod, timings=dict, slicer=None):
        self.store = store
        self.watch = watch
        self.template = template
        self.tag = tag
        self.make_pod = make_pod
        self.timings = timings
        self.slicer = slicer
        self.seq = 0
        self.create_s = 0.0
        self.window_end = float("inf")
        #: per round of `rounds` traffic: (pods, create s, bound s, all bound)
        self.rounds: list = []
        self.marks: list[Mark] = []

    def mark(self) -> None:
        self.marks.append(Mark(time.monotonic(), self.seq, self.create_s,
                               dict(self.timings())))

    async def create(self, n: int, gather: int = 512) -> list:
        keys = []
        for lo in range(0, n, gather):
            if time.monotonic() >= self.window_end:
                break
            names = [f"pod-{self.tag}-{self.seq + i}"
                     for i in range(min(gather, n - lo))]
            self.seq += len(names)
            objs = [self.make_pod(nm, **copy.deepcopy(self.template))
                    for nm in names]
            rng_ctx = self.slicer.create_range() if self.slicer else None
            created = self.watch.created
            t0 = time.monotonic()
            # The store's create does not suspend: the calls run back to
            # back, and the loop's other tasks run at the yield after them.
            with rng_ctx or contextlib.nullcontext():
                for nm, o in zip(names, objs):
                    created[f"default/{nm}"] = time.monotonic()
                    await self.store.create("pods", o)
            self.create_s += time.monotonic() - t0
            keys.extend(f"default/{nm}" for nm in names)
            await asyncio.sleep(0)
        return keys

    async def wait_bound(self, keys) -> bool:
        return await self.watch.wait_bound(keys, self.window_end)


class _TraceSlicer(Slicer):
    def create_range(self):
        if self.prof is None or self.done:
            return contextlib.nullcontext()
        import torch
        return torch.profiler.record_function("schedbench.create")


@dataclass
class RunRecord:
    """What a run measured, for the metric readers and the check.
    `layer` holds the per-layer readers' inputs over the part of the
    window they are taken from (`layer_part`): its `seconds`, the pods
    `created` in it and the `create_s` they took, the backend's
    `assign_s` and `device_s` in it, the pods `dispatched` and the
    `dispatches` that began in it, and the `latencies_s` of its pods."""
    seconds: float
    setup_s: float = 0.0
    bound_in_window: int = 0
    layer: dict = field(default_factory=dict)
    first_round_counts: object = None
    trace: dict | None = None
    traced_dispatches: list = field(default_factory=list)
    memory_peak_bytes: int = 0
    device_kind: str = ""
    extra: dict = field(default_factory=dict)


def process_age_s() -> float:
    """Seconds since this process started (Linux)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) \
        - start_ticks / os.sysconf("SC_CLK_TCK")


async def run_cell(spec: dict, seed: int, seconds: float, trace: bool,
                   device: str = "cuda:0", fault=None):
    """Run one cell; returns (RunRecord, check inputs)."""
    import torch

    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import Scheduler
    from kubernetes_tpu_torch.store import (install_core_validation,
                                            new_cluster_store)

    from schedbench.probe import BackendProbe

    cfg, mix = spec["config"], spec["traffic"]
    rng = np.random.default_rng(seed)
    rec = RunRecord(seconds=seconds)
    phases = rec.extra["setup_phases"] = {"imports": process_age_s()}
    store = new_cluster_store()
    install_core_validation(store)
    on_card = str(device).startswith("cuda")
    if on_card:
        from kubernetes_tpu_torch.ops import wave_kernel
        # A checkout's first run builds the kernel library (nvcc): its
        # set-up counts the build, and the run reports it apart.
        rec.extra["kernel_cache"] = "warm" if \
            wave_kernel.LIBRARY.library_path().exists() else "cold"
        t0 = time.monotonic()
        wave_kernel.LIBRARY.build()
        rec.extra["kernel_library_s"] = time.monotonic() - t0
    backend = TorchBackend(device=device)
    probe = BackendProbe(backend if fault is None else fault(backend))
    phases["backend"] = process_age_s()
    sched = Scheduler(store, seed=seed, backend=probe)
    factory = InformerFactory(store)
    await sched.setup_informers(factory)
    watch = BindWatch(store)
    await watch.start()
    factory.start()
    await factory.wait_for_sync()

    nodes = node_plan(cfg, rng)
    tmpl = cfg["nodeTemplate"]
    for lo in range(0, len(nodes), 512):
        await asyncio.gather(*(
            store.create("nodes", make_node(
                name, labels=labels, **copy.deepcopy(tmpl)))
            for name, labels in nodes[lo:lo + 512]))
    phases["nodes"] = process_age_s()
    run_task = asyncio.ensure_future(sched.run(batch_size=BATCH_SIZE))
    tag = f"{int(rng.integers(1 << 24)):06x}"
    creator = Creator(store, watch, cfg["podTemplate"], tag, make_pod,
                      timings=lambda: backend.timings)
    try:
        setup_deadline = time.monotonic() + SETUP_TIMEOUT_S
        creator.window_end = setup_deadline
        init_keys = await creator.create(int(cfg["initPods"]))
        if not await creator.wait_bound(init_keys):
            raise RuntimeError("set-up: the initial pods did not bind")
        phases["initial_pods"] = process_age_s()
        if on_card:
            torch.cuda.synchronize(device)
        creator.rounds = []
        creator.marks = []
        n_setup_dispatches = len(probe.dispatches)

        slicer = None
        if trace:
            slicer = _TraceSlicer(float("inf"),
                                  float(mix.get("trace_slice_s", 2.0)),
                                  device)
        window_start = time.monotonic()
        window_end = window_start + seconds
        cut = window_end - float(mix.get("trace_tail_s", 0.0))
        if slicer is not None:
            slicer.window_start = cut
            object.__setattr__(probe, "slicer", slicer)
            creator.slicer = slicer
        arm = getattr(probe._inner, "arm", None)
        if arm is not None:
            arm()       # a test's fault breaks the window, not the set-up
        rec.setup_s = process_age_s()
        creator.window_end = window_end
        creator.create_s = 0.0
        first_seq = creator.seq
        start = Mark(window_start, first_seq, 0.0, dict(backend.timings))
        await traffic_mod.drive(mix, creator, window_end)
        remaining = window_end - time.monotonic()
        if remaining > 0:
            await asyncio.sleep(remaining)
        if slicer is not None:
            slicer.stop()
        if on_card:
            rec.memory_peak_bytes = int(
                torch.cuda.max_memory_allocated(device))
            rec.device_kind = torch.cuda.get_device_name(device)
        rec.extra["rounds"] = list(creator.rounds)
        window_keys = [f"default/pod-{tag}-{i}"
                       for i in range(first_seq, creator.seq)]
        # Late answers: wait for every created pod, a minute past the close
        # at most; they count as late in the latencies, not as wrong.
        all_keys = [f"default/pod-{tag}-{i}" for i in range(creator.seq)]
        await watch.wait_bound(all_keys, time.monotonic() + LATE_S)
        latencies = []
        for k in window_keys:
            t_c = watch.created[k]
            b = watch.bound.get(k)
            if b is not None and b[0] <= window_end:
                rec.bound_in_window += 1
                latencies.append(b[0] - t_c)
            else:
                latencies.append(window_end - t_c)
        win = probe.dispatches[n_setup_dispatches:]
        # The part ends where the last round that began by the cut began:
        # the rounds before it are all bound by then.
        part_end = ([m for m in creator.marks
                     if m.seq > first_seq and m.t <= cut] or [None])[-1]
        rec.extra["layer_part"] = None
        if part_end is not None:
            rec.extra["layer_part"] = [0.0, part_end.t - window_start]
            rec.layer = _layer(start, part_end, win, latencies, first_seq)
        if slicer is not None:
            rec.extra["trace_start_s"] = None if slicer.t_start is None \
                else slicer.t_start - window_start
            rec.extra["trace_warm_up_s"] = slicer.warm_up_s
            rec.trace = summarize(slicer)
            rec.traced_dispatches = [d for d in probe.dispatches if d.traced]
        round_pods = int(mix["round_pods"])
        first = set(init_keys) | set(window_keys[:round_pods])
        if len(window_keys) >= round_pods and all(
                k in watch.bound for k in first):
            rec.first_round_counts = _node_counts(
                [watch.bound[k][1] for k in first], nodes)
            rec.extra["first_round_keys"] = sorted(first)
    finally:
        run_task.cancel()
        await asyncio.gather(run_task, return_exceptions=True)
        await sched.stop()
        factory.stop()
        await watch.stop()
    final = {}
    for obj in (await store.list("pods")).items:
        md = obj["metadata"]
        final[f"{md.get('namespace', 'default')}/{md['name']}"] = \
            (obj.get("spec") or {}).get("nodeName")
    store.stop()
    check_in = {
        "nodes": nodes, "node_template": tmpl, "pod_template":
            cfg["podTemplate"], "dispatches": probe.dispatches,
        "created": list(watch.created), "rebinds": watch.rebinds,
        "final": final, "chunk": int(backend.max_batch),
        "first_round_keys": rec.extra.get("first_round_keys"),
    }
    del probe, sched, backend
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return rec, check_in


def _layer(start: Mark, end: Mark, dispatches, latencies,
           first_seq: int) -> dict:
    """The per-layer readers' inputs from `start` to `end`."""
    mine = [d for d in dispatches if start.t <= d.t0 < end.t]
    out = {"seconds": end.t - start.t, "created": end.seq - start.seq,
           "create_s": end.create_s - start.create_s,
           "dispatched": sum(len(d.keys) for d in mine),
           "dispatches": len(mine),
           "latencies_s": latencies[start.seq - first_seq:
                                    end.seq - first_seq]}
    for k in ("assign_s", "device_s"):
        if k in end.timings and k in start.timings:
            out[k] = end.timings[k] - start.timings[k]
    return out


def _node_counts(node_names, nodes) -> np.ndarray:
    idx = {name: i for i, (name, _l) in enumerate(nodes)}
    counts = np.zeros(len(nodes), dtype=np.int64)
    for nm in node_names:
        counts[idx[nm]] += 1
    return counts


def free_occupied_pct(counts, nodes, node_template, pod_template) -> float:
    """Mean free share of allocatable cpu and memory over occupied nodes,
    in %: the fragmentation arithmetic of scheduler_perf's
    `PerfRunner._fragmentation_occupied` (frozen here), over the cpu and
    memory columns."""
    from schedbench.reference.quantity import milli
    alloc = [milli(node_template["allocatable"][r]) for r in ("cpu",
                                                               "memory")]
    req = [milli(pod_template["requests"][r]) for r in ("cpu", "memory")]
    total = 0.0
    occupied = 0
    for c in counts:
        if not c:
            continue
        occupied += 1
        fracs = []
        for a, q in zip(alloc, req):
            if a > 0:
                fracs.append(max(0.0, (a - c * q) / a))
        total += sum(fracs) / len(fracs) if fracs else 1.0
    return 100.0 * total / occupied if occupied else 0.0


def end_to_end(rec: RunRecord, check_in: dict) -> dict:
    """Every end-to-end metric this run can give."""
    out = {"setup_s": rec.setup_s}
    out["pods_per_s"] = rec.bound_in_window / rec.seconds
    if rec.first_round_counts is not None:
        out["free_occupied_pct"] = free_occupied_pct(
            rec.first_round_counts, check_in["nodes"],
            check_in["node_template"], check_in["pod_template"])
    return out


def load_reader(name: str, directory: Path = ROOT / "metrics"):
    """The per-layer metric's reader: `schedbench/metrics/<name>.py`'s
    `read(record) -> float | None`."""
    path = directory / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"schedbench_metric_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def per_layer(rec: RunRecord, names, directory: Path = ROOT / "metrics"):
    out = {}
    for name in names:
        v = load_reader(name, directory)(rec)
        if v is not None:
            out[name] = float(v)
    return out

