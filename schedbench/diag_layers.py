"""A diagnostic run of one cell that reads the port's host-layer clocks.

    python -m schedbench.diag_layers --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--out <file>]

It runs the cell as `schedbench.run` does and prints the same result line
with a `diag` object added. Its numbers are no benchmark metric. It wraps
harness functions while it runs and edits no file of the benchmark:

- every `Mark` (the window's start and each round's) also snapshots the
  port's clocks: the store's `record_s`, `fanout_s` and `events`, the
  informers' `apply_s` summed, the scheduler's `snapshot_s`, `assume_s`,
  `bind_s` and `bound`, the recorder's `drain_s`, and the samples that the
  pods informer's lag recorder and the queue's wait recorder took since
  the last mark (read at each mark, before the ring overwrites them);
- it adds two clocks of its own: the benchmark's watch (`watch_s`, each
  event's handling by `BindWatch`, in a `schedbench.watch` range while a
  profiler records) and the cacher's `ingest` (`ingest_s`, a part of
  `record_s`);
- `diag.part` gives, over the part the per-layer numbers are taken from
  (`layer_part`), `store_event_us` ((record_s + fanout_s) / events),
  `bind_cycle_us` (bind_s / bound), the p50 and p99 of the watch lag and
  the queue wait, each section's share of the part's wall and
  `host_unnamed_pct`: 100 (1 - (create_s + watch_s + assign_s + apply_s +
  snapshot_s + assume_s + bind_s + drain_s) / wall);
- `diag.rounds` gives each whole round's clocks (from its mark to the
  next), so the round that crosses a store limit shows what grew;
- traced, `diag.idle_gaps` names the slice's ten longest device idle
  gaps: by the benchmark's own range open at the gap's middle, as
  `trace.py` does, else by the program range (or `schedbench.watch`) that
  overlaps the gap most, else "scheduler loop and store"; and
  `diag.gap_s_by_range` sums each range's overlap with all the gaps.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from schedbench import run as run_mod  # noqa: E402  (sets the caches' env)
from schedbench import harness, trace  # noqa: E402

#: the port's layer sections (`kubernetes_tpu_torch/utils/tracing.py`);
#: the top-level ones never nest in one another, the store's lie in them.
TOP_RANGES = ("informer.apply", "scheduler.snapshot", "scheduler.assume",
              "scheduler.bind", "recorder.drain", "schedbench.watch")
STORE_RANGES = ("store.record", "store.fanout")
SCALARS = ("record_s", "fanout_s", "events", "ingest_s", "apply_s",
           "snapshot_s", "assume_s", "bind_s", "bound", "drain_s", "watch_s")
#: the sections summed against the wall (with the benchmark's creates and
#: the backend's `assign_s`).
NAMED = ("watch_s", "apply_s", "snapshot_s", "assume_s", "bind_s",
         "drain_s")


class Clocks:
    """The run's program objects, found as the harness makes them, and
    the diagnostic's own two clocks."""

    def __init__(self):
        self.store = self.sched = self.factory = None
        self.watch_s = 0.0
        self.ingest_s = 0.0
        self._lag_n = self._wait_n = 0
        self.marks: list = []
        self.part = None
        self.gaps = None

    def sample(self) -> dict:
        if self.sched is None:
            return {}
        st, sc = self.store.timings, self.sched.timings
        lag = self.factory.informer("pods").lag
        wait = self.sched.queue.wait
        n_lag, n_wait = lag.mark(), wait.mark()
        out = {
            "record_s": st["record_s"], "fanout_s": st["fanout_s"],
            "events": st["events"], "ingest_s": self.ingest_s,
            "apply_s": sum(i.timings["apply_s"]
                           for i in self.factory._informers.values()),
            "snapshot_s": sc["snapshot_s"], "assume_s": sc["assume_s"],
            "bind_s": sc["bind_s"], "bound": sc["bound"],
            "drain_s": self.sched.recorder.timings["drain_s"],
            "watch_s": self.watch_s,
            "lag_s": lag.values_between(self._lag_n, n_lag),
            "wait_s": wait.values_between(self._wait_n, n_wait)}
        self._lag_n, self._wait_n = n_lag, n_wait
        return out


CLOCKS = Clocks()


@dataclass
class ClockMark(harness.Mark):
    """`harness.Mark` that also snapshots the port's clocks."""
    clocks: dict = field(default_factory=dict)

    def __post_init__(self):
        self.clocks = CLOCKS.sample()
        CLOCKS.marks.append(self)


def _pct(values, q):
    return harness.percentile(values, q) if values else None


def _span(m0, m1) -> dict:
    """The clocks from mark m0 to mark m1 and the samples between them."""
    out = {k: m1.clocks[k] - m0.clocks[k] for k in SCALARS}
    marks = CLOCKS.marks
    i0 = next(i for i, m in enumerate(marks) if m is m0)
    i1 = next(i for i, m in enumerate(marks) if m is m1)
    for k in ("lag_s", "wait_s"):
        out[k] = [v for m in marks[i0 + 1:i1 + 1] for v in m.clocks[k]]
    return out


def _figures(m0, m1, create_s: float, assign_s: float) -> dict:
    d = _span(m0, m1)
    wall = m1.t - m0.t
    named = create_s + assign_s + sum(d[k] for k in NAMED)
    lag, wait = d.pop("lag_s"), d.pop("wait_s")
    out = {"wall_s": wall, **d, "create_s": create_s, "assign_s": assign_s,
           "store_event_us": 1e6 * (d["record_s"] + d["fanout_s"])
           / d["events"] if d["events"] else None,
           "bind_cycle_us": 1e6 * d["bind_s"] / d["bound"]
           if d["bound"] else None,
           "informer_lag_p50_ms": _ms(_pct(lag, 50)),
           "informer_lag_p99_ms": _ms(_pct(lag, 99)),
           "queue_wait_p50_ms": _ms(_pct(wait, 50)),
           "queue_wait_p99_ms": _ms(_pct(wait, 99)),
           "lag_samples": len(lag), "wait_samples": len(wait),
           "host_unnamed_pct": 100.0 * (1.0 - named / wall)}
    out["share_pct"] = {k: 100.0 * out[k] / wall for k in (
        "create_s", "assign_s", *NAMED, "record_s", "fanout_s", "ingest_s")}
    return out


def _ms(v):
    return None if v is None else 1e3 * v


def _rounds() -> list:
    """Each whole round's clocks: from its mark to the next round's."""
    rounds = [m for m in CLOCKS.marks if m.clocks][1:]   # after the start
    out = []
    for m0, m1 in zip(rounds, rounds[1:]):
        d = _figures(m0, m1, m1.create_s - m0.create_s,
                     m1.timings.get("assign_s", 0.0)
                     - m0.timings.get("assign_s", 0.0))
        d.pop("share_pct")
        d["t_s"] = m0.t - rounds[0].t
        out.append(d)
    return out


def _name_gaps(slicer) -> dict:
    """The slice's device idle gaps named by the ranges open in them."""
    from torch.autograd import DeviceType
    dev, host, prog = [], [], []
    for e in slicer.prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and e.name not in \
                trace.HOST_RANGES:
            dev.append((s, t))
        elif e.name in trace.HOST_RANGES:
            host.append((s, t, e.name))
        elif e.name in TOP_RANGES or e.name in STORE_RANGES:
            prog.append((s, t, e.name))
    _busy, merged = trace._union(dev)
    gaps = []
    by_range: dict[str, float] = {}
    for (_s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        bench = [n for hs, he, n in host if hs <= mid <= he]
        over: dict[str, float] = {}
        for ps, pe, n in prog:
            o = min(pe, s1) - max(ps, e0)
            if o > 0:
                over[n] = over.get(n, 0.0) + o
        for n, o in over.items():
            by_range[n] = by_range.get(n, 0.0) + o * 1e-6
        top = {n: o for n, o in over.items() if n in TOP_RANGES}
        if bench:
            name = bench[-1]
        elif top:
            name = max(top, key=top.get)
        else:
            name = "scheduler loop and store"
        gaps.append((s1 - e0, name, {n: o * 1e-6 for n, o in over.items()}))
    gaps.sort(key=lambda g: -g[0])
    return {"idle_gaps": [[n, g * 1e-6, ov] for g, n, ov in gaps[:10]],
            "gap_s_by_range": by_range,
            "gaps_s": sum(g for g, _n, _o in gaps) * 1e-6}


def install(patch=setattr) -> None:
    """Wrap the harness's and the port's functions for one run, through
    `patch(owner, name, value)` (a test passes one that undoes itself)."""
    global CLOCKS
    import torch

    from kubernetes_tpu_torch.scheduler import Scheduler

    CLOCKS = Clocks()
    patch(harness, "Mark", ClockMark)
    orig_setup = Scheduler.setup_informers

    async def setup_informers(self, factory):
        CLOCKS.sched, CLOCKS.factory = self, factory
        return await orig_setup(self, factory)
    patch(Scheduler, "setup_informers", setup_informers)

    orig_watch_init = harness.BindWatch.__init__

    def watch_init(self, store):
        orig_watch_init(self, store)
        CLOCKS.store = store
        ingest = store.cacher.ingest

        def timed_ingest(resource, ev):
            t0 = time.perf_counter()
            try:
                return ingest(resource, ev)
            finally:
                CLOCKS.ingest_s += time.perf_counter() - t0
        store.cacher.ingest = timed_ingest
    patch(harness.BindWatch, "__init__", watch_init)

    orig_consume = harness.BindWatch._consume

    async def timed(it):
        async for ev in it:
            rng = None
            if torch.autograd._profiler_enabled():
                rng = torch.autograd.profiler.record_function(
                    "schedbench.watch")
                rng.__enter__()
            t0 = time.perf_counter()
            yield ev        # BindWatch handles the event without awaiting
            CLOCKS.watch_s += time.perf_counter() - t0
            if rng is not None:
                rng.__exit__(None, None, None)

    async def consume(self, it):
        await orig_consume(self, timed(it))
    patch(harness.BindWatch, "_consume", consume)

    orig_layer = harness._layer

    def layer(start, end, dispatches, latencies, first_seq):
        out = orig_layer(start, end, dispatches, latencies, first_seq)
        CLOCKS.part = (start, end, out)
        return out
    patch(harness, "_layer", layer)

    orig_summarize = harness.summarize

    def summarize(slicer):
        out = orig_summarize(slicer)
        if out is not None:
            CLOCKS.gaps = _name_gaps(slicer)
        return out
    patch(harness, "summarize", summarize)


def diag() -> dict:
    out: dict = {"rounds": _rounds()}
    if CLOCKS.part is not None:
        start, end, lay = CLOCKS.part
        out["part"] = _figures(start, end, lay["create_s"],
                               lay.get("assign_s", 0.0))
    if CLOCKS.gaps is not None:
        out.update(CLOCKS.gaps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default=None,
                    help="also write the line to this file")
    args = ap.parse_args(argv)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    install()
    out, _rows = run_mod.execute(spec, args.seed, args.seconds,
                                 bool(args.trace), device=args.device)
    if out is None:
        return 3
    out["diag"] = diag()
    line = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
