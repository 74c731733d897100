"""The traced slice of a `--trace 1` run.

`torch.profiler` starts before the first dispatch that begins at or after
`window_start` (the harness sets it to the window's last `trace_tail_s`
seconds) and stops (after a device synchronize) when the first chunk that
ends `slice_s` or more after it started has been handed back. Its device
tracer is initialized (one short profile, `warm_up_s`) just before the
slice starts, not in set-up: once started in a process the tracer slows
the device stages for the rest of it, so nothing before the slice runs
under it. The slice's device
events give the busy time (the union of kernel and copy intervals), the
time by device operation, the longest idle gaps (named by the benchmark's
own host range open at the gap, else "scheduler loop and store") and the
`wave_solve` kernels' device time.
"""

from __future__ import annotations

import time
from collections import defaultdict

#: host ranges the benchmark opens with record_function in a traced run.
HOST_RANGES = ("schedbench.create", "backend.dispatch")
WAVE_KERNEL = "wave_solve_kernel"


class Slicer:
    def __init__(self, window_start: float, slice_s: float, device):
        self.window_start = window_start
        self.slice_s = slice_s
        self.device = device
        self.prof = None
        self.t_start = self.t_stop = None
        self.warm_up_s = None
        self.done = False

    def before_dispatch(self, t: float) -> bool:
        if self.done or t < self.window_start:
            return False
        if self.prof is None:
            from torch.profiler import ProfilerActivity, profile
            t0 = time.monotonic()
            self.warm_up()
            self.warm_up_s = time.monotonic() - t0
            acts = [ProfilerActivity.CPU]
            if self._cuda():
                acts.append(ProfilerActivity.CUDA)
                self._sync()
            self.prof = profile(activities=acts)
            self.prof.start()
            self.t_start = time.monotonic()
        return True

    def warm_up(self) -> None:
        """Start and stop the profiler once: its first start initializes
        the device tracer, which takes seconds."""
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self._cuda():
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts):
            torch.ones(8, device=self.device).sum().item()

    def _cuda(self) -> bool:
        return str(self.device).startswith("cuda")

    def _sync(self) -> None:
        import torch
        torch.cuda.synchronize(self.device)

    def after_chunk(self, t: float) -> None:
        if self.prof is not None and not self.done \
                and t - self.t_start >= self.slice_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        if self._cuda():
            self._sync()
        self.prof.stop()
        self.t_stop = time.monotonic()
        self.done = True


def _union(intervals):
    total, cur_s, cur_e = 0.0, None, None
    merged = []
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                merged.append((cur_s, cur_e))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        merged.append((cur_s, cur_e))
    for s, e in merged:
        total += e - s
    return total, merged


def summarize(slicer: Slicer) -> dict | None:
    """busy_s, window_s, the breakdown and the wave_solve kernel time of
    the slice (None when no slice was traced)."""
    if slicer.prof is None or not slicer.done:
        return None
    from torch.autograd import DeviceType
    dev_iv, by_name, host = [], defaultdict(float), []
    wave_us = 0.0
    wave_launches = 0
    for e in slicer.prof.events():
        s, t = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA and e.name not in HOST_RANGES:
            dev_iv.append((s, t))
            by_name[e.name] += (t - s) * 1e-6
            if WAVE_KERNEL in e.name:
                wave_us += t - s
                wave_launches += 1
        elif e.name in HOST_RANGES:
            host.append((s, t, e.name))
    busy_us, merged = _union(dev_iv)
    window_s = slicer.t_stop - slicer.t_start
    gaps = []
    for (s0, e0), (s1, _e1) in zip(merged, merged[1:]):
        mid = 0.5 * (e0 + s1)
        names = [n for hs, he, n in host if hs <= mid <= he]
        gaps.append((s1 - e0, names[-1] if names else
                     "scheduler loop and store"))
    top_gaps = sorted(gaps, reverse=True)[:10]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": window_s,
        "wave_solve_device_s": wave_us * 1e-6,
        "wave_solve_kernels": wave_launches,
        "breakdown": {
            "device_ops": sorted(([n, v] for n, v in by_name.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": [[n, g * 1e-6] for g, n in top_gaps],
        },
    }
