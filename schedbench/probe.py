"""A thin wrapper around the backend object handed to the scheduler.

It forwards every attribute to the wrapped backend and, on each dispatch
(`assign_stream`, the scheduler's batched entry), records what the
benchmark reads afterwards: the dispatch's pods in order, the pod count per node of
the snapshot it was given (the dispatch's starting state), its
assignments, and its host-clock span. With a `Slicer` attached it also
starts the profiler as a dispatch begins and stops it as a chunk ends, so a
traced slice begins with a dispatch and holds whole chunks.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Dispatch:
    t0: float
    keys: list
    counts: np.ndarray
    first_node: str
    last_node: str
    assignments: dict = field(default_factory=dict)
    t1: float = 0.0
    traced: bool = False
    range: object = None


class BackendProbe:
    """Forwards to `backend`; records each dispatch into `dispatches`."""

    def __init__(self, backend):
        object.__setattr__(self, "_inner", backend)
        object.__setattr__(self, "dispatches", [])
        object.__setattr__(self, "slicer", None)

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def __setattr__(self, name, value):
        setattr(self._inner, name, value)

    def _begin(self, pods, snapshot) -> Dispatch:
        nodes = snapshot.nodes
        d = Dispatch(
            t0=time.monotonic(), keys=[pi.key for pi in pods],
            counts=np.fromiter((len(ni.pods) for ni in nodes),
                               dtype=np.int64, count=len(nodes)),
            first_node=nodes[0].name if nodes else "",
            last_node=nodes[-1].name if nodes else "")
        if self.slicer is not None:
            d.traced = self.slicer.before_dispatch(d.t0)
            if d.traced:
                import torch
                d.range = torch.profiler.record_function("backend.dispatch")
                d.range.__enter__()
        self.dispatches.append(d)
        return d

    def _end(self, d: Dispatch, assignments) -> None:
        d.assignments = dict(assignments)
        d.t1 = time.monotonic()
        if d.range is not None:
            d.range.__exit__(None, None, None)
            d.range = None
        if self.slicer is not None and d.traced:
            self.slicer.after_chunk(d.t1)

    async def assign_stream(self, pods, snapshot, fwk):
        pods = list(pods)
        d = self._begin(pods, snapshot)
        ctx = None
        async for chunk_pods, ctx in self._inner.assign_stream(
                pods, snapshot, fwk):
            if d.traced:
                self.slicer.after_chunk(time.monotonic())
            yield chunk_pods, ctx
        self._end(d, ctx.assignments if ctx is not None else {})
