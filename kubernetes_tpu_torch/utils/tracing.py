"""OTel-style request tracing (SURVEY §5.1 component-base/tracing) and the
host layers' ranges on the device trace's clock.

A lightweight in-process tracer: spans with trace/span ids, parentage
via contextvars (so nested awaits auto-parent), W3C `traceparent`
propagation for cross-component HTTP hops, and export to the Chrome
trace-event JSON that Perfetto (and chrome://tracing) loads.

Where spans come from:
- APIServer: one span per request (verb/resource/user/status), child
  spans for store ops and admission webhook out-calls;
- Scheduler: a span per scheduling attempt and per binding cycle,
  attributed with the pod key;
- anything else via `TRACER.span(...)` / `aspan(...)`.

The pod's journey (create → schedule → bind) crosses async boundaries
the context can't follow (informer → queue → cycle), so spans carry a
`pod` attribute, and the creating request's traceparent rides the pod
(`stamp_traceparent`) so the scheduler's attempt parents to it.

Disabled by default: a disabled tracer's span() is a no-op costing one
attribute check, so the hot paths stay clean (utiltrace remains the
always-on threshold logger).

How the two clocks are joined. Spans are stamped with `time.monotonic()`;
torch.profiler (Kineto) stamps its events in Unix-epoch nanoseconds. Two
things put them on one timeline:
- while a profiler records, each host layer's section (`range_start` /
  `range_end`: `store.record`, `store.fanout`, `informer.apply`,
  `scheduler.snapshot`, `scheduler.assume`, `scheduler.bind`,
  `recorder.drain`) opens a `torch.profiler.record_function` range of its
  name, so it sits in the profiler's own trace on the profiler's clock;
  with no profiler recording, a section costs one read of torch's
  profiler-enabled flag. The sections never nest in one another, and
  spans open no range, so no range nests in another of these;
- `epoch_ns` converts a monotonic reading to the epoch through one
  anchor (`EPOCH_OFFSET_NS`, read at import), and `to_perfetto` writes
  the spans' timestamps, live and retroactive alike, that way. A
  torch.profiler Chrome trace writes its `ts` relative to its
  `baseTimeNanoseconds`: subtract that base (in µs) from `to_perfetto`'s
  `ts` to lay both in one file.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import json
import logging
import sys
import time
from typing import Any

from kubernetes_tpu_torch.utils import flags

logger = logging.getLogger(__name__)

_ids = itertools.count(1)
_current: contextvars.ContextVar["Span | None"] = contextvars.ContextVar(
    "ktpu_current_span", default=None)

#: Unix-epoch ns minus monotonic ns, read once: the one anchor between
#: the spans' clock and torch.profiler's (see the module docstring).
EPOCH_OFFSET_NS = time.time_ns() - time.monotonic_ns()


def epoch_ns(t: float) -> int:
    """A `time.monotonic()` reading in Unix-epoch nanoseconds, the clock
    torch.profiler stamps its events with."""
    return int(t * 1e9) + EPOCH_OFFSET_NS


#: torch's profiler-enabled check, bound once torch has been imported.
_profiler_enabled = None


def range_start(name: str):
    """Open a `torch.profiler.record_function` range named `name` when a
    profiler is recording on this thread, and return it for `range_end`;
    else return None. Without a recording profiler this is one call of
    torch's profiler-enabled check (and no torch import: a process that
    has not imported torch has no profiler)."""
    global _profiler_enabled
    if _profiler_enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return None
        _profiler_enabled = torch.autograd._profiler_enabled
    if not _profiler_enabled():
        return None
    import torch
    rng = torch.autograd.profiler.record_function(name)
    rng.__enter__()
    return rng


def range_end(rng) -> None:
    """Close what `range_start` opened (None: nothing)."""
    if rng is not None:
        rng.__exit__(None, None, None)


#: pod-annotation key carrying the creating request's traceparent across
#: the informer/queue async boundary (the context can't follow a pod from
#: the apiserver handler to the scheduling cycle; the object can).
TRACEPARENT_ANNOTATION = "ktpu.io/traceparent"


def current_span() -> "Span | None":
    """The span the calling context is inside, if any (shared across all
    Tracer instances — parentage is a property of the call stack, not of
    the collector)."""
    return _current.get()


def stamp_traceparent(obj: dict) -> None:
    """Stamp the current span's traceparent into `obj`'s annotations so a
    later consumer in another task (the scheduler's attempt span) can
    parent to the request that created the object. No-op outside a span,
    so call sites need no enabled-check of their own."""
    sp = _current.get()
    if sp is None:
        return
    meta = obj.setdefault("metadata", {})
    ann = meta.get("annotations")
    if ann is None:
        ann = meta["annotations"] = {}
    ann.setdefault(TRACEPARENT_ANNOTATION,
                   format_traceparent(sp.trace_id, sp.span_id))


def traceparent_of(obj: dict | None) -> str | None:
    """Read a stamped traceparent back off an object (see
    stamp_traceparent)."""
    if not obj:
        return None
    ann = (obj.get("metadata") or {}).get("annotations")
    if not ann:
        return None
    return ann.get(TRACEPARENT_ANNOTATION)


class Span:
    __slots__ = ("name", "trace_id", "span_id", "parent_id", "start",
                 "end", "attrs")

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: str | None, attrs: dict):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start = time.monotonic()
        self.end: float | None = None
        self.attrs = attrs

    @property
    def duration_ms(self) -> float:
        return 1000.0 * ((self.end or time.monotonic()) - self.start)


class Tracer:
    """Span collector. Bounded ring (oldest spans drop) so an always-on
    tracer can't grow without limit.

    `threshold_ms` is the utiltrace-semantics dump: when a ROOT span (no
    parent — e.g. a request arriving with no traceparent) closes slower
    than the threshold, its whole subtree logs as an indented breakdown;
    fast roots stay silent. Defaults from KTPU_TRACE_THRESHOLD_MS
    (unset = no tree dumps; the always-on per-attempt threshold logger
    remains utils/trace.Trace)."""

    def __init__(self, enabled: bool = False, max_spans: int = 65536,
                 threshold_ms: float | None = None):
        from collections import deque
        self.enabled = enabled
        self.max_spans = max_spans
        if threshold_ms is None:
            threshold_ms = flags.get("KTPU_TRACE_THRESHOLD_MS")
        self.threshold_ms = threshold_ms
        # deque(maxlen): O(1) ring-buffer appends — a full list ring
        # would memmove 64k entries per span on the hot path.
        self.spans: "deque[Span]" = deque(maxlen=max_spans)

    # -- span creation -----------------------------------------------------

    @contextlib.contextmanager
    def span(self, name: str, *, traceparent: str | None = None,
             **attrs: Any):
        """Sync/async-agnostic context manager (works under `async with
        tracer.aspan(...)` too via the wrapper below)."""
        if not self.enabled:
            yield None
            return
        parent = _current.get()
        if traceparent:
            trace_id, parent_id = _parse_traceparent(traceparent)
        elif parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = f"t{next(_ids):016x}", None
        sp = Span(name, trace_id, f"s{next(_ids):08x}", parent_id, attrs)
        self.spans.append(sp)  # maxlen ring: oldest drops automatically
        token = _current.set(sp)
        try:
            yield sp
        finally:
            sp.end = time.monotonic()
            _current.reset(token)
            if self.threshold_ms is not None and sp.parent_id is None \
                    and sp.duration_ms >= self.threshold_ms:
                self._log_tree(sp)

    @contextlib.asynccontextmanager
    async def aspan(self, name: str, **kw):
        with self.span(name, **kw) as sp:
            yield sp

    def annotate(self, **attrs: Any) -> None:
        """Attach attributes to the CURRENT span (e.g. the pod key a
        create request turns out to be about, known only after the body
        parses)."""
        if not self.enabled:
            return
        sp = _current.get()
        if sp is not None:
            sp.attrs.update(attrs)

    def record(self, name: str, start: float, end: float | None = None,
               **attrs: Any) -> "Span | None":
        """Retroactively record a COMPLETED span from caller-held
        timestamps (time.monotonic clock), parented to the current span —
        e.g. the scheduler's queue wait, which elapses across tasks no
        context can follow but whose endpoints the queue stamped. Like a
        live span, it reaches the device trace's clock through
        `to_perfetto`'s conversion."""
        if not self.enabled:
            return None
        parent = _current.get()
        if parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        else:
            trace_id, parent_id = f"t{next(_ids):016x}", None
        sp = Span(name, trace_id, f"s{next(_ids):08x}", parent_id, attrs)
        sp.start = start
        sp.end = end if end is not None else time.monotonic()
        self.spans.append(sp)
        return sp

    def current_traceparent(self) -> str | None:
        sp = _current.get()
        if sp is None:
            return None
        return format_traceparent(sp.trace_id, sp.span_id)

    # -- threshold tree dump (utiltrace semantics for span trees) ----------

    def _log_tree(self, root: Span) -> None:
        by_parent: dict[str, list[Span]] = {}
        for s in self.spans:
            if s.trace_id == root.trace_id and s.parent_id:
                by_parent.setdefault(s.parent_id, []).append(s)
        attrs = ",".join(f"{k}={v}" for k, v in root.attrs.items())
        lines = [f"Span[{root.name}{{{attrs}}}]: "
                 f"total {root.duration_ms:.1f}ms" if attrs else
                 f"Span[{root.name}]: total {root.duration_ms:.1f}ms"]

        def walk(sp: Span, depth: int) -> None:
            for child in sorted(by_parent.get(sp.span_id, ()),
                                key=lambda s: s.start):
                a = ",".join(f"{k}={v}" for k, v in child.attrs.items())
                lines.append(f'{"  " * depth}{child.name}'
                             f'{"{" + a + "}" if a else ""} '
                             f"{child.duration_ms:.1f}ms")
                walk(child, depth + 1)

        walk(root, 1)
        logger.info("\n".join(lines))

    # -- queries + export --------------------------------------------------

    def to_perfetto(self) -> str:
        """Chrome trace-event JSON (Perfetto/chrome://tracing).
        Complete ('X') events, `ts` in Unix-epoch µs (`epoch_ns`), so they
        line up with a torch.profiler trace (module docstring)."""
        events = []
        for s in self.spans:
            if s.end is None:
                continue
            events.append({
                "name": s.name, "ph": "X", "pid": 1,
                "tid": abs(hash(s.trace_id)) % 100_000,
                "ts": round(epoch_ns(s.start) / 1e3, 3),
                "dur": round((s.end - s.start) * 1e6, 3),
                "args": {**{k: str(v) for k, v in s.attrs.items()},
                         "trace_id": s.trace_id, "span_id": s.span_id,
                         **({"parent_id": s.parent_id}
                            if s.parent_id else {})},
            })
        return json.dumps({"traceEvents": events}, separators=(",", ":"))

    def clear(self) -> None:
        self.spans.clear()


def format_traceparent(trace_id: str, span_id: str) -> str:
    # W3C shape (version-trace-parent-flags); ids are our own tokens.
    return f"00-{trace_id}-{span_id}-01"


def _parse_traceparent(header: str) -> tuple[str, str | None]:
    # Tolerate garbage (wrong type, malformed): propagation input comes
    # off the wires, and a bad header must degrade to a fresh trace, not
    # crash the serving path.
    parts = header.split("-") if isinstance(header, str) else ()
    if len(parts) >= 3:
        return parts[1], parts[2]
    return f"t{next(_ids):016x}", None


#: process-wide default; enable with DEFAULT_TRACER.enabled = True.
DEFAULT_TRACER = Tracer(enabled=False)
