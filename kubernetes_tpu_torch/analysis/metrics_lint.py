"""Pass 4 — Prometheus conventions over the metric registrations.

The metric names are a dashboard contract (README Observability table;
SURVEY §5.5 pins the scheduler family to the reference's names), so
convention violations are API bugs, not style. The pass reads every
registration in the WHOLE tree — `r.counter(...)` / `r.gauge(...)` /
`r.histogram(...)` and direct `Counter(...)` / `Gauge(...)` /
`Histogram(...)` constructions with a literal name. (Originally it
only read `metrics/registry.py`; the audit sinks register their own
counters in `policy/audit.py` and the policy engine in `policy/vap.py`,
so the scan is wide — a counter is a counter wherever it is
constructed.) It enforces:

- MT401 invalid metric name (Prometheus `[a-zA-Z_:][a-zA-Z0-9_:]*`).
- MT402 counter without the `_total` suffix.
- MT403 non-counter WITH a `_total` suffix (a gauge named `_total`
  reads as a counter on every dashboard).
- MT404 non-base unit in the name: `_ms`/`_millis`/`_micros`/`_kb`/
  `_mb`/… — Prometheus units are seconds and bytes, full stop. (The
  pass's first real catch: `scheduler_admission_window_ms`.)
- MT405 unbounded label cardinality: a label named after a per-object
  identifier (`pod`, `node`, `name`, `key`, `id`, `uid`) — each value
  mints a new series, and a 200k-node preset would mint 200k.
- MT406 time-named histogram (`*_duration*`/`*_latency*`/`*_time*`/
  `*_wait*`) whose name doesn't end in `_seconds`.
- MT407 invalid label name (`[a-zA-Z_][a-zA-Z0-9_]*`).

Copy of `kubernetes_tpu/analysis/metrics_lint.py`.
"""

from __future__ import annotations

import ast
import re

from kubernetes_tpu_torch.analysis.engine import Finding, Module, call_name

PASS_ID = "metrics-lint"

#: kept for the fixture tests' narrow-scan mode; the default run scans
#: every module (registrations live in policy/audit.py etc. too).
REGISTRY_SUFFIX = "metrics/registry.py"

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")
_BAD_UNIT_TOKENS = frozenset((
    "ms", "msec", "msecs", "millis", "milliseconds",
    "us", "usec", "micros", "microseconds", "nanos", "nanoseconds",
    "kb", "mb", "gb", "kib", "mib", "gib", "minutes", "hours",
))
_HIGH_CARDINALITY_LABELS = frozenset((
    "pod", "pod_name", "node", "node_name", "name", "key", "id", "uid",
    "container", "image",
))
_TIME_HINTS = ("duration", "latency", "_time", "_wait")

_KIND_METHODS = {"counter": "counter", "gauge": "gauge",
                 "histogram": "histogram"}
_KIND_CTORS = {"Counter": "counter", "Gauge": "gauge",
               "Histogram": "histogram"}


def _registrations(mod: Module):
    """(kind, name, labels, line) for every literal registration."""
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        n = call_name(node)
        kind = None
        if n:
            last = n.split(".")[-1]
            if isinstance(node.func, ast.Attribute) \
                    and last in _KIND_METHODS:
                kind = _KIND_METHODS[last]
            elif last in _KIND_CTORS:
                kind = _KIND_CTORS[last]
        if kind is None or not node.args:
            continue
        first = node.args[0]
        if not (isinstance(first, ast.Constant)
                and isinstance(first.value, str)):
            continue
        labels: list[str] = []
        label_args = [kw.value for kw in node.keywords
                      if kw.arg == "labels"]
        if len(node.args) >= 3:
            label_args.append(node.args[2])
        for la in label_args:
            if isinstance(la, (ast.Tuple, ast.List)):
                for el in la.elts:
                    if isinstance(el, ast.Constant) \
                            and isinstance(el.value, str):
                        labels.append(el.value)
        yield kind, first.value, labels, node.lineno


def run(modules: list[Module],
        registry_suffix: str | None = None) -> list[Finding]:
    findings: list[Finding] = []
    for mod in modules:
        if registry_suffix is not None \
                and not mod.rel.endswith(registry_suffix):
            continue
        for kind, name, labels, line in _registrations(mod):
            def emit(code, msg, anchor=None):
                findings.append(Finding(
                    pass_id=PASS_ID, code=code, path=mod.rel, line=line,
                    symbol=anchor or name, message=msg))

            if not _NAME_RE.match(name):
                emit("MT401", f"invalid metric name {name!r}")
                continue
            tokens = name.split("_")
            if kind == "counter" and not name.endswith("_total"):
                emit("MT402", f"counter {name!r} must end in `_total`")
            if kind != "counter" and name.endswith("_total"):
                emit("MT403", f"{kind} {name!r} ends in `_total` — that "
                              "suffix means counter on every dashboard")
            bad = sorted(set(tokens) & _BAD_UNIT_TOKENS)
            if bad:
                emit("MT404", f"{kind} {name!r} uses non-base unit "
                              f"{bad} — Prometheus units are seconds "
                              "and bytes")
            if kind == "histogram" \
                    and any(h in name for h in _TIME_HINTS) \
                    and not name.endswith("_seconds"):
                emit("MT406", f"time-named histogram {name!r} must end "
                              "in `_seconds`")
            for lbl in labels:
                if not _LABEL_RE.match(lbl):
                    emit("MT407", f"{name!r}: invalid label name "
                                  f"{lbl!r}", anchor=f"{name}:{lbl}")
                elif lbl in _HIGH_CARDINALITY_LABELS:
                    emit("MT405", f"{name!r}: label {lbl!r} is a "
                                  "per-object identifier — unbounded "
                                  "series cardinality",
                         anchor=f"{name}:{lbl}")
    return findings
