"""Policy-driven audit pipeline (SURVEY §5.5: levels, RequestReceived →
ResponseComplete stages).

Parity target: `staging/src/k8s.io/apiserver/pkg/audit` + the
audit.k8s.io Policy file shape:

    apiVersion: audit.k8s.io/v1
    kind: Policy
    rules:
    - level: None
      users: ["system:kube-proxy"]
    - level: RequestResponse
      verbs: ["create", "update"]
      resources: ["pods"]
    - level: Metadata

First matching rule wins (the reference's policy checker); no match =
level None. Levels gate how much of the request rides the event:
Metadata = who/what/when + response code; Request adds the request
object; RequestResponse adds the response object too.

Each audited request emits two stage events sharing one auditID —
RequestReceived before the rest of the chain runs (so it carries the
pre-impersonation identity) and ResponseComplete after, carrying the
response status plus `impersonatedUser` when the impersonation filter
swapped identities mid-chain.

Sinks are bounded and async (the reference's buffered backend): `emit`
never blocks the serving path; overflow drops (counted,
`audit_events_dropped_total`) rather than backpressuring — the same
DropIfChannelFull stance as client/events.py. Production backends
(SURVEY §5.5):

- `RotatingFileSink` — the `--audit-log-path` analog with
  `--audit-log-maxsize` / `--audit-log-maxage` / `--audit-log-maxbackups`
  rotation (size OR age triggers; `audit.log.1` is the newest backup).
- `WebhookSink` — the `--audit-webhook-config` analog: batches events
  into one `EventList` POST, bounded queue, exponential-backoff retry;
  exhausted retries drop (counted), never backpressure.

Both ride the same emit/close seam `AuditPipeline` already uses, and
both guard their I/O with `locking.check_dispatch_seam` — the runtime
twin of ktpu-lint's LK206 (no lock held across file I/O or wire sends).

Copy of `kubernetes_tpu/policy/audit.py`.
"""

from __future__ import annotations

import asyncio
import contextvars
import itertools
import json
import logging
import os
import time
from typing import Any, Mapping

from kubernetes_tpu_torch.metrics.registry import Registry
from kubernetes_tpu_torch.utils import tracing
from kubernetes_tpu_torch.utils.locking import check_dispatch_seam

logger = logging.getLogger(__name__)

#: the request's open audit context (set by AuditPipeline.begin, cleared
#: at response_complete): the seam through which the admission chain —
#: notably VAP auditAnnotations (policy/vap.py) — attaches annotations
#: to the event without threading the context through every handler.
#: contextvars give per-task isolation, so concurrent requests on one
#: loop cannot cross-annotate.
_CURRENT_CTX: contextvars.ContextVar[dict | None] = \
    contextvars.ContextVar("ktpu_audit_ctx", default=None)


def annotate(key: str, value: str) -> None:
    """Attach `annotations[key] = value` to the current request's audit
    event (no-op when the request isn't audited). First writer wins per
    key, mirroring the reference's audit.AddAuditAnnotation."""
    ctx = _CURRENT_CTX.get()
    if ctx is not None:
        ctx.setdefault("annotations", {}).setdefault(key, value)

LEVEL_NONE = "None"
LEVEL_METADATA = "Metadata"
LEVEL_REQUEST = "Request"
LEVEL_REQUEST_RESPONSE = "RequestResponse"

_LEVEL_ORDER = {LEVEL_NONE: 0, LEVEL_METADATA: 1, LEVEL_REQUEST: 2,
                LEVEL_REQUEST_RESPONSE: 3}

STAGE_REQUEST_RECEIVED = "RequestReceived"
STAGE_RESPONSE_COMPLETE = "ResponseComplete"

_audit_seq = itertools.count(1)


def level_at_least(level: str, want: str) -> bool:
    return _LEVEL_ORDER.get(level, 0) >= _LEVEL_ORDER.get(want, 0)


class AuditPolicy:
    """Ordered rules; first match wins. Rule fields (all optional, all
    must match when present): users, groups, verbs, resources,
    namespaces. `omitStages` drops stages per rule."""

    _LIST_FIELDS = ("users", "groups", "verbs", "resources",
                    "namespaces", "omitStages")

    def __init__(self, rules: list[Mapping] | None = None):
        self.rules = [dict(r) for r in rules or []]
        for rule in self.rules:
            for f in self._LIST_FIELDS:
                v = rule.get(f)
                if isinstance(v, str):
                    # A YAML scalar where a list belongs would silently
                    # degrade `value in want` to SUBSTRING matching.
                    rule[f] = [v]

    @classmethod
    def from_dict(cls, doc: Mapping | None) -> "AuditPolicy":
        return cls((doc or {}).get("rules") or [])

    @classmethod
    def from_file(cls, path: str) -> "AuditPolicy":
        import yaml
        with open(path) as f:
            return cls.from_dict(yaml.safe_load(f))

    @classmethod
    def metadata_for_all(cls) -> "AuditPolicy":
        return cls([{"level": LEVEL_METADATA}])

    @staticmethod
    def _match(rule: Mapping, value: str | None, field: str) -> bool:
        want = rule.get(field)
        if not want:
            return True
        return (value or "") in want or "*" in want

    def rule_for(self, *, user: str | None = None,
                 groups: list[str] | None = None,
                 verb: str | None = None, resource: str | None = None,
                 namespace: str | None = None) -> Mapping | None:
        for rule in self.rules:
            if not self._match(rule, user, "users"):
                continue
            if rule.get("groups") and not any(
                    g in rule["groups"] for g in groups or []):
                continue
            if not self._match(rule, verb, "verbs"):
                continue
            if not self._match(rule, resource, "resources"):
                continue
            if not self._match(rule, namespace, "namespaces"):
                continue
            return rule
        return None

    def level_for(self, **attrs) -> str:
        rule = self.rule_for(**attrs)
        return rule.get("level", LEVEL_NONE) if rule else LEVEL_NONE


class AuditSink:
    """Bounded async JSON-lines writer. With `path=None` events collect
    in-memory (`self.entries`) — the test/bench sink; with a path they
    append as one JSON object per line, batched per drain pass."""

    MAX_PENDING = 4096
    #: in-memory retention cap (path=None): the serving path must not
    #: grow memory without bound under long runs.
    MAX_ENTRIES = 100_000

    def __init__(self, path: str | None = None,
                 registry: Registry | None = None):
        self.path = path
        self.entries: list[dict] = []
        r = registry or Registry()
        self.registry = r
        self.events_total = r.counter(
            "audit_events_total", "Audit stage events emitted",
            labels=("stage",))
        self.events_dropped = r.counter(
            "audit_events_dropped_total",
            "Audit events dropped on sink overflow")
        self._pending: list[dict] = []
        self._draining = False
        self._closed = False

    def register_into(self, registry: Registry) -> None:
        for c in (self.events_total, self.events_dropped):
            registry._metrics.setdefault(c.name, c)

    def emit(self, entry: dict) -> None:
        """Fire-and-forget enqueue; never blocks the handler chain."""
        if self._closed:
            return
        if len(self._pending) >= self.MAX_PENDING:
            self.events_dropped.inc()
            return
        self.events_total.inc(stage=entry.get("stage", ""))
        self._pending.append(entry)
        self._kick()

    def _kick(self) -> None:
        if self._draining or not self._pending:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            # No loop (sync contexts): drain inline to the memory sink so
            # nothing silently sits forever; file sinks flush on close.
            if self.path is None:
                self._absorb(self._pending)
                self._pending = []
            return
        self._draining = True
        asyncio.ensure_future(self._drain())

    def _absorb(self, batch: list[dict]) -> None:
        self.entries.extend(batch)
        if len(self.entries) > self.MAX_ENTRIES:
            del self.entries[:len(self.entries) - self.MAX_ENTRIES]

    def _write_batch(self, batch: list[dict]) -> None:
        """One buffered append per batch; the event loop eats a short
        write rather than a thread handoff per line. The rotation
        subclass hooks _before_append/_after_append — serialization and
        the dispatch-seam guard (the LK206 runtime twin) live HERE
        only. Never called with a lock held."""
        check_dispatch_seam("audit.file_write")
        lines = "".join(
            json.dumps(e, separators=(",", ":")) + "\n" for e in batch)
        self._before_append(len(lines))
        with open(self.path, "a") as f:
            f.write(lines)
        self._after_append(len(lines))

    def _before_append(self, nbytes: int) -> None:
        """Hook: called with the serialized batch size before the
        append (RotatingFileSink rotates here)."""

    def _after_append(self, nbytes: int) -> None:
        """Hook: called after a successful append."""

    async def _drain(self) -> None:
        try:
            while self._pending:
                batch, self._pending = self._pending, []
                if self.path is None:
                    self._absorb(batch)
                    continue
                try:
                    self._write_batch(batch)
                except OSError:
                    logger.exception("audit sink write failed "
                                     "(%d events lost)", len(batch))
                    self.events_dropped.inc(len(batch))
                await asyncio.sleep(0)  # yield between batches
        finally:
            self._draining = False

    async def close(self) -> None:
        """Flush whatever is still buffered, then refuse new events."""
        for _ in range(100):
            if not self._pending and not self._draining:
                break
            self._kick()
            await asyncio.sleep(0.01)
        self._closed = True
        if self._pending:
            # Drain task never caught up (slow disk, dying loop): flush
            # the tail inline — and if even that fails, the loss is
            # COUNTED, never silent (the module's drop contract).
            batch, self._pending = self._pending, []
            if self.path is None:
                self._absorb(batch)
            else:
                try:
                    self._write_batch(batch)
                except OSError:
                    logger.exception("audit sink close lost %d events",
                                     len(batch))
                    self.events_dropped.inc(len(batch))


class RotatingFileSink(AuditSink):
    """Size/age-rotated JSON-lines file sink — the reference's
    `--audit-log-path` + `--audit-log-maxsize`/`--audit-log-maxage`/
    `--audit-log-maxbackups` backend.

    Rotation happens at batch-write time (before the append that would
    cross the size bound, or once the open segment outlives max_age_s):
    `path` renames to `path.1`, existing backups shift up, anything past
    `backups` is deleted. Writes stay on the event loop like the base
    sink — one short buffered append per batch, no locks held (the
    dispatch-seam guard in `_write_batch` enforces it under
    KTPU_LOCK_CHECK)."""

    def __init__(self, path: str, *, max_bytes: int = 10 * 2 ** 20,
                 max_age_s: float | None = None, backups: int = 5,
                 registry: Registry | None = None):
        super().__init__(path=path, registry=registry)
        self.max_bytes = max(1, int(max_bytes))
        self.max_age_s = max_age_s
        self.backups = max(0, int(backups))
        self.rotations = self.registry.counter(
            "audit_log_rotations_total",
            "Audit log file rotations (size or age trigger)")
        try:
            self._size = os.path.getsize(path)
        except OSError:
            self._size = 0
        self._opened_at = time.monotonic()

    def register_into(self, registry: Registry) -> None:
        super().register_into(registry)
        registry._metrics.setdefault(self.rotations.name, self.rotations)

    def _should_rotate(self, incoming: int) -> bool:
        if self._size and self._size + incoming > self.max_bytes:
            return True
        return (self.max_age_s is not None and self._size
                and time.monotonic() - self._opened_at >= self.max_age_s)

    def _rotate(self) -> None:
        if self.backups == 0:
            try:
                os.remove(self.path)
            except OSError:
                pass
        else:
            for i in range(self.backups - 1, 0, -1):
                src = f"{self.path}.{i}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{i + 1}")
            try:
                os.replace(self.path, f"{self.path}.1")
            except OSError:
                pass
        self._size = 0
        self._opened_at = time.monotonic()
        self.rotations.inc()

    def _before_append(self, nbytes: int) -> None:
        if self._should_rotate(nbytes):
            self._rotate()

    def _after_append(self, nbytes: int) -> None:
        self._size += nbytes


class WebhookSink:
    """Batching audit webhook — the reference's `--audit-webhook-config`
    backend: events buffer into a bounded queue and a loop-resident
    worker POSTs them as one `audit.k8s.io/v1 EventList` per batch, with
    exponential-backoff retry. A batch that exhausts its retries drops
    (counted) — the pipeline never backpressures the serving path, and
    never blocks a second batch behind a dead endpoint forever.

    Duck-compatible with AuditSink where AuditPipeline cares (emit /
    close / register_into / events_total / events_dropped). `post` is
    the transport seam — default aiohttp POST of the config's `url`;
    tests inject a local server or a callable."""

    MAX_PENDING = 4096

    def __init__(self, url: str, *, batch_max: int = 400,
                 initial_backoff: float = 0.25, max_retries: int = 4,
                 timeout: float = 10.0,
                 registry: Registry | None = None, post=None):
        self.url = url
        self.batch_max = max(1, int(batch_max))
        self.initial_backoff = initial_backoff
        self.max_retries = max(0, int(max_retries))
        self.timeout = timeout
        r = registry or Registry()
        self.registry = r
        self.events_total = r.counter(
            "audit_events_total", "Audit stage events emitted",
            labels=("stage",))
        self.events_dropped = r.counter(
            "audit_events_dropped_total",
            "Audit events dropped on sink overflow")
        self.webhook_batches = r.counter(
            "audit_webhook_batches_total",
            "Audit webhook batch deliveries attempted",
            labels=("outcome",))
        self.webhook_retries = r.counter(
            "audit_webhook_retries_total",
            "Audit webhook batch retry attempts after a failed POST")
        self._post = post
        self._session = None
        self._pending: list[dict] = []
        self._draining = False
        self._drain_task: asyncio.Task | None = None
        self._closed = False

    @classmethod
    def from_config(cls, path: str,
                    registry: Registry | None = None) -> "WebhookSink":
        """Build from a YAML config file:

            url: http://collector:9099/audit
            batch: {maxSize: 400}
            retry: {backoff: 0.25, maxAttempts: 4}
        """
        import yaml
        with open(path) as f:
            doc = yaml.safe_load(f) or {}
        url = doc.get("url")
        if not url:
            raise ValueError(f"audit webhook config {path}: url required")
        batch = doc.get("batch") or {}
        retry = doc.get("retry") or {}
        return cls(url, batch_max=batch.get("maxSize", 400),
                   initial_backoff=retry.get("backoff", 0.25),
                   max_retries=retry.get("maxAttempts", 4),
                   registry=registry)

    def register_into(self, registry: Registry) -> None:
        for c in (self.events_total, self.events_dropped,
                  self.webhook_batches, self.webhook_retries):
            registry._metrics.setdefault(c.name, c)

    def emit(self, entry: dict) -> None:
        """Fire-and-forget enqueue; never blocks the handler chain."""
        if self._closed:
            return
        if len(self._pending) >= self.MAX_PENDING:
            self.events_dropped.inc()
            return
        self.events_total.inc(stage=entry.get("stage", ""))
        self._pending.append(entry)
        self._kick()

    def _kick(self) -> None:
        if self._draining or not self._pending:
            return
        try:
            asyncio.get_running_loop()
        except RuntimeError:
            return  # no loop: events wait for close()'s final flush
        self._draining = True
        self._drain_task = asyncio.ensure_future(self._drain())

    async def _send(self, batch: list[dict]) -> None:
        """One EventList POST. The dispatch-seam guard is the runtime
        twin of LK206 — the worker must not hold a lock across the
        wire send."""
        check_dispatch_seam("audit.webhook_send")
        body = {"kind": "EventList", "apiVersion": "audit.k8s.io/v1",
                "items": batch}
        if self._post is not None:
            await self._post(self.url, body)
            return
        import aiohttp
        if self._session is None:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout))
        async with self._session.post(self.url, json=body) as resp:
            resp.raise_for_status()

    async def _deliver(self, batch: list[dict]) -> None:
        backoff = self.initial_backoff
        for attempt in range(self.max_retries + 1):
            try:
                await self._send(batch)
                self.webhook_batches.inc(outcome="ok")
                return
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if attempt == self.max_retries:
                    self.webhook_batches.inc(outcome="failed")
                    self.events_dropped.inc(len(batch))
                    logger.warning(
                        "audit webhook %s: batch of %d dropped after "
                        "%d attempts: %s", self.url, len(batch),
                        attempt + 1, e)
                    return
                self.webhook_retries.inc()
                await asyncio.sleep(backoff)
                backoff *= 2

    async def _drain(self) -> None:
        try:
            while self._pending:
                batch = self._pending[:self.batch_max]
                del self._pending[:self.batch_max]
                await self._deliver(batch)
        finally:
            self._draining = False

    async def close(self) -> None:
        """Flush the queue (retries included), then refuse new events
        and close the transport. AWAITS the in-flight drain task rather
        than racing it: stealing its batches while it sleeps in a retry
        backoff would let it wake after the session is closed and mint
        a fresh one nothing ever closes."""
        self._closed = True
        task = self._drain_task
        if task is not None and not task.done():
            try:
                await task
            except asyncio.CancelledError:
                raise
            except Exception:  # _deliver already counted the loss
                logger.exception("audit webhook drain failed in close")
        while self._pending:
            batch = self._pending[:self.batch_max]
            del self._pending[:self.batch_max]
            await self._deliver(batch)
        if self._session is not None:
            await self._session.close()
            self._session = None


class AuditPipeline:
    """Policy + sink + stage-event construction, shared by the HTTP
    middleware, the KTPU wire handler, and the gRPC interceptor."""

    def __init__(self, policy: AuditPolicy | None = None,
                 sink: AuditSink | None = None,
                 registry: Registry | None = None):
        self.policy = policy or AuditPolicy()
        self.sink = sink or AuditSink(registry=registry)

    def register_into(self, registry: Registry) -> None:
        self.sink.register_into(registry)

    # -- stage events ------------------------------------------------------

    _RULE_UNSET = object()

    def begin(self, *, user: str, groups: list[str] | None = None,
              verb: str, resource: str, namespace: str | None = None,
              name: str | None = None, request_object: Any = None,
              rule: Any = _RULE_UNSET) -> dict | None:
        """Emit RequestReceived; returns the audit context to finish with
        response_complete(), or None when the policy says level None
        (nothing more to do for this request). Callers that already
        matched the policy (to decide whether to capture the body) pass
        the rule in — the scan must not run twice per request."""
        if rule is self._RULE_UNSET:
            rule = self.policy.rule_for(user=user, groups=groups,
                                        verb=verb, resource=resource,
                                        namespace=namespace)
        level = rule.get("level", LEVEL_NONE) if rule else LEVEL_NONE
        if level == LEVEL_NONE:
            # Clear the annotation seam: on a long-lived wire task a
            # stale context from the PREVIOUS op must not collect this
            # request's annotations.
            _CURRENT_CTX.set(None)
            return None
        omit = set((rule or {}).get("omitStages") or ())
        ctx = {
            "kind": "Event", "apiVersion": "audit.k8s.io/v1",
            "auditID": f"audit-{next(_audit_seq):x}",
            "level": level,
            "verb": verb,
            "user": {"username": user, "groups": list(groups or [])},
            "objectRef": {"resource": resource,
                          "namespace": namespace or "",
                          "name": name or ""},
        }
        # Trace ↔ audit correlation (§5.1 ↔ §5.5): when this request runs
        # inside a span, the audit event carries the span's traceparent
        # annotation and the span carries the auditID attribute — one
        # pod's create→admit→schedule→bind path joins on either key.
        sp = tracing.current_span()
        if sp is not None:
            sp.attrs.setdefault("audit_id", ctx["auditID"])
            ctx["annotations"] = {
                "traceparent": tracing.format_traceparent(
                    sp.trace_id, sp.span_id)}
        if level_at_least(level, LEVEL_REQUEST) and \
                request_object is not None:
            ctx["requestObject"] = request_object
        if STAGE_REQUEST_RECEIVED not in omit:
            self.sink.emit({**ctx, "stage": STAGE_REQUEST_RECEIVED,
                            "stageTimestamp": _now()})
        ctx["_omit"] = omit
        # Open the annotation seam: chain stages running under this
        # request (VAP auditAnnotations, webhooks) attach to this event
        # via annotate() — annotations land on ResponseComplete, the
        # stage emitted after they are set.
        _CURRENT_CTX.set(ctx)
        return ctx

    def response_complete(self, ctx: dict | None, *, code: int,
                          response_object: Any = None,
                          impersonated_user: str | None = None,
                          request_object: Any = None) -> None:
        """Emit ResponseComplete for a begin()-opened context. Records
        both identities when impersonation happened mid-chain: `user`
        stays the authenticated (original) principal, `impersonatedUser`
        is who the request ran as."""
        if ctx is None:
            return
        if _CURRENT_CTX.get() is ctx:
            _CURRENT_CTX.set(None)
        omit = ctx.pop("_omit", set())
        if STAGE_RESPONSE_COMPLETE in omit:
            return
        entry = {k: v for k, v in ctx.items() if not k.startswith("_")}
        entry["stage"] = STAGE_RESPONSE_COMPLETE
        entry["stageTimestamp"] = _now()
        entry["responseStatus"] = {"code": code}
        if impersonated_user:
            entry["impersonatedUser"] = {"username": impersonated_user}
        level = ctx.get("level", LEVEL_NONE)
        if level_at_least(level, LEVEL_REQUEST) and \
                request_object is not None and \
                "requestObject" not in entry:
            entry["requestObject"] = request_object
        if level_at_least(level, LEVEL_REQUEST_RESPONSE) and \
                response_object is not None:
            entry["responseObject"] = response_object
        self.sink.emit(entry)

    async def close(self) -> None:
        await self.sink.close()


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
