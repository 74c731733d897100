"""REST+JSON API server over MVCCStore.

Parity targets:
- staging/src/k8s.io/apiserver `pkg/server/config.go DefaultBuildHandlerChain`
  → the aiohttp middleware stack (recovery → request-info → authn →
  priority-and-fairness → audit), in the reference's order.
- `pkg/endpoints/handlers/{create,get,watch,rest}.go` → the resource routes.
- `pkg/util/flowcontrol` (APF) → `PriorityLevel` fair-queued seats with
  SHUFFLE SHARDING (see `PriorityLevel` below): each flow (User-Agent) is
  dealt a deterministic hand of candidate queues and enqueues on the
  shortest; queues drain round-robin into a bounded seat pool, 429 +
  Retry-After on queue overflow.
- `pkg/registry/core/pod/storage/storage.go BindingREST.Create` → the
  pods/binding subresource route.
- watch wire: newline-delimited JSON WatchEvents with BOOKMARK frames and
  `410 Gone` on expired resourceVersions (`pkg/storage/cacher`).

Paths accept both core (`/api/v1/...`) and group (`/apis/<g>/<v>/...`)
prefixes; resources map 1:1 onto store tables.

Copy of `kubernetes_tpu/apiserver/server.py`, with one refusal where the
reference reaches a module this package does not have yet: a request that
accepts `application/vnd.kubernetes.protobuf` gets a 406 naming
`apiserver/grpc_server.py` (whose envelope the protobuf content type
carries); it does not fall back to JSON.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from collections import deque
from typing import Mapping

from aiohttp import web

from kubernetes_tpu_torch.api.labels import parse_field_selector, parse_selector
from kubernetes_tpu_torch.metrics.registry import APIServerMetrics
from kubernetes_tpu_torch.utils.tracing import stamp_traceparent
from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Expired,
    Invalid,
    MVCCStore,
    NotFound,
    StoreError,
)

logger = logging.getLogger(__name__)



PROTOBUF_CT = "application/vnd.kubernetes.protobuf"


def _wants_protobuf(request: web.Request) -> bool:
    return PROTOBUF_CT in request.headers.get("Accept", "")


#: the refusal a protobuf-accepting request gets (the reference wraps the
#: object in grpc_server's runtime.Unknown envelope).
PROTOBUF_NOT_PORTED = (
    f"{PROTOBUF_CT} responses need apiserver/grpc_server.py, which this "
    "package does not have yet; accept application/json")


def _object_response(request: web.Request, obj: dict,
                     status: int = 200) -> web.Response:
    """Content negotiation: JSON. A client accepting
    application/vnd.kubernetes.protobuf never gets here: the
    request-info stage refused it with 406 before any write (the
    reference answers it with grpc_server's runtime.Unknown envelope)."""
    return web.json_response(obj, status=status)


def _status_body(code: int, reason: str, message: str) -> dict:
    return {"kind": "Status", "apiVersion": "v1", "status": "Failure",
            "reason": reason, "code": code, "message": message}


def _code_reason(exc: Exception) -> tuple[int, str]:
    if isinstance(exc, NotFound):
        return 404, "NotFound"
    if isinstance(exc, AlreadyExists):
        return 409, "AlreadyExists"
    if isinstance(exc, Conflict):
        return 409, "Conflict"
    if isinstance(exc, Invalid):
        return 422, "Invalid"
    if isinstance(exc, Expired):
        return 410, "Expired"
    if isinstance(exc, web.HTTPException):
        return exc.status, type(exc).__name__
    if isinstance(exc, (ValueError, json.JSONDecodeError)):
        return 400, "BadRequest"
    return 500, "InternalError"


def _error_response(exc: StoreError) -> web.Response:
    code, reason = _code_reason(exc)
    return web.json_response(_status_body(code, reason, str(exc)), status=code)


class PriorityLevel:
    """APF fair queuing with shuffle sharding (pkg/util/flowcontrol).

    `seats` concurrent requests execute. Excess requests park in one of
    `num_queues` FIFO queues: a flow's identity deals it a HAND of
    `hand_size` candidate queues (deterministic shuffle shard, the
    reference's dealer) and the request joins the shortest — an elephant
    flow fills at most its hand while mice flows' hands almost surely
    include an uncontended queue. Seats drain queues round-robin (the
    reference's virtual-finish-time fair queue, order-approximated).
    A request arriving to a full shortest-queue gets 429 + Retry-After —
    reject-when-queue-full.
    """

    def __init__(self, name: str, seats: int = 16, queue_limit: int = 128,
                 num_queues: int = 64, hand_size: int = 8):
        self.name = name
        self.seats = seats
        #: per-queue length limit (the reference's queueLengthLimit).
        self.queue_limit = queue_limit
        self.num_queues = max(1, num_queues)
        self.hand_size = max(1, min(hand_size, self.num_queues))
        self._in_use = 0
        self._queues: list[deque] = [deque() for _ in range(self.num_queues)]
        #: round-robin dispatch cursor over queues.
        self._rr_next = 0
        self._waiting = 0

    @property
    def in_use(self) -> int:
        return self._in_use

    @property
    def queued(self) -> int:
        return self._waiting

    def _hand(self, flow: str) -> list[int]:
        """Deterministic shuffle shard: deal `hand_size` DISTINCT queue
        indices from the flow's hash (shufflesharding.Dealer)."""
        import hashlib
        h = int.from_bytes(hashlib.blake2b(
            f"{self.name}/{flow}".encode(), digest_size=8).digest(), "big")
        hand = []
        remaining = self.num_queues
        for _ in range(self.hand_size):
            h, pick = divmod(h, remaining)
            # map pick over the indices not yet dealt
            for taken in sorted(hand):
                if pick >= taken:
                    pick += 1
            hand.append(pick)
            remaining -= 1
        return hand

    async def acquire(self, flow: str) -> None:
        if self._in_use < self.seats and self._waiting == 0:
            self._in_use += 1
            return
        hand = self._hand(flow)
        qi = min(hand, key=lambda i: len(self._queues[i]))
        q = self._queues[qi]
        if len(q) >= self.queue_limit:
            raise web.HTTPTooManyRequests(
                headers={"Retry-After": "1"},
                text=json.dumps(_status_body(
                    429, "TooManyRequests",
                    f"priority level {self.name!r} queue full")),
                content_type="application/json")
        fut = asyncio.get_event_loop().create_future()
        q.append(fut)
        self._waiting += 1
        try:
            await fut
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                # release() handed us the seat in the same tick the task
                # was cancelled — give it back or it leaks forever.
                self.release()
            else:
                try:
                    q.remove(fut)
                    self._waiting -= 1
                except ValueError:
                    pass
            raise
        # seat was transferred to us by release()

    def release(self) -> None:
        if self._waiting == 0:  # uncontended hot path: skip the scan
            self._in_use -= 1
            return
        # Hand the seat to the next waiter, round-robin across queues.
        for _ in range(self.num_queues):
            qi = self._rr_next
            self._rr_next = (self._rr_next + 1) % self.num_queues
            q = self._queues[qi]
            while q:
                fut = q.popleft()
                self._waiting -= 1
                if not fut.done():
                    fut.set_result(None)
                    return  # seat transferred
                # waiter was cancelled; try the next in this queue
        self._in_use -= 1


class APIServer:
    """Serve an MVCCStore over HTTP. One instance per "cluster"."""

    def __init__(self, store: MVCCStore | None = None, *,
                 host: str = "127.0.0.1", port: int = 0,
                 priority_levels: Mapping[str, PriorityLevel] | None = None,
                 bearer_tokens: Mapping[str, str] | None = None,
                 token_authenticator=None,
                 user_groups: Mapping[str, list[str]] | None = None,
                 authorizer=None,
                 admission=None,
                 metrics_registry=None,
                 audit_log: bool = False,
                 audit=None,
                 tracer=None,
                 data_dir: str | None = None,
                 fsync: str | None = None):
        #: Durability bootstrap: `data_dir` (or KTPU_DATA_DIR when no
        #: store is injected) recovers the newest snapshot + WAL tail on
        #: construction and runs the background flusher/snapshotter for
        #: the server's lifetime (started in start(), final snapshot in
        #: stop()). Passing a store AND a data_dir attaches the WAL to
        #: that store without recovery (the caller owns its contents).
        self.durability = None
        if store is None:
            from kubernetes_tpu_torch.utils import flags
            data_dir = data_dir or flags.get("KTPU_DATA_DIR")
            if not data_dir:
                raise ValueError(
                    "APIServer needs a store, a data_dir, or KTPU_DATA_DIR")
        #: remembered so a stop()/start() cycle of the same instance
        #: re-attaches a fresh WAL instead of silently running without
        #: durability (stop closes the log file and detaches the sink).
        self._data_dir = data_dir
        self._fsync = fsync
        if data_dir:
            from kubernetes_tpu_torch.store import (
                install_core_validation,
                new_cluster_store,
                recover_store,
            )
            if store is None:
                store = recover_store(data_dir, factory=new_cluster_store)
                install_core_validation(store)
        self.store = store
        self.host = host
        self.port = port
        #: route key → level. "system" catches lease/event traffic so node
        #: heartbeats survive workload floods (the APF design goal).
        self.priority_levels = dict(priority_levels or {
            "system": PriorityLevel("system", seats=64),
            "workload": PriorityLevel("workload", seats=32),
        })
        self.bearer_tokens = dict(bearer_tokens or {})  # token -> username
        #: dynamic authenticator (ServiceAccountAuthenticator): token ->
        #: username | None, consulted after the static map.
        self.token_authenticator = token_authenticator
        #: username -> group names, the authn side of Group subjects; the
        #: implicit system:authenticated/unauthenticated groups are added
        #: per-request (reference: authenticatorfactory + user.Info.Groups).
        self.user_groups = {u: list(g) for u, g in
                            (user_groups or {}).items()}
        #: RBACAuthorizer (apiserver/rbac.py) or None = authz disabled
        #: (the reference's AlwaysAllow mode).
        self.authorizer = authorizer
        #: WebhookAdmission (apiserver/admission.py) or None = no
        #: mutating/validating webhook out-calls.
        self.admission = admission
        self.metrics_registry = metrics_registry
        #: policy/audit.AuditPipeline or None = no stage-event audit
        #: (the legacy `audit_log` flat line remains available).
        self.audit = audit
        #: apiserver_request_duration_seconds / current_inflight — one
        #: instance shared with the KTPU wire (for_apiserver), so
        #: /metrics shows the whole request load across both wires.
        self.request_metrics = APIServerMetrics()
        if metrics_registry is not None:
            # Watch-dispatch counters live on the store (it owns dispatch);
            # surface them through this server's /metrics exposition.
            store.watch_metrics.register_into(metrics_registry)
            if store.cacher is not None:
                # Watch-cache serving-tier counters (hits/misses/ring).
                store.cacher.metrics.register_into(metrics_registry)
            self.request_metrics.register_into(metrics_registry)
            if audit is not None:
                audit.register_into(metrics_registry)
            engine = getattr(admission, "policy_engine", None)
            if engine is not None:
                engine.register_into(metrics_registry)
        self.audit_log = audit_log
        #: OTel-style request spans (SURVEY §5.1); defaults to the
        #: process tracer, which is disabled unless someone enables it.
        if tracer is None:
            from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
            tracer = DEFAULT_TRACER
        self.tracer = tracer
        self._runner: web.AppRunner | None = None
        self._proxy_session = None  # shared aggregator proxy client
        self.app = self._build_app()

    # -- handler chain (DefaultBuildHandlerChain order) --------------------

    def _build_app(self) -> web.Application:
        # The reference's DefaultBuildHandlerChain order (§3.2): authn →
        # audit → impersonation → APF → authz. Audit sits OUTSIDE
        # impersonation so RequestReceived carries the authenticated
        # principal and ResponseComplete records the impersonated one;
        # authz runs innermost, as the impersonated user.
        app = web.Application(middlewares=[
            self._mw_recovery,        # WithPanicRecovery
            self._mw_request_info,    # WithRequestInfo
            self._mw_request_metrics,  # request duration + inflight (§5.5)
            self._mw_trace,           # WithTracing (OTel spans, §5.1)
            self._mw_authn,           # WithAuthentication
            self._mw_audit,           # WithAudit (stage events, §5.5)
            self._mw_impersonation,   # WithImpersonation
            self._mw_priority,        # WithPriorityAndFairness
            self._mw_authz,           # WithAuthorization (RBAC, innermost)
        ])
        app.router.add_get("/healthz", self._healthz)
        app.router.add_get("/readyz", self._healthz)
        app.router.add_get("/metrics", self._metrics)
        # Discovery + OpenAPI (kubectl's first requests).
        app.router.add_get("/api", self._discovery_core)
        app.router.add_get("/apis", self._discovery_groups)
        app.router.add_get("/api/{version}", self._resource_list)
        app.router.add_get("/apis/{group}/{version}", self._resource_list)
        app.router.add_get("/openapi/v2", self._openapi)
        for prefix in ("/api/{version}", "/apis/{group}/{version}"):
            # Namespaced routes first: "/api/v1/namespaces/ns/pods" must not
            # be captured by the generic "{resource}/{name}/{subresource}".
            app.router.add_route(
                "*", prefix + "/namespaces/{namespace}/{resource}",
                self._collection)
            app.router.add_route(
                "*", prefix + "/namespaces/{namespace}/{resource}/{name}",
                self._item)
            app.router.add_route(
                "*",
                prefix + "/namespaces/{namespace}/{resource}/{name}/{subresource}",
                self._sub)
            app.router.add_route(
                "*", prefix + "/{resource}", self._collection)
            app.router.add_route(
                "*", prefix + "/{resource}/{name}", self._item)
            app.router.add_route(
                "*", prefix + "/{resource}/{name}/{subresource}", self._sub)
        return app

    @web.middleware
    async def _mw_recovery(self, request: web.Request, handler):
        try:
            return await handler(request)
        except web.HTTPException:
            raise
        except StoreError as e:
            return _error_response(e)
        except asyncio.CancelledError:
            raise
        except (ValueError, json.JSONDecodeError) as e:
            # Malformed client input (bad selector/limit/body JSON) is the
            # client's fault: 400, not 500 (the reference's BadRequest).
            return web.json_response(
                _status_body(400, "BadRequest", str(e)), status=400)
        except Exception:
            logger.exception("panic in handler for %s", request.path)
            return web.json_response(
                _status_body(500, "InternalError", "internal error"),
                status=500)

    @web.middleware
    async def _mw_request_info(self, request: web.Request, handler):
        if _wants_protobuf(request):
            return web.json_response(_status_body(
                406, "NotAcceptable", PROTOBUF_NOT_PORTED), status=406)
        m = request.match_info
        request["resource"] = m.get("resource", "")
        request["namespace"] = m.get("namespace")
        request["verb"] = {
            "GET": "watch" if request.query.get("watch") else (
                "get" if m.get("name") else "list"),
            "POST": "create", "PUT": "update", "DELETE": "delete",
            "PATCH": "patch",
        }.get(request.method, request.method.lower())
        return await handler(request)

    @web.middleware
    async def _mw_request_metrics(self, request: web.Request, handler):
        """apiserver_request_duration_seconds{verb,resource,code} +
        apiserver_current_inflight_requests{request_kind}. Non-resource
        paths (health, metrics, discovery) and long-running requests
        (watches) are excluded from BOTH families — a watch's "duration"
        is its stream lifetime, which would poison the latency
        percentiles (and differ from the KTPU wire's registration-time
        view of the same verb)."""
        m = self.request_metrics
        verb = request["verb"]
        resource = request.get("resource", "")
        if m is None or not resource or verb == "watch":
            return await handler(request)
        m.inc_inflight(verb)
        t0 = time.perf_counter()
        try:
            resp = await handler(request)
        except Exception as e:
            m.observe(verb, resource, _code_reason(e)[0],
                      time.perf_counter() - t0)
            raise
        finally:
            m.dec_inflight(verb)
        m.observe(verb, resource, resp.status, time.perf_counter() - t0)
        return resp

    @web.middleware
    async def _mw_trace(self, request: web.Request, handler):
        t = self.tracer
        if t is None or not t.enabled:
            return await handler(request)
        attrs = {"client": request.headers.get("User-Agent", "")}
        if request["resource"] == "pods" and request.match_info.get("name"):
            ns = request["namespace"] or "default"
            attrs["pod"] = f"{ns}/{request.match_info['name']}"
        with t.span(
                f"apiserver.{request['verb']}.{request['resource'] or 'misc'}",
                traceparent=request.headers.get("traceparent"),
                **attrs) as sp:
            try:
                resp = await handler(request)
            except Exception as e:
                # _mw_recovery (outside this span) will map the
                # exception; record the status HERE or every failed
                # request's span reads like a success in Perfetto.
                sp.attrs["status"] = _code_reason(e)[0]
                raise
            sp.attrs["status"] = resp.status
            return resp

    @web.middleware
    async def _mw_authn(self, request: web.Request, handler):
        user = "system:anonymous"
        auth = request.headers.get("Authorization", "")
        if auth.startswith("Bearer "):
            token = auth[len("Bearer "):]
            user = self.bearer_tokens.get(token)
            if user is None and self.token_authenticator is not None:
                user = self.token_authenticator(token)
            if user is None:
                if self.bearer_tokens or \
                        self.token_authenticator is not None:
                    return web.json_response(
                        _status_body(401, "Unauthorized", "invalid token"),
                        status=401)
                user = "system:anonymous"
        request["user"] = user
        self.tracer.annotate(user=user)  # identity, not client library
        return await handler(request)

    def _groups_for(self, user: str) -> list[str]:
        """Configured groups + the implicit authn group — the same set for
        local authz and the aggregator's X-Remote-Group, so group bindings
        behave identically on both sides of the proxy."""
        groups = list(self.user_groups.get(user, ()))
        groups.append("system:unauthenticated"
                      if user == "system:anonymous"
                      else "system:authenticated")
        return groups

    def _request_groups(self, request: web.Request) -> list[str]:
        """Effective groups for the request's CURRENT identity —
        Impersonate-Group headers win over configured group membership
        once impersonation swapped users (the reference's
        user.Info.Groups after the impersonation filter)."""
        override = request.get("groups")
        if override is not None:
            return override
        return self._groups_for(request.get("user", "system:anonymous"))

    @web.middleware
    async def _mw_impersonation(self, request: web.Request, handler):
        """WithImpersonation: Impersonate-User swaps the request identity
        when RBAC grants the AUTHENTICATED user the `impersonate` verb on
        `users` (plugin order: after audit — so audit sees both sides —
        before APF/authz, which run as the impersonated user)."""
        target = request.headers.get("Impersonate-User")
        if not target:
            return await handler(request)
        user = request.get("user", "system:anonymous")
        if self.authorizer is not None and not self.authorizer.allowed(
                user, "impersonate", "users",
                groups=self._groups_for(user)):
            return web.json_response(_status_body(
                403, "Forbidden",
                f'user "{user}" cannot impersonate user "{target}"'),
                status=403)
        imp_groups = request.headers.getall("Impersonate-Group", [])
        if imp_groups and self.authorizer is not None and \
                not self.authorizer.allowed(
                    user, "impersonate", "groups",
                    groups=self._groups_for(user)):
            # Group impersonation is a SEPARATE grant (the reference
            # checks each impersonated attribute on its own resource):
            # impersonate-on-users must not let a caller self-assign
            # arbitrary group memberships.
            return web.json_response(_status_body(
                403, "Forbidden",
                f'user "{user}" cannot impersonate groups'), status=403)
        request["original_user"] = user
        request["impersonated_user"] = target
        request["user"] = target
        if imp_groups:
            request["groups"] = [*imp_groups, "system:authenticated"]
        self.tracer.annotate(user=target)
        return await handler(request)

    @web.middleware
    async def _mw_authz(self, request: web.Request, handler):
        # Non-resource paths (health, metrics, discovery, openapi) are
        # exempt — the reference grants them via system:discovery
        # nonResourceURLs; RBAC rules here are verb × resource only.
        if self.authorizer is None or not request.get("resource"):
            return await handler(request)
        user = request.get("user", "system:anonymous")
        verb = request.get("verb", "")
        resource = request.get("resource", "")
        if not self.authorizer.allowed(user, verb, resource,
                                       groups=self._request_groups(request)):
            return web.json_response(_status_body(
                403, "Forbidden",
                f'user "{user}" cannot {verb} resource "{resource}"'),
                status=403)
        return await handler(request)

    def _classify(self, request: web.Request) -> PriorityLevel:
        """Flow-schema-lite: leases + events + node status ride the system
        level; everything else is workload."""
        if request["resource"] in ("leases", "events"):
            return self.priority_levels["system"]
        return self.priority_levels["workload"]

    @web.middleware
    async def _mw_priority(self, request: web.Request, handler):
        if request.path in ("/healthz", "/readyz", "/metrics"):
            return await handler(request)
        if request["verb"] == "watch":
            return await handler(request)  # watches hold no seat (cacher)
        level = self._classify(request)
        flow = request.headers.get("User-Agent", "unknown")
        await level.acquire(flow)
        try:
            return await handler(request)
        finally:
            level.release()

    @web.middleware
    async def _mw_audit(self, request: web.Request, handler):
        """WithAudit: policy-selected level, RequestReceived emitted
        before the inner chain (pre-impersonation identity — audit sits
        outside the impersonation filter, like the reference), and
        ResponseComplete after, carrying the final status plus
        `impersonatedUser` when the identity was swapped mid-chain."""
        pipeline = self.audit
        resource = request.get("resource", "")
        if pipeline is None or not resource:
            resp = await handler(request)
            if self.audit_log:
                logger.info(
                    "audit user=%s verb=%s resource=%s ns=%s name=%s "
                    "code=%s",
                    request.get("user"), request.get("verb"),
                    request.get("resource"), request.get("namespace"),
                    request.match_info.get("name"), resp.status)
            return resp
        from kubernetes_tpu_torch.policy.audit import (  # noqa: PLC0415 — lazy:
            LEVEL_REQUEST,                         # policy/ is optional
            LEVEL_REQUEST_RESPONSE,                # for audit-less servers
            level_at_least,
        )
        user = request.get("user", "system:anonymous")
        groups = self._groups_for(user)
        verb = request.get("verb", "")
        namespace = request.get("namespace")
        rule = pipeline.policy.rule_for(
            user=user, groups=groups, verb=verb, resource=resource,
            namespace=namespace)
        level = rule.get("level", "None") if rule else "None"
        req_obj = None
        if level_at_least(level, LEVEL_REQUEST) and request.can_read_body:
            # aiohttp caches the raw body, so the handler's own
            # request.json() still works after this read.
            try:
                req_obj = json.loads(await request.read())
            except (ValueError, json.JSONDecodeError):
                req_obj = None
        name = request.match_info.get("name") or \
            ((req_obj or {}).get("metadata") or {}).get("name")
        ctx = pipeline.begin(
            user=user, groups=groups, verb=verb, resource=resource,
            namespace=namespace, name=name, request_object=req_obj,
            rule=rule)
        try:
            resp = await handler(request)
        except Exception as e:
            pipeline.response_complete(
                ctx, code=_code_reason(e)[0],
                impersonated_user=request.get("impersonated_user"))
            raise
        resp_obj = None
        # Creates carry no name in the URL: the reference fills
        # objectRef.Name from the RESPONSE object at ResponseComplete.
        # Only creates — a LIST also has no URL name, but parsing a
        # multi-MB list body to hunt for a name it cannot contain would
        # tax the serving path for nothing.
        need_name = ctx is not None and verb == "create" and \
            not ctx["objectRef"]["name"]
        if (need_name
                or level_at_least(level, LEVEL_REQUEST_RESPONSE)) and \
                getattr(resp, "body", None) and \
                "json" in (resp.content_type or ""):
            try:
                parsed = json.loads(resp.body)
            except (ValueError, json.JSONDecodeError, TypeError):
                parsed = None
            if need_name and isinstance(parsed, dict):
                ctx["objectRef"]["name"] = (
                    parsed.get("metadata") or {}).get("name", "")
            if level_at_least(level, LEVEL_REQUEST_RESPONSE):
                resp_obj = parsed
        pipeline.response_complete(
            ctx, code=resp.status, response_object=resp_obj,
            impersonated_user=request.get("impersonated_user"))
        if self.audit_log:
            logger.info(
                "audit user=%s verb=%s resource=%s ns=%s name=%s code=%s",
                user, verb, resource, namespace,
                request.match_info.get("name"), resp.status)
        return resp

    # -- endpoints ---------------------------------------------------------

    async def _healthz(self, request: web.Request) -> web.Response:
        return web.Response(text="ok")

    # -- discovery + OpenAPI (kubectl bootstrap; kube-aggregator shape) ----

    async def _discovery_core(self, request: web.Request) -> web.Response:
        return web.json_response({"kind": "APIVersions", "versions": ["v1"]})

    async def _discovery_groups(self, request: web.Request) -> web.Response:
        """APIGroupList: built-in groups plus aggregated APIServices."""
        groups = {"apps", "batch", "storage.k8s.io", "scheduling.x-k8s.io",
                  "topology.node.k8s.io", "autoscaling", "policy",
                  "rbac.authorization.k8s.io", "apiextensions.k8s.io"}
        for svc in self.store._table("apiservices").values():
            g = (svc.get("spec") or {}).get("group")
            if g:
                groups.add(g)
        return web.json_response({
            "kind": "APIGroupList",
            "groups": [{"name": g, "versions": [{"version": "v1"}]}
                       for g in sorted(groups)]})

    async def _resource_list(self, request: web.Request) -> web.Response:
        """APIResourceList — kubectl's kind↔resource mapping request
        (GET /apis/apps/v1 etc.). Serves the full known set per group
        version; aggregated groups proxy."""
        proxied = await self._maybe_proxy(request)
        if proxied is not None:
            return proxied
        gv = request.match_info.get("version", "v1")
        group = request.match_info.get("group", "")
        return web.json_response({
            "kind": "APIResourceList",
            "groupVersion": f"{group}/{gv}" if group else gv,
            "resources": [
                {"name": resource, "kind": kind,
                 "namespaced": not self.store.is_cluster_scoped(resource),
                 "verbs": ["get", "list", "watch", "create", "update",
                           "delete"]}
                for kind, resource in sorted(self.store.kind_map().items())],
        })

    async def _openapi(self, request: web.Request) -> web.Response:
        """Minimal swagger 2.0: one path pair per known resource."""
        paths = {}
        for kind, resource in sorted(self.store.kind_map().items()):
            base = f"/api/v1/{resource}" if self.store.is_cluster_scoped(
                resource) else f"/api/v1/namespaces/{{namespace}}/{resource}"
            paths[base] = {"get": {"operationId": f"list{kind}"},
                           "post": {"operationId": f"create{kind}"}}
            paths[base + "/{name}"] = {
                "get": {"operationId": f"read{kind}"},
                "put": {"operationId": f"replace{kind}"},
                "delete": {"operationId": f"delete{kind}"}}
        return web.json_response({
            "swagger": "2.0",
            "info": {"title": "kubernetes-tpu", "version": "v1"},
            "paths": paths})

    def _aggregated_target(self, group: str) -> str | None:
        """kube-aggregator handler_proxy: an APIService object with
        spec.group == <group> routes the whole /apis/<group>/... subtree
        to its extension server."""
        for svc in self.store._table("apiservices").values():
            spec = svc.get("spec") or {}
            if spec.get("group") == group and \
                    (spec.get("service") or {}).get("url"):
                return spec["service"]["url"].rstrip("/")
        return None

    # Client credentials are stripped, not forwarded: the reference
    # aggregator authenticates ITSELF to extension servers and passes the
    # caller's identity via X-Remote-* headers (kube-aggregator
    # handler_proxy + x509 requestheader authn). Forwarding the bearer
    # token would hand every client's credential to whoever registers an
    # APIService.
    _HOP_HEADERS = {"host", "connection", "keep-alive", "transfer-encoding",
                    "upgrade", "proxy-authorization", "te", "trailers",
                    "authorization", "cookie"}

    @classmethod
    def _forwardable(cls, header: str) -> bool:
        h = header.lower()
        # Every client-supplied x-remote-* is dropped (not just user/group):
        # the extension trusts that namespace as proxy-asserted identity, so
        # forwarding e.g. X-Remote-Extra-Scopes would let callers inject
        # attributes onto their verified identity.
        return h not in cls._HOP_HEADERS and not h.startswith("x-remote-")

    def _proxy_client(self):
        import aiohttp
        if self._proxy_session is None:
            # Bounded total timeout: a blackholed extension server must not
            # pin APF workload seats for aiohttp's 5-minute default (the
            # WebhookAdmission session pattern). Watches override per-call.
            self._proxy_session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=30.0))
        return self._proxy_session

    async def _maybe_proxy(self,
                           request: web.Request) -> web.StreamResponse | None:
        group = request.match_info.get("group")
        if not group:
            return None
        target = self._aggregated_target(group)
        if target is None:
            return None
        import aiohttp
        url = target + request.path_qs
        body = await request.read() if request.can_read_body else None
        headers = {k: v for k, v in request.headers.items()
                   if self._forwardable(k)}
        ruser = request.get("user", "system:anonymous")
        headers["X-Remote-User"] = ruser
        rgroups = self._groups_for(ruser)
        headers["X-Remote-Group"] = ",".join(rgroups)
        is_watch = bool(request.query.get("watch"))
        resp = None
        try:
            session = self._proxy_client()
            kwargs = {}
            if is_watch:
                # Long-lived stream: no total deadline, just connect.
                kwargs["timeout"] = aiohttp.ClientTimeout(
                    total=None, sock_connect=5.0)
            async with session.request(request.method, url, data=body,
                                       headers=headers, **kwargs) as r:
                if is_watch:
                    # Stream the chunked watch frames through.
                    resp = web.StreamResponse(status=r.status)
                    resp.content_type = r.content_type
                    await resp.prepare(request)
                    async for chunk in r.content.iter_any():
                        await resp.write(chunk)
                    await resp.write_eof()
                    return resp
                return web.Response(
                    status=r.status, body=await r.read(),
                    content_type=r.content_type or "application/json")
        except (aiohttp.ClientError, asyncio.TimeoutError) as e:
            # TimeoutError is what the total ClientTimeout raises — it is
            # NOT a ClientError subclass.
            if resp is not None and resp.prepared:
                # Headers already sent (extension died mid-watch): end the
                # stream cleanly; a second response body would corrupt the
                # connection.
                try:
                    await resp.write_eof()
                except (ConnectionError, RuntimeError):
                    pass
                return resp
            return web.json_response(_status_body(
                503, "ServiceUnavailable",
                f"aggregated apiserver for {group!r} unreachable: {e}"),
                status=503)

    async def _metrics(self, request: web.Request) -> web.Response:
        text = ""
        if self.metrics_registry is not None:
            text = self.metrics_registry.render()
        return web.Response(text=text, content_type="text/plain")

    @staticmethod
    def _key(request: web.Request) -> str:
        ns, name = request["namespace"], request.match_info["name"]
        return f"{ns}/{name}" if ns else name

    async def _collection(self, request: web.Request) -> web.StreamResponse:
        proxied = await self._maybe_proxy(request)
        if proxied is not None:
            return proxied
        resource = request["resource"]
        if request.method == "GET":
            if request.query.get("watch"):
                return await self._watch(request)
            sel = None
            if request.query.get("labelSelector"):
                sel = parse_selector(request.query["labelSelector"])
            fields = None
            if request.query.get("fieldSelector"):
                fields = parse_field_selector(
                    request.query["fieldSelector"])
            limit = int(request.query.get("limit", 0) or 0)
            cont = request.query.get("continue")
            # RV-semantics params (the cacher contract, store/cacher.py):
            # resourceVersion + resourceVersionMatch=Exact serves the
            # historical snapshot; bare/0 RVs serve "any cached" =
            # current. Continue tokens carry their own RV pin.
            rv_q = request.query.get("resourceVersion")
            rv = int(rv_q) if rv_q and rv_q.isdigit() and int(rv_q) \
                else None
            lst = await self.store.list(
                resource, namespace=request["namespace"], selector=sel,
                limit=limit, continue_key=cont, fields=fields,
                resource_version=rv,
                resource_version_match=request.query.get(
                    "resourceVersionMatch"),
                copy=False)  # encode-only: serialized before return
            body = {
                "kind": "List", "apiVersion": "v1",
                "metadata": {"resourceVersion": str(lst.resource_version)},
                "items": lst.items,
            }
            if lst.cont:
                # Snapshot-pinned token off the cacher: later pages are
                # served at THIS page's RV (identical on the KTPU wire).
                body["metadata"]["continue"] = lst.cont
            elif limit and len(lst.items) >= limit:
                # Legacy (cacher disabled): the bare store key of the
                # last item (store.list resumes strictly after it).
                last = lst.items[-1]["metadata"]
                ns = last.get("namespace")
                body["metadata"]["continue"] = \
                    f"{ns}/{last['name']}" if ns else last["name"]
            return web.json_response(body)
        if request.method == "POST":
            obj = await request.json()
            if request["namespace"] and not obj.get(
                    "metadata", {}).get("namespace"):
                obj.setdefault("metadata", {})["namespace"] = \
                    request["namespace"]
            if resource == "pods":
                meta = obj.get("metadata") or {}
                ns = meta.get("namespace") or "default"
                self.tracer.annotate(pod=f"{ns}/{meta.get('name', '')}")
                # Carry this request's trace across the informer/queue
                # boundary: the scheduler parents its attempt span to the
                # stamped traceparent (no-op with tracing off).
                stamp_traceparent(obj)
            if self.admission is not None:
                with self.tracer.span("admission.webhooks",
                                      resource=resource, op="create"):
                    obj = await self.admission.admit(
                        obj, resource, "create",
                        user=request.get("user"),
                        groups=self._request_groups(request))
            if request.query.get("dryRun"):
                # dryRun=All (kubectl diff's seam): the FULL admission
                # chain ran above, and the store's mutators+validators
                # run here too (defaulting becomes VISIBLE in the
                # diff; an unpersistable object fails the dry run the
                # way a real create would). Only uniqueness/RV checks
                # are skipped — nothing persists, no watch event.
                admit = getattr(self.store, "_admit", None)
                if admit is not None:
                    admit(resource, obj, "create")
                return _object_response(request, obj, status=201)
            with self.tracer.span("store.create", resource=resource):
                created = await self.store.create(resource, obj)
            return _object_response(request, created, status=201)
        raise web.HTTPMethodNotAllowed(request.method, ["GET", "POST"])

    async def _item(self, request: web.Request) -> web.Response:
        proxied = await self._maybe_proxy(request)
        if proxied is not None:
            return proxied
        resource, key = request["resource"], self._key(request)
        if request.method == "GET":
            return _object_response(
                request, await self.store.get(resource, key))
        if request.method == "PUT":
            obj = await request.json()
            # The URL fully identifies the object; default the body's
            # metadata from it so a sparse body can't target the wrong key.
            meta = obj.setdefault("metadata", {})
            meta.setdefault("name", request.match_info["name"])
            if request["namespace"]:
                meta.setdefault("namespace", request["namespace"])
            if self.admission is not None:
                obj = await self.admission.admit(
                    obj, resource, "update", user=request.get("user"),
                    groups=self._request_groups(request))
            if request.query.get("dryRun"):
                # Admission + store mutators/validators ran; the
                # update is NOT persisted (see the POST dryRun note).
                admit = getattr(self.store, "_admit", None)
                if admit is not None:
                    admit(resource, obj, "update")
                return _object_response(request, obj)
            return _object_response(
                request, await self.store.update(resource, obj))
        if request.method == "PATCH" and "apply-patch" in \
                request.headers.get("Content-Type", ""):
            # Server-side apply (application/apply-patch+yaml): the
            # fieldManager param names the owner; force transfers
            # conflicting fields (SURVEY §2.7).
            obj = await request.json()
            meta = obj.setdefault("metadata", {})
            meta.setdefault("name", request.match_info["name"])
            if request["namespace"]:
                meta.setdefault("namespace", request["namespace"])
            manager = request.query.get("fieldManager", "")
            if not manager:
                return web.json_response(_status_body(
                    400, "BadRequest", "fieldManager is required"),
                    status=400)
            if self.admission is not None:
                obj = await self.admission.admit(
                    obj, resource, "update", user=request.get("user"),
                    groups=self._request_groups(request))
            out = await self.store.apply(
                resource, obj, field_manager=manager,
                force=request.query.get("force") in ("true", "1"))
            # 200 for both create and update (the reference 201s fresh
            # creates; callers here key off the object, not the code).
            return _object_response(request, out)
        if request.method == "PATCH":
            # Strategic-merge / merge patch (kubectl patch): read-modify-
            # write over the live object. The merged result flows through
            # the FULL admission chain — webhooks + expression policies —
            # exactly like a PUT (the reference's patchResource path).
            ct = request.headers.get("Content-Type", "")
            patch = await request.json()
            from kubernetes_tpu_torch.store.apply import strategic_merge_patch
            # Patch carries no client RV precondition, so a concurrent
            # writer must not surface as a spurious 409: re-read and
            # re-merge on Conflict (the reference's patchResource retry).
            for attempt in range(8):
                current = await self.store.get(resource, key)
                if "json-patch" in ct:
                    from kubernetes_tpu_torch.apiserver.admission import (
                        apply_json_patch,
                    )
                    merged = apply_json_patch(current, patch)
                else:
                    # application/strategic-merge-patch+json and
                    # application/merge-patch+json: dict deep-merge; the
                    # strategic variant also merges named list entries.
                    merged = strategic_merge_patch(
                        current, patch, strategic="strategic" in ct or
                        not ct.startswith("application/merge-patch"))
                if self.admission is not None:
                    merged = await self.admission.admit(
                        merged, resource, "update",
                        user=request.get("user"),
                        groups=self._request_groups(request))
                try:
                    return _object_response(
                        request, await self.store.update(resource, merged))
                except Conflict:
                    if attempt == 7:
                        raise
                    continue
        if request.method == "DELETE":
            uid = None
            if request.can_read_body:
                try:
                    body = await request.json()
                    uid = (body.get("preconditions") or {}).get("uid")
                except (ValueError, json.JSONDecodeError):
                    pass
            if self.admission is not None:
                # Webhooks see the object being deleted (patches have no
                # meaning on delete; deny aborts it).
                current = await self.store.get(resource, key)
                await self.admission.admit(
                    current, resource, "delete",
                    user=request.get("user"),
                    groups=self._request_groups(request))
            return web.json_response(
                await self.store.delete(resource, key, uid=uid))
        raise web.HTTPMethodNotAllowed(
            request.method, ["GET", "PUT", "PATCH", "DELETE"])

    async def _sub(self, request: web.Request) -> web.Response:
        proxied = await self._maybe_proxy(request)
        if proxied is not None:
            return proxied
        resource, key = request["resource"], self._key(request)
        sub = request.match_info["subresource"]
        if sub == "status" and request.method == "PUT":
            obj = await request.json()
            # The key comes from the URL; the subresource only replaces
            # `.status` over the live object (the reference's StatusREST).
            # A resourceVersion in the body is an optimistic-concurrency
            # precondition: mismatch → 409, as with a full-object PUT.
            status = obj.get("status", {})
            want_rv = obj.get("metadata", {}).get("resourceVersion")

            def merge_status(current: dict) -> dict:
                if want_rv and \
                        str(current["metadata"]["resourceVersion"]) != str(want_rv):
                    raise Conflict(
                        f"{resource} {key!r}: resourceVersion mismatch")
                current["status"] = status
                return current

            out = await self.store.guaranteed_update(
                resource, key, merge_status)
            return web.json_response(out)
        if request.method != "POST":
            raise web.HTTPMethodNotAllowed(request.method, ["POST"])
        body = await request.json()
        with self.tracer.span(f"store.subresource.{sub}",
                              resource=resource):
            result = await self.store.subresource(resource, key, sub, body)
        return web.json_response(result, status=201)

    async def _watch(self, request: web.Request) -> web.StreamResponse:
        """Chunked newline-delimited WatchEvents (the reference's
        `Transfer-Encoding: chunked` watch stream)."""
        resource = request["resource"]
        rv = int(request.query.get("resourceVersion", 0) or 0)
        sel = None
        if request.query.get("labelSelector"):
            sel = parse_selector(request.query["labelSelector"])
        fields = None
        if request.query.get("fieldSelector"):
            # The kubelet's watch shape (spec.nodeName=<me>): exact-match
            # field terms ride the store's tracked-field index, so this
            # wire's fan-out is O(matching watchers) too.
            fields = parse_field_selector(request.query["fieldSelector"])
        try:
            watch = await self.store.watch(
                resource, resource_version=rv,
                namespace=request["namespace"], selector=sel,
                fields=fields)
        except Expired as e:
            return _error_response(e)
        resp = web.StreamResponse(
            status=200,
            headers={"Content-Type": "application/json;stream=watch"})
        await resp.prepare(request)
        from kubernetes_tpu_torch.apiserver.wire import encode_event_object
        try:
            async for ev in watch:
                if ev.type == "BOOKMARK":
                    frame = (b'{"type":"BOOKMARK","object":{"metadata":'
                             b'{"resourceVersion":"' + str(ev.rv).encode()
                             + b'"}}}\n')
                else:
                    # Spliced frame: object bytes encoded once per event
                    # ACROSS its synthesized twins too (encode_event_object
                    # follows _wire_src — SURVEY §3.2). The splice itself
                    # stays per-connection: memoizing the whole frame would
                    # pin a second full copy of every object on events
                    # retained in the 200k-entry history window.
                    frame = (b'{"type":"' + ev.type.encode()
                             + b'","object":' + encode_event_object(ev)
                             + b'}\n')
                await resp.write(frame)
        except (ConnectionResetError, asyncio.CancelledError):
            pass
        finally:
            aclose = getattr(watch, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass
        return resp

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        if self.durability is None and self._data_dir:
            from kubernetes_tpu_torch.store import DurabilityManager
            self.durability = DurabilityManager(
                self.store, self._data_dir, fsync=self._fsync)
        if self.durability is not None:
            self.durability.start()
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        # Resolve the ephemeral port.
        server = site._server  # noqa: SLF001
        if server and server.sockets:
            self.port = server.sockets[0].getsockname()[1]
        logger.info("apiserver listening on %s:%d", self.host, self.port)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._proxy_session is not None:
            await self._proxy_session.close()
            self._proxy_session = None
        if self.audit is not None:
            await self.audit.close()
        if self.admission is not None:
            await self.admission.close()
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        if self.durability is not None:
            # Final snapshot: a clean shutdown leaves one compact
            # snapshot file, so the next boot replays no WAL tail.
            await self.durability.stop(final_snapshot=True)
            self.durability = None
