"""gRPC + protobuf wire for the store (SURVEY §5.8's "gRPC variant").

Parity notes: the reference's core components speak protobuf over HTTP/2
(`application/vnd.kubernetes.protobuf`), with objects carried in a
`runtime.Unknown` envelope — TypeMeta plus raw payload bytes. This wire
is exactly that shape (`Unknown{api_version, kind, raw, content_type}`,
raw = JSON bytes), over grpc.aio. The service surface mirrors
`storage.Interface`: Get/List/Create/Update/Delete/Subresource unary
calls plus a server-streaming Watch with BOOKMARK frames and
OUT_OF_RANGE for expired resourceVersions (the 410 analog).

`GRPCRemoteStore` is MVCCStore-shaped: informers/controllers/scheduler
run over it unchanged, like the HTTP RemoteStore.

Copy of `kubernetes_tpu/apiserver/grpc_server.py`. The generated module is
imported package-qualified (`apiserver.proto.ktpu_pb2`), not as a top-level
`ktpu_pb2` from a `sys.path` entry, so it is this package's own file even
where the JAX package's copy is loaded too. A `grpc.aio` server and its
channels belong to the event loop that made them: create and close them
inside one `asyncio.run`.
"""

from __future__ import annotations

import asyncio
import contextvars
import json
import logging
from typing import Mapping

import grpc

from kubernetes_tpu_torch.api.labels import (
    Selector,
    parse_selector,
    selector_to_string,
)
from kubernetes_tpu_torch.apiserver.proto import ktpu_pb2
from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Expired,
    Invalid,
    MVCCStore,
    NotFound,
    StoreError,
)
from kubernetes_tpu_torch.utils.tracing import stamp_traceparent

logger = logging.getLogger(__name__)

_SERVICE = "ktpu.Store"

_CODE_OF = {
    NotFound: grpc.StatusCode.NOT_FOUND,
    AlreadyExists: grpc.StatusCode.ALREADY_EXISTS,
    Conflict: grpc.StatusCode.ABORTED,
    Invalid: grpc.StatusCode.INVALID_ARGUMENT,
    Expired: grpc.StatusCode.OUT_OF_RANGE,
}
_ERR_OF = {v: k for k, v in _CODE_OF.items()}


def _wrap(obj: dict) -> "ktpu_pb2.Unknown":
    return ktpu_pb2.Unknown(
        api_version=obj.get("apiVersion", ""),
        kind=obj.get("kind", ""),
        raw=json.dumps(obj).encode(),
        content_type="application/json")


def _unwrap(u: "ktpu_pb2.Unknown") -> dict:
    return json.loads(u.raw.decode()) if u.raw else {}


def _abort_code(e: StoreError) -> grpc.StatusCode:
    for cls, code in _CODE_OF.items():
        if isinstance(e, cls):
            return code
    return grpc.StatusCode.INTERNAL


#: (user, groups) of the current RPC, set by AuthInterceptor's wrapped
#: handler in the same task context the service method runs in — how the
#: admission chain learns the caller identity without widening the
#: service signatures.
_CALLER: contextvars.ContextVar = contextvars.ContextVar(
    "ktpu_grpc_caller", default=None)


class StoreService:
    """grpc.aio service over one MVCCStore. With an admission chain
    attached, writes run mutating webhooks → expression policies →
    validating webhooks exactly like the HTTP and KTPU wires."""

    def __init__(self, store: MVCCStore, admission=None):
        self.store = store
        self.admission = admission

    async def _admit(self, obj: dict, resource: str, op: str) -> dict:
        if self.admission is None:
            return obj
        caller = _CALLER.get() or ("system:anonymous", [])
        return await self.admission.admit(
            obj, resource, op, user=caller[0], groups=caller[1])

    async def Get(self, request, context):
        try:
            obj = await self.store.get(request.resource, request.key)
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return _wrap(obj)

    async def List(self, request, context):
        sel = parse_selector(request.label_selector) \
            if request.label_selector else None
        try:
            # Served from the watch-cache tier (store/cacher.py) like the
            # other two wires. Exact-RV reads need no new proto field:
            # the continue token carries its own RV pin ("<rv>:<key>",
            # "<rv>:" for a pinned first page), so snapshot-consistent
            # pagination round-trips through ListRequest.continue_key.
            lst = await self.store.list(
                request.resource,
                namespace=request.namespace or None,
                selector=sel, limit=request.limit,
                continue_key=request.continue_key or None,
                copy=False)  # encode-only: wrapped before return
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return ktpu_pb2.ListResponse(
            items=[_wrap(o) for o in lst.items],
            resource_version=str(lst.resource_version))

    async def Create(self, request, context):
        try:
            obj = _unwrap(request.object)
            if request.resource == "pods":
                # Carry the RPC's trace across the informer/queue
                # boundary (no-op outside a span).
                stamp_traceparent(obj)
            obj = await self._admit(obj, request.resource, "create")
            obj = await self.store.create(request.resource, obj)
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return _wrap(obj)

    async def Update(self, request, context):
        try:
            obj = await self._admit(
                _unwrap(request.object), request.resource, "update")
            obj = await self.store.update(request.resource, obj)
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return _wrap(obj)

    async def Delete(self, request, context):
        try:
            if self.admission is not None:
                current = await self.store.get(
                    request.resource, request.key)
                await self._admit(current, request.resource, "delete")
            obj = await self.store.delete(
                request.resource, request.key, uid=request.uid or None)
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return _wrap(obj)

    async def Subresource(self, request, context):
        try:
            obj = await self.store.subresource(
                request.resource, request.key, request.subresource,
                _unwrap(request.body))
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))
        return _wrap(obj)

    async def Watch(self, request, context):
        sel = parse_selector(request.label_selector) \
            if request.label_selector else None
        rv = int(request.resource_version) \
            if request.resource_version else 0
        try:
            async for ev in await self.store.watch(
                    request.resource, resource_version=rv, selector=sel):
                yield ktpu_pb2.WatchEvent(
                    type=ev.type, object=_wrap(ev.object),
                    rv=str(ev.rv))
        except Expired as e:
            await context.abort(grpc.StatusCode.OUT_OF_RANGE, str(e))
        except StoreError as e:
            await context.abort(_abort_code(e), str(e))


_VERB_OF_METHOD = {"Get": "get", "List": "list", "Create": "create",
                   "Update": "update", "Delete": "delete",
                   "Subresource": "update", "Watch": "watch"}


class AuthInterceptor(grpc.aio.ServerInterceptor):
    """The gRPC analog of the apiserver handler chain (§3.2): authn
    (authorization metadata) → audit stage events → impersonation
    (impersonate-user metadata, RBAC `impersonate`-gated) → authz →
    service method. Wraps the resolved method handler so the audit
    events see the DESERIALIZED request (resource/key) and the final
    status code."""

    def __init__(self, owner: "GRPCAPIServer"):
        self.owner = owner

    def _authn(self, md: Mapping) -> str | None:
        owner = self.owner
        auth = md.get("authorization", "")
        if auth.startswith("Bearer ") and owner.bearer_tokens is not None:
            user = owner.bearer_tokens.get(auth[len("Bearer "):])
            if user is None:
                return None  # invalid token → UNAUTHENTICATED
            return user
        return "system:anonymous"

    async def intercept_service(self, continuation, details):
        handler = await continuation(details)
        owner = self.owner
        tracer = owner.tracer
        tracing = tracer is not None and tracer.enabled
        if handler is None or (owner.bearer_tokens is None
                               and owner.authorizer is None
                               and owner.audit is None
                               and not tracing):
            return handler  # chain disabled: raw service
        md = {k: v for k, v in (details.invocation_metadata or ())}
        method = details.method.rsplit("/", 1)[-1]
        verb = _VERB_OF_METHOD.get(method, method.lower())
        auth_user = self._authn(md)
        target = md.get("impersonate-user") or None
        fail: tuple[grpc.StatusCode, str] | None = None
        user = auth_user
        if auth_user is None:
            fail = (grpc.StatusCode.UNAUTHENTICATED, "invalid token")
        elif target:
            if owner.authorizer is not None and \
                    not owner.authorizer.allowed(
                        auth_user, "impersonate", "users",
                        groups=owner.groups_for(auth_user)):
                fail = (grpc.StatusCode.PERMISSION_DENIED,
                        f'user "{auth_user}" cannot impersonate user '
                        f'"{target}"')
            else:
                user = target

        def begin_audit(request):
            if owner.audit is None:
                return None
            resource = getattr(request, "resource", "") or ""
            if not resource:
                return None
            key = getattr(request, "key", "") or ""
            ns, _, name = key.rpartition("/")
            # Invalid-token requests still audit (as anonymous): the
            # denials are exactly what the pipeline exists to record.
            audit_user = auth_user or "system:anonymous"
            groups = owner.groups_for(audit_user)
            rule = owner.audit.policy.rule_for(
                user=audit_user, groups=groups, verb=verb,
                resource=resource, namespace=ns or None)
            if rule is None or rule.get("level", "None") == "None":
                return None  # unaudited: skip the payload parse below
            if not name:
                # Create/Update carry the identity inside the
                # runtime.Unknown envelope, not a key field — parsed
                # only for requests the policy actually audits (the
                # service re-parses via _unwrap; doubling that cost on
                # every unaudited write would tax the wire's whole
                # point).
                unknown = getattr(request, "object", None)
                if unknown is not None and unknown.raw:
                    try:
                        meta = (json.loads(unknown.raw).get("metadata")
                                or {})
                        name = meta.get("name", "")
                        ns = meta.get("namespace", "")
                    except (ValueError, json.JSONDecodeError):
                        pass
            return owner.audit.begin(
                user=audit_user, groups=groups, verb=verb,
                resource=resource, namespace=ns or None,
                name=name or None, rule=rule)

        def end_audit(actx, code: int):
            if actx is not None:
                owner.audit.response_complete(
                    actx, code=code,
                    impersonated_user=user
                    if user and user != auth_user else None)

        def check_authz(request) -> str | None:
            resource = getattr(request, "resource", "") or ""
            if owner.authorizer is None or not resource:
                return None
            if not owner.authorizer.allowed(
                    user, verb, resource, groups=owner.groups_for(user)):
                return f'user "{user}" cannot {verb} resource ' \
                       f'"{resource}"'
            return None

        if handler.unary_unary is not None:
            inner = handler.unary_unary

            async def uu(request, context):
                if tracing:
                    # gRPC-metadata traceparent (the interceptor-chain
                    # analog of the HTTP traceparent header): the RPC's
                    # server span parents to the caller's.
                    resource = getattr(request, "resource", "") or "misc"
                    with tracer.span(f"grpc.{verb}.{resource}",
                                     traceparent=md.get("traceparent"),
                                     user=user or "system:anonymous"):
                        return await uu_chain(request, context)
                return await uu_chain(request, context)

            async def uu_chain(request, context):
                actx = begin_audit(request)
                if fail is not None:
                    # authn/impersonation denials are audited too — the
                    # HTTP wire records its 401/403s, so must this one.
                    end_audit(actx, _GRPC_AUDIT_CODE.get(fail[0], 500))
                    await context.abort(*fail)
                denied = check_authz(request)
                if denied is not None:
                    end_audit(actx, 403)
                    await context.abort(
                        grpc.StatusCode.PERMISSION_DENIED, denied)
                token = _CALLER.set((user, owner.groups_for(user)))
                try:
                    resp = await inner(request, context)
                except grpc.aio.AbortError:
                    end_audit(actx, _GRPC_AUDIT_CODE.get(
                        context.code(), 500))
                    raise
                except Exception:
                    # Non-StoreError bug: gRPC will return UNKNOWN; the
                    # audit trail still gets its ResponseComplete (the
                    # HTTP wire records these as 500 the same way).
                    end_audit(actx, 500)
                    raise
                finally:
                    _CALLER.reset(token)
                end_audit(actx, 200)
                return resp

            return grpc.unary_unary_rpc_method_handler(
                uu, request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)

        if handler.unary_stream is not None:
            inner_stream = handler.unary_stream

            async def us(request, context):
                if tracing:
                    resource = getattr(request, "resource", "") or "misc"
                    with tracer.span(f"grpc.{verb}.{resource}",
                                     traceparent=md.get("traceparent"),
                                     user=user or "system:anonymous"):
                        async for item in us_chain(request, context):
                            yield item
                    return
                async for item in us_chain(request, context):
                    yield item

            async def us_chain(request, context):
                actx = begin_audit(request)
                if fail is not None:
                    end_audit(actx, _GRPC_AUDIT_CODE.get(fail[0], 500))
                    await context.abort(*fail)
                denied = check_authz(request)
                if denied is not None:
                    end_audit(actx, 403)
                    await context.abort(
                        grpc.StatusCode.PERMISSION_DENIED, denied)
                end_audit(actx, 200)  # long-running: accepted = complete
                async for item in inner_stream(request, context):
                    yield item

            return grpc.unary_stream_rpc_method_handler(
                us, request_deserializer=handler.request_deserializer,
                response_serializer=handler.response_serializer)

        return handler


_GRPC_AUDIT_CODE = {
    grpc.StatusCode.NOT_FOUND: 404,
    grpc.StatusCode.ALREADY_EXISTS: 409,
    grpc.StatusCode.ABORTED: 409,
    grpc.StatusCode.INVALID_ARGUMENT: 422,
    grpc.StatusCode.OUT_OF_RANGE: 410,
    grpc.StatusCode.PERMISSION_DENIED: 403,
    grpc.StatusCode.UNAUTHENTICATED: 401,
}


def _handlers(svc: StoreService) -> grpc.GenericRpcHandler:
    def uu(fn, req_cls, resp_cls=ktpu_pb2.Unknown):
        return grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req_cls.FromString,
            response_serializer=resp_cls.SerializeToString)

    method_handlers = {
        "Get": uu(svc.Get, ktpu_pb2.GetRequest),
        "List": uu(svc.List, ktpu_pb2.ListRequest, ktpu_pb2.ListResponse),
        "Create": uu(svc.Create, ktpu_pb2.CreateRequest),
        "Update": uu(svc.Update, ktpu_pb2.UpdateRequest),
        "Delete": uu(svc.Delete, ktpu_pb2.DeleteRequest),
        "Subresource": uu(svc.Subresource, ktpu_pb2.SubresourceRequest),
        "Watch": grpc.unary_stream_rpc_method_handler(
            svc.Watch,
            request_deserializer=ktpu_pb2.WatchRequest.FromString,
            response_serializer=ktpu_pb2.WatchEvent.SerializeToString),
    }
    return grpc.method_handlers_generic_handler(_SERVICE, method_handlers)


class GRPCAPIServer:
    """Serve one MVCCStore over gRPC (the §5.8 wire option).

    With any of `bearer_tokens` / `authorizer` / `audit` configured, the
    AuthInterceptor chain (authn → audit → impersonation → authz) runs in
    front of the service — the same policy objects the HTTP and KTPU
    wires share."""

    def __init__(self, store: MVCCStore, host: str = "127.0.0.1",
                 port: int = 0, *,
                 bearer_tokens: Mapping[str, str] | None = None,
                 user_groups: Mapping[str, list] | None = None,
                 authorizer=None, audit=None, admission=None,
                 tracer=None):
        self.store = store
        self.host = host
        self.port = port
        #: WebhookAdmission (webhooks + expression policies) or None.
        self.admission = admission
        #: None = authn disabled (anonymous); {} would reject every token.
        self.bearer_tokens = dict(bearer_tokens) \
            if bearer_tokens is not None else None
        self.user_groups = {u: list(g) for u, g in
                            (user_groups or {}).items()}
        self.authorizer = authorizer
        self.audit = audit
        #: OTel-style per-RPC spans (§5.1), same process tracer as the
        #: other wires by default.
        if tracer is None:
            from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
            tracer = DEFAULT_TRACER
        self.tracer = tracer
        self._server: grpc.aio.Server | None = None

    def groups_for(self, user: str) -> list:
        groups = list(self.user_groups.get(user, ()))
        groups.append("system:unauthenticated"
                      if user == "system:anonymous"
                      else "system:authenticated")
        return groups

    @property
    def target(self) -> str:
        return f"{self.host}:{self.port}"

    async def start(self) -> None:
        self._server = grpc.aio.server(
            interceptors=(AuthInterceptor(self),))
        self._server.add_generic_rpc_handlers(
            (_handlers(StoreService(self.store, self.admission)),))
        self.port = self._server.add_insecure_port(
            f"{self.host}:{self.port}")
        await self._server.start()

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=0.2)
            self._server = None


class _ListResult:
    __slots__ = ("items", "resource_version", "cont")

    def __init__(self, items, rv, cont=None):
        self.items = items
        self.resource_version = rv
        self.cont = cont


class _Event:
    __slots__ = ("type", "object", "rv")

    def __init__(self, type_, obj, rv=0):
        self.type = type_
        self.object = obj
        self.rv = rv


def _map_rpc_error(e: grpc.aio.AioRpcError) -> StoreError:
    cls = _ERR_OF.get(e.code(), StoreError)
    return cls(e.details() or str(e.code()))


class GRPCRemoteStore:
    """MVCCStore-shaped client over the gRPC wire."""

    def __init__(self, target: str, *, token: str | None = None,
                 impersonate: str | None = None):
        self.target = target
        self._channel = grpc.aio.insecure_channel(target)
        md = []
        if token:
            md.append(("authorization", f"Bearer {token}"))
        if impersonate:
            # The interceptor-chain impersonation field (client-go
            # ImpersonationConfig analog on this wire).
            md.append(("impersonate-user", impersonate))
        self._metadata = tuple(md) or None

    def _md(self):
        """Per-call metadata: the static auth/impersonation pairs plus a
        traceparent when the call is issued inside a span (client-go's
        otelgrpc interceptor analog)."""
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        if DEFAULT_TRACER.enabled:
            tp = DEFAULT_TRACER.current_traceparent()
            if tp:
                return (*(self._metadata or ()), ("traceparent", tp))
        return self._metadata

    def _uu(self, method: str, req, resp_cls=ktpu_pb2.Unknown):
        return self._channel.unary_unary(
            f"/{_SERVICE}/{method}",
            request_serializer=type(req).SerializeToString,
            response_deserializer=resp_cls.FromString)(
                req, metadata=self._md())

    async def close(self) -> None:
        await self._channel.close()

    async def get(self, resource: str, key: str) -> dict:
        try:
            return _unwrap(await self._uu(
                "Get", ktpu_pb2.GetRequest(resource=resource, key=key)))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e

    async def list(self, resource: str, namespace: str | None = None,
                   selector: Selector | None = None, limit: int = 0,
                   continue_key: str | None = None, *,
                   resource_version: int | None = None,
                   resource_version_match: str | None = None,
                   **_kw) -> _ListResult:
        sel = selector_to_string(selector) if selector else ""
        if resource_version and resource_version_match == "Exact" \
                and not continue_key:
            # Exact-RV LIST without a proto field: the pinned continue
            # token ("<rv>:") asks the server's watch-cache tier for the
            # snapshot at that RV from the first page on.
            continue_key = f"{resource_version}:"
        try:
            resp = await self._uu(
                "List",
                ktpu_pb2.ListRequest(
                    resource=resource, namespace=namespace or "",
                    label_selector=sel or "", limit=limit,
                    continue_key=continue_key or ""),
                ktpu_pb2.ListResponse)
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e
        items = [_unwrap(u) for u in resp.items]
        cont = None
        if limit and len(items) >= limit and items:
            # ListResponse carries no token field; rebuild the pinned one
            # from the snapshot RV + last key (the server resumes
            # strictly after it, at the same snapshot).
            meta = items[-1].get("metadata") or {}
            last = f"{meta['namespace']}/{meta['name']}" \
                if meta.get("namespace") else meta.get("name", "")
            cont = f"{int(resp.resource_version)}:{last}"
        return _ListResult(items, int(resp.resource_version), cont)

    async def create(self, resource: str, obj: dict, **_kw) -> dict:
        try:
            return _unwrap(await self._uu("Create", ktpu_pb2.CreateRequest(
                resource=resource, object=_wrap(dict(obj)))))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e

    async def update(self, resource: str, obj: dict, **_kw) -> dict:
        try:
            return _unwrap(await self._uu("Update", ktpu_pb2.UpdateRequest(
                resource=resource, object=_wrap(dict(obj)))))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e

    async def delete(self, resource: str, key: str,
                     uid: str | None = None) -> dict:
        try:
            return _unwrap(await self._uu("Delete", ktpu_pb2.DeleteRequest(
                resource=resource, key=key, uid=uid or "")))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e

    async def subresource(self, resource: str, key: str, sub: str,
                          body: dict) -> dict:
        try:
            return _unwrap(await self._uu(
                "Subresource", ktpu_pb2.SubresourceRequest(
                    resource=resource, key=key, subresource=sub,
                    body=_wrap(dict(body)))))
        except grpc.aio.AioRpcError as e:
            raise _map_rpc_error(e) from e

    async def guaranteed_update(self, resource: str, key: str, mutate,
                                max_retries: int = 16,
                                return_copy: bool = True) -> dict | None:
        """Client-side CAS loop, like the HTTP RemoteStore."""
        for _ in range(max_retries):
            current = await self.get(resource, key)
            updated = mutate(current)
            if updated is None:
                if not return_copy:
                    return None
                return await self.get(resource, key)
            try:
                out = await self.update(resource, updated)
                return out if return_copy else None
            except Conflict:
                continue
        raise Conflict(f"{resource} {key!r}: too many conflicts")

    async def watch(self, resource: str, resource_version: int | None = None,
                    selector: Selector | None = None):
        """Async iterator of events; Expired raised on 410-equivalents so
        the informer relists, matching the store contract."""
        sel = selector_to_string(selector) if selector else ""
        call = self._channel.unary_stream(
            f"/{_SERVICE}/Watch",
            request_serializer=ktpu_pb2.WatchRequest.SerializeToString,
            response_deserializer=ktpu_pb2.WatchEvent.FromString,
        )(ktpu_pb2.WatchRequest(
            resource=resource,
            resource_version=str(resource_version)
            if resource_version is not None else "",
            label_selector=sel or ""), metadata=self._md())

        async def gen():
            try:
                async for ev in call:
                    obj = _unwrap(ev.object)
                    # rv rides its own field; old servers omit it, so
                    # fall back to the object's stamped metadata.
                    rv = int(ev.rv) if ev.rv else int(
                        (obj.get("metadata") or {})
                        .get("resourceVersion") or 0)
                    yield _Event(ev.type, obj, rv)
            except grpc.aio.AioRpcError as e:
                raise _map_rpc_error(e) from e
            except asyncio.CancelledError:
                call.cancel()
                raise
        return gen()
