"""KTPU wire: multiplexed framed transport for core components.

Parity target: the reference's core components speak protobuf over
HTTP/2 to the apiserver — ONE long-lived connection per component,
many concurrent requests multiplexed as streams (client-go transport
uses http2.Transport; watches are server-push streams on the same
connection). Python has no usable HTTP/2 server in-tree, and per-request
HTTP/1.1 costs ~230µs/req on one core — so this module implements the
multiplexing idea directly: length-prefixed frames over one TCP
connection, request ids instead of streams, watch events pushed as
frames on the same socket. Same wire role, ~13× the throughput of the
aiohttp path on this host (59k vs 4.4k msg/s microbench).

Server semantics mirror the HTTP handler chain in `server.py`
(DefaultBuildHandlerChain order): recovery → authn (handshake) →
priority-and-fairness seats → audit → RBAC authz → admission webhooks →
store. A WireServer shares the APIServer's PriorityLevels, tokens,
authorizer and admission objects, so policy is identical on both wires.

Frame format: 4-byte big-endian length + body. The body is msgpack (the
protobuf-role binary codec: ~3x faster to encode/decode than JSON on
this host and ~25% smaller on the socket) or JSON — codecs are
self-distinguishing (msgpack arrays start 0x9x/0xdc/0xdd, JSON arrays
with '['), so each side decodes per frame and replies in the codec the
peer last spoke. Core components use msgpack; JSON remains for
debugging and hand-rolled clients.
  client→server: [id, op, ...args]
    ["", "hello", {"token": t, "ua": ...}]     (id "" = pre-auth)
    [id, "create", resource, obj]
    [id, "get", resource, key]
    [id, "update", resource, obj]
    [id, "delete", resource, key, uid|null]
    [id, "sub", resource, key, subresource, body]
    [id, "list", resource, {namespace, selector, limit, continue}]
    [id, "watch", resource, {rv, namespace, selector}]   (id = watch id)
    [id, "stopwatch"]
    [id, "kinds"]                               (discovery: kind map)
    [id, "multi", [[op, ...args], ...]]         (same-tick op batch)
  server→client: [id, "ok", result] | [id, "err", reason, message]
    [watch_id, "ev", TYPE, object]              (watch push)
    [watch_id, "exp", message]                  (watch 410/terminated)

Reference pointers (SURVEY §5.8 comms backend, §3.2 watch fan-out):
staging/src/k8s.io/apimachinery/pkg/watch, client-go transport/cache.

Copy of `kubernetes_tpu/apiserver/wire.py`; a `unix:` listener with no
path binds a per-instance socket under the temporary directory, and a
`WireStore` refuses a codec name other than "msgpack" or "json".
"""

from __future__ import annotations

import asyncio
import contextlib
import json
import logging
import os
import struct
import tempfile
import time
from typing import AsyncIterator, Callable, Mapping

import msgpack

from kubernetes_tpu_torch.utils.locking import check_dispatch_seam

from kubernetes_tpu_torch.api.labels import (
    Selector,
    parse_selector,
    selector_to_string,
)
from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Event,
    Expired,
    Invalid,
    ListResult,
    MVCCStore,
    NotFound,
    StoreError,
)
from kubernetes_tpu_torch.utils.tracing import stamp_traceparent

logger = logging.getLogger(__name__)

_NULL_CM = contextlib.nullcontext()

_LEN = struct.Struct(">I")
_MAX_FRAME = 64 << 20

_REASON_OF = {
    NotFound: "NotFound",
    AlreadyExists: "AlreadyExists",
    Conflict: "Conflict",
    Invalid: "Invalid",
    Expired: "Expired",
}
_EXC_OF = {v: k for k, v in _REASON_OF.items()}

_VERB_OF = {"create": "create", "get": "get", "update": "update",
            "delete": "delete", "sub": "update", "list": "list",
            "watch": "watch", "kinds": "get", "apply": "patch"}

#: StoreError reason → HTTP-equivalent code for audit responseStatus.
_CODE_OF_REASON = {"NotFound": 404, "AlreadyExists": 409,
                   "Conflict": 409, "Invalid": 422, "Expired": 410,
                   "Forbidden": 403, "TooManyRequests": 429,
                   "BadRequest": 400, "Unauthorized": 401}

_dumps = json.dumps
_packb = msgpack.packb
_unpackb = msgpack.unpackb


def _decode_frame(payload: bytes):
    """Decode one frame body, either codec. Returns (frame, is_msgpack)."""
    lead = payload[0]
    if lead == 0x5B or lead in (0x20, 0x09, 0x0A, 0x0D):  # '[' / ws → JSON
        return json.loads(payload), False
    return _unpackb(payload), True


def _encode_reply(frame: list, mp: bool) -> bytes:
    """Encode a server reply in the codec the peer speaks (the server-side
    dual of WireStore._encode)."""
    return _packb(frame) if mp else \
        _dumps(frame, separators=(",", ":")).encode()


def _reason_for(exc: StoreError) -> str:
    for cls, reason in _REASON_OF.items():
        if isinstance(exc, cls):
            return reason
    return "InternalError"


def _encode_memo(ev: Event, attr: str, encode) -> bytes:
    """Per-codec encode-once across an event AND its synthesized
    enter/leave twins: the store delivers the same Event instance to all
    channels of a selector group, and a twin links its source via
    `_wire_src` (store/mvcc.py `_synth`) — they share one object, so
    they share one encoding. The memo is read from/written to both ends
    of the link, so whichever watcher encodes first pays for everyone
    (SURVEY §3.2 — the reference cacher serializes once per event, not
    per watcher)."""
    b = getattr(ev, attr, None)
    if b is not None:
        return b
    src = getattr(ev, "_wire_src", None)
    if src is not None:
        b = getattr(src, attr, None)
    if b is None:
        b = encode(ev.object)
        if src is not None:
            try:
                setattr(src, attr, b)
            except AttributeError:
                pass
    try:
        setattr(ev, attr, b)
    except AttributeError:  # frozen/slots object: still correct, no memo
        pass
    return b


def encode_event_object(ev: Event) -> bytes:
    """JSON-encode a watch event's object once per event (+ twins),
    shared across every watcher on both wires."""
    return _encode_memo(
        ev, "_wire_obj",
        lambda obj: _dumps(obj, separators=(",", ":")).encode())


def encode_event_object_mp(ev: Event) -> bytes:
    """msgpack twin of encode_event_object — one packing per event
    shared across every msgpack watcher."""
    return _encode_memo(ev, "_wire_obj_mp", _packb)


class _Conn(asyncio.Protocol):
    """One client connection on the server side."""

    def __init__(self, server: "WireServer"):
        self.server = server
        self.transport: asyncio.Transport | None = None
        self.buf = bytearray()
        self.user = "system:anonymous"
        #: the AUTHENTICATED principal — differs from `user` when the
        #: hello frame's impersonate field swapped identities; audit
        #: events record this as `user` and `user` as impersonatedUser.
        self.auth_user = "system:anonymous"
        self.flow = "wire"
        #: codec the peer speaks (learned per received frame; replies and
        #: watch pushes mirror it).
        self._mp = False
        #: one hello per connection (see _hello).
        self._hello_done = False
        #: watch id -> pump task
        self.watches: dict[str, asyncio.Task] = {}
        self._out: list[bytes] = []
        self._flush_scheduled = False
        self._closed = False
        #: transport backpressure (pause_writing/resume_writing): watch
        #: pumps await this so a slow consumer parks its pumps instead of
        #: growing the transport buffer without bound.
        self._drained = asyncio.Event()
        self._drained.set()

    def pause_writing(self) -> None:
        self._drained.clear()

    def resume_writing(self) -> None:
        self._drained.set()

    # -- transport ---------------------------------------------------------

    def connection_made(self, transport: asyncio.Transport) -> None:
        self.transport = transport
        transport.set_write_buffer_limits(high=8 << 20)
        self.server._conns.add(self)

    def connection_lost(self, exc) -> None:
        self._closed = True
        for t in self.watches.values():
            t.cancel()
        self.watches.clear()
        self.server._conns.discard(self)

    def data_received(self, data: bytes) -> None:
        # Offset-scan then ONE tail compaction: a coalesced read can hold
        # hundreds of frames, and `del buf[:4+n]` per frame is an O(bytes)
        # memmove each time — quadratic over the burst.
        buf = self.buf
        buf.extend(data)
        end = len(buf)
        ofs = 0
        while end - ofs >= 4:
            n = _LEN.unpack_from(buf, ofs)[0]
            if n > _MAX_FRAME:
                logger.error("wire: oversized frame (%d bytes); closing", n)
                self.transport.close()
                return
            if end - ofs - 4 < n:
                break
            payload = bytes(buf[ofs + 4:ofs + 4 + n])
            ofs += 4 + n
            try:
                frame, self._mp = _decode_frame(payload)
            except Exception:
                logger.error("wire: undecodable frame; closing")
                self.transport.close()
                return
            asyncio.ensure_future(self._handle(frame))
        if ofs:
            del buf[:ofs]

    # -- batched writes ----------------------------------------------------

    def send(self, body: bytes) -> None:
        if self._closed:
            return
        self._out.append(_LEN.pack(len(body)))
        self._out.append(body)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        if self._out and not self._closed:
            # Sanctioned wire-send seam: the lock-hygiene detector
            # (KTPU_LOCK_CHECK=1) raises here if the flushing thread
            # still holds an instrumented lock.
            check_dispatch_seam("wire.flush")
            self.transport.write(b"".join(self._out))
            self._out.clear()

    def _ok(self, rid: str, result) -> None:
        self.send(_encode_reply([rid, "ok", result], self._mp))

    def _err(self, rid: str, reason: str, message: str) -> None:
        self.send(_encode_reply([rid, "err", reason, message], self._mp))

    @staticmethod
    def _unwrap_traced(frame: list) -> tuple[str | None, list]:
        """Frame-field traceparent (the wire analog of the HTTP
        `traceparent` header): [id, "traced", tp, op, ...args] unwraps to
        (tp, [id, op, ...args]); untraced frames pass through. A
        non-string tp is dropped, not propagated — it would otherwise
        crash span creation OUTSIDE the error-reply path and hang the
        client's future."""
        if len(frame) > 3 and frame[1] == "traced":
            tp = frame[2] if isinstance(frame[2], str) else None
            return tp, [frame[0], *frame[3:]]
        return None, frame

    def _span_cm(self, op: str, resource: str, tp: str | None):
        """Server-side span for one frame op (a no-op context when the
        tracer is off)."""
        tracer = self.server.tracer
        if tracer is None or not tracer.enabled or op in (
                "hello", "stopwatch"):
            return _NULL_CM
        name = "wire.multi" if op == "multi" else \
            f"wire.{_VERB_OF.get(op, op)}.{resource or 'misc'}"
        return tracer.span(name, traceparent=tp, client=self.flow,
                           user=self.user)

    def _finish(self, actx, code: int, verb: str, resource: str,
                t0: float, result=None) -> None:
        """ResponseComplete + the request-duration observation — one call
        per frame-op outcome, mirroring where the HTTP chain's audit
        middleware and metrics middleware both fire. Watches are excluded
        from the duration family on both wires: here the frame finishes
        at registration, on HTTP at stream end — two incompatible
        semantics that would share one metric."""
        self._audit_end(actx, code, result)
        m = self.server.request_metrics
        if m is not None and resource and verb != "watch":
            m.observe(verb, resource, code, time.perf_counter() - t0)

    # -- handler chain (server.py middleware order) ------------------------

    # -- audit stage events ------------------------------------------------

    def _audit_begin(self, op: str, verb: str, resource: str,
                     frame: list):
        """RequestReceived for one frame op — BEFORE APF/authz, the
        reference chain position (audit outside everything but authn)."""
        pipeline = self.server.audit
        if pipeline is None or not resource:
            return None
        name = namespace = None
        request_object = None
        arg = frame[3] if len(frame) > 3 else None
        if op in ("create", "update", "apply") and isinstance(arg, dict):
            meta = arg.get("metadata") or {}
            name = meta.get("name")
            namespace = meta.get("namespace")
            request_object = arg
        elif isinstance(arg, str):  # get/delete/sub carry a key
            namespace, _, name = arg.rpartition("/")
            namespace = namespace or None
        return pipeline.begin(
            user=self.auth_user,
            groups=self.server.groups_for(self.auth_user),
            verb=verb, resource=resource, namespace=namespace,
            name=name, request_object=request_object)

    def _audit_end(self, actx, code: int, result=None) -> None:
        if actx is None:
            return
        self.server.audit.response_complete(
            actx, code=code,
            response_object=result if isinstance(result, dict) else None,
            impersonated_user=self.user
            if self.user != self.auth_user else None)

    async def _handle(self, frame: list) -> None:
        try:
            tp, frame = self._unwrap_traced(frame)
            op = frame[1]
            resource = frame[2] if len(frame) > 2 and \
                isinstance(frame[2], str) else ""
        except Exception:
            tp, op, resource = None, "", ""
        with self._span_cm(op, resource, tp):
            await self._handle_frame(frame)

    async def _handle_frame(self, frame: list) -> None:
        rid = ""
        actx = None
        verb = resource = ""
        t0 = time.perf_counter()
        try:
            rid, op = frame[0], frame[1]
            if op == "hello":
                return self._hello(rid, frame[2] or {})
            if op == "stopwatch":
                t = self.watches.pop(rid, None)
                if t is not None:
                    t.cancel()
                return
            if op == "multi":
                return await self._multi(rid, frame[2])
            srv = self.server
            verb = _VERB_OF.get(op, op)
            resource = frame[2] if len(frame) > 2 and \
                isinstance(frame[2], str) else ""
            # audit: RequestReceived before APF/authz (reference chain
            # position; authn + impersonation were hello-time).
            actx = self._audit_begin(op, verb, resource, frame)
            if op == "watch":
                # No APF seat (cacher semantics) but authz still applies.
                if srv.authorizer is not None and resource and \
                        not srv.authorizer.allowed(
                            self.user, verb, resource,
                            groups=srv.groups_for(self.user)):
                    self._finish(actx, 403, verb, resource, t0)
                    return self._err(
                        rid, "Forbidden",
                        f'user "{self.user}" cannot {verb} resource '
                        f'"{resource}"')
                await self._start_watch(rid, frame[2], frame[3] or {})
                self._finish(actx, 200, verb, resource, t0)
                return
            # APF: watches hold no seat (cacher semantics); everything
            # else acquires one from the shared priority levels.
            level = srv.classify(resource)
            if level is not None:
                try:
                    await level.acquire(self.flow)
                except Exception:
                    self._finish(actx, 429, verb, resource, t0)
                    return self._err(rid, "TooManyRequests",
                                     f"priority level {level.name!r} "
                                     "queue full")
            try:
                # authz (RBAC) innermost, as the (possibly impersonated)
                # request identity — same rule set as the HTTP server.
                if srv.authorizer is not None and resource and \
                        not srv.authorizer.allowed(
                            self.user, verb, resource,
                            groups=srv.groups_for(self.user)):
                    self._finish(actx, 403, verb, resource, t0)
                    return self._err(
                        rid, "Forbidden",
                        f'user "{self.user}" cannot {verb} resource '
                        f'"{resource}"')
                m = srv.request_metrics
                if m is not None:
                    m.inc_inflight(verb)
                try:
                    result = await self._dispatch(op, frame)
                finally:
                    if m is not None:
                        m.dec_inflight(verb)
            finally:
                if level is not None:
                    level.release()
            self._finish(actx, 200 if op != "create" else 201,
                         verb, resource, t0, result)
            self._ok(rid, result)
        except StoreError as e:
            reason = _reason_for(e)
            self._finish(actx, _CODE_OF_REASON.get(reason, 500),
                         verb, resource, t0)
            self._err(rid, reason, str(e))
        except asyncio.CancelledError:
            raise
        except (ValueError, KeyError, IndexError, TypeError) as e:
            self._finish(actx, 400, verb, resource, t0)
            self._err(rid, "BadRequest", f"malformed frame: {e!r}")
        except Exception:
            logger.exception("wire: panic handling frame")
            self._finish(actx, 500, verb, resource, t0)
            self._err(rid, "InternalError", "internal error")

    async def _multi(self, rid: str, ops: list) -> None:
        """Same-tick op batch from one client (the HTTP/2 concurrent-
        streams analog): runs sequentially under ONE APF seat — the batch
        is one scheduling unit of server work, like one connection's
        stream window. Per-op authz still applies; results are positional
        ["ok", result] | ["err", reason, message] pairs."""
        srv = self.server
        results: list = [None] * len(ops)
        # Per-member traceparents (the traced wrapper applies to multi
        # members too — each member is one request, so each gets its own
        # server span parented to its caller's span).
        member_tps: list[str | None] = [None] * len(ops)
        unwrapped: list = []
        for i, sub in enumerate(ops):
            if len(sub) > 2 and sub[0] == "traced":
                if isinstance(sub[1], str):  # see _unwrap_traced
                    member_tps[i] = sub[1]
                sub = list(sub[2:])
            unwrapped.append(sub)
        ops = unwrapped
        # Seats are held PER PRIORITY LEVEL, matching the single-op path:
        # a lease renewal coalesced into the same tick as a pod burst must
        # still ride the "system" level, or a full workload queue would
        # starve leader election — the exact failure APF exists to stop.
        by_level: dict[str | None, list[int]] = {}
        for idx, sub in enumerate(ops):
            resource = sub[1] if len(sub) > 1 and \
                isinstance(sub[1], str) else ""
            level = srv.classify(resource) if srv.priority_levels else None
            by_level.setdefault(
                level.name if level is not None else None,
                []).append(idx)
        for level_name, idxs in by_level.items():
            level = srv.priority_levels.get(level_name) \
                if level_name is not None else None
            if level is not None:
                try:
                    await level.acquire(self.flow)
                except Exception:
                    for idx in idxs:
                        results[idx] = ["err", "TooManyRequests",
                                        f"priority level {level.name!r} "
                                        "queue full"]
                    continue
            try:
                for idx in idxs:
                    sub = ops[idx]
                    op = sub[0]
                    actx = None
                    verb = resource = ""
                    t0 = time.perf_counter()
                    try:
                        resource = sub[1] if len(sub) > 1 and \
                            isinstance(sub[1], str) else ""
                        verb = _VERB_OF.get(op, op)
                        with self._span_cm(op, resource, member_tps[idx]):
                            # Per-op audit, same stages as the single-op
                            # path (one coalesced frame is N requests).
                            actx = self._audit_begin(op, verb, resource,
                                                     ["", *sub])
                            if srv.authorizer is not None and resource \
                                    and not srv.authorizer.allowed(
                                        self.user, verb, resource,
                                        groups=srv.groups_for(self.user)):
                                self._finish(actx, 403, verb, resource, t0)
                                results[idx] = [
                                    "err", "Forbidden",
                                    f'user "{self.user}" cannot {verb} '
                                    f'resource "{resource}"']
                                continue
                            m = srv.request_metrics
                            if m is not None:
                                m.inc_inflight(verb)
                            try:
                                result = await self._dispatch(
                                    op, ["", *sub])
                            finally:
                                if m is not None:
                                    m.dec_inflight(verb)
                            self._finish(
                                actx, 200 if op != "create" else 201,
                                verb, resource, t0, result)
                            results[idx] = ["ok", result]
                    except StoreError as e:
                        reason = _reason_for(e)
                        self._finish(actx, _CODE_OF_REASON.get(reason, 500),
                                     verb, resource, t0)
                        results[idx] = ["err", reason, str(e)]
                    except (ValueError, KeyError, IndexError,
                            TypeError) as e:
                        self._finish(actx, 400, verb, resource, t0)
                        results[idx] = ["err", "BadRequest",
                                        f"malformed op: {e!r}"]
            finally:
                if level is not None:
                    level.release()
        self._ok(rid, results)

    def _hello(self, rid: str, args: Mapping) -> None:
        srv = self.server
        if self._hello_done:
            # One handshake per connection: a second hello could reset
            # auth_user to the impersonated identity (erasing the real
            # principal from the audit trail) or re-authenticate the
            # session mid-stream. Refuse and drop the connection.
            self._err(rid, "BadRequest", "session already authenticated")
            self._flush()
            if self.transport is not None:
                self.transport.close()
            return
        self._hello_done = True
        token = args.get("token")
        self.flow = args.get("ua") or "wire"
        if token:
            user = srv.bearer_tokens.get(token)
            if user is None and srv.token_authenticator is not None:
                user = srv.token_authenticator(token)
            if user is None and (srv.bearer_tokens
                                 or srv.token_authenticator is not None):
                self._err(rid, "Unauthorized", "invalid token")
                # The HTTP chain 401s EVERY request carrying a bad token;
                # the connection-oriented analog is to refuse the session
                # outright — leaving it open would let the client keep
                # operating as system:anonymous.
                self._flush()
                if self.transport is not None:
                    self.transport.close()
                return
            self.user = user or "system:anonymous"
        self.auth_user = self.user
        target = args.get("impersonate")
        if target:
            # WithImpersonation, frame-field form: the session adopts the
            # target identity for every subsequent frame (client-go's
            # transport-level ImpersonationConfig), gated by the RBAC
            # `impersonate` verb for the AUTHENTICATED user. A denial
            # refuses the session, like a bad token — silently continuing
            # as the original user would mask a policy violation.
            if srv.authorizer is not None and not srv.authorizer.allowed(
                    self.auth_user, "impersonate", "users",
                    groups=srv.groups_for(self.auth_user)):
                self._err(rid, "Forbidden",
                          f'user "{self.auth_user}" cannot impersonate '
                          f'user "{target}"')
                self._flush()
                if self.transport is not None:
                    self.transport.close()
                return
            self.user = target
        self._ok(rid, {"user": self.user})

    async def _dispatch(self, op: str, frame: list):
        store = self.server.store
        admission = self.server.admission
        user = self.user
        groups = self.server.groups_for(user) \
            if admission is not None else None
        if op == "create":
            resource, obj = frame[2], frame[3]
            if resource == "pods":
                # Carry this frame's trace across the informer/queue
                # boundary (see utils/tracing.stamp_traceparent); no-op
                # outside a span.
                stamp_traceparent(obj)
            if admission is not None:
                obj = await admission.admit(obj, resource, "create",
                                            user=user, groups=groups)
            # The decoded object is exclusively ours (just parsed off the
            # socket): hand ownership to the store and skip its entry
            # deep-copy; the response encodes the stored object directly.
            created = await store.create(resource, obj, _owned=True)
            return created
        if op == "get":
            return await store.get(frame[2], frame[3])
        if op == "update":
            resource, obj = frame[2], frame[3]
            if admission is not None:
                obj = await admission.admit(obj, resource, "update",
                                            user=user, groups=groups)
            return await store.update(resource, obj)
        if op == "delete":
            resource, key = frame[2], frame[3]
            uid = frame[4] if len(frame) > 4 else None
            if admission is not None:
                current = await store.get(resource, key)
                await admission.admit(current, resource, "delete",
                                      user=user, groups=groups)
            return await store.delete(resource, key, uid=uid)
        if op == "sub":
            return await store.subresource(
                frame[2], frame[3], frame[4], frame[5])
        if op == "apply":
            resource, obj = frame[2], frame[3]
            if admission is not None:
                obj = await admission.admit(obj, resource, "update",
                                            user=user, groups=groups)
            return await store.apply(
                resource, obj, field_manager=frame[4],
                force=bool(frame[5] if len(frame) > 5 else False))
        if op == "list":
            resource, args = frame[2], frame[3] or {}
            sel = parse_selector(args["selector"]) \
                if args.get("selector") else None
            # RV semantics + snapshot-pinned continue tokens ride the
            # watch-cache tier (store/cacher.py) — same contract as the
            # HTTP wire's resourceVersion/resourceVersionMatch params,
            # so paginated pages agree on one snapshot RV across wires.
            kw = {}
            if args.get("shard") is not None \
                    and hasattr(store, "node_shards"):
                # Shard-scoped LIST (per-shard informer relists) —
                # ignored when the backing store is unsharded.
                kw["shard"] = int(args["shard"])
            lst = await store.list(
                resource, namespace=args.get("namespace"),
                selector=sel, limit=int(args.get("limit") or 0),
                continue_key=args.get("continue"),
                fields=args.get("fields") or None,
                resource_version=int(args.get("rv") or 0) or None,
                resource_version_match=args.get("rvMatch"),
                copy=False, **kw)  # encode-only: packed before return
            out = {"items": lst.items, "rv": lst.resource_version}
            if lst.cont:
                out["cont"] = lst.cont
            return out
        if op == "kinds":
            return {"kinds": store.kind_map(),
                    "clusterScoped": sorted(
                        r for r in set(store.kind_map().values())
                        if store.is_cluster_scoped(r))}
        if op == "topology":
            # Control-plane shape discovery: a sharded backing store
            # advertises its shard count + partitioned resources so
            # clients can open per-shard watches (ShardedInformer).
            return {"nodeShards": int(getattr(store, "node_shards", 1)),
                    "partitioned": list(
                        getattr(store, "partitioned_resources", ()))}
        if op == "stats":
            # Server-side observability snapshot: a shard process
            # reports its WAL/durability counters (and anything else the
            # host wired into stats_fn) so the parent can sum per-shard
            # deltas into the bench detail JSON without scraping
            # /metrics text.
            fn = getattr(self.server, "stats_fn", None)
            return dict(fn()) if fn is not None else {}
        raise ValueError(f"unknown op {op!r}")

    # -- watch push --------------------------------------------------------

    async def _start_watch(self, wid: str, resource: str,
                           args: Mapping) -> None:
        if wid in self.watches:
            return self._err(wid, "BadRequest", "watch id in use")
        sel = parse_selector(args["selector"]) \
            if args.get("selector") else None
        # Register the store channel HERE, inside the frame's own handler
        # task: frame handlers run in arrival order, so a write processed
        # after this watch frame is guaranteed to reach it. Spawning the
        # registration into the pump task would let an rv=0 ("from now")
        # watch miss writes that arrived just behind it.
        kw = {}
        if args.get("shard") is not None \
                and hasattr(self.server.store, "node_shards"):
            kw["shard"] = int(args["shard"])
        try:
            watch = await self.server.store.watch(
                resource, resource_version=int(args.get("rv") or 0),
                namespace=args.get("namespace"), selector=sel,
                fields=args.get("fields") or None, **kw)
        except Expired as e:
            self.send(_encode_reply([wid, "exp", str(e)], self._mp))
            return
        task = asyncio.ensure_future(self._watch_pump(wid, watch))
        self.watches[wid] = task
        task.add_done_callback(lambda _t: self.watches.pop(wid, None))

    async def _watch_pump(self, wid: str, watch) -> None:
        # Codec is fixed per connection by the time a watch starts (the
        # client spoke at least the hello + watch frames already).
        mp = self._mp
        wid_b = _packb(wid) if mp else _dumps(wid).encode()
        try:
            async for ev in watch:
                if ev.type == "BOOKMARK":
                    bm = {"metadata": {"resourceVersion": str(ev.rv)}}
                    body = (b"\x94" + wid_b + b"\xa2ev\xa8BOOKMARK"
                            + _packb(bm)) if mp else (
                        b'[' + wid_b + b',"ev","BOOKMARK",'
                        b'{"metadata":{"resourceVersion":"'
                        + str(ev.rv).encode() + b'"}}]')
                elif mp:
                    # Spliced msgpack frame [wid,"ev",TYPE,obj]: fixarray(4)
                    # header + concatenated elements — msgpack concatenates
                    # like JSON splices, and the object bytes are packed
                    # once per event across ALL watchers (the _mp memo).
                    body = (b"\x94" + wid_b + b"\xa2ev"
                            + _packb(ev.type) + encode_event_object_mp(ev))
                else:
                    # Spliced frame: the object bytes are encoded once per
                    # event across ALL watchers (encode_event_object memo).
                    body = (b'[' + wid_b + b',"ev","' + ev.type.encode()
                            + b'",' + encode_event_object(ev) + b']')
                self.send(body)
                if self._closed:
                    return
                if not self._drained.is_set():
                    # Slow consumer: park this pump until the transport
                    # drains (the HTTP path got this via `await write`).
                    # The store watch channel buffers meanwhile, bounded
                    # by its event window.
                    await self._drained.wait()
        except asyncio.CancelledError:
            raise
        except Exception as e:
            logger.exception("wire: watch pump %s died", wid)
            self.send(_encode_reply([wid, "exp", f"watch error: {e}"], mp))
        finally:
            aclose = getattr(watch, "aclose", None)
            if aclose is not None:
                try:
                    await aclose()
                except Exception:
                    pass


class WireServer:
    """Serve an MVCCStore over the KTPU wire. Policy objects (priority
    levels, tokens, RBAC authorizer, admission, audit pipeline) are
    shared with an APIServer when one exists, so both wires enforce
    identical rules."""

    #: per-frame stage order, mirroring server.py's middleware list /
    #: the reference's DefaultBuildHandlerChain (§3.2). authn and
    #: impersonation are connection-scoped (the hello frame); the rest
    #: run per frame in this order — the chain-order tests pin it.
    HANDLER_CHAIN = ("authn", "audit", "impersonation", "apf", "authz",
                     "admission")

    def __init__(self, store: MVCCStore, *, host: str = "127.0.0.1",
                 port: int = 0, priority_levels: Mapping | None = None,
                 bearer_tokens: Mapping[str, str] | None = None,
                 token_authenticator=None,
                 user_groups: Mapping[str, list[str]] | None = None,
                 authorizer=None, admission=None, audit=None,
                 tracer=None, request_metrics=None):
        self.store = store
        self.host = host
        self.port = port
        self.priority_levels = dict(priority_levels or {})
        self.bearer_tokens = dict(bearer_tokens or {})
        self.token_authenticator = token_authenticator
        self.user_groups = {u: list(g) for u, g in
                            (user_groups or {}).items()}
        self.authorizer = authorizer
        self.admission = admission
        #: policy/audit.AuditPipeline or None (shared with the HTTP
        #: server via for_apiserver — ONE sink for both wires).
        self.audit = audit
        #: OTel-style per-frame spans (§5.1) — the frame-field analog of
        #: the HTTP wire's traceparent middleware.
        if tracer is None:
            from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
            tracer = DEFAULT_TRACER
        self.tracer = tracer
        #: APIServerMetrics shared with the HTTP server (for_apiserver):
        #: both wires report into one request-duration family.
        self.request_metrics = request_metrics
        #: optional () -> dict for the `stats` op: a shard process wires
        #: its WAL/durability counters here so the parent can pull
        #: per-shard observability over the same socket.
        self.stats_fn = None
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[_Conn] = set()
        self._path = ""

    @classmethod
    def for_apiserver(cls, api, *, host: str = "127.0.0.1",
                      port: int = 0) -> "WireServer":
        """Share the APIServer's policy objects (seats are one pool across
        both wires — a wire client and an HTTP client contend fairly)."""
        return cls(api.store, host=host, port=port,
                   priority_levels=api.priority_levels,
                   bearer_tokens=api.bearer_tokens,
                   token_authenticator=api.token_authenticator,
                   user_groups=api.user_groups,
                   authorizer=api.authorizer, admission=api.admission,
                   audit=api.audit, tracer=api.tracer,
                   request_metrics=api.request_metrics)

    def classify(self, resource: str):
        if not self.priority_levels:
            return None
        if resource in ("leases", "events"):
            return self.priority_levels.get("system") \
                or self.priority_levels.get("workload")
        return self.priority_levels.get("workload")

    def groups_for(self, user: str) -> list[str]:
        groups = list(self.user_groups.get(user, ()))
        groups.append("system:unauthenticated"
                      if user == "system:anonymous"
                      else "system:authenticated")
        return groups

    async def start(self) -> None:
        loop = asyncio.get_event_loop()
        if self.host.startswith("unix:"):
            # Unix-domain listener: same frames, ~30% less per-byte
            # syscall cost than TCP loopback — the co-located-component
            # fast path (the reference's apiserver on the same host).
            self._path = self.host[len("unix:"):] or os.path.join(
                tempfile.gettempdir(),
                f"ktpu-wire-{os.getpid()}-{id(self):x}.sock")
            self._server = await loop.create_unix_server(
                lambda: _Conn(self), self._path)
            logger.info("wire server listening on unix:%s", self._path)
            return
        self._server = await loop.create_server(
            lambda: _Conn(self), self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        logger.info("wire server listening on %s:%d", self.host, self.port)

    @property
    def target(self) -> str:
        if self.host.startswith("unix:"):
            return f"unix:{self._path}"
        return f"{self.host}:{self.port}"

    async def stop(self) -> None:
        for conn in list(self._conns):
            if conn.transport is not None:
                conn.transport.close()
        self._conns.clear()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if self._path:
            try:
                os.unlink(self._path)
            except OSError:
                pass
            self._path = ""


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class _ClientProto(asyncio.Protocol):
    def __init__(self, owner: "WireStore"):
        self.owner = owner
        self.buf = bytearray()
        self.transport: asyncio.Transport | None = None

    def connection_made(self, transport: asyncio.Transport) -> None:
        self.transport = transport
        transport.set_write_buffer_limits(high=8 << 20)

    def connection_lost(self, exc) -> None:
        self.owner._conn_lost(exc)

    def data_received(self, data: bytes) -> None:
        # Offset-scan + single compaction (see _Conn.data_received): the
        # server's watch-push bursts coalesce into large reads. The
        # compaction runs in `finally` so a decode/handler error cannot
        # leave already-delivered frames at the buffer head (they would
        # replay on the next read); an undecodable frame is fatal to the
        # connection, mirroring the server side.
        buf = self.buf
        buf.extend(data)
        end = len(buf)
        ofs = 0
        try:
            while end - ofs >= 4:
                n = _LEN.unpack_from(buf, ofs)[0]
                if end - ofs - 4 < n:
                    break
                payload = bytes(buf[ofs + 4:ofs + 4 + n])
                ofs += 4 + n
                try:
                    frame = _decode_frame(payload)[0]
                except Exception:
                    logger.error("wire client: undecodable frame; closing")
                    if self.transport is not None:
                        self.transport.close()
                    return
                self.owner._on_frame(frame)
        finally:
            if ofs:
                del buf[:ofs]


class _WireWatch:
    """Client side of one pushed watch stream.

    The queue is BOUNDED (advisor r4): the client reads the socket
    eagerly, so the server's pause_writing backpressure cannot protect a
    consumer that stops iterating — without a bound, events would pile
    up in this queue without limit. On overflow the watch terminates
    with the Expired signal, the same contract as the store channel's
    bounded window: the consumer relists and re-watches."""

    MAX_BUFFERED = 8192

    def __init__(self, wid: str):
        self.wid = wid
        self.queue: asyncio.Queue = asyncio.Queue()
        self.closed = False


class WireStore:
    """MVCCStore-shaped client over the KTPU wire — the core-component
    transport (informers, scheduler, controllers run over it unchanged).
    All ops multiplex over ONE connection; outgoing frames written in the
    same loop tick coalesce into one socket write."""

    def __init__(self, target: str, *, token: str | None = None,
                 user_agent: str = "kubernetes-tpu-wire",
                 enc: str = "msgpack", impersonate: str | None = None):
        if target.startswith("unix:"):
            self.path: str | None = target[len("unix:"):]
            self.host, self.port = "", 0
        else:
            self.path = None
            host, _, port = target.rpartition(":")
            self.host, self.port = host or "127.0.0.1", int(port)
        self.token = token
        self.user_agent = user_agent
        #: session-wide impersonation target (client-go's transport-level
        #: ImpersonationConfig analog) — rides the hello frame; the server
        #: RBAC-gates it on the authenticated user's `impersonate` verb.
        self.impersonate = impersonate
        #: frame codec: "msgpack" (default — the binary fast path) or
        #: "json"; the server mirrors whichever the client speaks. Any
        #: other name is refused (the reference reads it as JSON).
        if enc not in ("msgpack", "json"):
            raise ValueError(f"unknown wire codec {enc!r}: expected "
                             "'msgpack' or 'json'")
        self._encode = (_packb if enc == "msgpack" else
                        lambda f: _dumps(f, separators=(",", ":")).encode())
        self._proto: _ClientProto | None = None
        self._next_id = 0
        self._pending: dict[str, asyncio.Future] = {}
        self._watches: dict[str, _WireWatch] = {}
        self._out: list[bytes] = []
        self._flush_scheduled = False
        #: ops issued in the current loop tick, coalesced into ONE `multi`
        #: frame at flush (the HTTP/2 concurrent-streams analog): a
        #: 128-wide asyncio.gather of creates becomes one frame + one
        #: server task instead of 128 of each.
        self._tick_ops: list[tuple[str, list]] = []
        #: multi frame id -> ordered member request ids
        self._multis: dict[str, list[str]] = {}
        self._connecting: asyncio.Future | None = None
        self._stopped = False
        self._kinds: dict[str, str] | None = None
        self._cluster_scoped: set[str] = set()

    # -- connection --------------------------------------------------------

    async def _ensure(self) -> None:
        if self._stopped:
            raise StoreError("wire store is closed")
        if self._proto is not None and self._proto.transport is not None \
                and not self._proto.transport.is_closing():
            return
        if self._connecting is not None:
            await self._connecting
            return
        loop = asyncio.get_event_loop()
        self._connecting = loop.create_future()
        try:
            if self.path is not None:
                _t, proto = await loop.create_unix_connection(
                    lambda: _ClientProto(self), self.path)
            else:
                _t, proto = await loop.create_connection(
                    lambda: _ClientProto(self), self.host, self.port)
            self._proto = proto
            hello_args = {"token": self.token, "ua": self.user_agent}
            if self.impersonate:
                hello_args["impersonate"] = self.impersonate
            hello = await self._call("hello", hello_args, _pre_auth=True)
            logger.debug("wire connected as %s", hello.get("user"))
            self._connecting.set_result(None)
        except BaseException as e:
            # A refused handshake must not leave a half-open session that
            # later calls would reuse unauthenticated. Transport-level
            # connect failures (refused/absent socket during a shard
            # restart window) surface as StoreError like every other
            # wire failure — one error surface for retry loops.
            if isinstance(e, OSError):
                e = StoreError(f"wire connect failed: {e}")
            if self._proto is not None and self._proto.transport is not None:
                self._proto.transport.close()
            self._proto = None
            fut, self._connecting = self._connecting, None
            fut.set_exception(e)
            fut.exception()  # retrieved: the creator raises below
            raise e
        self._connecting = None

    def _conn_lost(self, exc) -> None:
        err = StoreError(f"wire connection lost: {exc}")
        # Drop frames serialized but never written: their callers' futures
        # fail below, so replaying them on the next connection would
        # duplicate side effects (and run pre-hello as anonymous).
        self._out.clear()
        self._tick_ops.clear()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(err)
        self._pending.clear()
        for w in self._watches.values():
            w.closed = True
            w.queue.put_nowait(("exp", "wire connection lost"))
        self._watches.clear()
        self._multis.clear()
        self._proto = None

    async def close(self) -> None:
        self._stopped = True
        if self._proto is not None and self._proto.transport is not None:
            self._proto.transport.close()
        self._proto = None

    def stop(self) -> None:
        self._stopped = True
        if self._proto is not None and self._proto.transport is not None:
            self._proto.transport.close()
        self._proto = None

    # -- framing -----------------------------------------------------------

    def _send(self, frame: list) -> None:
        body = self._encode(frame)
        self._out.append(_LEN.pack(len(body)))
        self._out.append(body)
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _send_op(self, rid: str, op_frame: list) -> None:
        self._tick_ops.append((rid, op_frame))
        if not self._flush_scheduled:
            self._flush_scheduled = True
            asyncio.get_event_loop().call_soon(self._flush)

    def _flush(self) -> None:
        self._flush_scheduled = False
        ops, self._tick_ops = self._tick_ops, []
        if len(ops) == 1:
            rid, op_frame = ops[0]
            body = self._encode([rid, *op_frame])
            self._out.append(_LEN.pack(len(body)))
            self._out.append(body)
        elif ops:
            self._next_id += 1
            mid = f"m{self._next_id}"
            self._multis[mid] = [rid for rid, _ in ops]
            body = self._encode([mid, "multi", [f for _, f in ops]])
            self._out.append(_LEN.pack(len(body)))
            self._out.append(body)
        if self._out and self._proto is not None \
                and self._proto.transport is not None:
            self._proto.transport.write(b"".join(self._out))
            self._out.clear()

    def _on_frame(self, frame: list) -> None:
        rid, kind = frame[0], frame[1]
        if kind == "ok" and rid in self._multis:
            for member_rid, res in zip(self._multis.pop(rid), frame[2]):
                fut = self._pending.pop(member_rid, None)
                if fut is None or fut.done():
                    continue
                if res[0] == "ok":
                    fut.set_result(res[1])
                else:
                    fut.set_exception(_EXC_OF.get(
                        res[1], StoreError)(res[2]))
            return
        if kind == "err" and rid in self._multis:
            exc = _EXC_OF.get(frame[2], StoreError)(frame[3])
            for member_rid in self._multis.pop(rid):
                fut = self._pending.pop(member_rid, None)
                if fut is not None and not fut.done():
                    fut.set_exception(exc)
            return
        if kind == "ev":
            w = self._watches.get(rid)
            if w is not None and not w.closed:
                if w.queue.qsize() >= w.MAX_BUFFERED:
                    # Consumer stopped draining: expire the watch instead
                    # of buffering without bound (see _WireWatch).
                    self._watches.pop(rid, None)
                    w.closed = True
                    w.queue.put_nowait(
                        ("exp", "watch expired: client buffer overflow "
                                "(consumer too slow)"))
                    self._send([rid, "stopwatch"])
                else:
                    w.queue.put_nowait(("ev", frame[2], frame[3]))
            return
        if kind == "exp":
            w = self._watches.pop(rid, None)
            if w is not None:
                w.closed = True
                w.queue.put_nowait(("exp", frame[2]))
            return
        fut = self._pending.pop(rid, None)
        if fut is None or fut.done():
            return
        if kind == "ok":
            fut.set_result(frame[2])
        else:  # err
            exc = _EXC_OF.get(frame[2], StoreError)
            fut.set_exception(exc(frame[3]))

    @staticmethod
    def _trace_wrap(op_frame: list) -> list:
        """W3C traceparent propagation, frame-field form: an op issued
        inside a span ships ["traced", tp, op, ...args] so the server's
        frame span parents to the caller's (the wire analog of
        RemoteStore's traceparent header)."""
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        if not DEFAULT_TRACER.enabled:
            return op_frame
        tp = DEFAULT_TRACER.current_traceparent()
        return ["traced", tp, *op_frame] if tp else op_frame

    async def _call(self, op: str, *args, _pre_auth: bool = False):
        if not _pre_auth:
            await self._ensure()
        self._next_id += 1
        rid = f"r{self._next_id}"
        fut = asyncio.get_event_loop().create_future()
        self._pending[rid] = fut
        if _pre_auth:
            self._send([rid, op, *args])  # hello must not ride a multi
        else:
            self._send_op(rid, self._trace_wrap([op, *args]))
        return await fut

    # -- MVCCStore surface -------------------------------------------------

    async def create(self, resource: str, obj: Mapping, **_kw) -> dict:
        return await self._call("create", resource, dict(obj))

    async def get(self, resource: str, key: str) -> dict:
        return await self._call("get", resource, key)

    async def update(self, resource: str, obj: Mapping, **_kw) -> dict:
        return await self._call("update", resource, dict(obj))

    async def delete(self, resource: str, key: str, *,
                     uid: str | None = None) -> dict:
        return await self._call("delete", resource, key, uid)

    async def subresource(self, resource: str, key: str, sub: str,
                          body: Mapping) -> dict:
        return await self._call("sub", resource, key, sub, dict(body))

    async def apply(self, resource: str, obj: Mapping, *,
                    field_manager: str, force: bool = False) -> dict:
        return await self._call("apply", resource, dict(obj),
                                field_manager, force)

    async def guaranteed_update(
        self, resource: str, key: str,
        mutate: Callable[[dict], dict | None],
        max_retries: int = 16, return_copy: bool = True,
    ) -> dict | None:
        """Client-side CAS loop (util/retry.RetryOnConflict)."""
        from kubernetes_tpu_torch.client.retry import retry_on_conflict
        return await retry_on_conflict(
            self, resource, key, mutate,
            max_retries=max_retries, return_copy=return_copy)

    async def list(
        self, resource: str, namespace: str | None = None,
        selector: Selector | None = None, limit: int = 0,
        continue_key: str | None = None,
        fields: Mapping[str, str] | None = None,
        *,
        resource_version: int | None = None,
        resource_version_match: str | None = None,
        shard: int | None = None,
        **_kw,
    ) -> ListResult:
        args = {
            "namespace": namespace,
            "selector": selector_to_string(selector) or None,
            "limit": limit or 0, "continue": continue_key,
            "fields": dict(fields) if fields else None}
        if resource_version:
            args["rv"] = resource_version
            args["rvMatch"] = resource_version_match
        if shard is not None:
            args["shard"] = int(shard)
        resp = await self._call("list", resource, args)
        return ListResult(items=resp["items"],
                          resource_version=int(resp["rv"]),
                          cont=resp.get("cont"))

    async def watch(
        self, resource: str, resource_version: int = 0,
        namespace: str | None = None, selector: Selector | None = None,
        fields: Mapping[str, str] | None = None,
        shard: int | None = None,
        **_kw,
    ) -> AsyncIterator[Event]:
        await self._ensure()
        self._next_id += 1
        wid = f"w{self._next_id}"
        w = _WireWatch(wid)
        self._watches[wid] = w
        args = {
            "rv": resource_version or 0, "namespace": namespace,
            "selector": selector_to_string(selector) or None,
            "fields": dict(fields) if fields else None}
        if shard is not None:
            args["shard"] = int(shard)
        self._send([wid, "watch", resource, args])

        async def gen() -> AsyncIterator[Event]:
            try:
                while True:
                    kind, *rest = await w.queue.get()
                    if kind == "exp":
                        msg = rest[0]
                        if "too old" in msg or "expired" in msg.lower():
                            raise Expired(msg)
                        raise StoreError(msg)
                    ev_type, obj = rest
                    rv = int(obj.get("metadata", {})
                             .get("resourceVersion", 0) or 0)
                    yield Event(ev_type, obj, rv)
            finally:
                w.closed = True
                if self._watches.pop(wid, None) is not None \
                        and self._proto is not None:
                    self._send([wid, "stopwatch"])

        return gen()

    # -- discovery (RESTMapper analog, used by CLI-ish consumers) ----------

    async def control_topology(self) -> dict:
        """Server control-plane shape ({"nodeShards": S, "partitioned":
        [...]}), cached — ShardedInformer calls this once per informer
        start to decide between per-shard and single-stream reflectors.
        Servers predating the op report the unsharded shape."""
        if getattr(self, "_topology", None) is None:
            try:
                self._topology = await self._call("topology")
            except Exception:
                # Do NOT cache the failure: a transient error at probe
                # time must not pin this connection to the single-stream
                # path forever — the next informer start retries.
                logger.warning("topology probe failed; assuming an "
                               "unsharded server this time", exc_info=True)
                return {"nodeShards": 1, "partitioned": []}
        return self._topology

    async def control_stats(self) -> dict:
        """Server-side observability snapshot (the `stats` op): the
        shard process's WAL counters etc. Uncached — callers difference
        snapshots around a measured phase. Servers predating the op
        (or with no stats_fn wired) report {}."""
        try:
            return dict(await self._call("stats") or {})
        except Exception:
            logger.warning("stats probe failed; reporting empty",
                           exc_info=True)
            return {}

    async def refresh_discovery(self) -> None:
        resp = await self._call("kinds")
        self._kinds = dict(resp.get("kinds") or {})
        self._cluster_scoped = set(resp.get("clusterScoped") or [])

    def is_cluster_scoped(self, resource: str) -> bool:
        if self._kinds is not None:
            return resource in self._cluster_scoped
        from kubernetes_tpu_torch.api.meta import CLUSTER_SCOPED_RESOURCES
        return resource in CLUSTER_SCOPED_RESOURCES

    def resource_for_kind(self, kind: str) -> str | None:
        if self._kinds is not None and kind in self._kinds:
            return self._kinds[kind]
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        return KIND_TO_RESOURCE.get(kind)

    def kind_map(self) -> dict[str, str]:
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        merged = dict(KIND_TO_RESOURCE)
        merged.update(self._kinds or {})
        return merged
