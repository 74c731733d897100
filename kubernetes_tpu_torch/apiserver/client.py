"""RemoteStore: the client-go analog — MVCCStore's interface over HTTP.

Parity target: client-go `rest/request.go` + the clientset surface. Every
in-process consumer (informers, controllers, the scheduler's DefaultBinder)
takes a "store" duck-typed to MVCCStore; RemoteStore implements that duck
type against an APIServer, so components gain a remote mode with no changes:

- list/watch with label selectors, resourceVersion resume, 410 → Expired
  (the informer's relist path), BOOKMARK frames
- create/get/update/delete with kube Status error mapping
- guaranteed_update as a client-side CAS retry loop
  (client-go util/retry.RetryOnConflict)
- subresource POST (binding)

Copy of `kubernetes_tpu/apiserver/client.py`. `RemoteStore(protobuf=True)`
asks for the protobuf content type and decodes single objects from the
`runtime.Unknown` envelope of `apiserver/grpc_server.py`.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import AsyncIterator, Callable, Mapping

import aiohttp

from kubernetes_tpu_torch.api.labels import (
    Selector,
    field_selector_to_string,
    selector_to_string,
)
from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Event,
    Expired,
    Invalid,
    ListResult,
    NotFound,
    StoreError,
)
from kubernetes_tpu_torch.api.meta import (
    CLUSTER_SCOPED_RESOURCES as CLUSTER_SCOPED,
)
from kubernetes_tpu_torch.apiserver.server import PROTOBUF_CT

logger = logging.getLogger(__name__)

_REASON_TO_EXC = {
    "NotFound": NotFound,
    "AlreadyExists": AlreadyExists,
    "Conflict": Conflict,
    "Invalid": Invalid,
    "Expired": Expired,
    "Gone": Expired,
}


def _raise_for_status(status: int, body: dict | str) -> None:
    if status < 400:
        return
    reason, message = "", str(body)
    if isinstance(body, dict):
        reason = body.get("reason", "")
        message = body.get("message", message)
    exc = _REASON_TO_EXC.get(reason)
    if exc is None:
        exc = {404: NotFound, 409: Conflict, 410: Expired,
               422: Invalid}.get(status, StoreError)
    raise exc(message)


class RemoteStore:
    """MVCCStore-shaped client for an APIServer at `base_url`."""

    def __init__(self, base_url: str, *, token: str | None = None,
                 user_agent: str = "kubernetes-tpu-client",
                 protobuf: bool = False, impersonate: str | None = None):
        self.base_url = base_url.rstrip("/")
        self._headers = {"User-Agent": user_agent}
        if impersonate:
            # client-go ImpersonationConfig: every request asks the server
            # to run as this user (RBAC `impersonate` verb gates it).
            self._headers["Impersonate-User"] = impersonate
        #: Negotiate the runtime.Unknown protobuf envelope for single
        #: objects (the reference's application/vnd.kubernetes.protobuf
        #: wire between core components); lists/watches stay JSON.
        self.protobuf = protobuf
        if protobuf:
            self._headers["Accept"] = f"{PROTOBUF_CT}, application/json"
        if token:
            self._headers["Authorization"] = f"Bearer {token}"
        self._session: aiohttp.ClientSession | None = None
        # Discovery-learned kind/scope maps (refresh_discovery). CRD
        # registration is store-local server-side, so a remote client must
        # LEARN custom scopes from /api/v1 rather than share process
        # globals; until fetched, built-ins apply.
        self._disc_kinds: dict[str, str] | None = None
        self._disc_cluster_scoped: set[str] = set()

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(headers=self._headers)
        return self._session

    @staticmethod
    def _trace_headers() -> dict | None:
        """W3C traceparent propagation: a write issued inside a span
        (e.g. the binding POST inside scheduler.bind) parents the
        server-side request span to it."""
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        if not DEFAULT_TRACER.enabled:
            return None
        tp = DEFAULT_TRACER.current_traceparent()
        return {"traceparent": tp} if tp else None

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    # alias so factory.stop()/store.stop() call sites can treat either store
    def stop(self) -> None:
        if self._session is not None and not self._session.closed:
            asyncio.ensure_future(self._session.close())

    # -- discovery ---------------------------------------------------------

    async def refresh_discovery(self) -> None:
        """Fetch /api/v1 (APIResourceList) and cache kind↔resource +
        scope for every server-known resource, CRDs included — the
        kubectl RESTMapper pattern. Safe to skip: built-ins then apply."""
        async with self._sess().get(f"{self.base_url}/api/v1") as r:
            if r.status != 200:
                return
            doc = await r.json()
        kinds: dict[str, str] = {}
        scoped: set[str] = set()
        for res in doc.get("resources") or []:
            name, kind = res.get("name"), res.get("kind")
            if not name or not kind:
                continue
            kinds[kind] = name
            if not res.get("namespaced", True):
                scoped.add(name)
        self._disc_kinds = kinds
        self._disc_cluster_scoped = scoped

    def is_cluster_scoped(self, resource: str) -> bool:
        if self._disc_kinds is not None:
            return resource in self._disc_cluster_scoped
        return resource in CLUSTER_SCOPED

    def resource_for_kind(self, kind: str) -> str | None:
        if self._disc_kinds is not None and kind in self._disc_kinds:
            return self._disc_kinds[kind]
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        return KIND_TO_RESOURCE.get(kind)

    def kind_map(self) -> dict[str, str]:
        from kubernetes_tpu_torch.api.meta import KIND_TO_RESOURCE
        merged = dict(KIND_TO_RESOURCE)
        merged.update(self._disc_kinds or {})
        return merged

    # -- URL helpers -------------------------------------------------------

    def _collection_url(self, resource: str, namespace: str | None) -> str:
        if self.is_cluster_scoped(resource) or not namespace:
            return f"{self.base_url}/api/v1/{resource}"
        return f"{self.base_url}/api/v1/namespaces/{namespace}/{resource}"

    def _item_url(self, resource: str, key: str) -> str:
        if "/" in key:
            ns, name = key.split("/", 1)
            return (f"{self.base_url}/api/v1/namespaces/{ns}/"
                    f"{resource}/{name}")
        return f"{self.base_url}/api/v1/{resource}/{key}"

    async def _json(self, resp: aiohttp.ClientResponse):
        if resp.content_type == PROTOBUF_CT:
            # runtime.Unknown envelope (see apiserver/grpc_server._wrap).
            from kubernetes_tpu_torch.apiserver.grpc_server import (
                _unwrap,
                ktpu_pb2,
            )
            raw = await resp.read()
            if resp.status < 400:
                return _unwrap(ktpu_pb2.Unknown.FromString(raw))
            body = raw.decode(errors="replace")
            _raise_for_status(resp.status, body)
        try:
            body = await resp.json()
        except (aiohttp.ContentTypeError, json.JSONDecodeError):
            body = await resp.text()
        _raise_for_status(resp.status, body)
        return body

    # -- CRUD --------------------------------------------------------------

    async def create(self, resource: str, obj: Mapping, **_kw) -> dict:
        ns = obj.get("metadata", {}).get("namespace")
        async with self._sess().post(
                self._collection_url(resource, ns), json=dict(obj),
                headers=self._trace_headers()) as resp:
            return await self._json(resp)

    async def get(self, resource: str, key: str) -> dict:
        async with self._sess().get(self._item_url(resource, key)) as resp:
            return await self._json(resp)

    async def update(self, resource: str, obj: Mapping, **_kw) -> dict:
        key = namespaced_name(obj)
        async with self._sess().put(
                self._item_url(resource, key), json=dict(obj),
                headers=self._trace_headers()) as resp:
            return await self._json(resp)

    async def dry_run(self, resource: str, obj: Mapping,
                      operation: str = "update") -> dict:
        """Server-side dry run (?dryRun=All — kubectl diff's seam): the
        object flows through the FULL admission chain — mutating
        webhooks, expression policies, validating webhooks — and the
        admitted result comes back WITHOUT being persisted (no RV
        assigned, no watch event)."""
        params = {"dryRun": "All"}
        if operation == "create":
            ns = obj.get("metadata", {}).get("namespace")
            async with self._sess().post(
                    self._collection_url(resource, ns), json=dict(obj),
                    params=params,
                    headers=self._trace_headers()) as resp:
                return await self._json(resp)
        key = namespaced_name(obj)
        async with self._sess().put(
                self._item_url(resource, key), json=dict(obj),
                params=params,
                headers=self._trace_headers()) as resp:
            return await self._json(resp)

    async def delete(self, resource: str, key: str, *,
                     uid: str | None = None) -> dict:
        kwargs = {}
        if uid:
            kwargs["json"] = {"preconditions": {"uid": uid}}
        async with self._sess().delete(
                self._item_url(resource, key),
                headers=self._trace_headers(), **kwargs) as resp:
            return await self._json(resp)

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

    async def subresource(self, resource: str, key: str, sub: str,
                          body: Mapping) -> dict:
        url = self._item_url(resource, key) + "/" + sub
        async with self._sess().post(
                url, json=dict(body),
                headers=self._trace_headers()) as resp:
            return await self._json(resp)

    async def patch(self, resource: str, key: str, patch: Mapping, *,
                    patch_type: str = "strategic") -> dict:
        """kubectl patch: strategic-merge (default), merge, or json patch
        — the server merges against the live object and the result flows
        through its full admission chain (webhooks + policies)."""
        ct = {
            "strategic": "application/strategic-merge-patch+json",
            "merge": "application/merge-patch+json",
            "json": "application/json-patch+json",
        }.get(patch_type)
        if ct is None:
            raise ValueError(f"unknown patch type {patch_type!r}")
        headers = {"Content-Type": ct, **(self._trace_headers() or {})}
        async with self._sess().patch(
                self._item_url(resource, key),
                data=json.dumps(patch), headers=headers) as resp:
            return await self._json(resp)

    async def apply(self, resource: str, obj: Mapping, *,
                    field_manager: str, force: bool = False) -> dict:
        """Server-side apply (PATCH application/apply-patch+yaml)."""
        key = namespaced_name(obj)
        params = {"fieldManager": field_manager}
        if force:
            params["force"] = "true"
        async with self._sess().patch(
                self._item_url(resource, key), params=params,
                data=json.dumps(dict(obj)),
                headers={"Content-Type":
                         "application/apply-patch+yaml"}) as resp:
            return await self._json(resp)

    # -- LIST + WATCH ------------------------------------------------------

    async def list(
        self, resource: str, namespace: str | None = None,
        selector: Selector | None = None, limit: int = 0,
        continue_key: str | None = None,
        fields: Mapping[str, str] | None = None,
        *,
        resource_version: int | None = None,
        resource_version_match: str | None = None,
        **_kw,
    ) -> ListResult:
        params = {}
        sel = selector_to_string(selector)
        if sel:
            params["labelSelector"] = sel
        fs = field_selector_to_string(fields)
        if fs:
            params["fieldSelector"] = fs
        if limit:
            params["limit"] = str(limit)
        if continue_key:
            params["continue"] = continue_key
        if resource_version:
            # Watch-cache RV semantics (store/cacher.py): Exact pins the
            # historical snapshot; bare RV = "not older than" = current.
            params["resourceVersion"] = str(resource_version)
            if resource_version_match:
                params["resourceVersionMatch"] = resource_version_match
        async with self._sess().get(
                self._collection_url(resource, namespace),
                params=params) as resp:
            body = await self._json(resp)
        return ListResult(
            items=body.get("items", []),
            resource_version=int(
                body.get("metadata", {}).get("resourceVersion", 0)),
            cont=body.get("metadata", {}).get("continue"))

    async def watch(
        self, resource: str, resource_version: int = 0,
        namespace: str | None = None, selector: Selector | None = None,
        fields: Mapping[str, str] | None = None,
        **_kw,
    ) -> AsyncIterator[Event]:
        params = {"watch": "1"}
        if resource_version:
            params["resourceVersion"] = str(resource_version)
        sel = selector_to_string(selector)
        if sel:
            params["labelSelector"] = sel
        fs = field_selector_to_string(fields)
        if fs:
            params["fieldSelector"] = fs
        resp = await self._sess().get(
            self._collection_url(resource, namespace), params=params,
            timeout=aiohttp.ClientTimeout(total=None, sock_read=None))
        if resp.status >= 400:
            try:
                body = await resp.json()
            except (aiohttp.ContentTypeError, json.JSONDecodeError):
                body = await resp.text()
            resp.release()
            _raise_for_status(resp.status, body)

        async def gen() -> AsyncIterator[Event]:
            try:
                async for raw in _stream_lines(resp):
                    line = raw.strip()
                    if not line:
                        continue
                    frame = json.loads(line)
                    obj = frame.get("object") or {}
                    rv = int(obj.get("metadata", {})
                             .get("resourceVersion", 0) or 0)
                    if frame.get("type") == "ERROR":
                        reason = obj.get("reason", "")
                        if reason in ("Expired", "Gone"):
                            raise Expired(obj.get("message", "watch expired"))
                        raise StoreError(obj.get("message", "watch error"))
                    yield Event(frame["type"], obj, rv)
            except (aiohttp.ClientError, ValueError) as e:
                # Transport hiccups / oversized frames become a retriable
                # StoreError so the informer relists instead of dying.
                raise StoreError(f"watch stream error: {e}") from e
            finally:
                resp.release()

        return gen()


_MAX_FRAME = 64 << 20  # hard stop against a newline-free (corrupt) stream


async def _stream_lines(resp: aiohttp.ClientResponse):
    """Newline-split the watch stream from raw chunks, so a single frame
    larger than the reader's line limit can't kill the watch."""
    buf = bytearray()
    async for chunk in resp.content.iter_any():
        buf.extend(chunk)
        if len(buf) > _MAX_FRAME:
            raise ValueError(f"watch frame exceeded {_MAX_FRAME} bytes")
        while True:
            nl = buf.find(b"\n")
            if nl < 0:
                break
            line = bytes(buf[:nl])
            del buf[:nl + 1]
            yield line
    if buf:
        yield bytes(buf)
