"""ServiceAccount + token controllers: principal lifecycle for authn.

Parity targets (SURVEY §2.4 `serviceaccount/`):
- pkg/controller/serviceaccount/serviceaccounts_controller.go: ensure
  the "default" ServiceAccount exists in every namespace (recreated if
  deleted, stamped on namespace creation).
- pkg/controller/serviceaccount/tokens_controller.go (legacy token
  secrets): issue a token Secret per ServiceAccount, delete it with the
  SA. The issued token authenticates to the apiserver as
  `system:serviceaccount:<ns>:<name>` — the exact username RBAC's
  ServiceAccount subjects bind to (apiserver/rbac.py add_binding).

The apiserver side: `ServiceAccountAuthenticator` plugs into
APIServer/WireServer `token_authenticator` and resolves presented
bearer tokens through the secrets informer, so issued tokens work on
both wires with no static bearer_tokens entry.

Copy of `kubernetes_tpu/controllers/serviceaccount.py`.
"""

from __future__ import annotations

import hashlib
import logging
import secrets as _secrets

from kubernetes_tpu_torch.api.meta import name_of, namespace_of, namespaced_name, new_object
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)

SA_TOKEN_TYPE = "kubernetes.io/service-account-token"
SA_NAME_ANN = "kubernetes.io/service-account.name"


def sa_username(namespace: str, name: str) -> str:
    return f"system:serviceaccount:{namespace}:{name}"


class ServiceAccountController(Controller):
    """Every namespace gets a "default" ServiceAccount."""

    NAME = "serviceaccount"
    WORKERS = 2
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.ns_informer = factory.informer("namespaces")
        self.sa_informer = factory.informer("serviceaccounts")
        self.watch_resource(factory, "namespaces", key_fn=name_of)
        # SA deletion re-syncs its namespace (recreate default).
        factory.informer("serviceaccounts").add_event_handler(
            ResourceEventHandler(on_delete=self._sa_deleted))

    def _sa_deleted(self, obj) -> None:
        import asyncio
        ns = namespace_of(obj)
        if ns:
            asyncio.ensure_future(self.queue.add(ns))

    async def resync_keys(self):
        return [name_of(n) for n in self.ns_informer.indexer.list()]

    async def sync(self, key: str) -> None:
        ns = self.ns_informer.indexer.get(key)
        if ns is None or (ns.get("status") or {}).get("phase") == \
                "Terminating":
            return
        if self.sa_informer.indexer.get(f"{key}/default") is not None:
            return
        sa = new_object("ServiceAccount", "default", key)
        try:
            await self.store.create("serviceaccounts", sa,
                                    return_copy=False)
        except (AlreadyExists, StoreError) as e:
            logger.debug("default SA for %s: %s", key, e)


class TokenController(Controller):
    """Issue a token Secret per ServiceAccount; GC it with the SA."""

    NAME = "serviceaccount-token"
    WORKERS = 2
    RESYNC_PERIOD = 5.0

    def _events(self):
        # Lazy: the recorder spins a drain task on first use, and most
        # syncs never emit (ADVICE r5 — only the double-squat dead end
        # needs the Event surface).
        rec = getattr(self, "_recorder", None)
        if rec is None:
            from kubernetes_tpu_torch.client.events import EventRecorder
            rec = self._recorder = EventRecorder(
                self.store, "serviceaccount-token-controller")
        return rec

    def setup(self, factory: InformerFactory) -> None:
        self.sa_informer = factory.informer("serviceaccounts")
        self.secret_informer = factory.informer("secrets")
        self.watch_resource(factory, "serviceaccounts")

        def secret_event(obj):
            # Secret deleted/changed → re-sync its SA.
            import asyncio
            ann = (obj.get("metadata") or {}).get("annotations") or {}
            sa = ann.get(SA_NAME_ANN)
            if sa:
                ns = namespace_of(obj) or "default"
                asyncio.ensure_future(self.queue.add(f"{ns}/{sa}"))

        factory.informer("secrets").add_event_handler(
            ResourceEventHandler(on_delete=secret_event))

    async def resync_keys(self):
        return [namespaced_name(sa)
                for sa in self.sa_informer.indexer.list()]

    def _token_secret_of(self, ns: str, sa_name: str) -> dict | None:
        for s in self.secret_informer.indexer.list():
            if (namespace_of(s) or "default") != ns:
                continue
            if s.get("type") != SA_TOKEN_TYPE:
                continue
            ann = (s.get("metadata") or {}).get("annotations") or {}
            if ann.get(SA_NAME_ANN) == sa_name:
                return s
        return None

    async def sync(self, key: str) -> None:
        ns, _, sa_name = key.partition("/")
        sa = self.sa_informer.indexer.get(key)
        existing = self._token_secret_of(ns, sa_name)
        if sa is None:
            # SA gone → its token secret dies too (tokens_controller
            # secret deletion; ownerRef GC would also cover it).
            if existing is not None:
                try:
                    await self.store.delete(
                        "secrets", namespaced_name(existing))
                except StoreError:
                    pass
            return
        if existing is not None:
            return
        token = f"sa-{_secrets.token_urlsafe(24)}"
        secret_name = None
        # The fallback suffix is DETERMINISTIC (derived from the SA uid):
        # informer-lag resyncs recompute the same name and collide on
        # AlreadyExists instead of minting a new secret per sync.
        uid = (sa.get("metadata") or {}).get("uid") or ""
        suffix = (uid.replace("-", "")[:6]
                  or hashlib.sha256(key.encode()).hexdigest()[:6])
        for candidate in (f"{sa_name}-token",
                          f"{sa_name}-token-{suffix}"):
            secret = new_object(
                "Secret", candidate, ns,
                type=SA_TOKEN_TYPE,
                data={"token": token, "namespace": ns})
            secret["metadata"]["annotations"] = {SA_NAME_ANN: sa_name}
            secret["metadata"]["ownerReferences"] = [{
                "apiVersion": "v1", "kind": "ServiceAccount",
                "name": sa_name,
                "uid": sa.get("metadata", {}).get("uid", ""),
                "controller": True}]
            try:
                await self.store.create("secrets", secret, return_copy=False)
                secret_name = candidate
                break
            except AlreadyExists:
                # The name may be squatted by a FOREIGN secret (wrong
                # type/annotation) that will never authenticate; only
                # accept it as "established" if it really is our token,
                # else retry under a suffixed name rather than mirroring
                # a dead name into sa.secrets.
                try:
                    held = await self.store.get("secrets", f"{ns}/{candidate}")
                except StoreError:
                    continue
                ann = (held.get("metadata") or {}).get("annotations") or {}
                if (held.get("type") == SA_TOKEN_TYPE
                        and ann.get(SA_NAME_ANN) == sa_name):
                    secret_name = candidate
                    break
        if secret_name is None:
            # BOTH candidate names are squatted by foreign secrets
            # (wrong type/annotation): every resync from here recomputes
            # the same names and dead-ends identically, so the SA never
            # gets a working token. Returning silently hid that (ADVICE
            # r5) — log once per sync and emit a Warning Event so the
            # dead-end is observable from `kubectl describe sa` land.
            logger.warning(
                "serviceaccount %s: token secret names %r are both "
                "held by foreign secrets; no token will be issued "
                "until one is freed", key,
                [f"{sa_name}-token", f"{sa_name}-token-{suffix}"])
            self._events().event(
                sa, "Warning", "TokenSecretSquatted",
                f"cannot issue a token secret: both candidate names "
                f"{sa_name}-token and {sa_name}-token-{suffix} exist "
                f"with a foreign type or owner annotation")
            return

        # Mirror the secret name into the SA (kubectl describe parity).
        def note(obj):
            secrets_list = obj.setdefault("secrets", [])
            entry = {"name": secret_name}
            if entry in secrets_list:
                return None
            secrets_list.append(entry)
            return obj
        try:
            await self.store.guaranteed_update(
                "serviceaccounts", key, note, return_copy=False)
        except NotFound:
            pass


class ServiceAccountAuthenticator:
    """Bearer-token authenticator backed by the token secrets.

    Plugs into APIServer/WireServer as `token_authenticator`: returns
    the SA username for a valid token, None otherwise. Uses an
    incremental token index fed by the secrets informer."""

    def __init__(self, factory: InformerFactory):
        self._by_token: dict[str, str] = {}
        self._secret_token: dict[str, str] = {}

        def index(obj):
            # Drop any stale entry FIRST: a token secret updated to a
            # different type must stop authenticating immediately.
            key = namespaced_name(obj)
            old = self._secret_token.pop(key, None)
            if old is not None:
                self._by_token.pop(old, None)
            if obj.get("type") != SA_TOKEN_TYPE:
                return
            data = obj.get("data") or {}
            token = data.get("token")
            ann = (obj.get("metadata") or {}).get("annotations") or {}
            sa = ann.get(SA_NAME_ANN)
            if token and sa:
                ns = namespace_of(obj) or "default"
                self._by_token[token] = sa_username(ns, sa)
                self._secret_token[key] = token

        def drop(obj):
            key = namespaced_name(obj)
            old = self._secret_token.pop(key, None)
            if old is not None:
                self._by_token.pop(old, None)

        factory.informer("secrets").add_event_handler(
            ResourceEventHandler(
                on_add=index, on_update=lambda o, n: index(n),
                on_delete=drop))

    def __call__(self, token: str) -> str | None:
        return self._by_token.get(token)
