"""The port's gRPC service (`apiserver/grpc_server.py`) and the protobuf
content type over HTTP, on the CPU against the JAX package's.

One serial request script runs through each package's `GRPCAPIServer` and
`GRPCRemoteStore` (`grpc_script`). The server holds an `MVCCStore`
(32-event window) with core validation, the binding subresource, a
`WebhookAdmission` whose ValidatingAdmissionPolicy denies pods named
`denied-*`, RBAC over bearer tokens and an audit pipeline at Metadata for
pods. The script covers create, get, an update conflict,
guaranteed_update, delete with a uid precondition, the binding
subresource; lists with a selector, a namespace and continue tokens, and
an exact-RV list through a pinned continue token; a watch replayed from a
resource version up to a BOOKMARK, and an expired version that raises
`Expired`; the per-RPC server span and its parent; the interceptor chain
(bearer tokens, impersonation allowed and refused, an RBAC denial, an
invalid token, an anonymous call) and the audit events. Objects, resource
versions, error classes and messages, gRPC status codes and audit events
must be identical, and so must `_wrap(obj).SerializeToString()` for every
object the script got back.

Over HTTP, the same requests with `Accept: application/vnd.kubernetes.
protobuf` go to each package's `APIServer`: status codes and body bytes
must be identical, and `RemoteStore(protobuf=True)` returns the same dicts.

The reference's `tests/test_grpc_wire.py` cases run against the port too,
the scheduler binding with `TorchBackend(device="cpu")`.

Uids and creation timestamps are pinned in both packages (a counter per
package, reset per run); audit ids and stage timestamps are masked, as
are the random trace ids (the trace section records how spans relate).

Tolerance: none (exact host logic).
"""

import asyncio
import copy
import itertools
from importlib import import_module

import aiohttp
import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
MASKED = ("time", "auditID", "stageTimestamp", "requestReceivedTimestamp")
EVENT_WINDOW = 32
STAMP = "2026-01-01T00:00:00Z"
TOKENS = {"admin-token": "admin", "viewer-token": "viewer",
          "imp-token": "imp"}
PROTOBUF_CT = "application/vnd.kubernetes.protobuf"


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


def masked(value):
    if isinstance(value, dict):
        return {k: "<masked>" if k in MASKED else masked(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [masked(v) for v in value]
    return value


class Pinned:
    """Deterministic uids and creation timestamps in one package, and a
    short bookmark interval: the patched attributes are restored on
    exit."""

    def __init__(self, root: str):
        self.root = root
        self.saved = []

    def _set(self, module, name, value):
        self.saved.append((module, name, getattr(module, name)))
        setattr(module, name, value)

    def __enter__(self):
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            self._set(mod(self.root, sub), "new_uid",
                      lambda seq=seq: f"uid-{next(seq)}")
        self._set(mod(self.root, "api.meta"), "now_iso", lambda: STAMP)
        self._set(mod(self.root, "store.mvcc"), "BOOKMARK_INTERVAL_S", 0.05)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)


# -- the gRPC script ---------------------------------------------------------

async def attempt(coro, raw: list | None = None):
    """A call's result, or the error's type, message and gRPC status code
    (the client raises its StoreError from the AioRpcError). Successful
    single objects are appended to `raw` for the envelope bytes."""
    try:
        got = await coro
    except Exception as e:  # the error itself is compared
        cause = e.__cause__
        code = cause.code().name if hasattr(cause, "code") else None
        return (type(e).__name__, str(e), code)
    if hasattr(got, "items") and hasattr(got, "resource_version"):
        return ("ok", got.items, got.resource_version, got.cont)
    if raw is not None:
        raw.append(copy.deepcopy(got))
    return ("ok", got)


def names(items) -> list:
    return [(o["metadata"].get("namespace"), o["metadata"]["name"],
             o["metadata"]["resourceVersion"]) for o in items]


async def watch_until_bookmark(client, resource, rv, **kw) -> list:
    out = []
    watch = await client.watch(resource, resource_version=rv, **kw)
    try:
        while True:
            ev = await asyncio.wait_for(watch.__anext__(), 10.0)
            if ev.type == "BOOKMARK":
                out.append(("BOOKMARK", ev.object["metadata"].get(
                    "resourceVersion")))
                return out
            out.append((ev.type, ev.object["metadata"]["name"], ev.rv))
    finally:
        await watch.aclose()


async def first_event(client, **kw) -> str:
    watch = await client.watch("pods", **kw)
    try:
        async for ev in watch:
            return ev.type
    finally:
        await watch.aclose()


def authorizer(rbac):
    return rbac.RBACAuthorizer(
        [rbac.make_cluster_role("admin", [{"verbs": ["*"],
                                           "resources": ["*"]}]),
         rbac.make_cluster_role("viewer", [
             {"verbs": ["get", "list", "watch"], "resources": ["pods"]}]),
         rbac.make_cluster_role("imp", [{"verbs": ["impersonate"],
                                         "resources": ["users"]}])],
        [rbac.make_cluster_role_binding("admin-b", "admin", ["admin"]),
         rbac.make_cluster_role_binding("viewer-b", "viewer", ["viewer"]),
         rbac.make_cluster_role_binding("imp-b", "imp", ["imp"])])


async def grpc_script(root: str) -> dict:
    mvcc = mod(root, "store.mvcc")
    types = mod(root, "api.types")
    labels = mod(root, "api.labels")
    policy = mod(root, "policy")
    gs = mod(root, "apiserver.grpc_server")
    tracing = mod(root, "utils.tracing")

    store = mvcc.MVCCStore(event_window=EVENT_WINDOW)
    store.register_subresource("pods", "binding", mvcc.binding_subresource)
    mod(root, "store").install_core_validation(store)
    await store.create("nodes", types.make_node("n1"))
    await store.create(
        "validatingadmissionpolicies",
        types.make_validating_admission_policy("no-denied", [
            {"expression": "not object.metadata.name.startsWith('denied')",
             "message": "names starting with denied are refused"}],
            match_constraints={"resourceRules": [
                {"resources": ["pods"], "operations": ["CREATE"]}]}))
    await store.create("validatingadmissionpolicybindings",
                       types.make_vap_binding("no-denied-b", "no-denied"))
    admission = mod(root, "apiserver.admission").WebhookAdmission(
        store, policy_engine=policy.PolicyEngine(store))
    audit = policy.AuditPipeline(policy.AuditPolicy(
        [{"level": "Metadata", "resources": ["pods"]}]))
    tracer = tracing.Tracer(enabled=False)
    server = gs.GRPCAPIServer(
        store, bearer_tokens=TOKENS, authorizer=authorizer(
            mod(root, "apiserver.rbac")),
        audit=audit, admission=admission, tracer=tracer)
    await server.start()
    clients = []

    def client(**kw):
        c = gs.GRPCRemoteStore(server.target, **kw)
        clients.append(c)
        return c

    out = {}
    raw = []
    try:
        admin = client(token="admin-token")
        rec = out.setdefault("crud", [])
        for i in range(6):
            pod = types.make_pod(f"p{i}", "other" if i == 5 else "default",
                                 labels={"app": ("web", "db")[i % 2]})
            rec.append(await attempt(admin.create("pods", pod), raw))
        rv_after_creates = int(rec[-1][1]["metadata"]["resourceVersion"])
        rec.append(await attempt(admin.create("pods", types.make_pod(
            "p0", "default")), raw))
        rec.append(await attempt(admin.create("pods", types.make_pod(
            "denied-1", "default")), raw))
        rec.append(await attempt(admin.get("pods", "default/p0"), raw))
        rec.append(await attempt(admin.get("pods", "default/nope"), raw))
        cur = copy.deepcopy(await admin.get("pods", "default/p0"))
        stale = copy.deepcopy(cur)
        cur["metadata"]["labels"]["tier"] = "gold"
        rec.append(await attempt(admin.update("pods", cur), raw))
        stale["metadata"]["labels"]["tier"] = "stale"
        rec.append(await attempt(admin.update("pods", stale), raw))

        def annotate(obj):
            obj["metadata"].setdefault("annotations", {})["seen"] = "yes"
            return obj

        rec.append(await attempt(admin.guaranteed_update(
            "pods", "default/p1", annotate), raw))
        p3 = await admin.get("pods", "default/p3")
        rec.append(await attempt(admin.subresource(
            "pods", "default/p3", "binding", types.make_binding(p3, "n1")),
            raw))
        rec.append(await attempt(admin.get("pods", "default/p3"), raw))
        p4 = await admin.get("pods", "default/p4")
        rec.append(await attempt(admin.delete("pods", "default/p4",
                                              uid="not-the-uid"), raw))
        rec.append(await attempt(admin.delete(
            "pods", "default/p4", uid=p4["metadata"]["uid"]), raw))
        rec.append(await attempt(admin.delete("pods", "default/p4"), raw))
        for i in range(20):
            rec.append(await attempt(admin.create(
                "configmaps", types.make_config_map(
                    f"cm{i}", "default", {"i": str(i)})), raw))

        rec = out.setdefault("list", [])
        rec.append(names((await admin.list("pods")).items))
        web = labels.parse_selector("app=web")
        rec.append(names((await admin.list("pods", selector=web)).items))
        rec.append(names((await admin.list("pods",
                                           namespace="other")).items))
        pages, token = [], None
        while True:
            page = await admin.list("configmaps", limit=7,
                                    continue_key=token)
            pages.append((names(page.items), page.resource_version,
                          page.cont))
            token = page.cont
            if not token:
                break
        rec.append(pages)
        # The exact-RV read: a snapshot at rv0, later writes invisible,
        # and a pinned page resumed at the same snapshot.
        rv0 = (await admin.list("configmaps")).resource_version
        for i in range(3):
            await admin.create("configmaps", types.make_config_map(
                f"late{i}", "default", {}))
        exact = await admin.list("configmaps", resource_version=rv0,
                                 resource_version_match="Exact")
        rec.append((names(exact.items), exact.resource_version))
        page = await admin.list("configmaps", limit=5, resource_version=rv0,
                                resource_version_match="Exact")
        rest = await admin.list("configmaps", continue_key=page.cont)
        rec.append((names(page.items), page.cont, names(rest.items),
                    rest.resource_version))

        rec = out.setdefault("watch", [])
        recent = int((await admin.list("configmaps")).resource_version) - 5
        rec.append(await watch_until_bookmark(admin, "configmaps", recent))
        rec.append(await watch_until_bookmark(admin, "pods",
                                              rv_after_creates,
                                              selector=web))

        rec.append(await attempt(first_event(admin, resource_version=2)))

        # The per-RPC span: the server's span joins the caller's trace,
        # and the created pod carries the caller's traceparent.
        rec = out.setdefault("trace", [])
        default = tracing.DEFAULT_TRACER
        tracer.enabled = default.enabled = True
        try:
            with default.span("client.create") as root_span:
                created = await admin.create("pods", types.make_pod(
                    "traced", "default"))
        finally:
            tracer.enabled = default.enabled = False
        spans = [s for s in tracer.spans if s.name == "grpc.create.pods"]
        tp = tracing.traceparent_of(created)
        rec.append(([s.name for s in tracer.spans], len(spans),
                    spans[-1].trace_id == root_span.trace_id,
                    spans[-1].parent_id == root_span.span_id,
                    spans[-1].attrs.get("user"),
                    bool(tp) and root_span.trace_id in tp))
        default.clear()

        rec = out.setdefault("auth", [])
        viewer = client(token="viewer-token")
        as_viewer = client(token="imp-token", impersonate="viewer")
        refused = client(token="viewer-token", impersonate="admin")
        wrong = client(token="wrong")
        anon = client()
        rec.append(names((await viewer.list("pods")).items))
        rec.append(await attempt(viewer.get("pods", "default/p0"), raw))
        rec.append(await attempt(viewer.create("pods", types.make_pod(
            "v1", "default")), raw))
        rec.append(names((await as_viewer.list("pods")).items))
        rec.append(await attempt(as_viewer.create("pods", types.make_pod(
            "i1", "default")), raw))
        rec.append(await attempt(refused.get("pods", "default/p0"), raw))
        rec.append(await attempt(wrong.get("pods", "default/p0"), raw))
        rec.append(await attempt(anon.get("pods", "default/p0"), raw))
        rec.append(await attempt(first_event(anon)))
        await audit.close()
        rec.append(masked(audit.sink.entries))
        out["wrap"] = [gs._wrap(o).SerializeToString() for o in raw]
        out["unwrap"] = [gs._unwrap(gs.ktpu_pb2.Unknown.FromString(b))
                         for b in out["wrap"]]
        out["raw"] = raw
        out["pb2_file"] = gs.ktpu_pb2.__file__
    finally:
        for c in clients:
            await c.close()
        await server.stop()
        store.stop()
    return out


@pytest.fixture(scope="module")
def runs():
    """The script through each package's gRPC server, once per module."""
    out = {}
    for root in PACKAGES:
        with Pinned(root):
            out[root] = asyncio.run(grpc_script(root))
    return out


SECTIONS = ("crud", "list", "watch", "trace", "auth", "wrap", "unwrap",
            "raw")


@pytest.mark.parametrize("section", SECTIONS)
def test_grpc_script_matches_the_reference(runs, section):
    assert runs["kubernetes_tpu_torch"][section] == \
        runs["kubernetes_tpu"][section]


def test_the_grpc_script_reaches_every_path(runs):
    out = runs["kubernetes_tpu_torch"]
    codes = {r[2] for sec in ("crud", "auth") for r in out[sec]
             if isinstance(r, tuple) and r[0] != "ok"}
    for code in ("ALREADY_EXISTS", "NOT_FOUND", "ABORTED",
                 "PERMISSION_DENIED", "UNAUTHENTICATED"):
        assert code in codes, code
    kinds = {r[0] for r in out["crud"]}
    assert {"ok", "AlreadyExists", "NotFound", "Conflict"} <= kinds
    assert any("names starting with denied" in str(r) for r in out["crud"])
    bound = [r for r in out["crud"] if r[0] == "ok"
             and r[1].get("metadata", {}).get("name") == "p3"]
    assert bound[-1][1]["spec"]["nodeName"] == "n1"
    pages = out["list"][3]
    assert len(pages) == 3 and sum(len(p[0]) for p in pages) == 20
    exact, pinned = out["list"][4], out["list"][5]
    assert len(exact[0]) == 20 and not any("late" in n[1]
                                           for n in exact[0])
    assert len(pinned[0]) + len(pinned[2]) == 20
    assert pinned[3] == exact[1]
    watch = out["watch"]
    assert watch[0][-1][0] == "BOOKMARK" and len(watch[0]) == 6
    assert watch[2][0] == "Expired" and watch[2][2] == "OUT_OF_RANGE"
    names_, count, same_trace, parented, user, stamped = out["trace"][0]
    assert count == 1 and same_trace and parented and stamped
    assert user == "admin"
    audit = out["auth"][-1]
    assert {e["stage"] for e in audit} == {"RequestReceived",
                                           "ResponseComplete"}
    assert any(e.get("impersonatedUser", {}).get("username") == "viewer"
               for e in audit)
    assert any(e.get("responseStatus", {}).get("code") == 401
               for e in audit)
    # the envelope decodes back to the objects
    assert out["unwrap"] == out["raw"] and len(out["wrap"]) > 20


def test_each_package_loads_its_own_generated_module(runs):
    for root in PACKAGES:
        assert runs[root]["pb2_file"].replace("\\", "/").endswith(
            f"{root}/apiserver/proto/ktpu_pb2.py")


# -- the protobuf content type over HTTP -------------------------------------

async def protobuf_http(root: str) -> dict:
    mvcc = mod(root, "store.mvcc")
    types = mod(root, "api.types")
    client_mod = mod(root, "apiserver.client")
    store = mvcc.MVCCStore(event_window=EVENT_WINDOW)
    store.register_subresource("pods", "binding", mvcc.binding_subresource)
    mod(root, "store").install_core_validation(store)
    await store.create("nodes", types.make_node("n1"))
    api = mod(root, "apiserver.server").APIServer(store)
    await api.start()
    out = {"raw": [], "client": []}
    rs = client_mod.RemoteStore(api.url, protobuf=True)
    try:
        pods = api.url + "/api/v1/namespaces/default/pods"
        accept = {"Accept": PROTOBUF_CT}
        body = {"apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": "a", "labels": {"app": "web"}},
                "spec": {"containers": [{"name": "c", "image": "i"}]}}
        reqs = [("POST", pods, body), ("GET", pods + "/a", None),
                ("POST", pods, body), ("GET", pods + "/nope", None),
                ("GET", pods, None),
                ("PUT", pods + "/a/status", {"status": {"phase": "Running"}}),
                ("DELETE", pods + "/a", None)]
        async with aiohttp.ClientSession() as s:
            for method, url, payload in reqs:
                kw = {"headers": accept}
                if payload is not None:
                    kw["json"] = payload
                async with s.request(method, url, **kw) as resp:
                    out["raw"].append((method, url.replace(api.url, ""),
                                       resp.status, resp.content_type,
                                       await resp.read()))
        rec = out["client"]
        rec.append(await attempt(rs.create("pods", types.make_pod(
            "b", "default", labels={"app": "db"}))))
        rec.append(await attempt(rs.get("pods", "default/b")))
        rec.append(await attempt(rs.get("pods", "default/nope")))
        rec.append(await attempt(rs.create("pods", types.make_pod(
            "b", "default"))))
        cur = await rs.get("pods", "default/b")
        cur["metadata"]["labels"]["tier"] = "gold"
        rec.append(await attempt(rs.update("pods", cur)))
        rec.append(await attempt(rs.subresource(
            "pods", "default/b", "binding",
            types.make_binding(cur, "n1"))))
        lst = await rs.list("pods")
        rec.append((names(lst.items), lst.resource_version))
        rec.append(await attempt(rs.delete("pods", "default/b")))
        out["protobuf"] = rs.protobuf
    finally:
        await rs.close()
        await api.stop()
        store.stop()
    return out


@pytest.fixture(scope="module")
def http_runs():
    out = {}
    for root in PACKAGES:
        with Pinned(root):
            out[root] = asyncio.run(protobuf_http(root))
    return out


def test_protobuf_responses_match_the_reference_byte_for_byte(http_runs):
    got = http_runs["kubernetes_tpu_torch"]["raw"]
    assert got == http_runs["kubernetes_tpu"]["raw"]
    # single objects come back in the envelope, errors and lists as JSON
    kinds = [(r[0], r[2], r[3]) for r in got]
    assert kinds[0] == ("POST", 201, PROTOBUF_CT)
    assert kinds[1] == ("GET", 200, PROTOBUF_CT)
    assert kinds[2][1] == 409 and kinds[3][1] == 404
    assert kinds[4] == ("GET", 200, "application/json")


def test_protobuf_envelope_decodes_to_the_created_object(http_runs):
    from kubernetes_tpu_torch.apiserver.grpc_server import _unwrap, ktpu_pb2
    got = http_runs["kubernetes_tpu_torch"]["raw"]
    created = _unwrap(ktpu_pb2.Unknown.FromString(got[0][4]))
    fetched = _unwrap(ktpu_pb2.Unknown.FromString(got[1][4]))
    assert created == fetched
    assert created["metadata"]["name"] == "a"
    assert created["metadata"]["uid"].startswith("uid-")
    envelope = ktpu_pb2.Unknown.FromString(got[0][4])
    assert envelope.kind == "Pod" and envelope.api_version == "v1"
    assert envelope.content_type == "application/json"


def test_remote_store_protobuf_matches_the_reference(http_runs):
    port, ref = (http_runs[r] for r in ("kubernetes_tpu_torch",
                                        "kubernetes_tpu"))
    assert port["protobuf"] is True
    assert port["client"] == ref["client"]
    kinds = [r[0] for r in port["client"][:6]]
    assert kinds == ["ok", "ok", "NotFound", "AlreadyExists", "ok", "ok"]


# -- the reference's tests/test_grpc_wire.py cases, against the port ----------

def port_api():
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.grpc_server import (
        GRPCAPIServer,
        GRPCRemoteStore,
    )
    from kubernetes_tpu_torch.store import (
        install_core_validation,
        new_cluster_store,
    )
    return (make_node, make_pod, GRPCAPIServer, GRPCRemoteStore,
            install_core_validation, new_cluster_store)


async def _serve(store=None):
    _, _, GRPCAPIServer, _, install_core_validation, new_cluster_store = \
        port_api()
    store = store or new_cluster_store()
    install_core_validation(store)
    srv = GRPCAPIServer(store)
    await srv.start()
    return store, srv


def test_port_roundtrip_and_error_mapping():
    from kubernetes_tpu_torch.store.mvcc import (
        AlreadyExists,
        Conflict,
        NotFound,
    )
    make_node, make_pod, _, GRPCRemoteStore, _, _ = port_api()

    async def body():
        store, srv = await _serve()
        rs = GRPCRemoteStore(srv.target)
        try:
            created = await rs.create("pods", make_pod("a"))
            assert created["metadata"]["resourceVersion"]
            got = await rs.get("pods", "default/a")
            assert got["metadata"]["name"] == "a"
            with pytest.raises(AlreadyExists):
                await rs.create("pods", make_pod("a"))
            with pytest.raises(NotFound):
                await rs.get("pods", "default/nope")
            stale = dict(got)
            await rs.update("pods", got)
            with pytest.raises(Conflict):
                await rs.update("pods", stale)
            await rs.create("nodes", make_node("n1"))
            st = await rs.subresource(
                "pods", "default/a", "binding", {"target": {"name": "n1"}})
            assert st["status"] == "Success"
            bound = await rs.get("pods", "default/a")
            assert bound["spec"]["nodeName"] == "n1"
        finally:
            await rs.close()
            await srv.stop()
            store.stop()
    asyncio.run(body())


def test_port_guaranteed_update_cas():
    _, make_pod, _, GRPCRemoteStore, _, _ = port_api()

    async def body():
        store, srv = await _serve()
        rs = GRPCRemoteStore(srv.target)
        try:
            await rs.create("pods", make_pod("a"))

            def label(obj):
                obj["metadata"].setdefault("labels", {})["x"] = "1"
                return obj
            out = await rs.guaranteed_update("pods", "default/a", label)
            assert out["metadata"]["labels"]["x"] == "1"
        finally:
            await rs.close()
            await srv.stop()
            store.stop()
    asyncio.run(body())


def test_port_watch_streams_and_expires():
    from kubernetes_tpu_torch.store.mvcc import Expired, MVCCStore
    _, make_pod, GRPCAPIServer, GRPCRemoteStore, install, _ = port_api()

    async def body():
        small = MVCCStore(event_window=5)
        install(small)
        srv = GRPCAPIServer(small)
        await srv.start()
        rs = GRPCRemoteStore(srv.target)
        events = []

        async def consume():
            async for ev in await rs.watch("pods"):
                if ev.type != "BOOKMARK":
                    events.append((ev.type, ev.object["metadata"]["name"]))
                if len(events) >= 2:
                    return
        try:
            task = asyncio.ensure_future(consume())
            await asyncio.sleep(0.1)
            await rs.create("pods", make_pod("w1"))
            await rs.delete("pods", "default/w1")
            await asyncio.wait_for(task, timeout=5.0)
            assert events == [("ADDED", "w1"), ("DELETED", "w1")]
            for i in range(30):
                await rs.create("pods", make_pod(f"p{i}"))
            with pytest.raises(Expired):
                gen = await rs.watch("pods", resource_version=2)
                async for _ in gen:
                    break
        finally:
            await rs.close()
            await srv.stop()
            small.stop()
    asyncio.run(body())


def test_port_scheduler_binds_through_grpc():
    """The port's informers and scheduler, with `TorchBackend` on the CPU,
    run unchanged over the gRPC wire: the bind is a protobuf RPC."""
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.scheduler import Scheduler
    make_node, make_pod, _, GRPCRemoteStore, _, _ = port_api()

    async def body():
        store, srv = await _serve()
        rs = GRPCRemoteStore(srv.target)
        factory = InformerFactory(rs)
        sched = Scheduler(rs, seed=4, backend=TorchBackend(device="cpu"))
        task = None
        try:
            for i in range(3):
                await rs.create("nodes", make_node(f"n{i}"))
            await sched.setup_informers(factory)
            factory.start()
            await factory.wait_for_sync()
            task = asyncio.ensure_future(sched.run())
            for i in range(10):
                await rs.create("pods", make_pod(
                    f"p{i}", requests={"cpu": "100m"}))
            for _ in range(200):
                lst = await rs.list("pods")
                if sum(1 for p in lst.items
                       if p["spec"].get("nodeName")) == 10:
                    break
                await asyncio.sleep(0.05)
            lst = await rs.list("pods")
            assert sum(1 for p in lst.items
                       if p["spec"].get("nodeName")) == 10
            # the binds reached the backing store
            bound = (await store.list("pods")).items
            assert all(p["spec"].get("nodeName") for p in bound)
        finally:
            await sched.stop()
            if task is not None:
                task.cancel()
            factory.stop()
            await rs.close()
            await srv.stop()
            store.stop()
    asyncio.run(body())


def test_port_informer_syncs_over_grpc():
    from kubernetes_tpu_torch.client import (
        InformerFactory,
        ResourceEventHandler,
    )
    _, make_pod, _, GRPCRemoteStore, _, _ = port_api()

    async def body():
        store, srv = await _serve()
        rs = GRPCRemoteStore(srv.target)
        factory = InformerFactory(rs)
        try:
            for i in range(5):
                await store.create("pods", make_pod(f"p{i}"))
            inf = factory.informer("pods")
            adds = []
            inf.add_event_handler(ResourceEventHandler(
                on_add=lambda o: adds.append(o["metadata"]["name"])))
            factory.start()
            await factory.wait_for_sync()
            assert len(adds) == 5
            await store.create("pods", make_pod("live"))
            await asyncio.sleep(0.3)
            assert "live" in adds
        finally:
            factory.stop()
            await rs.close()
            await srv.stop()
            store.stop()
    asyncio.run(body())


# -- phase 22's runners and gates, on the CPU ------------------------------------

CELL = {"initNodes": 60, "initPods": 40, "measurePods": 200}


def transport_run(transport: str, before_stop=None, **kw):
    import chip_smoke
    from kubernetes_tpu_torch.ops.backend import TorchBackend
    from kubernetes_tpu_torch.perf.scheduler_perf import (
        SCHEDULING_BASIC,
        PerfRunner,
    )
    from kubernetes_tpu_torch.utils import flags

    runner = chip_smoke.transport_runner_cls(
        PerfRunner, transport, before_stop)(
        TorchBackend(device="cpu", max_batch=128), batch_size=256, **kw)
    with flags.scoped_set("KTPU_SOLVE_MODE", "auto"), \
            flags.scoped_set("KTPU_SERVING", "1"):
        result = asyncio.run(runner.run(
            SCHEDULING_BASIC["workloadTemplate"], CELL, timeout=300.0))
    pods = asyncio.run(runner.store.list("pods")).items
    nodes = asyncio.run(runner.store.list("nodes")).items
    return runner, result, pods, nodes


def test_phase_22a_runner_crosses_grpc_and_passes_its_gates():
    import chip_smoke
    from kubernetes_tpu_torch.apiserver import grpc_server

    calls = {"create": 0, "subresource": 0, "watch": 0}
    originals = {name: getattr(grpc_server.GRPCRemoteStore, name)
                 for name in calls}

    def counting(name):
        fn = originals[name]

        def wrapped(self, *a, **kw):
            calls[name] += 1
            return fn(self, *a, **kw)
        return wrapped

    for name in calls:
        setattr(grpc_server.GRPCRemoteStore, name, counting(name))
    try:
        runner, result, pods, nodes = transport_run("grpc")
    finally:
        for name, fn in originals.items():
            setattr(grpc_server.GRPCRemoteStore, name, fn)
    want = CELL["initPods"] + CELL["measurePods"]
    assert chip_smoke.transport_violations(
        runner, result, pods, nodes, want, 0, "GRPCRemoteStore") == []
    assert isinstance(runner.server, grpc_server.GRPCAPIServer)
    # every node and pod write, every bind and the informers' watches
    # crossed the gRPC client
    assert calls["create"] >= CELL["initNodes"] + want
    assert calls["subresource"] >= want and calls["watch"] > 0
    assert result.measured_pods == CELL["measurePods"]
    # the gates fire: a run whose store is not the gRPC client
    assert chip_smoke.transport_violations(
        runner, result, pods, nodes, want, 0, "RemoteStore")
    assert chip_smoke.transport_violations(
        runner, result, pods[:-1], nodes, want, 0, "GRPCRemoteStore")


def test_phase_22bc_protobuf_runner_and_cli_pass_their_gates():
    import chip_smoke

    seen = {}

    async def before_stop(runner, server, backing):
        seen.update(await chip_smoke.cli_phase(server.url, backing))

    runner, result, pods, nodes = transport_run(
        "protobuf", before_stop, policy_count=3)
    want = CELL["initPods"] + CELL["measurePods"]
    assert chip_smoke.transport_violations(
        runner, result, pods, nodes, want, 3, "RemoteStore") == []
    assert runner.client.protobuf and runner.protobuf_responses > 0
    assert seen["nodes"] == CELL["initNodes"] and seen["pods"] == want
    assert set(seen["seconds"]) == {
        "get nodes", "get pods -o json", f"describe nodes {seen['busiest']}",
        f"cordon {seen['busiest']}", f"uncordon {seen['busiest']}",
        "top nodes"}
    assert seen["busiest_pods"] > 0


def test_phase_22c_cli_checks_fail_on_a_wrong_store():
    """The CLI's checks compare against the store they are given: a
    store that lost a pod's binding fails `get pods -o json` and `top`."""
    import chip_smoke
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.store import (
        install_core_validation,
        new_cluster_store,
    )

    async def body():
        served = new_cluster_store()
        other = new_cluster_store()
        for store in (served, other):
            install_core_validation(store)
            await store.create("nodes", make_node("n0"))
        await served.create("pods", make_pod(
            "p0", node_name="n0", requests={"cpu": "1"}))
        await other.create("pods", make_pod("p0", requests={"cpu": "1"}))
        await other.create("pods", make_pod(
            "p1", node_name="n0", requests={"cpu": "1"}))
        server = APIServer(served)
        await server.start()
        try:
            ok = await chip_smoke.cli_phase(server.url, served)
            with pytest.raises(RuntimeError, match="22\\(c\\)"):
                await chip_smoke.cli_phase(server.url, other)
        finally:
            await server.stop()
            served.stop()
            other.stop()
        return ok

    ok = asyncio.run(body())
    assert ok["busiest"] == "n0" and ok["busiest_pods"] == 1
