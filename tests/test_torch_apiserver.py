"""The port's apiserver boundary (`APIServer` + `RemoteStore`) on the CPU
against the JAX package's, by one serial script run through each.

Each package serves an `MVCCStore` (32-event window) with its core
validation, a mutating and a validating webhook (one local aiohttp
server plays both for both packages), a ValidatingAdmissionPolicy that
denies pods named `denied-*`, RBAC over three bearer tokens, an audit
pipeline at Metadata for pods, APF levels and a metrics registry. The
script (`store_script`, which `test_torch_wire.py` runs over the KTPU
wire too) covers create, get, update, guaranteed_update, merge and JSON
patches, server-side apply with its conflict, the binding subresource and
delete; lists with label and field selectors and continue tokens; a watch
replayed from a resource version up to a bookmark, and a 410 once the
version left the window; RBAC denials (a viewer's create, an impersonated
create); an APF rejection (every workload seat held); the webhook's
mutation and denial; and a `PolicyDenied`. Raw HTTP requests add the
status codes and bodies (discovery, dryRun, a bad selector, an apply
without a field manager, a 401, a 403 and a 410 watch). Results, bodies
with their resource versions, error types and messages and event
sequences must be identical; uids, timestamps and audit ids are masked.

The port's refusal: a request accepting the protobuf content type gets
406 naming `apiserver/grpc_server.py` (and `RemoteStore(protobuf=True)`
raises). The `data_dir` bootstrap is held against the reference in
`test_torch_durability.py`.

Tolerance: none (exact host logic).
"""

import asyncio
import copy
import tempfile
from importlib import import_module

import aiohttp
import pytest
from aiohttp import web

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
MASKED = ("uid", "creationTimestamp", "time", "auditID", "stageTimestamp")
EVENT_WINDOW = 32
TOKENS = {"admin-token": "admin", "viewer-token": "viewer"}


def masked(value):
    if isinstance(value, dict):
        return {k: "<masked>" if k in MASKED else masked(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [masked(v) for v in value]
    return value


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


@pytest.fixture
def reference_wire_in_tmpdir(monkeypatch):
    """The JAX package's `WireServer.for_apiserver(host="unix:")`, as its
    runner calls it, binds a fixed path under /tmp; bind it in a private
    directory of the temporary directory instead. Yields that directory."""
    from kubernetes_tpu.apiserver import wire as jwire

    made = jwire.WireServer.for_apiserver
    with tempfile.TemporaryDirectory(prefix="ktpu-") as d:
        def for_apiserver(api, *, host="127.0.0.1", port=0):
            if host == "unix:":
                host = f"unix:{d}/jax.sock"
            return made(api, host=host, port=port)

        monkeypatch.setattr(jwire.WireServer, "for_apiserver",
                            staticmethod(for_apiserver))
        yield d


# -- the webhook -------------------------------------------------------------

async def webhook_server():
    """One local server playing both webhooks: /mutate adds the label
    `injected: "true"` to every pod create, /validate denies a pod that
    carries the annotation `forbidden: "true"`."""
    async def mutate(request):
        review = await request.json()
        meta = review["request"]["object"]["metadata"]
        labels = {**(meta.get("labels") or {}), "injected": "true"}
        return web.json_response({"response": {
            "allowed": True,
            "patch": [{"op": "add", "path": "/metadata/labels",
                       "value": labels}]}})

    async def validate(request):
        review = await request.json()
        meta = review["request"]["object"]["metadata"]
        ok = (meta.get("annotations") or {}).get("forbidden") != "true"
        return web.json_response({"response": {
            "allowed": ok, "status": {"message": "forbidden annotation"}}})

    app = web.Application()
    app.router.add_post("/mutate", mutate)
    app.router.add_post("/validate", validate)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    port = site._server.sockets[0].getsockname()[1]
    return runner, f"http://127.0.0.1:{port}"


# -- one package's cluster ---------------------------------------------------

class Cluster:
    """A package's backing store with its policy objects, and an
    `APIServer` over it with the admission chain, RBAC, audit and APF."""

    def __init__(self, root: str):
        self.root = root
        self.api = None
        self.store = None

    async def start(self, hook_url: str) -> None:
        root = self.root
        mvcc = mod(root, "store.mvcc")
        types = mod(root, "api.types")
        policy = mod(root, "policy")
        rbac = mod(root, "apiserver.rbac")
        server = mod(root, "apiserver.server")
        store = mvcc.MVCCStore(event_window=EVENT_WINDOW)
        store.register_subresource("pods", "binding",
                                   mvcc.binding_subresource)
        mod(root, "store").install_core_validation(store)
        self.store = store
        await store.create("mutatingwebhookconfigurations", {
            "kind": "MutatingWebhookConfiguration",
            "metadata": {"name": "inject"},
            "webhooks": [{"name": "inject.ktpu.dev", "failurePolicy": "Fail",
                          "clientConfig": {"url": hook_url + "/mutate"},
                          "rules": [{"resources": ["pods"],
                                     "operations": ["CREATE"]}]}]})
        await store.create("validatingwebhookconfigurations", {
            "kind": "ValidatingWebhookConfiguration",
            "metadata": {"name": "check"},
            "webhooks": [{"name": "check.ktpu.dev", "failurePolicy": "Fail",
                          "clientConfig": {"url": hook_url + "/validate"},
                          "rules": [{"resources": ["pods"],
                                     "operations": ["CREATE"]}]}]})
        await store.create(
            "validatingadmissionpolicies",
            types.make_validating_admission_policy("no-denied", [
                {"expression":
                 "not object.metadata.name.startsWith('denied')",
                 "message": "names starting with denied are refused"}],
                match_constraints={"resourceRules": [
                    {"resources": ["pods"], "operations": ["CREATE"]}]}))
        await store.create("validatingadmissionpolicybindings",
                           types.make_vap_binding("no-denied-b",
                                                  "no-denied"))
        await store.create("nodes", types.make_node("n1"))
        engine = policy.PolicyEngine(store)
        admission = mod(root, "apiserver.admission").WebhookAdmission(
            store, policy_engine=engine)
        authz = rbac.RBACAuthorizer(
            [rbac.make_cluster_role("admin", [{"verbs": ["*"],
                                               "resources": ["*"]}]),
             rbac.make_cluster_role("viewer", [
                 {"verbs": ["get", "list", "watch"],
                  "resources": ["pods"]}])],
            [rbac.make_cluster_role_binding("admin-b", "admin", ["admin"]),
             rbac.make_cluster_role_binding("viewer-b", "viewer",
                                            ["viewer"])])
        audit = policy.AuditPipeline(policy.AuditPolicy(
            [{"level": "Metadata", "resources": ["pods"]}]))
        levels = {
            "system": server.PriorityLevel("system", seats=8),
            # queue_limit 0: a request finding every seat held is refused
            # at once (429), whatever the timing.
            "workload": server.PriorityLevel("workload", seats=64,
                                             queue_limit=0, num_queues=1),
        }
        self.api = server.APIServer(
            store, priority_levels=levels, bearer_tokens=TOKENS,
            authorizer=authz, admission=admission, audit=audit,
            metrics_registry=mod(root, "metrics.registry").Registry())
        await self.api.start()
        self.engine, self.audit = engine, audit

    async def stop(self) -> None:
        if self.api is not None:
            await self.api.stop()
        if self.store is not None:
            self.store.stop()


# -- the script --------------------------------------------------------------

async def attempt(coro):
    """A call's result, masked (a list as its items and resource
    version), or the error's type and message."""
    try:
        got = await coro
    except Exception as e:  # the error itself is compared
        return (type(e).__name__, str(e))
    if hasattr(got, "items") and hasattr(got, "resource_version"):
        return ("ok", masked(got.items), got.resource_version, got.cont)
    return ("ok", masked(got))


def names(items) -> list:
    return [(o["metadata"].get("namespace"), o["metadata"]["name"],
             o["metadata"]["resourceVersion"]) for o in items]


async def watch_until_bookmark(client, resource, rv, **kw) -> list:
    """The events a watch from `rv` replays, up to and including the first
    bookmark (the store's bookmark interval is shortened for the test)."""
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


async def store_script(root: str, cluster: Cluster, client, viewer,
                       impersonating) -> dict:
    """The serial script over `client` (RemoteStore or WireStore, as
    `admin`), `viewer` (as `viewer`) and `impersonating` (as admin
    impersonating viewer). Returns {section: records}."""
    types = mod(root, "api.types")
    labels = mod(root, "api.labels")
    out = {}
    rec = out.setdefault("crud", [])
    for i in range(6):
        pod = types.make_pod(f"p{i}", "other" if i == 5 else "default",
                             labels={"app": ("web", "db")[i % 2]})
        rec.append(await attempt(client.create("pods", pod)))
    rv_after_creates = int(rec[-1][1]["metadata"]["resourceVersion"])
    rec.append(await attempt(client.create("pods", types.make_pod(
        "denied-1", "default"))))
    bad = types.make_pod("forbid", "default")
    bad["metadata"]["annotations"] = {"forbidden": "true"}
    rec.append(await attempt(client.create("pods", bad)))
    rec.append(await attempt(client.get("pods", "default/p0")))
    rec.append(await attempt(client.get("pods", "default/nope")))
    cur = copy.deepcopy(await client.get("pods", "default/p0"))
    stale = copy.deepcopy(cur)
    cur["metadata"]["labels"]["tier"] = "gold"
    rec.append(await attempt(client.update("pods", cur)))
    stale["metadata"]["labels"]["tier"] = "stale"
    rec.append(await attempt(client.update("pods", stale)))

    def annotate(obj):
        obj["metadata"].setdefault("annotations", {})["seen"] = "yes"
        return obj

    rec.append(await attempt(client.guaranteed_update("pods", "default/p1",
                                                      annotate)))
    if hasattr(client, "patch"):
        rec.append(await attempt(client.patch(
            "pods", "default/p2", {"metadata": {"labels": {"x": "1"}}})))
        rec.append(await attempt(client.patch(
            "pods", "default/p2", {"metadata": {"labels": {"x": None}}},
            patch_type="merge")))
        rec.append(await attempt(client.patch(
            "pods", "default/p2",
            [{"op": "add", "path": "/metadata/annotations",
              "value": {"j": "2"}}], patch_type="json")))
    dep = {"apiVersion": "apps/v1", "kind": "Deployment",
           "metadata": {"name": "web", "namespace": "default"},
           "spec": {"replicas": 2}}
    rec.append(await attempt(client.apply("deployments", dep,
                                          field_manager="a")))
    rec.append(await attempt(client.apply(
        "deployments", {**dep, "spec": {"replicas": 3}}, field_manager="b")))
    rec.append(await attempt(client.apply(
        "deployments", {**dep, "spec": {"replicas": 3}}, field_manager="b",
        force=True)))
    p3 = await client.get("pods", "default/p3")
    rec.append(await attempt(client.subresource(
        "pods", "default/p3", "binding", types.make_binding(p3, "n1"))))
    rec.append(await attempt(client.delete("pods", "default/p4")))
    rec.append(await attempt(client.delete("pods", "default/p4")))
    rec.append(await attempt(client.delete("pods", "default/p1",
                                           uid="not-the-uid")))

    # A burst of creates issued in one tick (one `multi` frame on the
    # wire), enough writes to push the first ones out of the window.
    rec = out.setdefault("bulk", [])
    results = await asyncio.gather(*(
        attempt(client.create("configmaps", types.make_config_map(
            f"cm{i}", "default", {"i": str(i)}))) for i in range(40)))
    rec.extend(results)

    rec = out.setdefault("list", [])
    lst = await client.list("pods")
    rec.append(names(lst.items))
    web_sel = labels.parse_selector("app=web")
    rec.append(names((await client.list("pods", selector=web_sel)).items))
    rec.append(names((await client.list("pods", namespace="other")).items))
    rec.append(names((await client.list(
        "pods", fields={"spec.nodeName": "n1"})).items))
    pages, token = [], None
    while True:
        page = await client.list("configmaps", limit=7, continue_key=token)
        pages.append((names(page.items), page.resource_version))
        token = page.cont
        if not token:
            break
    rec.append(pages)
    rec.append(await attempt(client.list("pods", selector=web_sel,
                                         limit=1)))

    rec = out.setdefault("watch", [])
    recent = int((await client.list("configmaps")).resource_version) - 5
    rec.append(await watch_until_bookmark(client, "configmaps", recent))
    rec.append(await watch_until_bookmark(client, "pods", rv_after_creates,
                                          selector=web_sel))

    async def expired():
        watch = await client.watch("pods", resource_version=2)
        async for ev in watch:
            return ev.type
    rec.append(await attempt(expired()))

    rec = out.setdefault("rbac", [])
    rec.append(names((await viewer.list("pods")).items))
    rec.append(await attempt(viewer.create("pods", types.make_pod(
        "v1", "default"))))
    rec.append(await attempt(impersonating.create("pods", types.make_pod(
        "i1", "default"))))
    rec.append(await attempt(impersonating.list("pods")))

    rec = out.setdefault("apf", [])
    level = cluster.api.priority_levels["workload"]
    for _ in range(level.seats):
        await level.acquire("holder")
    try:
        rec.append(await attempt(client.get("pods", "default/p0")))
    finally:
        for _ in range(level.seats):
            level.release()
    rec.append(await attempt(client.get("pods", "default/p0")))
    rec.append((level.in_use, level.queued))

    rec = out.setdefault("policy", [])
    eng = cluster.engine
    rec.append((sum(eng.evaluations._values.values()),
                sum(eng.rejections._values.values()),
                eng.index_hits.value()))
    await cluster.audit.close()
    rec.append(masked(cluster.audit.sink.entries))
    return out


async def raw_http(url: str) -> list:
    """Status codes and bodies of raw requests, as admin unless noted."""
    admin = {"Authorization": "Bearer admin-token"}
    pods = url + "/api/v1/namespaces/default/pods"
    reqs = [
        ("GET", url + "/api", admin, None),
        ("GET", url + "/apis", admin, None),
        ("GET", url + "/api/v1", admin, None),
        ("GET", url + "/openapi/v2", admin, None),
        ("GET", pods + "?labelSelector=app%3Dweb&limit=1", admin, None),
        ("GET", pods + "?labelSelector=app%3D%3D%3D", admin, None),
        ("POST", pods + "?dryRun=All", admin,
         {"metadata": {"name": "dry"}, "spec": {"containers": [
             {"name": "c", "image": "i"}]}}),
        ("POST", pods, admin, {"metadata": {"name": "raw"}, "spec": {
            "containers": [{"name": "c", "image": "i"}]}}),
        ("PUT", pods + "/raw/status", admin,
         {"status": {"phase": "Running"}}),
        ("PATCH", pods + "/raw", {**admin, "Content-Type":
                                  "application/apply-patch+yaml"},
         {"metadata": {"name": "raw"}}),
        ("DELETE", pods + "/raw", admin, None),
        ("GET", pods + "?watch=1&resourceVersion=2", admin, None),
        ("GET", pods, {}, None),
        ("GET", pods, {"Authorization": "Bearer wrong"}, None),
        ("GET", pods + "/nope", admin, None),
        ("GET", url + "/healthz", {}, None),
    ]
    out = []
    timeout = aiohttp.ClientTimeout(total=20.0)
    async with aiohttp.ClientSession(timeout=timeout) as s:
        for method, u, headers, body in reqs:
            kw = {"headers": dict(headers)}
            if body is not None:
                kw["json"] = body
            async with s.request(method, u, **kw) as resp:
                text = await resp.text()
                try:
                    import json
                    parsed = masked(json.loads(text))
                except ValueError:
                    parsed = text
                out.append((method, u.replace(url, ""), resp.status, parsed))
        # The registered families (their TYPE lines): which samples a
        # family holds depends on when the server noticed a closed watch.
        async with s.get(url + "/metrics") as resp:
            out.append(sorted(line for line in (await resp.text()).splitlines()
                              if line.startswith("# TYPE ")))
    return out


async def http_run(root: str, hook_url: str) -> dict:
    client_mod = mod(root, "apiserver.client")
    cluster = Cluster(root)
    clients = []
    try:
        await cluster.start(hook_url)
        url = cluster.api.url
        client = client_mod.RemoteStore(url, token="admin-token")
        viewer = client_mod.RemoteStore(url, token="viewer-token")
        imp = client_mod.RemoteStore(url, token="admin-token",
                                     impersonate="viewer")
        clients = [client, viewer, imp]
        out = await store_script(root, cluster, client, viewer, imp)
        out["raw"] = await raw_http(url)
        return out
    finally:
        for c in clients:
            await c.close()
        await cluster.stop()


@pytest.fixture(scope="module")
def runs():
    """The script through each package's HTTP server, once per module."""
    mvccs = [mod(root, "store.mvcc") for root in PACKAGES]
    old = [m.BOOKMARK_INTERVAL_S for m in mvccs]

    async def both():
        hook, hook_url = await webhook_server()
        try:
            return {root: await http_run(root, hook_url)
                    for root in PACKAGES}
        finally:
            await hook.cleanup()

    for m in mvccs:
        m.BOOKMARK_INTERVAL_S = 0.05
    try:
        return asyncio.run(both())
    finally:
        for m, v in zip(mvccs, old):
            m.BOOKMARK_INTERVAL_S = v


SECTIONS = ("crud", "bulk", "list", "watch", "rbac", "apf", "policy", "raw")


@pytest.mark.parametrize("section", SECTIONS)
def test_http_script_matches_the_reference(runs, section):
    want = runs["kubernetes_tpu"][section]
    got = runs["kubernetes_tpu_torch"][section]
    assert got == want


def test_the_script_reaches_every_path(runs):
    out = runs["kubernetes_tpu"]
    kinds = [r[0] for r in out["crud"]]
    for k in ("ok", "Invalid", "NotFound", "Conflict"):
        assert k in kinds, k
    assert out["crud"][0][1]["metadata"]["labels"]["injected"] == "true"
    assert any("denied the request" in str(r) for r in out["crud"])
    assert any("names starting with denied" in str(r) for r in out["crud"])
    pages = out["list"][4]
    assert len(pages) == 6 and sum(len(p[0]) for p in pages) == 40
    watch = out["watch"]
    assert watch[0][-1][0] == "BOOKMARK" and len(watch[0]) == 6
    assert {e[0] for e in watch[1][:-1]} == {"MODIFIED", "DELETED"}
    assert watch[2][0] == "Expired"
    assert out["rbac"][1][0] == "StoreError" and "cannot create" in \
        out["rbac"][1][1]
    assert out["apf"][0][0] == "StoreError" and out["apf"][1][0] == "ok"
    evals, denials, _ = out["policy"][0]
    assert evals > 0 and denials == 1
    statuses = [r[2] for r in out["raw"][:-1]]
    for code in (200, 201, 400, 401, 403, 404, 410):
        assert code in statuses, code


def test_protobuf_is_refused():
    from kubernetes_tpu_torch.apiserver.client import RemoteStore
    from kubernetes_tpu_torch.apiserver.server import PROTOBUF_NOT_PORTED
    from kubernetes_tpu_torch.store import install_core_validation
    from kubernetes_tpu_torch.store import new_cluster_store

    with pytest.raises(NotImplementedError, match="grpc_server.py"):
        RemoteStore("http://127.0.0.1:1", protobuf=True)

    async def body():
        store = new_cluster_store()
        install_core_validation(store)
        server = mod("kubernetes_tpu_torch", "apiserver.server").APIServer(
            store)
        await server.start()
        try:
            async with aiohttp.ClientSession() as s:
                url = server.url + "/api/v1/namespaces/default/pods"
                async with s.post(url, json={"metadata": {"name": "a"},
                                             "spec": {"containers": [
                                                 {"name": "c"}]}},
                                  headers={"Accept":
                                           "application/vnd.kubernetes."
                                           "protobuf"}) as resp:
                    status, body = resp.status, await resp.json()
            # refused before the write: nothing was created
            listed = (await store.list("pods")).items
        finally:
            await server.stop()
            store.stop()
        return status, body, listed

    status, body, listed = asyncio.run(body())
    assert status == 406 and body["reason"] == "NotAcceptable"
    assert body["message"] == PROTOBUF_NOT_PORTED and listed == []


