"""The port's object store on the CPU against the JAX package's.

- One seeded sequence of creates, updates (fresh and stale
  resourceVersions), deletes, guaranteed updates and bindings (to a node,
  then to another: Conflict), duplicates (AlreadyExists) and invalid
  objects (Invalid) through `new_cluster_store()` with the core
  validation of each package: the same resource version, object and error
  (class and message) for every step, and the same watch events (plain,
  label-selector with the synthesized enter/leave, and the tracked
  spec.nodeName field) in the same order.
- LIST with selectors, field selectors, limits and pinned continue tokens:
  the same pages from both packages, and with the watch cache off
  (KTPU_WATCH_CACHE=0) the same as with it on.
- A tiny event window: an informer whose resourceVersion was compacted
  relists and converges to the store, in both packages.
- `new_cluster_store(shards=S)`: the plain store at S=1, the sharded
  store above it, with the same lists, RVs, routing and binding as the
  JAX package's.

Objects are compared without `metadata.uid` and
`metadata.creationTimestamp` (a random epoch and the wall clock).
Tolerance: none.
"""

import asyncio

import numpy as np
import pytest

from kubernetes_tpu.api import labels as jlabels
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.client import informer as jinformer
from kubernetes_tpu.store import mvcc as jmvcc
from kubernetes_tpu.store import validation as jvalidation
from kubernetes_tpu_torch.api import labels as tlabels
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.client import informer as tinformer
from kubernetes_tpu_torch.store import mvcc as tmvcc
from kubernetes_tpu_torch.store import validation as tvalidation

PACKAGES = {
    "jax": (jmvcc, jvalidation, jtypes, jlabels, jinformer),
    "port": (tmvcc, tvalidation, ttypes, tlabels, tinformer),
}


def norm(obj):
    """A wire object without its uid and creation timestamp."""
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()
                if k not in ("uid", "creationTimestamp")}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def script(seed: int, steps: int = 160) -> list[tuple]:
    """A seeded op sequence over 6 nodes and 12 pod names."""
    rng = np.random.default_rng(seed)
    ops = [("node", f"n{i}", {"labels": {"zone": "a" if i % 2 else "b"}})
           for i in range(6)]
    for _ in range(steps):
        u = rng.random()
        pod = f"p{int(rng.integers(0, 12))}"
        if u < 0.25:
            kw = {"requests": {"cpu": f"{int(rng.integers(1, 9)) * 100}m"}}
            if rng.random() < 0.5:
                kw["labels"] = {"app": "web"}
            if rng.random() < 0.08:
                kw["limits"] = {"cpu": "50m"}  # request above limit: Invalid
            ops.append(("create", pod, kw))
        elif u < 0.35:
            ops.append(("update", pod, bool(rng.random() < 0.3)))
        elif u < 0.5:
            ops.append(("label", pod, str(rng.choice(["web", "db"]))))
        elif u < 0.7:
            ops.append(("bind", pod, f"n{int(rng.integers(0, 6))}"))
        elif u < 0.8:
            ops.append(("delete", pod, None))
        elif u < 0.85:
            ops.append(("invalid", f"Bad_{pod}", None))
        else:
            ops.append(("node_update", f"n{int(rng.integers(0, 6))}",
                        bool(rng.random() < 0.5)))
    return ops


async def apply(pkg, ops) -> tuple[list, dict]:
    mvcc, validation, types, labels, _ = PACKAGES[pkg]
    store = mvcc.new_cluster_store()
    validation.install_core_validation(store)
    watches = {
        "pods": await store.watch("pods"),
        "web": await store.watch(
            "pods", selector=labels.parse_selector("app=web")),
        "on_n1": await store.watch("pods", fields={"spec.nodeName": "n1"}),
        "nodes": await store.watch("nodes"),
    }
    out = []
    for op, name, arg in ops:
        try:
            if op == "node":
                got = await store.create("nodes", types.make_node(name, **arg))
            elif op == "create":
                got = await store.create("pods", types.make_pod(name, **arg))
            elif op == "invalid":
                got = await store.create("pods", types.make_pod(name))
            elif op == "update":
                cur = await store.get("pods", f"default/{name}")
                cur["metadata"].setdefault("annotations", {})["touch"] = "1"
                if arg:  # a stale resourceVersion
                    cur["metadata"]["resourceVersion"] = "1"
                got = await store.update("pods", cur)
            elif op == "label":
                def mutate(p, v=arg):
                    p["metadata"]["labels"] = {"app": v}
                    return p
                got = await store.guaranteed_update(
                    "pods", f"default/{name}", mutate)
            elif op == "bind":
                cur = await store.get("pods", f"default/{name}")
                got = await store.subresource(
                    "pods", f"default/{name}", "binding",
                    types.make_binding(cur, arg))
            elif op == "delete":
                got = await store.delete("pods", f"default/{name}")
            else:  # node_update: cordon or uncordon
                def mutate(n, v=arg):
                    n.setdefault("spec", {})["unschedulable"] = v
                    return n
                got = await store.guaranteed_update("nodes", name, mutate)
            out.append(("ok", store.resource_version, norm(got)))
        except mvcc.StoreError as e:
            out.append(("err", type(e).__name__, str(e)))
    events = {}
    for what, w in watches.items():
        got = []
        while True:
            try:
                ev = await asyncio.wait_for(w.__anext__(), 0.05)
            except (asyncio.TimeoutError, StopAsyncIteration):
                break
            if ev.type != "BOOKMARK":
                got.append((ev.type, ev.rv, norm(ev.object)))
        events[what] = got
    store.stop()
    return out, events


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_op_sequence_matches_reference(seed):
    ops = script(seed)
    want, want_ev = asyncio.run(apply("jax", ops))
    got, got_ev = asyncio.run(apply("port", ops))
    assert got == want
    assert got_ev == want_ev
    kinds = {r[1] for r in want if r[0] == "err"}
    assert {"Conflict", "AlreadyExists", "Invalid", "NotFound"} <= kinds
    assert len(want_ev["web"]) and len(want_ev["on_n1"])
    assert any(t == "DELETED" for t, _, _ in want_ev["web"])


async def listing(pkg, seed: int) -> list:
    mvcc, validation, types, labels, _ = PACKAGES[pkg]
    store = mvcc.new_cluster_store()
    validation.install_core_validation(store)
    rng = np.random.default_rng(seed)
    for i in range(40):
        pod = types.make_pod(f"p{i:02d}", labels={"app": str(rng.choice(
            ["web", "db", "cache"]))})
        await store.create("pods", pod)
        if rng.random() < 0.5:
            await store.subresource(
                "pods", f"default/p{i:02d}", "binding",
                types.make_binding(pod, f"n{int(rng.integers(0, 3))}"))
    out = []
    sel = labels.parse_selector("app in (web,cache)")
    fields = labels.parse_field_selector("spec.nodeName=n1")
    for kw in ({}, {"selector": sel}, {"fields": fields},
               {"selector": sel, "fields": fields}):
        lst = await store.list("pods", **kw)
        out.append((lst.resource_version, norm(lst.items)))
    # Pages of 7, a write between pages: every page at the first's RV.
    page = await store.list("pods", limit=7)
    pages = [page]
    await store.create("pods", types.make_pod("late"))
    while page.cont:
        page = await store.list("pods", limit=7, continue_key=page.cont)
        pages.append(page)
    out.append([(p.resource_version, [norm(i) for i in p.items])
                for p in pages])
    store.stop()
    return out


def test_list_matches_reference_with_and_without_watch_cache(monkeypatch):
    want = asyncio.run(listing("jax", 5))
    assert asyncio.run(listing("port", 5)) == want
    assert len(want[-1]) == 6  # 40 pods in pages of 7, pinned
    monkeypatch.setenv("KTPU_WATCH_CACHE", "0")
    plain = asyncio.run(listing("port", 5))
    assert plain[:4] == want[:4]
    # Without the cache a page after a write is served at the current RV
    # (direct path), as in the reference.
    assert plain == asyncio.run(listing("jax", 5))


async def relist(pkg) -> tuple[list, list, list]:
    mvcc, _, types, _, informer = PACKAGES[pkg]
    store = mvcc.MVCCStore(event_window=5)
    seen = []
    inf = informer.SharedInformer(store, "pods")
    inf.add_event_handler(informer.ResourceEventHandler(
        on_add=lambda o: seen.append(("add", o["metadata"]["name"])),
        on_update=lambda a, b: seen.append(("update", b["metadata"]["name"])),
        on_delete=lambda o: seen.append(("delete", o["metadata"]["name"]))))
    for i in range(4):
        await store.create("pods", types.make_pod(f"p{i}"))
    inf.start()
    await inf.wait_for_sync()
    inf.stop()
    # Churn past the window while the reflector is down.
    for i in range(4, 20):
        await store.create("pods", types.make_pod(f"p{i}"))
    for i in range(0, 20, 3):
        await store.delete("pods", f"default/p{i}")
    with pytest.raises(mvcc.Expired):
        await store.watch("pods", resource_version=inf.last_rv)
    inf.start()
    for _ in range(400):
        await asyncio.sleep(0.005)
        if sorted(inf.indexer.keys()) == sorted(
                store._table("pods").keys()):
            break
    keys = sorted(inf.indexer.keys())
    want = sorted(store._table("pods").keys())
    inf.stop()
    store.stop()
    return keys, want, sorted(seen)


def test_tiny_event_window_relists_and_converges():
    keys, want, seen = asyncio.run(relist("port"))
    assert keys == want and len(want) == 13
    jkeys, jwant, jseen = asyncio.run(relist("jax"))
    assert (keys, want, seen) == (jkeys, jwant, jseen)
    assert ("delete", "p0") in seen and ("add", "p19") in seen


async def _sharded_script(mvcc, types, shards: int) -> dict:
    store = mvcc.new_cluster_store(shards=shards)
    out = {"type": type(store).__name__,
           "node_shards": getattr(store, "node_shards", 1)}
    for i in range(12):
        await store.create("nodes", types.make_node(f"node-{i}"))
    await store.create("pods", types.make_pod("p"))
    await store.subresource("pods", "default/p", "binding",
                            {"target": {"name": "node-3"}})
    lst = await store.list("nodes")
    out["nodes"] = [(o["metadata"]["name"], o["metadata"]["resourceVersion"])
                    for o in lst.items]
    out["rv"] = lst.resource_version
    out["bound"] = (await store.get("pods", "default/p"))["spec"]["nodeName"]
    if shards > 1:
        out["per_shard"] = [sorted(s._table("nodes")) for s in store.shards]
    store.stop()
    return out


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_new_cluster_store_builds_the_sharded_store(shards):
    got = asyncio.run(_sharded_script(tmvcc, ttypes, shards))
    want = asyncio.run(_sharded_script(jmvcc, jtypes, shards))
    assert got == want
    assert got["type"] == ("MVCCStore" if shards == 1
                           else "ShardedNodeStore")
    assert got["node_shards"] == shards and got["bound"] == "node-3"
