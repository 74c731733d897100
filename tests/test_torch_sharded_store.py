"""The port's sharded control plane store on the CPU against the JAX package's.

The same seeded op streams go to both packages' `new_cluster_store(shards=S)`
at S in {1, 2, 4, 8} (1 is the plain single `MVCCStore`; above it the
`ShardedNodeStore`), and every answer must be identical:

- merged LISTs (items, RVs and continue tokens), paginated at several
  limits, with label selectors, and a pinned pagination whose pages span
  writes made between them;
- the per-shard watch sequences and the multiplexed one (replayed from an
  RV, then live), and the merged bookmarks' RVs;
- `Expired` at the same RV, per shard and multiplexed;
- the binding subresource, routing (which shard holds each node-keyed
  object), the shared RV counter and the fanned-out event sinks;
- `shard_of` over 10,000 names at several shard counts, and
  `control_plane_shards` under KTPU_SHARDS and KTPU_SHARD_THRESHOLD.

Objects are compared without `metadata.uid` and
`metadata.creationTimestamp` (a random epoch and the wall clock).
Tolerance: none.
"""

import asyncio

import numpy as np
import pytest

from kubernetes_tpu.api import labels as jlabels
from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.store import mvcc as jmvcc
from kubernetes_tpu.store import sharded as jsharded
from kubernetes_tpu.store import validation as jvalidation
from kubernetes_tpu_torch.api import labels as tlabels
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.store import mvcc as tmvcc
from kubernetes_tpu_torch.store import sharded as tsharded
from kubernetes_tpu_torch.store import validation as tvalidation

PACKAGES = {
    "jax": (jmvcc, jsharded, jvalidation, jtypes, jlabels),
    "port": (tmvcc, tsharded, tvalidation, ttypes, tlabels),
}
SHARDS = (1, 2, 4, 8)


def norm(obj):
    """A wire object without its uid and creation timestamp."""
    if isinstance(obj, dict):
        return {k: norm(v) for k, v in obj.items()
                if k not in ("uid", "creationTimestamp")}
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def ops_script(seed: int, steps: int = 120) -> list[tuple]:
    """A seeded op stream over node-keyed objects (nodes, leases) and pods:
    creates, label updates, deletes and binds."""
    rng = np.random.default_rng(seed)
    ops = [("node", f"node-{int(rng.integers(0, 10_000))}-{i}",
            str(rng.choice(["a", "b", "c"]))) for i in range(40)]
    names = [n for _, n, _ in ops]
    for _ in range(steps):
        u = rng.random()
        node = names[int(rng.integers(0, len(names)))]
        pod = f"p{int(rng.integers(0, 16))}"
        if u < 0.2:
            ops.append(("relabel", node, str(rng.choice(["a", "b", "c"]))))
        elif u < 0.3:
            ops.append(("delete_node", node, None))
        elif u < 0.45:
            ops.append(("lease", node, None))
        elif u < 0.7:
            ops.append(("pod", pod, None))
        elif u < 0.9:
            ops.append(("bind", pod, node))
        else:
            ops.append(("delete_pod", pod, None))
    return ops


async def apply_ops(store, types, ops) -> list:
    """Apply `ops`; returns each step's (RV, object) or error class."""
    out = []
    for op, name, arg in ops:
        try:
            if op == "node":
                got = await store.create("nodes", types.make_node(
                    name, labels={"bucket": arg}))
            elif op == "relabel":
                def mutate(o, v=arg):
                    o["metadata"]["labels"] = {"bucket": v}
                    return o
                got = await store.guaranteed_update("nodes", name, mutate)
            elif op == "delete_node":
                got = await store.delete("nodes", name)
            elif op == "lease":
                got = await store.create("leases", {
                    "apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
                    "metadata": {"name": name,
                                 "namespace": "kube-node-lease"},
                    "spec": {"holderIdentity": name}})
            elif op == "pod":
                got = await store.create("pods", types.make_pod(name))
            elif op == "bind":
                got = await store.subresource(
                    "pods", f"default/{name}", "binding",
                    {"target": {"name": arg}})
            else:
                got = await store.delete("pods", f"default/{name}")
            out.append(("ok", store.resource_version, norm(got)))
        except Exception as e:
            out.append(("err", type(e).__name__, str(e)))
    return out


def page_view(res) -> tuple:
    return ([(o["metadata"]["name"], o["metadata"]["resourceVersion"])
             for o in res.items], res.resource_version, res.cont)


async def collect(watch, n: int) -> list:
    got = []

    async def take():
        async for ev in watch:
            got.append((ev.type, ev.rv,
                        ev.object["metadata"].get("name")))
            if sum(1 for t, _, _ in got if t != "BOOKMARK") >= n:
                return
    await asyncio.wait_for(take(), 10.0)
    return got


async def run_store(pkg: str, shards: int, seed: int) -> dict:
    mvcc, sharded, validation, types, labels = PACKAGES[pkg]
    store = mvcc.new_cluster_store(shards=shards)
    validation.install_core_validation(store)
    sinks: list = []
    store.add_event_sink(lambda res, ev: sinks.append(
        (res, ev.type, ev.rv)))
    out: dict = {"type": type(store).__name__,
                 "node_shards": getattr(store, "node_shards", 1)}
    ops = ops_script(seed)
    out["ops"] = await apply_ops(store, types, ops)
    out["rv"] = store.resource_version
    # Merged LISTs: whole, with a selector, and paginated.
    out["list"] = [norm(o) for o in (await store.list("nodes")).items]
    out["leases"] = page_view(await store.list("leases"))
    out["selected"] = page_view(await store.list(
        "nodes", selector=labels.parse_selector("bucket=b")))
    pages = {}
    for limit in (1, 7, 20):
        seen, cont = [], None
        while True:
            res = await store.list("nodes", limit=limit, continue_key=cont)
            seen.append(page_view(res))
            cont = res.cont
            if not cont:
                break
        pages[limit] = seen
    out["pages"] = pages
    # Pinned pagination across writes: the later pages serve the first
    # page's snapshot.
    first = await store.list("nodes", limit=9)
    await store.create("nodes", types.make_node("a-first-by-name"))
    name = first.items[-1]["metadata"]["name"]
    await store.guaranteed_update("nodes", name, lambda o: (
        o["metadata"].setdefault("labels", {}).update(late="1") or o))
    pinned, cont = [page_view(first)], first.cont
    while cont:
        res = await store.list("nodes", limit=9, continue_key=cont)
        pinned.append(page_view(res))
        cont = res.cont
    out["pinned"] = pinned
    # Watches: multiplexed from an RV (replay, then live), and per shard.
    mark = store.resource_version
    for i in range(6):
        await store.create("nodes", types.make_node(f"w-{i}"))
    merged = await store.watch("nodes", resource_version=mark)
    per_shard = []
    if shards > 1:
        per_shard = [await store.watch("nodes", resource_version=mark,
                                       shard=i) for i in range(shards)]
        out["route"] = {f"w-{i}": store.shard_index("nodes", f"w-{i}")
                        for i in range(6)}
        out["tables"] = [sorted(s._table("nodes")) for s in store.shards]
    for i in range(6, 9):
        await store.create("nodes", types.make_node(f"w-{i}"))
    got = await collect(merged, 9)
    out["merged_watch"] = sorted(e for e in got if e[0] != "BOOKMARK")
    out["merged_order"] = [e for e in got if e[0] != "BOOKMARK"]
    if shards > 1:
        counts = [sum(1 for i in range(9) if tsharded.shard_of(
            f"w-{i}", shards) == s) for s in range(shards)]
        out["shard_watches"] = [
            await collect(w, c) if c else [] for w, c in
            zip(per_shard, counts)]
    # Expired at the same RV, per shard and multiplexed.
    expired = []
    for kw in ([{}] + ([{"shard": 0}] if shards > 1 else [])):
        try:
            await store.watch("nodes", resource_version=10_000_000, **kw)
            expired.append(None)
        except mvcc.Expired as e:
            expired.append(str(e))
    out["expired"] = expired
    if shards > 1:
        for bad in (-1, shards):
            try:
                await store.list("nodes", shard=bad)
                out.setdefault("bad_shard", []).append(None)
            except mvcc.Invalid as e:
                out.setdefault("bad_shard", []).append(str(e))
    out["sinks"] = sinks
    store.stop()
    return out


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("seed", [3, 11])
def test_sharded_store_matches_the_reference(shards, seed):
    got = asyncio.run(run_store("port", shards, seed))
    want = asyncio.run(run_store("jax", shards, seed))
    assert got.keys() == want.keys()
    for key in got:
        assert got[key] == want[key], key
    assert got["type"] == ("MVCCStore" if shards == 1
                           else "ShardedNodeStore")
    # The pinned pages never show the write made between them.
    names = [n for page in got["pinned"] for n, _ in page[0]]
    assert "a-first-by-name" not in names
    assert any(t == "err" for t, *_ in got["ops"])
    assert any(t == "ok" for t, *_ in got["ops"])


@pytest.mark.parametrize("shards", SHARDS[1:])
def test_sharded_store_equals_the_single_store(shards):
    """The facade is invisible: the merged answers equal the single
    store's fed the same writes (the port's, at every shard count)."""
    one = asyncio.run(run_store("port", 1, 5))
    many = asyncio.run(run_store("port", shards, 5))
    for key in ("ops", "rv", "list", "leases", "selected", "pages",
                "pinned", "merged_watch"):
        assert one[key] == many[key], key
    # The multiplexed watch expires as the single store's does; the
    # per-shard one at the same RV with the same message.
    assert many["expired"] == one["expired"] * 2


def test_shard_of_over_ten_thousand_names():
    names = [f"node-{i}" for i in range(10_000)] + \
        [f"n{i:05d}.zone-{i % 7}" for i in range(0, 10_000, 37)]
    for s in (1, 2, 3, 4, 8, 16):
        got = [tsharded.shard_of(n, s) for n in names]
        assert got == [jsharded.shard_of(n, s) for n in names]
        if s > 1:
            counts = np.bincount(got[:10_000], minlength=s)
            assert counts.min() > 10_000 / s * 0.8


def test_control_plane_shards_policy(monkeypatch):
    cases = [((5_000,), {}), ((50_000,), {}), ((99_999,), {}),
             ((100_000,), {}), ((200_000,), {}), ((200_000, 4), {}),
             ((100, 2), {}), ((100,), {"KTPU_SHARDS": "6"}),
             ((200_000,), {"KTPU_SHARDS": "0"}),
             ((200_000,), {"KTPU_SHARDS": "1"}),
             ((100,), {"KTPU_SHARD_THRESHOLD": "50"}),
             ((49,), {"KTPU_SHARD_THRESHOLD": "50"}),
             ((100,), {"KTPU_SHARD_THRESHOLD": "junk"})]
    for args, env in cases:
        monkeypatch.delenv("KTPU_SHARDS", raising=False)
        monkeypatch.delenv("KTPU_SHARD_THRESHOLD", raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = tsharded.control_plane_shards(*args)
        assert got == jsharded.control_plane_shards(*args), (args, env)
    monkeypatch.delenv("KTPU_SHARDS", raising=False)
    monkeypatch.delenv("KTPU_SHARD_THRESHOLD", raising=False)
    assert tsharded.control_plane_shards(200_000) == 8
    assert tsharded.control_plane_shards(50_000) == 1
    monkeypatch.setenv("KTPU_SHARDS", "3")
    store = tmvcc.new_cluster_store()
    assert isinstance(store, tsharded.ShardedNodeStore)
    assert store.node_shards == 3
    store.stop()


def test_shared_observability_surfaces():
    async def go():
        s = tsharded.ShardedNodeStore(4)
        for i in range(8):
            await s.create("nodes", ttypes.make_node(f"o-{i}"))
        assert s.cacher is s.meta.cacher
        for shard in s.shards:
            assert shard.cacher.metrics is s.cacher.metrics
            assert shard.watch_metrics is s.watch_metrics
        h0 = s.cacher.metrics.hits.value()
        await s.list("nodes")
        assert s.cacher.metrics.hits.value() >= h0 + s.node_shards
        dump = s.dump()
        s.stop()
        return dump

    assert '"o-7"' in asyncio.run(go())
