"""The port's scheduler extenders (`scheduler/extender.py`: `HTTPExtender`
and `ExtenderServer`) and the Scheduler's extender hooks (filter,
prioritize fan-out, bind), on the CPU against the JAX package's.

Each case runs both packages' `Scheduler`s (host path, seed 42, pods
created before the loop starts, uids and timestamps pinned) against one
in-process `ExtenderServer` of the case's package: the placements, the
FailedScheduling events of unschedulable pods and every request the
extender received (verb and body) must be the reference's. The cases:
filter narrowing the feasible set, filter rejecting every node, weighted
prioritize steering the choice, the bind verb replacing the default
binder, node-cache-capable names-only requests, an ignorable extender
that is down, a pod outside the extender's managed resources. Unit
checks: a non-ignorable extender that is down raises ExtenderError,
`is_interested`, `from_config`, and the two servers' raw responses.

Tolerance: none (exact host logic).
"""

import asyncio
import itertools
from importlib import import_module

import aiohttp
import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
STAMP = "2026-01-01T00:00:00Z"
NODE = {"cpu": "8", "memory": "16Gi", "pods": "110"}
GPU = "example.com/gpu"


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


@pytest.fixture(autouse=True)
def pinned(monkeypatch):
    for root in PACKAGES:
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            monkeypatch.setattr(mod(root, sub), "new_uid",
                                lambda seq=seq: f"uid-{next(seq)}")
        monkeypatch.setattr(mod(root, "api.meta"), "now_iso", lambda: STAMP)


def keep_n2(pod, names):
    return ([n for n in names if n == "n2"],
            {n: "extender says no" for n in names if n != "n2"})


def reject_all(pod, names):
    return [], {n: f"no room on {n}" for n in names}


def prefer_n1(pod, names):
    return {"n1": 10, "n3": 4}


#: case -> (ExtenderServer callbacks, HTTPExtender options, pods' requests)
CASES = {
    "filter": ({"filter_fn": keep_n2}, {"filter_verb": "filter"}, None),
    "filter-none": ({"filter_fn": reject_all}, {"filter_verb": "filter"},
                    None),
    "prioritize": ({"prioritize_fn": prefer_n1},
                   {"prioritize_verb": "prioritize", "weight": 100}, None),
    "filter-prioritize": ({"filter_fn": keep_n2, "prioritize_fn": prefer_n1},
                          {"filter_verb": "filter",
                           "prioritize_verb": "prioritize", "weight": 3},
                          None),
    "bind": ({"bind": True}, {"bind_verb": "bind"}, None),
    "node-cache": ({"filter_fn": lambda pod, names: (names[1:], {})},
                   {"filter_verb": "filter", "node_cache_capable": True},
                   None),
    "ignorable-down": (None, {"filter_verb": "filter", "ignorable": True,
                              "timeout": 0.5}, None),
    "unmanaged": ({"filter_fn": reject_all},
                  {"filter_verb": "filter", "managed_resources": [GPU]},
                  {"cpu": "100m"}),
}


def failed_scheduling(events) -> dict:
    """{pod name: sorted distinct FailedScheduling messages}."""
    out: dict = {}
    for ev in events:
        if ev.get("reason") == "FailedScheduling":
            name = (ev.get("involvedObject") or {}).get("name")
            out.setdefault(name, set()).add(ev.get("message"))
    return {k: sorted(v) for k, v in sorted(out.items())}


async def drive(root: str, case: str, server_root: str) -> dict:
    """One case through `root`'s Scheduler against an ExtenderServer of
    `server_root`."""
    callbacks, options, requests = CASES[case]
    types = mod(root, "api.types")
    store_mod = mod(root, "store")
    store = store_mod.new_cluster_store()
    store_mod.install_core_validation(store)
    for i in range(4):
        await store.create("nodes", types.make_node(f"n{i}",
                                                    allocatable=NODE))
    for i in range(3):
        await store.create("pods", types.make_pod(
            f"p{i}", "default", requests=requests or {"cpu": "100m"}))
    srv = None
    url = "http://127.0.0.1:1"  # nothing listens: the extender is down
    if callbacks is not None:
        kw = dict(callbacks)
        if kw.pop("bind", False):
            def bind_fn(args):
                asyncio.ensure_future(store.subresource(
                    "pods", f"{args['podNamespace']}/{args['podName']}",
                    "binding", {"target": {"name": args["node"]}}))
                return None
            kw["bind_fn"] = bind_fn
        srv = mod(server_root, "scheduler.extender").ExtenderServer(**kw)
        await srv.start()
        url = srv.url
    sched = mod(root, "scheduler").Scheduler(store, seed=42)
    sched.extenders = [mod(root, "scheduler.extender").HTTPExtender(
        url, name="demo", **options)]
    factory = mod(root, "client").InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    await factory.wait_for_sync()
    task = asyncio.ensure_future(sched.run())
    try:
        for _ in range(1000):
            pods = (await store.list("pods")).items
            refused = failed_scheduling((await store.list("events")).items)
            if all(p["spec"].get("nodeName") or p["metadata"]["name"]
                   in refused for p in pods):
                break
            await asyncio.sleep(0.02)
        else:
            raise AssertionError(f"{case}: pods neither bound nor refused")
    finally:
        await sched.stop()
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)
        factory.stop()
        if srv is not None:
            await srv.stop()
    out = {"placements": {p["metadata"]["name"]: p["spec"].get("nodeName")
                          for p in pods},
           "refused": refused,
           "requests": [] if srv is None else list(srv.requests)}
    store.stop()
    return out


@pytest.mark.parametrize("server_root", PACKAGES)
@pytest.mark.parametrize("case", list(CASES))
def test_scheduler_with_extender_matches_the_reference(case, server_root):
    got = {root: asyncio.run(drive(root, case, server_root))
           for root in PACKAGES}
    ref, port = got[PACKAGES[0]], got[PACKAGES[1]]
    assert port == ref
    placed = port["placements"]
    verbs = [v for v, _ in port["requests"]]
    if case in ("filter", "filter-prioritize"):
        assert set(placed.values()) == {"n2"} and "filter" in verbs
    elif case == "filter-none":
        assert set(placed.values()) == {None}
        assert sorted(port["refused"]) == ["p0", "p1", "p2"]
        assert all("no room on" in str(m) for m in port["refused"].values())
    elif case == "prioritize":
        assert set(placed.values()) == {"n1"}
        assert verbs.count("prioritize") == 3
    elif case == "bind":
        assert None not in placed.values() and verbs.count("bind") == 3
    elif case == "node-cache":
        assert None not in placed.values()
        assert all("nodenames" in args and "nodes" not in args
                   for _, args in port["requests"])
    elif case == "ignorable-down":
        assert None not in placed.values()
    elif case == "unmanaged":
        assert None not in placed.values() and verbs == []


@pytest.mark.parametrize("root", PACKAGES)
def test_non_ignorable_extender_down_raises(root):
    ext_mod = mod(root, "scheduler.extender")
    types = mod(root, "scheduler.types")
    api_types = mod(root, "api.types")

    async def body():
        ext = ext_mod.HTTPExtender("http://127.0.0.1:1",
                                   filter_verb="filter", timeout=0.5,
                                   name="down")
        nodes = [types.NodeInfo(api_types.make_node("n0", allocatable=NODE))]
        pod = types.PodInfo(api_types.make_pod("p", requests={"cpu": "1"}))
        try:
            with pytest.raises(ext_mod.ExtenderError):
                await ext.filter(pod, nodes)
            # prioritize swallows the error and scores nothing
            ext.prioritize_verb = "prioritize"
            assert await ext.prioritize(pod, nodes) == {}
        finally:
            await ext.close()
    asyncio.run(body())


def test_interest_and_from_config_match_the_reference():
    cfg = {"urlPrefix": "http://127.0.0.1:9999/scheduler/",
           "filterVerb": "filter", "prioritizeVerb": "prioritize",
           "bindVerb": "bind", "weight": 5, "nodeCacheCapable": True,
           "ignorable": True, "httpTimeout": "500ms",
           "managedResources": [{"name": GPU, "ignoredByScheduler": True}]}
    views = {}
    for root in PACKAGES:
        ext_mod = mod(root, "scheduler.extender")
        types = mod(root, "scheduler.types")
        make_pod = mod(root, "api.types").make_pod
        ext = ext_mod.HTTPExtender.from_config(cfg)
        plain = types.PodInfo(make_pod("p", requests={"cpu": "1"}))
        gpu = types.PodInfo(make_pod("g", requests={GPU: "1"}))
        views[root] = (
            ext.url_prefix, ext.filter_verb, ext.prioritize_verb,
            ext.bind_verb, ext.weight, ext.node_cache_capable,
            ext.ignorable, sorted(ext.managed_resources), ext.timeout,
            ext.name, ext.is_binder(), ext.is_interested(plain),
            ext.is_interested(gpu),
            [ext_mod._parse_duration(s) for s in ("2s", "250ms", "1m", 3,
                                                  "1.5")])
    assert views[PACKAGES[1]] == views[PACKAGES[0]]
    view = views[PACKAGES[1]]
    assert view[8] == pytest.approx(0.5) and view[10:13] == (True, False,
                                                             True)


async def raw_responses(root: str) -> list:
    srv = mod(root, "scheduler.extender").ExtenderServer(
        filter_fn=keep_n2, prioritize_fn=prefer_n1,
        bind_fn=lambda args: "refused" if args["node"] == "n0" else None)
    await srv.start()
    nodes = {"items": [{"metadata": {"name": f"n{i}"}} for i in range(4)]}
    pod = {"metadata": {"name": "p", "namespace": "default"}}
    posts = [("filter", {"pod": pod, "nodes": nodes}),
             ("filter", {"pod": pod, "nodenames": ["n1", "n2"]}),
             ("prioritize", {"pod": pod, "nodenames": ["n0", "n1", "n3"]}),
             ("bind", {"podName": "p", "podNamespace": "default",
                       "podUID": "u", "node": "n0"}),
             ("bind", {"podName": "p", "podNamespace": "default",
                       "podUID": "u", "node": "n1"})]
    out = []
    try:
        async with aiohttp.ClientSession() as s:
            for verb, body in posts:
                async with s.post(f"{srv.url}/{verb}", json=body) as r:
                    out.append((verb, r.status, await r.json()))
        out.append(list(srv.requests))
    finally:
        await srv.stop()
    return out


def test_extender_servers_answer_alike():
    got = {root: asyncio.run(raw_responses(root)) for root in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    assert got[PACKAGES[1]][3][2] == {"error": "refused"}
