"""The port's workload controllers against the JAX package on the CPU:
ReplicaSet, Deployment, the garbage collector, Namespace, PodGC and KWOK.

- Differentials: each package's controllers run over its own
  `new_cluster_store()` with `install_core_validation`, on the same
  objects, with uids, timestamps, `time.time` of the timed controllers,
  the name counters and KWOK's pod IPs pinned (`pinned`). No worker task
  runs: a `Stepper` waits until every informer holds what the store
  holds, then syncs every queued key (delayed ones at once) and every
  resync key, one at a time in sorted order, and records the store's
  objects of the touched resources (name, labels, annotations,
  ownerReferences, spec, status and any other field beside the metadata)
  after each sync, until a round leaves
  them as they were (quiescence). The two traces must be identical.
  Pods are bound by a fixed round-robin binder step, the same in both.
- Pure functions: `pod_template_hash` on seeded templates and
  `_resolve_bound` (integers, percentages, rounding) alike.
- The reference's end-to-end cases (`tests/test_controllers.py`,
  `tests/test_garbagecollector.py`) run against the port: the source of
  each, with `kubernetes_tpu` read as `kubernetes_tpu_torch`, one test
  per case (host-path scheduler where a case schedules).
- Hazard 2 of the controller manager (pod names after a fresh process)
  is pinned in `tests/test_torch_controller_manager.py`.

Tolerance: none (identical objects after every step). Every wait has a
deadline of 60 s.
"""

import asyncio
import itertools
import random
import re
import time
import types
import unittest
from importlib import import_module
from pathlib import Path
from types import SimpleNamespace

import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
STAMP = "2026-01-01T00:00:00Z"
#: STAMP in seconds since the epoch: the pinned clock's start.
T0 = 1767225600.0
DEADLINE = 60.0
TESTS = Path(__file__).resolve().parent
FIELDS = ("labels", "annotations", "ownerReferences")


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


def api(root: str) -> SimpleNamespace:
    types_ = mod(root, "api.types")
    store = mod(root, "store")
    return SimpleNamespace(
        root=root, C=mod(root, "controllers"), types=types_,
        meta=mod(root, "api.meta"), client=mod(root, "client"),
        mvcc=mod(root, "store.mvcc"), new_store=store.new_cluster_store,
        install=store.install_core_validation)


class Clock:
    """`time.time` (and `time.monotonic`, from 0 at T0) of the timed
    controllers; each run resets it to T0."""

    def __init__(self):
        self.t = T0

    def time(self) -> float:
        return self.t

    def monotonic(self) -> float:
        return self.t - T0


@pytest.fixture
def pinned(monkeypatch):
    """Deterministic uids (`uid-<n>` per package), timestamps (STAMP),
    the clock of Job, CronJob, TTL-after-finished, the prober and
    kube-proxy (a `Clock`), the ReplicaSet and Job name counters (0), the
    token generator."""
    clock = Clock()
    for root in PACKAGES:
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            monkeypatch.setattr(mod(root, sub), "new_uid",
                                lambda seq=seq: f"uid-{next(seq)}")
        for sub in ("api.meta", "controllers.job", "client.events"):
            monkeypatch.setattr(mod(root, sub), "now_iso", lambda: STAMP)
        for sub in ("controllers.job", "controllers.longtail",
                    "controllers.nodeagent", "controllers.kubeproxy"):
            monkeypatch.setattr(mod(root, sub), "time", clock)
        monkeypatch.setattr(mod(root, "controllers.cronjob"), "_time", clock)
        for sub, cls in (("replicaset", "ReplicaSetController"),
                         ("job", "JobController")):
            monkeypatch.setattr(getattr(mod(root, f"controllers.{sub}"), cls),
                                "_seq", 0)
        tokens = itertools.count(1)
        monkeypatch.setattr(
            mod(root, "controllers.serviceaccount"), "_secrets",
            SimpleNamespace(token_urlsafe=lambda n, t=tokens: f"tok{next(t)}"))
    return clock


def view(obj: dict) -> dict:
    """What a differential compares: the name, namespace, labels,
    annotations and ownerReferences, and every field beside `metadata`
    (spec and status; an EndpointSlice's endpoints, a Secret's data)."""
    meta = obj.get("metadata") or {}
    out = {k: v for k, v in obj.items() if k != "metadata"}
    out.update({f: meta.get(f) for f in ("name", "namespace") + FIELDS})
    return out


def take(queue) -> set:
    """Every key of a controller's queue, the delayed ones too (their
    delay elapses at once), leaving it empty."""
    keys = set(queue._queue) | {item for _, _, item in queue._heap}
    queue._queue.clear()
    queue._dirty.clear()
    queue._heap.clear()
    return keys


class Stepper:
    """One package's controllers, driven by hand (module docstring)."""

    def __init__(self, a: SimpleNamespace, store, controllers, resources,
                 idle=(), binder=False):
        self.a = a
        self.store = store
        self.controllers = controllers
        self.resources = resources
        self.idle = idle
        self.binder = binder
        self.factory = a.client.InformerFactory(store)
        self.trace: list = []
        self._bind_seq = 0

    async def start(self) -> None:
        for c in self.controllers:
            c.setup(self.factory)
        self.factory.start()
        await self.factory.wait_for_sync()
        await self.record("start")

    def stop(self) -> None:
        self.factory.stop()
        self.store.stop()

    async def settle(self) -> None:
        """Until every informer holds the store's objects at their RVs and
        every `idle` predicate holds, twice in a row across yields."""
        name = self.a.meta.namespaced_name
        deadline = time.monotonic() + DEADLINE
        calm = 0
        while calm < 2:
            for _ in range(3):
                await asyncio.sleep(0)
            ok = all(p() for p in self.idle)
            for res, inf in self.factory._informers.items():
                if not ok:
                    break
                want = {name(o): o["metadata"]["resourceVersion"]
                        for o in (await self.store.list(res)).items}
                have = {name(o): o["metadata"]["resourceVersion"]
                        for o in inf.indexer.list()}
                ok = want == have
            calm = calm + 1 if ok else 0
            if time.monotonic() > deadline:
                raise TimeoutError("informers did not catch up")
            if not ok:
                await asyncio.sleep(0.002)

    async def snapshot(self) -> dict:
        name = self.a.meta.namespaced_name
        return {res: {name(o): view(o)
                      for o in (await self.store.list(res)).items}
                for res in self.resources}

    async def record(self, what: str) -> None:
        self.trace.append((what, await self.snapshot()))

    async def bind(self) -> None:
        """The scheduler's stand-in: each unbound live pod, by name, to the
        node its `metadata.name` affinity pins it to (left unbound if that
        node is gone), else to the next of the sorted node names in turn."""
        nodes = sorted(n["metadata"]["name"]
                       for n in (await self.store.list("nodes")).items)
        pods = sorted((await self.store.list("pods")).items,
                      key=lambda p: p["metadata"]["name"])
        for p in pods:
            if p["spec"].get("nodeName") or \
                    p["status"].get("phase") in ("Succeeded", "Failed"):
                continue
            node = pinned_node(p)
            if node is None:
                node = nodes[self._bind_seq % len(nodes)]
                self._bind_seq += 1
            elif node not in nodes:
                continue
            await self.store.subresource(
                "pods", self.a.meta.namespaced_name(p), "binding",
                self.a.types.make_binding(p, node))
        await self.settle()
        await self.record("bind")

    async def step(self, what: str, coro) -> None:
        """A scripted action (a create, an update, a delete), then the
        store's objects."""
        await coro
        await self.settle()
        await self.record(what)

    async def attempt(self, what: str, coro) -> str:
        """A scripted call that the store may refuse: its outcome (the
        error's type and message, or "ok") joins the step's name."""
        try:
            await coro
            outcome = "ok"
        except self.a.mvcc.StoreError as e:
            outcome = f"{type(e).__name__}: {e}"
        await self.settle()
        await self.record(f"{what}: {outcome}")
        return outcome

    async def round(self) -> None:
        if self.binder:
            await self.bind()
        await self.settle()
        for c in self.controllers:
            keys = take(c.queue) | set(await c.resync_keys())
            for key in sorted(keys):
                await c.sync(key)
                await self.settle()
                await self.record(f"{c.NAME} {key}")

    async def run(self, max_rounds: int = 60) -> None:
        """Rounds until one leaves the recorded objects as they were."""
        for _ in range(max_rounds):
            before = await self.snapshot()
            await self.round()
            if await self.snapshot() == before:
                self.trace.append(("quiescence", before))
                return
        raise AssertionError(f"no quiescence in {max_rounds} rounds")


def pinned_node(pod: dict) -> str | None:
    """The node a DaemonSet pod's `matchFields` affinity names."""
    na = ((pod["spec"].get("affinity") or {}).get("nodeAffinity") or {})
    req = na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in req.get("nodeSelectorTerms") or []:
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name":
                return f["values"][0]
    return None


async def kwok_cluster(a, nodes: int = 3, **kw):
    """A store with `nodes` KWOK nodes registered, and the controller."""
    store = a.new_store()
    a.install(store)
    kwok = a.C.KwokController(store, node_count=nodes, lease_period=3600.0,
                              **kw)
    await kwok.register_nodes()
    return store, kwok


def kwok_idle(kwok):
    """KWOK has no pod left to mark Running or complete."""
    return lambda: not (kwok._run_draining or kwok._run_queue
                        or kwok._stage_tasks)


def same_traces(a: list, b: list) -> None:
    """The first step where the two traces differ, if any."""
    for i, (x, y) in enumerate(zip(a, b)):
        assert x == y, f"step {i}: {x[0]!r} vs {y[0]!r}"
    assert len(a) == len(b), (len(a), len(b), a[len(b):len(b) + 1],
                              b[len(a):len(a) + 1])
    assert a and a[-1][0] == "quiescence"


def both(script, *args) -> list:
    """The script's trace in each package; asserts they are identical."""
    traces = [asyncio.run(script(api(root), *args)) for root in PACKAGES]
    same_traces(*traces)
    return traces[1]


POD_TEMPLATE = {
    "metadata": {"labels": {"app": "web"}},
    "spec": {"containers": [{"name": "main", "image": "web:v1",
                             "resources": {"requests": {"cpu": "100m"}}}]},
}


def _template(image: str, app: str = "web") -> dict:
    t = {"metadata": {"labels": {"app": app}},
         "spec": {"containers": [dict(POD_TEMPLATE["spec"]["containers"][0],
                                      image=image)]}}
    return t


async def _cluster(a, nodes: int = 3):
    store = a.new_store()
    a.install(store)
    for i in range(nodes):
        await store.create("nodes", a.types.make_node(f"n{i}"))
    return store


def _set_spec(field: str, value):
    def mutate(o):
        o["spec"][field] = value
        return o
    return mutate


# -- ReplicaSet ---------------------------------------------------------------


async def _replicaset_script(a, clock) -> list:
    clock.t = T0
    store = await _cluster(a)
    # An orphan that matches the selector (adopted into the count) and a
    # pod another ReplicaSet owns (not counted).
    await store.create("pods", a.types.make_pod(
        "orphan", labels={"app": "web"}))
    other = a.types.make_pod("other", labels={"app": "web"})
    other["metadata"]["ownerReferences"] = [{
        "apiVersion": "apps/v1", "kind": "ReplicaSet", "name": "db",
        "uid": "uid-db", "controller": True}]
    await store.create("pods", other)
    st = Stepper(a, store, [a.C.ReplicaSetController(store)],
                 ["replicasets", "pods"], binder=True)
    await st.start()
    await st.step("create web", store.create(
        "replicasets", a.C.make_replicaset(
            "web", 5, {"matchLabels": {"app": "web"}}, POD_TEMPLATE)))
    await st.run()
    await st.step("scale to 2", store.guaranteed_update(
        "replicasets", "default/web", _set_spec("replicas", 2)))
    await st.run()
    pods = sorted(p["metadata"]["name"]
                  for p in (await store.list("pods")).items
                  if p["metadata"]["name"].startswith("web-"))
    await st.step(f"delete {pods[0]}", store.delete(
        "pods", f"default/{pods[0]}"))
    await st.run()
    # Past the burst cap (patched to 3): several syncs to fill; with the
    # binder off, the new pods stay unbound, and a scale-down deletes
    # them before the bound ones.
    st.binder = False
    await st.step("scale to 8", store.guaranteed_update(
        "replicasets", "default/web", _set_spec("replicas", 8)))
    await st.run()
    await st.step("scale to 4", store.guaranteed_update(
        "replicasets", "default/web", _set_spec("replicas", 4)))
    await st.run()
    st.binder = True
    await st.step("scale to 8", store.guaranteed_update(
        "replicasets", "default/web", _set_spec("replicas", 8)))
    await st.run()
    st.stop()
    return st.trace


def test_replicaset_sync_steps_match(pinned, monkeypatch):
    for root in PACKAGES:
        monkeypatch.setattr(mod(root, "controllers.replicaset"),
                            "BURST_REPLICAS", 3)
    trace = both(_replicaset_script, pinned)
    final = trace[-1][1]
    counted = [p for p in final["pods"].values()
               if (p["ownerReferences"] or [{}])[0].get("name") == "web"
               or p["name"] == "orphan"]  # a matching orphan counts
    assert len(counted) == 8 and "default/other" in final["pods"]
    assert final["replicasets"]["default/web"]["status"]["readyReplicas"] == 8


# -- Deployment ---------------------------------------------------------------


async def _deployment_script(a, clock, strategy) -> list:
    clock.t = T0
    store = await _cluster(a)
    st = Stepper(a, store, [a.C.DeploymentController(store),
                            a.C.ReplicaSetController(store)],
                 ["deployments", "replicasets", "pods"], binder=True)
    await st.start()
    await st.step("create", store.create("deployments", a.C.make_deployment(
        "web", 8, {"matchLabels": {"app": "web"}}, _template("web:v1"),
        strategy=strategy)))
    await st.run()

    def image(tag):
        def mutate(o):
            o["spec"]["template"]["spec"]["containers"][0]["image"] = tag
            return o
        return mutate
    await st.step("roll to v2", store.guaranteed_update(
        "deployments", "default/web", image("web:v2")))
    await st.run()
    await st.step("scale to 12", store.guaranteed_update(
        "deployments", "default/web", _set_spec("replicas", 12)))
    await st.run()
    await st.step("roll to v3 and scale to 5", store.guaranteed_update(
        "deployments", "default/web",
        lambda o: _set_spec("replicas", 5)(image("web:v3")(o))))
    await st.run()
    st.stop()
    return st.trace


STRATEGIES = {
    "percent": {"type": "RollingUpdate", "rollingUpdate": {
        "maxSurge": "25%", "maxUnavailable": "25%"}},
    "default": None,
    "surge-only": {"type": "RollingUpdate", "rollingUpdate": {
        "maxSurge": 2, "maxUnavailable": 0}},
    "zero-zero": {"type": "RollingUpdate", "rollingUpdate": {
        "maxSurge": 0, "maxUnavailable": 0}},
    "recreate": {"type": "Recreate"},
}


@pytest.mark.parametrize("strategy", sorted(STRATEGIES))
def test_deployment_sync_steps_match(pinned, strategy):
    trace = both(_deployment_script, pinned, STRATEGIES[strategy])
    final = trace[-1][1]
    live = list(final["pods"].values())
    assert len(live) == 5
    assert {p["labels"]["pod-template-hash"] for p in live} == {
        r["labels"]["pod-template-hash"]
        for r in final["replicasets"].values() if r["spec"]["replicas"]}


def test_pod_template_hash_and_resolve_bound_match():
    rng = random.Random(20)
    hashes = []
    for root in PACKAGES:
        dep = mod(root, "controllers.deployment")
        rng.seed(20)
        out = []
        for _ in range(200):
            t = {"metadata": {"labels": {f"k{rng.randrange(5)}":
                                         str(rng.random())}},
                 "spec": {"containers": [{
                     "name": "c", "image": f"img:{rng.randrange(1000)}",
                     "resources": {"requests": {
                         "cpu": f"{rng.randrange(1, 4000)}m"}}}],
                     "nodeSelector": {"z": str(rng.randrange(3))}}}
            out.append(dep.pod_template_hash(t))
        for total in (0, 1, 3, 4, 10, 250, 1001):
            for v in (None, 0, 1, 5, "0", "3", "0%", "1%", "10%", "25%",
                      "33%", "50%", "99%", "100%"):
                out.append(dep._resolve_bound(v, total))
        hashes.append(out)
    assert hashes[0] == hashes[1]
    assert len(set(hashes[1][:200])) == 200
    dep = mod("kubernetes_tpu_torch", "controllers.deployment")
    assert dep._resolve_bound("25%", 250) == 63
    assert dep._resolve_bound(None, 10) == 0


# -- the garbage collector and Namespace --------------------------------------


async def _gc_script(a, clock) -> list:
    clock.t = T0
    store = await _cluster(a, 2)
    gc = a.C.GarbageCollectorController(store)
    st = Stepper(a, store, [a.C.DeploymentController(store),
                            a.C.ReplicaSetController(store), gc],
                 ["deployments", "replicasets", "pods"], binder=True)
    await st.start()
    for name in ("web", "keep"):
        await st.step(f"create {name}", store.create(
            "deployments", a.C.make_deployment(
                name, 3, {"matchLabels": {"app": name}},
                _template("web:v1", name))))
    await st.run()
    # One of keep's pods opts into the orphan policy.
    keep = sorted(n for n, p in (await st.snapshot())["pods"].items()
                  if p["labels"].get("app") == "keep")[0]

    def orphan(o):
        o["metadata"].setdefault("annotations", {})[
            "kubernetes.io/orphan"] = "true"
        return o
    await st.step("annotate", store.guaranteed_update(
        "pods", keep, orphan))
    await st.step("delete web", store.delete("deployments", "default/web"))
    await st.run()
    await st.step("delete keep", store.delete("deployments", "default/keep"))
    await st.run()
    # A dependent whose owner never existed, and one owned by a Node (an
    # unwatched kind, never collectable).
    late = a.types.make_pod("late")
    late["metadata"]["ownerReferences"] = [{
        "apiVersion": "apps/v1", "kind": "ReplicaSet", "name": "gone",
        "uid": "uid-gone", "controller": True}]
    mirror = a.types.make_pod("mirror")
    mirror["metadata"]["ownerReferences"] = [{
        "apiVersion": "v1", "kind": "Node", "name": "n0", "uid": "uid-n0",
        "controller": True}]
    await st.step("create late and mirror", asyncio.gather(
        store.create("pods", late), store.create("pods", mirror)))
    await st.run()
    st.stop()
    return st.trace


def test_garbage_collector_sync_steps_match(pinned):
    final = both(_gc_script, pinned)[-1][1]
    assert not final["deployments"] and not final["replicasets"]
    names = sorted(final["pods"])
    assert len(names) == 2 and "default/mirror" in names
    kept = next(p for n, p in final["pods"].items() if n != "default/mirror")
    assert kept["annotations"]["kubernetes.io/orphan"] == "true"
    assert not kept["ownerReferences"]


async def _namespace_script(a, clock) -> list:
    clock.t = T0
    store = await _cluster(a, 1)
    await store.create("namespaces", a.types.make_namespace("team"))
    for ns in ("team", "default"):
        await store.create("pods", a.types.make_pod("p", namespace=ns))
        await store.create("replicasets", a.C.make_replicaset(
            "rs", 0, {"matchLabels": {"app": "x"}}, POD_TEMPLATE,
            namespace=ns))
        await store.create("leases", a.meta.new_object(
            "Lease", "l", ns, spec={"renewTime": 0}))
    st = Stepper(a, store, [a.C.NamespaceController(store)],
                 ["namespaces", "pods", "replicasets", "leases"])
    await st.start()
    await st.step("delete team", store.delete("namespaces", "team"))
    await st.run()
    st.stop()
    return st.trace


def test_namespace_sync_steps_match(pinned):
    final = both(_namespace_script, pinned)[-1][1]
    for res in ("pods", "replicasets", "leases"):
        assert [v["namespace"] for v in final[res].values()] == ["default"]


# -- PodGC --------------------------------------------------------------------


async def _podgc_script(a, clock) -> list:
    clock.t = T0
    store = await _cluster(a)
    for i in range(9):
        pod = a.types.make_pod(f"p{i}", node_name=f"n{i % 3}")
        await store.create("pods", pod)
    for i in (1, 4, 5):
        def done(o, i=i):
            o["status"]["phase"] = "Succeeded" if i != 5 else "Failed"
            return o
        await store.guaranteed_update("pods", f"default/p{i}", done)
    gc = a.C.PodGCController(store, terminated_pod_threshold=1)
    st = Stepper(a, store, [gc], ["nodes", "pods"])
    await st.start()
    await st.step("gc", gc.gc_once())
    await st.step("delete n2", store.delete("nodes", "n2"))
    await st.step("gc", gc.gc_once())
    await st.step("gc", gc.gc_once())
    st.trace.append(("quiescence", await st.snapshot()))
    st.stop()
    return st.trace


def test_podgc_passes_match(pinned):
    final = both(_podgc_script, pinned)[-1][1]
    # The two oldest of three terminated pods (threshold 1; equal
    # timestamps keep list order), then n2's orphans.
    assert sorted(final["pods"]) == ["default/p0", "default/p3",
                                     "default/p6", "default/p7"]


# -- KWOK ---------------------------------------------------------------------


async def _kwok_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    kwok = a.C.KwokController(
        store, node_count=3, lease_period=3600.0,
        node_template={"allocatable": {"cpu": "8", "memory": "32Gi",
                                       "pods": "110", "example.com/gpu": "4"}})
    st = Stepper(a, store, [kwok],
                 ["nodes", "leases", "resourceslices", "pods"],
                 idle=(kwok_idle(kwok),), binder=True)
    await st.step("register", kwok.register_nodes())
    await st.start()

    await st.step("leases", lease_pass(kwok, store, 0))
    await st.step("renew", lease_pass(kwok, store, 1))
    for i in range(5):
        pod = a.types.make_pod(f"p{i}")
        if i == 2:
            pod["metadata"]["annotations"] = {
                "kwok.x-k8s.io/complete-after": "0"}
        await st.step(f"create p{i}", store.create("pods", pod))
    await st.run()
    kwok.fail_node("kwok-node-1")
    await st.step("renew without kwok-node-1", lease_pass(kwok, store, 2))
    st.trace.append(("quiescence", await st.snapshot()))
    st.stop()
    return st.trace


async def lease_pass(kwok, store, renew_time: int) -> None:
    """One pass of KWOK's lease loop: until every Lease of a node it
    manages has `renew_time` (the first pass creates them at 0)."""
    task = asyncio.ensure_future(kwok._lease_loop())
    end = time.monotonic() + DEADLINE
    while True:
        leases = {lz["metadata"]["name"]: lz["spec"]["renewTime"]
                  for lz in (await store.list("leases")).items}
        if all(leases.get(n) == renew_time for n in kwok._managed):
            break
        assert time.monotonic() < end, leases
        await asyncio.sleep(0.002)
    task.cancel()
    await asyncio.gather(task, return_exceptions=True)


def test_kwok_steps_match(pinned):
    final = both(_kwok_script, pinned)[-1][1]
    phases = {n: p["status"]["phase"] for n, p in final["pods"].items()}
    assert phases == {f"default/p{i}": "Succeeded" if i == 2 else "Running"
                      for i in range(5)}
    assert len({p["status"]["podIP"] for p in final["pods"].values()}) == 5
    assert len(final["resourceslices"]) == 3
    assert {n: lz["spec"]["renewTime"] for n, lz in final["leases"].items()
            } == {"kube-node-lease/kwok-node-0": 2,
                  "kube-node-lease/kwok-node-1": 1,
                  "kube-node-lease/kwok-node-2": 2}


# -- the reference's end-to-end cases against the port ------------------------


def port_of(name: str) -> types.ModuleType:
    """The reference test file `name`, with `kubernetes_tpu` read as
    `kubernetes_tpu_torch`, as a module."""
    src = re.sub(r"\bkubernetes_tpu\b", "kubernetes_tpu_torch",
                 (TESTS / name).read_text())
    assert not re.search(r"\bkubernetes_tpu\b", src)
    module = types.ModuleType(f"port_of_{name[:-3]}")
    module.__file__ = str(TESTS / name)
    exec(compile(src, f"{name} (read as the port's)", "exec"),
         module.__dict__)
    return module


def cases(module: types.ModuleType) -> list[str]:
    return [f"{cname}::{m}" for cname, cls in vars(module).items()
            if cname.startswith("Test") and isinstance(cls, type)
            for m in vars(cls) if m.startswith("test_")]


def run_case(module: types.ModuleType, case: str) -> None:
    cname, method = case.split("::")
    cls = getattr(module, cname)
    if issubclass(cls, unittest.TestCase):
        cls(method).debug()
    else:
        getattr(cls(), method)()


REFERENCE = {name: port_of(name) for name in (
    "test_controllers.py", "test_garbagecollector.py")}


@pytest.mark.parametrize("case", [
    f"{name}::{case}" for name, m in REFERENCE.items() for case in cases(m)])
def test_reference_case_against_the_port(case):
    name, _, rest = case.partition("::")
    run_case(REFERENCE[name], rest)


def test_unchanged_status_is_not_rewritten(pinned):
    """The port's one divergence (`controllers/base.status_writer`): at
    quiescence a ReplicaSet sync rewrites the reference's status (a new
    resource version, an event that queues the key again) and leaves the
    port's as it was; the objects are equal."""
    async def script(a):
        store = await _cluster(a)
        rsc = a.C.ReplicaSetController(store)
        st = Stepper(a, store, [rsc], ["replicasets", "pods"], binder=True)
        await st.start()
        await store.create("replicasets", a.C.make_replicaset(
            "web", 2, {"matchLabels": {"app": "web"}}, POD_TEMPLATE))
        await st.run()
        before = await store.get("replicasets", "default/web")
        await rsc.sync("default/web")
        await st.settle()
        after = await store.get("replicasets", "default/web")
        queued = take(rsc.queue)
        st.stop()
        return (before["metadata"]["resourceVersion"] !=
                after["metadata"]["resourceVersion"], queued,
                view(before) == view(after))
    ref, port = (asyncio.run(script(api(root))) for root in PACKAGES)
    assert ref == (True, {"default/web"}, True)
    assert port == (False, set(), True)
