"""The port's leader election (`client/leaderelection.LeaderElector`) and
the Scheduler's leader-elected run, on the CPU against the JAX package's.

Both packages' electors run under one fake clock: each module's `time`
and `asyncio.sleep` are replaced, so a renewal happens only when the test
steps the clock, and nothing depends on host load. Two electors ("a" and
"b") per package share one store; after every step the Lease object (its
resource version included; uids and timestamps pinned), each elector's
`is_leader` and its HAMetrics must be the reference's:

- `_try_acquire_or_renew` by hand: acquire, a renew, a held lease
  refused, expiry takeover, a CAS lost to an interleaved renewal, a
  Conflict from the store, a transient StoreError;
- `run()`: acquisition, renewals, the renew deadline cancelling the
  payload (fencing) while the store fails the leader's reads, and the
  standby's takeover after expiry;
- a leader-elected pair of `Scheduler`s (`run_with_leader_election`, host
  path) binds 20 pods, each exactly once, the second ten after the
  leader was deposed, none of them by the deposed one. The new leader
  also pops the first ten, which it queued as a standby and never
  dropped once they were bound (the reference's pod update handler does
  not take an assigned pod out of the queue, as upstream's filtered
  handler does); its assume fails for each. Both packages must fail the
  same pods (ROADMAP queue 3 item 2(e)).

Tolerance: none (exact host logic).
"""

import asyncio
import itertools
import logging
from importlib import import_module
from types import SimpleNamespace

import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
STAMP = "2026-01-01T00:00:00Z"
LEASE = "kube-system/kube-scheduler"
T0 = 1000.0


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


class Stepper:
    """The fake clock: `time()` reads it, `sleep()` parks until `step`."""

    def __init__(self):
        self.now = T0
        self._parked: list = []

    def time(self) -> float:
        return self.now

    async def sleep(self, _seconds) -> None:
        fut = asyncio.get_running_loop().create_future()
        self._parked.append(fut)
        await fut

    async def step(self, seconds: float) -> None:
        """Advance the clock, wake every parked sleep, let the loop run."""
        self.now += seconds
        parked, self._parked = self._parked, []
        for fut in parked:
            if not fut.done():
                fut.set_result(None)
        await settle()


async def settle(rounds: int = 50) -> None:
    for _ in range(rounds):
        await asyncio.sleep(0)


@pytest.fixture
def clocks(monkeypatch):
    """{root: Stepper}, installed into each package's leaderelection module,
    with uids and creation timestamps pinned per package."""
    out = {}
    for root in PACKAGES:
        clock = Stepper()
        le = mod(root, "client.leaderelection")
        monkeypatch.setattr(le, "time", SimpleNamespace(time=clock.time))
        monkeypatch.setattr(le, "asyncio", SimpleNamespace(
            sleep=clock.sleep, ensure_future=asyncio.ensure_future,
            gather=asyncio.gather, CancelledError=asyncio.CancelledError))
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            monkeypatch.setattr(mod(root, sub), "new_uid",
                                lambda seq=seq: f"uid-{next(seq)}")
        monkeypatch.setattr(mod(root, "api.meta"), "now_iso", lambda: STAMP)
        out[root] = clock
    return out


class FlakyStore:
    """A store proxy for one elector: `fail_get` raises the store's
    StoreError on reads, `conflict` raises Conflict from the CAS, and
    `before_cas` runs a coroutine (another elector's attempt) between the
    read and the CAS."""

    def __init__(self, store, errors):
        self._store, self._errors = store, errors
        self.fail_get = False
        self.conflict = False
        self.before_cas = None

    async def get(self, resource, key):
        if self.fail_get:
            raise self._errors.StoreError("apiserver unavailable")
        return await self._store.get(resource, key)

    async def create(self, resource, obj):
        return await self._store.create(resource, obj)

    async def guaranteed_update(self, resource, key, mutate):
        if self.conflict:
            raise self._errors.Conflict(f"{resource} {key!r}: lost the CAS")
        if self.before_cas is not None:
            run, self.before_cas = self.before_cas, None
            await run()
        return await self._store.guaranteed_update(resource, key, mutate)


def pair(root: str, store):
    """Electors "a" and "b" on `store`, each behind its own FlakyStore."""
    le = mod(root, "client.leaderelection")
    errors = mod(root, "store.mvcc")
    proxies = {i: FlakyStore(store, errors) for i in "ab"}
    electors = {i: le.LeaderElector(proxies[i], "kube-scheduler", i,
                                    lease_duration=15.0)
                for i in "ab"}
    return electors, proxies


async def lease_view(store) -> dict | None:
    try:
        lease = await store.get("leases", LEASE)
    except Exception as e:  # NotFound before the first acquisition
        return {"error": type(e).__name__}
    return {"spec": lease["spec"],
            "resourceVersion": lease["metadata"]["resourceVersion"],
            "uid": lease["metadata"]["uid"]}


def elector_view(el) -> dict:
    return {"is_leader": el.is_leader,
            "elections": el.metrics.elections.value(),
            "is_leader_gauge": el.metrics.is_leader.value(),
            "timings": (el.lease_duration, el.renew_deadline,
                        el.retry_period)}


async def attempts_script(root: str, clock: Stepper) -> list:
    store = mod(root, "store").new_cluster_store()
    electors, proxies = pair(root, store)
    a, b = electors["a"], electors["b"]
    trace = []

    async def record(what, *results):
        trace.append((what, results, clock.now, await lease_view(store),
                      elector_view(a), elector_view(b)))

    await record("empty")
    await record("a acquires", await a._try_acquire_or_renew())
    await record("b refused", await b._try_acquire_or_renew())
    await clock.step(5.0)
    await record("a renews", await a._try_acquire_or_renew(),
                 await b._try_acquire_or_renew())
    await clock.step(15.5)  # past a's renewTime + 15 s
    await record("b takes over", await b._try_acquire_or_renew(),
                 await a._try_acquire_or_renew())
    await clock.step(16.0)  # b's lease expired: a and b race for it
    proxies["a"].before_cas = b._try_acquire_or_renew
    await record("a loses the CAS to b", await a._try_acquire_or_renew())
    await clock.step(16.0)
    proxies["b"].conflict = True
    await record("b's CAS conflicts", await b._try_acquire_or_renew())
    proxies["b"].conflict = False
    proxies["a"].fail_get = True
    await record("a's read fails", await a._try_acquire_or_renew())
    proxies["a"].fail_get = False
    await record("a acquires after expiry", await a._try_acquire_or_renew())
    store.stop()
    return trace


def test_attempts_match_step_by_step(clocks):
    got = {r: asyncio.run(attempts_script(r, clocks[r])) for r in PACKAGES}
    ref, port = got[PACKAGES[0]], got[PACKAGES[1]]
    assert len(port) == len(ref)
    for want, have in zip(ref, port):
        assert have == want, want[0]
    results = {step[0]: step[1] for step in port}
    assert results["a acquires"] == (True,)
    assert results["b refused"] == (False,)
    assert results["a renews"] == (True, False)
    assert results["b takes over"] == (True, False)
    assert results["a loses the CAS to b"] == (False,)
    assert results["b's CAS conflicts"] == (False,)
    assert results["a's read fails"] == (False,)
    assert results["a acquires after expiry"] == (True,)
    assert port[-1][3]["spec"]["holderIdentity"] == "a"


async def run_script(root: str, clock: Stepper) -> list:
    store = mod(root, "store").new_cluster_store()
    electors, proxies = pair(root, store)
    a, b = electors["a"], electors["b"]
    events = []
    trace = []

    def payload(name):
        async def lead():
            events.append(f"{name} leads")
            try:
                await asyncio.Event().wait()
            except asyncio.CancelledError:
                events.append(f"{name} payload cancelled")
                raise
        return lead

    async def record(what):
        trace.append((what, clock.now, await lease_view(store),
                      elector_view(a), elector_view(b), list(events)))

    task_a = asyncio.ensure_future(a.run(
        payload("a"), lambda: events.append("a stopped leading")))
    await settle()
    task_b = asyncio.ensure_future(b.run(
        payload("b"), lambda: events.append("b stopped leading")))
    await settle()
    await record("started")
    for _ in range(3):
        await clock.step(a.retry_period)
        await record("renewal")
    proxies["a"].fail_get = True  # the apiserver stops answering a
    for _ in range(12):
        await clock.step(a.retry_period)
        await record("a cannot renew")
    await asyncio.wait_for(task_a, 5.0)
    await record("a returned")
    task_b.cancel()
    await asyncio.gather(task_b, return_exceptions=True)
    await record("b cancelled")
    store.stop()
    return trace


def test_run_fences_and_fails_over_like_the_reference(clocks):
    got = {r: asyncio.run(run_script(r, clocks[r])) for r in PACKAGES}
    ref, port = got[PACKAGES[0]], got[PACKAGES[1]]
    assert len(port) == len(ref)
    for want, have in zip(ref, port):
        assert have == want, want[0]
    events = port[-2][-1]
    assert events.index("a payload cancelled") < events.index("b leads")
    assert port[0][3]["is_leader"] and not port[0][4]["is_leader"]
    assert port[-2][3] == {**port[-2][3], "is_leader": False,
                           "is_leader_gauge": 0.0, "elections": 1.0}
    assert port[-2][4]["is_leader"] and port[-2][4]["elections"] == 1.0
    assert port[-1][4]["is_leader_gauge"] == 0.0


class StaleAssumes(logging.Handler):
    """The pod keys of the scheduler's "assume failed" errors."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.keys: set[str] = set()

    def emit(self, record):
        if record.msg.startswith("assume failed"):
            self.keys.add(record.args[0])


async def scheduler_pair_script(root: str, clock: Stepper) -> dict:
    types = mod(root, "api.types")
    store = mod(root, "store").new_cluster_store()
    mod(root, "store").install_core_validation(store)
    for i in range(4):
        await store.create("nodes", types.make_node(f"n{i}"))
    electors, proxies = pair(root, store)
    Scheduler = mod(root, "scheduler").Scheduler
    InformerFactory = mod(root, "client").InformerFactory
    binds: dict[str, list[str]] = {}
    scheds, factories, tasks = {}, [], {}
    for name in "ab":
        sched = Scheduler(store, seed=42)
        bind = sched._bind

        async def counted(fwk, state, pi, node, name=name, bind=bind):
            binds.setdefault(pi.key, []).append(name)
            return await bind(fwk, state, pi, node)
        sched._bind = counted
        factory = InformerFactory(store)
        await sched.setup_informers(factory)
        factory.start()
        await factory.wait_for_sync()
        scheds[name] = sched
        factories.append(factory)
        tasks[name] = asyncio.ensure_future(
            sched.run_with_leader_election(electors[name], batch_size=8))
        await settle()

    async def bound(names, deadline=30.0):
        for _ in range(int(deadline / 0.02)):
            pods = (await store.list("pods")).items
            got = {p["metadata"]["name"] for p in pods
                   if p["spec"].get("nodeName")}
            if set(names) <= got:
                return
            await asyncio.sleep(0.02)
        raise AssertionError(f"{len(set(names) - got)} pods unbound")

    first = [f"p{i}" for i in range(10)]
    for n in first:
        await store.create("pods", types.make_pod(n, requests={"cpu": "100m"}))
    await bound(first)
    leaders = {n: electors[n].is_leader for n in "ab"}
    proxies["a"].fail_get = True  # a can no longer renew: deposed
    while not electors["b"].is_leader:
        await clock.step(electors["a"].retry_period)
    a_done = tasks["a"].done()
    second = [f"q{i}" for i in range(10)]
    for n in second:
        await store.create("pods", types.make_pod(n, requests={"cpu": "100m"}))
    await bound(second)
    for name in "ab":
        await scheds[name].stop()
        tasks[name].cancel()
    await asyncio.gather(*tasks.values(), return_exceptions=True)
    for factory in factories:
        factory.stop()
    store.stop()
    return {"leaders": leaders, "a_done": a_done,
            "binds": {k: binds[k] for k in sorted(binds)}}


def test_leader_elected_scheduler_pair_binds_each_pod_once(clocks):
    got = {}
    for root in PACKAGES:
        stale = StaleAssumes()
        log = logging.getLogger(f"{root}.scheduler.scheduler")
        log.addHandler(stale)
        try:
            got[root] = asyncio.run(scheduler_pair_script(root, clocks[root]))
        finally:
            log.removeHandler(stale)
        got[root]["stale_assumes"] = sorted(stale.keys)
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["leaders"] == {"a": True, "b": False}
    assert out["a_done"], "the deposed leader's run did not end"
    binds = out["binds"]
    assert sorted(binds) == sorted([f"default/p{i}" for i in range(10)]
                                   + [f"default/q{i}" for i in range(10)])
    for key, who in binds.items():
        want = ["a"] if key.startswith("default/p") else ["b"]
        assert who == want, (key, who)
    assert out["stale_assumes"] == sorted(f"default/p{i}" for i in range(10))
