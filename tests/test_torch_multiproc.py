"""The port's multi-process control plane on the CPU.

Each shard of the store is an apiserver process (`multiproc.shardproc`)
behind the KTPU wire on a unix socket; a leader-elected pair of scheduler
processes (`multiproc.schedproc`) schedules; the parent works through
`multiproc.ProcessShardedStore`. Held here:

- a spawned end-to-end bind, on the host path (KTPU_PROCESSES=2) and with
  `TorchBackend(device="cpu")` through `PerfRunner(processes=2)`, whose
  result carries the process count, the elections and the leader's
  launch counts and provenance;
- one write stream (creates, bindings, a meta-shard Lease, deletes) into
  the port's and the JAX package's `ProcessShardedStore` and both
  packages' in-process `ShardedNodeStore`: the writes' RVs, the merged and
  per-shard LISTs and a paginated walk with its continue tokens are
  identical, name by name and RV by RV;
- `SharedRVCounter`'s monotonic setter, step for step with the JAX
  package's;
- a SIGKILL of the meta shard (pods and bindings) under a create stream
  with fsync=always, restarted on its data dir: no acknowledged pod lost,
  every survivor bound;
- a SIGKILL of the lease-holding scheduler: the standby takes the lease on
  its expiry and binds a pod created after the kill;
- `killLeader` through the port's runner (ChurnDay at 50 nodes, 20/s for
  3 s): the record names the killed leader and recovers, two elections,
  every pod bound.

Every wait is on an event (a pod seen bound, a change of Lease holder, a
count of acknowledged creates) with a deadline of 30 s or more, never a
fixed sleep. The leases are 4 s, so a failover takes about that long.
"""

import asyncio
import copy
import time

from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.multiproc import MultiProcessControlPlane as JCP
from kubernetes_tpu.multiproc import rv as jrv
from kubernetes_tpu.store import mvcc as jmvcc
from kubernetes_tpu_torch.api import types
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.multiproc import (
    MultiProcessControlPlane,
    SharedRVCounter,
)
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf.scheduler_perf import (
    CHURN_DAY,
    SCHEDULING_BASIC,
    PerfRunner,
)
from kubernetes_tpu_torch.store.mvcc import StoreError, new_cluster_store
from kubernetes_tpu_torch.utils import flags

DEADLINE_S = 60.0
LEASE_S = 4.0


async def until(cond, what: str, timeout: float = DEADLINE_S):
    """Poll the async predicate `cond` until it returns a true value,
    which is returned; store errors (a shard restarting) count as not
    yet."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            got = await cond()
        except StoreError:
            got = None
        if got:
            return got
        await asyncio.sleep(0.05)
    raise TimeoutError(f"{what} not within {timeout} s")


async def bound_names(store) -> set:
    return {p["metadata"]["name"] for p in (await store.list("pods")).items
            if p["spec"].get("nodeName")}


def test_spawn_e2e_bind_on_the_host_path():
    async def body():
        with flags.scoped_set("KTPU_PROCESSES", 2):
            cp = MultiProcessControlPlane(flags.get("KTPU_PROCESSES"))
            store = None
            try:
                await cp.start()
                await cp.start_schedulers(2)
                store = cp.client()
                for i in range(4):
                    await store.create("nodes", make_node(f"n{i}"))
                for i in range(6):
                    await store.create("pods", make_pod(f"p{i}"))
                want = {f"p{i}" for i in range(6)}

                async def all_bound():
                    return want <= await bound_names(store)
                await until(all_bound, "6 pods bound")
                assert (await store.control_topology())["nodeShards"] == 2
                nodes = await store.list("nodes")
                assert sorted(n["metadata"]["name"] for n in nodes.items) \
                    == [f"n{i}" for i in range(4)]
                cp.check_alive()
            finally:
                if store is not None:
                    await store.close()
                await cp.stop()
    asyncio.run(body())


def test_runner_with_the_cpu_backend_in_processes(tmp_path):
    runner = PerfRunner(backend=TorchBackend(device="cpu", max_batch=64),
                        batch_size=256, processes=2, data_dir=str(tmp_path))
    res = asyncio.run(runner.run(
        SCHEDULING_BASIC["workloadTemplate"],
        {"initNodes": 20, "initPods": 30, "measurePods": 60},
        timeout=DEADLINE_S))
    d = res.as_dict()
    assert d["process_count"] == 2 and d["shard_count"] == 2
    assert d["scheduled_total"] == 90 and d["measured_pods"] == 60
    assert d["leader_elections_total"] == 1
    assert d["attempt_percentiles_exact"]
    assert d["wal_appends_total"] > 90
    assert res.leader_kernel_launches == {"wave_solve": 0, "probe": 0}
    assert d["solve_provenance"]["solve_kernel"] == "plain"


def test_quiesced_merged_list_parity():
    """One write stream into four stores: the port's and the JAX
    package's ProcessShardedStore (each over its own 2 spawned shard
    processes) and both packages' in-process ShardedNodeStore
    (`new_cluster_store(2)`). Every write's answer, the merged and
    per-shard LISTs (items, RVs, list RV), a paginated walk with its
    continue tokens, and the meta shard's resources are identical across
    the four."""
    lease = {"apiVersion": "coordination.k8s.io/v1", "kind": "Lease",
             "metadata": {"name": "lease-a", "namespace": "kube-node-lease"},
             "spec": {"holderIdentity": "a"}}

    async def feed(store, types) -> list:
        out = []

        def rec(obj):
            meta = obj.get("metadata") or {}
            out.append((obj.get("kind"), meta.get("name"),
                        meta.get("resourceVersion"), obj.get("status")))
        for i in range(17):
            rec(await store.create("nodes",
                                   types.make_node(f"node-{i:03d}")))
        for i in range(9):
            rec(await store.create("pods", types.make_pod(f"pod-{i:03d}")))
        for i in range(3):
            rec(await store.subresource(
                "pods", f"default/pod-{i:03d}", "binding",
                {"target": {"name": f"node-{3 * i + 1:03d}"}}))
        rec(await store.create("leases", copy.deepcopy(lease)))
        rec(await store.delete("nodes", "node-004"))
        rec(await store.delete("pods", "default/pod-007"))
        return out

    def view(res):
        return ([(o["metadata"]["name"], o["metadata"]["resourceVersion"],
                  (o.get("spec") or {}).get("nodeName"))
                 for o in res.items], res.resource_version)

    async def walk(store, resource, limit):
        pages, cont = [], None
        while True:
            res = await store.list(resource, limit=limit, continue_key=cont)
            pages.append((view(res), res.cont))
            cont = res.cont
            if not cont:
                return pages

    async def views(store) -> dict:
        got = {r: view(await store.list(r))
               for r in ("nodes", "pods", "leases")}
        for shard in range(2):
            got[f"shard-{shard}"] = view(
                await store.list("nodes", shard=shard))
        got["walk"] = await walk(store, "nodes", 5)
        return got

    async def body():
        port_cp, ref_cp = MultiProcessControlPlane(2), JCP(2)
        inproc = [new_cluster_store(2), jmvcc.new_cluster_store(2)]
        clients = []
        try:
            await asyncio.gather(port_cp.start(), ref_cp.start())
            clients = [port_cp.client(), ref_cp.client()]
            stores = [(clients[0], types), (clients[1], jtypes),
                      (inproc[0], types), (inproc[1], jtypes)]
            writes = [await feed(s, t) for s, t in stores]
            seen = [await views(s) for s, _ in stores]
            assert writes[0] == writes[1] == writes[2] == writes[3]
            assert seen[0] == seen[1] == seen[2] == seen[3]
            assert len(seen[0]["walk"]) == 4
            assert seen[0]["pods"][0][1][2] == "node-004"
        finally:
            for c in clients:
                await c.close()
            for s in inproc:
                s.stop()
            await asyncio.gather(port_cp.stop(), ref_cp.stop())
    asyncio.run(body())


def test_shared_rv_counter_matches_the_reference():
    got, want = SharedRVCounter(), jrv.SharedRVCounter()
    steps = []
    for op in ("next", "next", 10, "next", 3, "next", 12, 12, "next"):
        for c in (got, want):
            if op == "next":
                c.next()
            else:
                c.value = op
        steps.append((got.value, want.value))
    assert all(a == b for a, b in steps)
    assert [a for a, _ in steps] == [1, 2, 10, 11, 11, 12, 12, 12, 13]


def test_meta_shard_sigkill_loses_no_acknowledged_pod(tmp_path):
    async def body():
        d = str(tmp_path)
        with flags.scoped_set("KTPU_WAL", 1), \
                flags.scoped_set("KTPU_WAL_FSYNC", "always"):
            cp = MultiProcessControlPlane(2, data_dir=d)
            store = None
            try:
                await cp.start()
                await cp.start_schedulers(2)
                store = cp.client()
                for i in range(3):
                    await store.create("nodes", make_node(f"n{i}"))
                acked: list = []
                refused = [0]
                stop_churn = asyncio.Event()

                async def churn():
                    i = 0
                    while not stop_churn.is_set():
                        name = f"c{i}"
                        i += 1
                        try:
                            await store.create("pods", make_pod(name))
                        except StoreError:
                            # The shard is down: never acknowledged.
                            refused[0] += 1
                            await asyncio.sleep(0.02)
                            continue
                        acked.append(name)
                        await asyncio.sleep(0.005)

                task = asyncio.ensure_future(churn())

                async def acked_at_least(n):
                    return len(acked) >= n
                await until(lambda: acked_at_least(10), "10 creates")
                await cp.kill_shard(0)           # SIGKILL: no flush

                async def refused_some():
                    return refused[0] >= 3
                await until(refused_some, "creates refused while down")
                t0 = time.monotonic()
                await cp.restart_shard(0)        # snapshot + WAL replay
                recovery_s = time.monotonic() - t0
                n = len(acked)
                await until(lambda: acked_at_least(n + 10),
                            "creates after the restart")
                stop_churn.set()
                await task
                assert recovery_s < 30.0
                survivors = {p["metadata"]["name"]
                             for p in (await store.list("pods")).items}
                lost = [a for a in acked if a not in survivors]
                assert lost == []

                async def all_bound():
                    return survivors <= await bound_names(store)
                await until(all_bound, "every survivor bound")
                cp.check_alive()
            finally:
                if store is not None:
                    await store.close()
                await cp.stop()
    asyncio.run(body())


def test_leader_failover_and_post_failover_binding():
    async def body():
        with flags.scoped_set("KTPU_LEASE_DURATION", LEASE_S):
            cp = MultiProcessControlPlane(1)
            store = None
            try:
                await cp.start()
                await cp.start_schedulers(2)
                store = cp.client()
                await store.create("nodes", make_node("n0"))
                await store.create("pods", make_pod("before"))

                async def bound(name):
                    return name in await bound_names(store)
                await until(lambda: bound("before"), "the first bind")
                leader = await until(cp.leader_identity, "a leader")
                killed = await cp.kill_leader()
                assert killed == leader

                async def new_leader():
                    who = await cp.leader_identity()
                    return who if who and who != killed else None
                survivor = await until(new_leader, "the standby leading")
                await store.create("pods", make_pod("after-failover"))
                await until(lambda: bound("after-failover"),
                            "the bind after the failover")
                assert await cp.leader_identity() == survivor
                assert list(cp.sched_procs) == [survivor]
                cp.check_alive()
            finally:
                if store is not None:
                    await store.close()
                await cp.stop()
    asyncio.run(body())


def test_kill_leader_through_the_runner():
    template = copy.deepcopy(CHURN_DAY["workloadTemplate"])
    template[-1]["faults"] = [{"at": 1.0, "kind": "killLeader"}]
    template[-1]["recoveryTimeout"] = 30.0
    template.append({"opcode": "barrier"})
    with flags.scoped_set("KTPU_LEASE_DURATION", LEASE_S):
        runner = PerfRunner(batch_size=1, processes=2)
        res = asyncio.run(runner.run(template, {
            "initNodes": 50, "warmupPods": 20, "rate": 20,
            "duration": 3.0}, timeout=DEADLINE_S))
    d = res.as_dict()
    (rec,) = d["churn_faults"]
    assert rec["kind"] == "killLeader" and rec["recovered"] is True
    assert rec["leader"] in ("ktpu-sched-0", "ktpu-sched-1")
    assert rec["replacements"] == 8 and rec["recovery_s"] > 0
    assert d["leader_elections_total"] == 2 and d["process_count"] == 2
    assert d["churn_faults_injected"] == {"killLeader": 1}
