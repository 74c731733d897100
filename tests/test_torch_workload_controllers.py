"""The port's Job, CronJob, DaemonSet and StatefulSet controllers against
the JAX package on the CPU, with the harness of
`tests/test_torch_controllers.py` (`Stepper`: every sync step and
quiescence compared, uids, timestamps, `time.time` and the name counters
pinned; KWOK marks bound pods Running and completes those annotated
`kwok.x-k8s.io/complete-after`).

- Job: NonIndexed and Indexed completion modes, no completions,
  backoffLimit (pods failed by a scripted step) and
  activeDeadlineSeconds (the pinned clock moved past it).
- CronJob: the Allow, Forbid and Replace policies over ticks of the
  pinned clock, the history limits, suspend and startingDeadlineSeconds;
  `CronSchedule` over a seeded sweep of expressions: every fire time of a
  year from the same start identical (at most 300 each), the same
  refusals.
- DaemonSet: a node selector, a NoSchedule taint, a node added and one
  deleted; `node_name_affinity` and `_tolerates` alike.
- StatefulSet: OrderedReady and Parallel, scale down and up,
  volumeClaimTemplates whose PVCs the ported PV binder provisions, a
  deleted and a failed pod replaced.
- The reference's end-to-end cases (`tests/test_workload_controllers.py`)
  against the port, with the host-path scheduler.

Tolerance: none (identical objects after every step). Every wait has a
deadline of 60 s.
"""

import asyncio
import random
from datetime import datetime, timedelta, timezone

import pytest

from test_torch_controllers import (  # noqa: F401
    PACKAGES, T0, Stepper, both, cases, kwok_cluster, kwok_idle, mod, pinned,
    port_of, run_case)

DONE_FAST = {"kwok.x-k8s.io/complete-after": "0"}


def _pod_template(annotations=None, app="batch") -> dict:
    meta = {"labels": {"app": app}}
    if annotations:
        meta["annotations"] = dict(annotations)
    return {"metadata": meta,
            "spec": {"containers": [{"name": "main", "image": "batch:v1",
                                     "resources": {"requests":
                                                   {"cpu": "100m"}}}]}}


def _set_phase(phase: str):
    def mutate(o):
        o["status"]["phase"] = phase
        return o
    return mutate


def _set_spec(field: str, value):
    def mutate(o):
        o["spec"][field] = value
        return o
    return mutate


# -- Job ----------------------------------------------------------------------

JOBS = {
    "nonindexed": dict(parallelism=2, completions=5),
    "indexed": dict(parallelism=2, completions=4, completion_mode="Indexed"),
    "no-completions": dict(parallelism=3),
    "backoff": dict(parallelism=2, completions=3, backoff_limit=1),
    "deadline": dict(parallelism=2, completions=3,
                     active_deadline_seconds=30),
}


async def _job_script(a, clock, case: str) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    st = Stepper(a, store, [a.C.JobController(store), kwok],
                 ["jobs", "pods"], idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    fast = case not in ("backoff", "deadline")
    await st.step("create", store.create("jobs", a.C.make_job(
        "work", template=_pod_template(DONE_FAST if fast else None),
        **JOBS[case])))
    await st.run()
    if case == "backoff":
        # One failure at a time: the Job fails only past backoffLimit.
        for _ in range(3):
            running = sorted(p["metadata"]["name"]
                             for p in (await store.list("pods")).items
                             if p["status"].get("phase") == "Running")
            if running:
                await st.step(f"fail {running[0]}", store.guaranteed_update(
                    "pods", f"default/{running[0]}", _set_phase("Failed")))
            await st.run()
    if case == "deadline":
        clock.t = T0 + 31
        await st.run()
    st.stop()
    return st.trace


@pytest.mark.parametrize("case", sorted(JOBS))
def test_job_sync_steps_match(pinned, case):
    final = both(_job_script, pinned, case)[-1][1]
    job = final["jobs"]["default/work"]["status"]
    want = {"nonindexed": "Complete", "indexed": "Complete",
            "no-completions": "Complete", "backoff": "Failed",
            "deadline": "Failed"}[case]
    assert [c["type"] for c in job["conditions"]] == [want]
    if case == "indexed":
        assert job["completedIndexes"] == ["0", "1", "2", "3"]
        assert sorted(final["pods"]) == [f"default/work-{i}" for i in range(4)]


# -- CronJob ------------------------------------------------------------------


async def _cronjob_script(a, clock, policy: str) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    st = Stepper(a, store, [a.C.CronJobController(store)],
                 ["cronjobs", "jobs"])
    await st.start()
    await st.step("create", store.create("cronjobs", a.C.make_cronjob(
        "tick", "*/5 * * * *", concurrency_policy=policy,
        successful_jobs_history_limit=1, failed_jobs_history_limit=1)))
    await st.run()
    for minutes in (5, 10, 15):
        clock.t = T0 + 60 * minutes + 1
        await st.run()

    def finish(kind):
        def mutate(o):
            o["status"]["conditions"] = [{"type": kind, "status": "True"}]
            return o
        return mutate
    for i, j in enumerate(sorted((await store.list("jobs")).items,
                                 key=lambda j: j["metadata"]["name"])):
        await st.step(f"finish {j['metadata']['name']}",
                      store.guaranteed_update(
                          "jobs", f"default/{j['metadata']['name']}",
                          finish("Complete" if i % 2 == 0 else "Failed")))
    clock.t = T0 + 60 * 20 + 1
    await st.run()
    await st.step("suspend", store.guaranteed_update(
        "cronjobs", "default/tick", _set_spec("suspend", True)))
    clock.t = T0 + 60 * 25 + 1
    await st.run()
    await st.step("resume, deadline 10 s", store.guaranteed_update(
        "cronjobs", "default/tick",
        lambda o: _set_spec("startingDeadlineSeconds", 10)(
            _set_spec("suspend", False)(o))))
    clock.t = T0 + 60 * 41
    await st.run()
    st.stop()
    return st.trace


@pytest.mark.parametrize("policy", ["Allow", "Forbid", "Replace"])
def test_cronjob_sync_steps_match(pinned, policy):
    final = both(_cronjob_script, pinned, policy)[-1][1]
    tick = final["cronjobs"]["default/tick"]
    # The deadline skipped the 40-minute run but recorded it.
    assert tick["status"]["lastScheduleTime"] == "2026-01-01T00:40:00Z"
    assert final["jobs"]


def _expressions(rng: random.Random, n: int) -> list[str]:
    def field(lo, hi):
        kind = rng.randrange(6)
        a, b = sorted(rng.sample(range(lo, hi + 1), 2))
        return ["*", f"*/{rng.randrange(1, 9)}", str(a), f"{a}-{b}",
                ",".join(str(x) for x in sorted(rng.sample(
                    range(lo, hi + 1), 3))),
                f"{a}-{b}/{rng.randrange(1, 4)}"][kind]
    out = []
    for _ in range(n):
        out.append(" ".join([field(0, 59), field(0, 23), field(1, 31),
                             field(1, 12), field(0, 7)]))
    out += ["61 * * * *", "* * *", "0 0 30 2 *", "* * 0 * *", "*/0 * * * *",
            "5-2 * * * *", "0 0 * * 7", "0 9 * * 1"]
    return out


def _fires(cron_mod, expr: str, start: datetime) -> list:
    try:
        sched = cron_mod.CronSchedule(expr)
    except ValueError as e:
        return ["refused", str(e)]
    out, t, end = [], start, start + timedelta(days=365)
    try:
        while len(out) < 300:
            t = sched.next_after(t)
            if t > end:
                break
            out.append(t.isoformat())
    except ValueError as e:
        out.append(("never", str(e)))
    return out


def test_cron_schedule_sweep_matches():
    exprs = _expressions(random.Random(20), 120)
    start = datetime(2026, 7, 30, 10, 0, 30, tzinfo=timezone.utc)
    got = [[_fires(mod(root, "controllers.cronjob"), e, start)
            for e in exprs] for root in PACKAGES]
    assert got[0] == got[1]
    assert sum(1 for f in got[1] if f and f[0] == "refused") >= 4
    assert sum(len(f) for f in got[1]) > 10000


# -- DaemonSet ----------------------------------------------------------------


async def _daemonset_script(a, clock) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)

    def label(o):
        o["metadata"]["labels"]["role"] = "edge"
        return o
    await store.guaranteed_update("nodes", "kwok-node-0", label)
    ds = a.C.DaemonSetController(store)
    st = Stepper(a, store, [ds, kwok], ["daemonsets", "pods"],
                 idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    await st.step("create agent", store.create(
        "daemonsets", a.C.make_daemonset(
            "agent", {"matchLabels": {"app": "agent"}},
            _pod_template(app="agent"))))
    edge = _pod_template(app="edge")
    edge["spec"]["nodeSelector"] = {"role": "edge"}
    await st.step("create edge", store.create("daemonsets", a.C.make_daemonset(
        "edge", {"matchLabels": {"app": "edge"}}, edge)))
    await st.run()
    await st.step("add n-extra", store.create("nodes", a.types.make_node(
        "n-extra", labels={"role": "edge"})))
    await st.run()

    def taint(o):
        o["spec"]["taints"] = [{"key": "dedicated", "value": "db",
                                "effect": "NoSchedule"}]
        return o
    await st.step("taint kwok-node-1", store.guaranteed_update(
        "nodes", "kwok-node-1", taint))
    await st.run()
    await st.step("delete kwok-node-2", store.delete("nodes", "kwok-node-2"))
    await st.run()
    st.stop()
    return st.trace


def test_daemonset_sync_steps_match(pinned):
    final = both(_daemonset_script, pinned)[-1][1]
    assert sorted(final["pods"]) == [
        "default/agent-kwok-node-0", "default/agent-n-extra",
        "default/edge-kwok-node-0", "default/edge-n-extra"]
    assert final["daemonsets"]["default/agent"]["status"][
        "desiredNumberScheduled"] == 2


def test_daemonset_pure_functions_match():
    rng = random.Random(9)
    out = []
    for root in PACKAGES:
        dsm = mod(root, "controllers.daemonset")
        rng.seed(9)
        got = [dsm.node_name_affinity(f"node-{i}") for i in range(5)]
        for _ in range(300):
            tol = {k: v for k, v in (
                ("key", rng.choice(["a", "b", ""])),
                ("operator", rng.choice(["Equal", "Exists"])),
                ("value", rng.choice(["x", "y", ""])),
                ("effect", rng.choice(["NoSchedule", "NoExecute", ""])))
                if v or rng.random() < 0.3}
            taint = {"key": rng.choice(["a", "b"]),
                     "value": rng.choice(["x", "y", ""]),
                     "effect": rng.choice(["NoSchedule", "NoExecute"])}
            got.append(dsm._tolerates(tol, taint))
        got.append(dsm.DAEMON_TOLERATIONS)
        out.append(got)
    assert out[0] == out[1]


# -- StatefulSet --------------------------------------------------------------


async def _statefulset_script(a, clock, policy: str) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    await store.create("storageclasses", a.types.make_storage_class(
        "standard", binding_mode="Immediate", is_default=True))
    st = Stepper(a, store, [a.C.StatefulSetController(store),
                            a.C.PVBinderController(store, provision_delay=0),
                            kwok],
                 ["statefulsets", "pods", "persistentvolumeclaims",
                  "persistentvolumes"], idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    vct = [{"metadata": {"name": "data"},
            "spec": {"accessModes": ["ReadWriteOnce"],
                     "resources": {"requests": {"storage": "1Gi"}}}}]
    await st.step("create", store.create("statefulsets", a.C.make_statefulset(
        "db", 3, {"matchLabels": {"app": "db"}}, _pod_template(app="db"),
        pod_management_policy=policy, volume_claim_templates=vct)))
    await st.run()
    await st.step("scale to 1", store.guaranteed_update(
        "statefulsets", "default/db", _set_spec("replicas", 1)))
    await st.run()
    await st.step("scale to 3", store.guaranteed_update(
        "statefulsets", "default/db", _set_spec("replicas", 3)))
    await st.run()
    await st.step("delete db-1", store.delete("pods", "default/db-1"))
    await st.run()
    await st.step("fail db-2", store.guaranteed_update(
        "pods", "default/db-2", _set_phase("Failed")))
    await st.run()
    st.stop()
    return st.trace


@pytest.mark.parametrize("policy", ["OrderedReady", "Parallel"])
def test_statefulset_sync_steps_match(pinned, policy):
    final = both(_statefulset_script, pinned, policy)[-1][1]
    assert sorted(final["pods"]) == [f"default/db-{i}" for i in range(3)]
    assert all(p["status"]["phase"] == "Running"
               for p in final["pods"].values())
    assert sorted(final["persistentvolumeclaims"]) == [
        f"default/data-db-{i}" for i in range(3)]
    assert all(c["status"]["phase"] == "Bound"
               for c in final["persistentvolumeclaims"].values())


# -- the reference's end-to-end cases against the port ------------------------

WORKLOAD = port_of("test_workload_controllers.py")


@pytest.mark.parametrize("case", cases(WORKLOAD))
def test_reference_case_against_the_port(case):
    run_case(WORKLOAD, case)
