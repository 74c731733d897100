"""The port's controller manager, `python -m kubernetes_tpu_torch.controllers`,
on the CPU.

- `REGISTRY` and `DEFAULT_SET` name the reference's controllers in the
  reference's order, `build_parser` has the reference's options, and every
  controller of the registry (the default set's node lifecycle controller
  included) builds over the port's store.
- An unknown controller, or neither `--server` nor `--wire`, exits
  non-zero in both packages.
- Two `--leader-elect` processes (`chip_smoke.controller_manager_child`,
  each with its own token and a 4 s lease) against the port's apiserver
  process over the KTPU wire: a Deployment of 6 reaches Running through
  the port's host-path scheduler and KWOK in the test; a SIGKILL of the
  lease holder moves the Lease to the other, which scales the Deployment
  to 9 (the 3 new pods Running too) and exits 0 on SIGTERM.
- `chip_smoke.py` phase 21's script (`controller_manager`) at a small
  size on the CPU (4 Deployments of 8 over 20 KWOK nodes, an Indexed Job
  of 16, the scheduler process on the host path): every gate of (a)-(e)
  holds and each process exits 0 on SIGTERM.
- Hazard 2, pinned in both packages: pod names come from one class-level
  counter per process, so a fresh process (the counter reset to 0) that
  scales up an existing ReplicaSet meets the names the old one used; each
  create that collides ends its sync, one name per sync, until the
  counter passes them. The same syncs in both (the `Stepper` of
  `tests/test_torch_controllers.py`).

Every wait has a deadline (60 s); children are killed in `finally`.
"""

import asyncio
import subprocess
import sys
import time

import pytest

import chip_smoke
from chip_smoke import (CM_IDENTITY, CM_LEASE_KEY, REPO, Child,
                        apiserver_addresses, apiserver_child,
                        controller_manager_child, lease_holder)
from test_torch_controllers import (  # noqa: F401
    PACKAGES, T0, Stepper, api, both, mod, pinned)
from test_torch_entrypoints import children, parser_view  # noqa: F401

DEADLINE = 60.0


def test_registry_and_default_set_match_the_reference():
    ref, port = (mod(r, "controllers.__main__") for r in PACKAGES)
    assert list(port.REGISTRY.items()) == list(ref.REGISTRY.items())
    assert port.DEFAULT_SET == ref.DEFAULT_SET
    assert "nodelifecycle" in port.DEFAULT_SET
    assert "kubeproxy" not in port.DEFAULT_SET
    assert parser_view(port.build_parser()) == parser_view(ref.build_parser())


def test_every_registered_controller_builds():
    a = api("kubernetes_tpu_torch")
    main = mod("kubernetes_tpu_torch", "controllers.__main__")
    store = a.new_store()
    built = {name: getattr(a.C, cls)(store)
             for name, cls in main.REGISTRY.items()}
    assert all(isinstance(c, a.C.Controller) for c in built.values())
    assert {c.NAME for c in built.values()} >= {"deployment", "replicaset",
                                                "garbage-collector", "job"}
    mgr = a.C.ControllerManager(store, [built[n] for n in main.DEFAULT_SET])
    assert len(mgr.controllers) == len(main.REGISTRY) - 1
    assert sorted(a.C.__all__) == sorted(
        mod("kubernetes_tpu", "controllers").__all__)


@pytest.mark.parametrize("root", PACKAGES)
@pytest.mark.parametrize("args,message", [
    ((), "one of --server / --wire is required"),
    (("--wire", "127.0.0.1:1", "--controllers", "deployment,nope"),
     "unknown controller 'nope'"),
])
def test_refusals_exit_non_zero(root, args, message):
    out = subprocess.run(
        [sys.executable, "-m", f"{root}.controllers", *args], cwd=REPO,
        capture_output=True, text=True, timeout=DEADLINE,
        env={"JAX_PLATFORMS": "cpu", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert message in out.stderr


async def _until(pred, what: str, *live: Child):
    """The first true value of the coroutine function `pred`."""
    deadline = time.monotonic() + DEADLINE
    while True:
        got = await pred()
        if got:
            return got
        for c in live:
            c.check_alive()
        if time.monotonic() > deadline:
            raise TimeoutError(what)
        await asyncio.sleep(0.05)


def test_leader_elected_pair_rolls_out_and_fails_over(tmp_path, children):
    from kubernetes_tpu_torch.apiserver.wire import WireStore
    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.controllers import (ControllerManager,
                                                  KwokController,
                                                  make_deployment)
    from kubernetes_tpu_torch.scheduler import Scheduler

    template = {"metadata": {"labels": {"app": "web"}},
                "spec": {"containers": [{
                    "name": "c", "image": "web:v1",
                    "resources": {"requests": {"cpu": "100m"}}}]}}

    async def body():
        log = str(tmp_path)
        api_ = apiserver_child(log, "apiserver", "--port", 0, "--wire-port",
                               0, "--token", "admin-token=admin", "--token",
                               "cm-a-token=cm-a", "--token",
                               "cm-b-token=cm-b")
        children.append(api_)
        _, wire = await apiserver_addresses(api_, DEADLINE)
        cms = {s: controller_manager_child(
            log, f"cm-{s}", wire, f"cm-{s}-token",
            controllers="deployment,replicaset", lease_s=4.0) for s in "ab"}
        children.extend(cms.values())
        store = WireStore(wire, token="admin-token")
        kwok = KwokController(store, node_count=3, lease_period=1.0)
        await kwok.register_nodes()
        mgr = ControllerManager(store, [kwok])
        await mgr.start()
        sched = Scheduler(store, seed=3)
        factory = InformerFactory(store)
        await sched.setup_informers(factory)
        factory.start()
        await factory.wait_for_sync()
        task = asyncio.ensure_future(sched.run())
        try:
            ids = {s: (await c.line(CM_IDENTITY, DEADLINE)).group(1)
                   for s, c in cms.items()}
            await store.create("deployments", make_deployment(
                "web", 6, {"matchLabels": {"app": "web"}}, template))

            async def running(n):
                pods = (await store.list("pods")).items
                return len(pods) == n and all(
                    p["status"].get("phase") == "Running" for p in pods) \
                    and pods

            first = await _until(lambda: running(6), "6 pods Running",
                                 api_, *cms.values())
            holder = await _until(
                lambda: lease_holder(store, CM_LEASE_KEY),
                "a lease holder")
            lead = next(s for s, i in ids.items() if i == holder)
            other = "b" if lead == "a" else "a"
            assert await cms[lead].kill() == -9

            async def moved():
                return await lease_holder(store, CM_LEASE_KEY) == ids[other]
            await _until(moved, "the lease handover", api_, cms[other])

            def scale(o):
                o["spec"]["replicas"] = 9
                return o
            await store.guaranteed_update("deployments", "default/web",
                                          scale)
            final = await _until(lambda: running(9), "9 pods Running",
                                 api_, cms[other])
            rc = await cms[other].stop()
            return first, final, rc, cms[other].text()
        finally:
            await sched.stop()
            task.cancel()
            await mgr.stop()
            factory.stop()
            await store.close()

    first, final, rc, log = asyncio.run(body())
    old = {p["metadata"]["name"] for p in first}
    new = {p["metadata"]["name"] for p in final}
    assert old < new and len(new - old) == 3
    assert all(p["spec"]["nodeName"].startswith("kwok-node-") for p in final)
    assert rc == 0
    assert "deployment, replicaset" in log


def test_phase21_script_at_a_small_size(tmp_path, monkeypatch):
    for name, value in (("CM_NODES", 20), ("CM_DEPLOYMENTS", 4),
                        ("CM_REPLICAS", 8), ("CM_JOB_COMPLETIONS", 16),
                        ("CM_JOB_PARALLELISM", 4)):
        monkeypatch.setattr(chip_smoke, name, value)
    out = asyncio.run(chip_smoke.controller_manager(None, str(tmp_path),
                                                    card=False))
    assert out["rollout_creates"] == 32 and out["rollout_deletes"] == 0
    assert out["launches"] == {"wave_solve": 0, "probe": 0}
    assert 0 < out["failover_s"] < DEADLINE


async def _fresh_process_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    await store.create("nodes", a.types.make_node("n0"))
    template = {"metadata": {"labels": {"app": "web"}},
                "spec": {"containers": [{"name": "c", "image": "web:v1"}]}}
    rsc = a.C.ReplicaSetController(store)
    st = Stepper(a, store, [rsc], ["replicasets", "pods"], binder=True)
    await st.start()
    await st.step("create", store.create("replicasets", a.C.make_replicaset(
        "web", 3, {"matchLabels": {"app": "web"}}, template)))
    await st.run()
    st.stop()
    # A fresh controller-manager process: the class-level counter restarts.
    type(rsc)._seq = 0
    rsc2 = a.C.ReplicaSetController(store)
    st2 = Stepper(a, store, [rsc2], ["replicasets", "pods"], binder=True)
    st2.trace = st.trace
    await st2.start()
    await st2.step("scale to 5", store.guaranteed_update(
        "replicasets", "default/web",
        lambda o: (o["spec"].__setitem__("replicas", 5), o)[1]))
    # A sync whose create collides changes no object (only the counter),
    # so rounds are driven one by one before the run to quiescence.
    for _ in range(4):
        await st2.round()
    await st2.run()
    st2.stop()
    return st2.trace


def test_fresh_process_pod_names_collide_one_per_sync(pinned):
    trace = both(_fresh_process_script, pinned)
    scaled = trace.index(next(t for t in trace if t[0] == "scale to 5"))
    after = [len(s["pods"]) for w, s in trace[scaled:]
             if w.startswith("replicaset default/web")]
    # web-00001..00003 exist: the first three syncs each meet one of them
    # and create nothing; the fourth creates web-00004 and web-00005.
    assert after[:4] == [3, 3, 3, 5] and after[-1] == 5
    names = sorted(trace[-1][1]["pods"])
    assert names == [f"default/web-{i:05d}" for i in range(1, 6)]
