"""The port's long-tail controllers against the JAX package on the CPU,
with the harness of `tests/test_torch_controllers.py` (`Stepper`: every
sync step and quiescence compared; uids, timestamps, the clocks and the
token generator pinned; a refused call's error recorded with its step):

- EndpointSlice over KWOK pods (a Ready condition turned False, a
  relabel, the Service deleted); ResourceQuota's status with
  `install_quota_admission` refusing the pod that would exceed it;
  Disruption's PDB status with `install_eviction_subresource` (an
  eviction allowed, the next refused, a PDB with neither field refused);
  TTL-after-finished over the pinned clock; the HPA over pods'
  `ktpu.dev/load` (up, down, clamped);
- ServiceAccount and Token controllers (a default account per namespace,
  a token per account, a squatted name, a deleted account) and what
  `ServiceAccountAuthenticator` maps each token to; the authenticator
  plugged into the port's `APIServer(token_authenticator=...)` lets an
  issued token through and refuses another;
- ResourceClaim (a claim stamped from a template, a reservation released
  when its pod ends, a drained user claim deallocated) and
  AttachDetach (VolumeAttachments for bound claims on scheduled pods,
  detached when the pod goes);
- the prober (readiness and liveness stages over the pinned clock) and
  node-pressure eviction (taint, lowest priority evicted, untaint);
  kube-proxy's compiled rules with `install_service_ip_allocator`;
- the reference's end-to-end cases (`tests/test_longtail_controllers.py`,
  `tests/test_controller_tier2.py`) against the port.

Tolerance: none (identical objects, outcomes and tables after every
step). Every wait has a deadline of 60 s.
"""

import asyncio

import aiohttp
import pytest

from test_torch_controllers import (  # noqa: F401
    T0, Stepper, api, both, cases, kwok_cluster, kwok_idle, pinned, port_of,
    run_case)

WEB = {"metadata": {"labels": {"app": "web"}},
       "spec": {"containers": [{"name": "c", "image": "web:v1",
                                "resources": {"requests": {
                                    "cpu": "100m", "memory": "1Gi"}}}]}}


def _pod(a, name: str, labels=None, **kw) -> dict:
    return a.types.make_pod(name, labels=labels or {"app": "web"}, **kw)


def _update(field_path: tuple, value):
    def mutate(o):
        cur = o
        for k in field_path[:-1]:
            cur = cur.setdefault(k, {})
        cur[field_path[-1]] = value
        return o
    return mutate


def _not_ready(o):
    for c in o["status"]["conditions"]:
        if c["type"] == "Ready":
            c["status"] = "False"
    return o


# -- EndpointSlice, quota, disruption, TTL, HPA -------------------------------


async def _endpointslice_script(a, clock) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    st = Stepper(a, store, [a.C.EndpointSliceController(store), kwok],
                 ["services", "endpointslices", "pods"],
                 idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    await st.step("service", store.create("services", a.C.make_service(
        "web", {"app": "web"})))
    for i in range(3):
        await st.step(f"pod w{i}", store.create("pods", _pod(a, f"w{i}")))
    await st.step("other", store.create("pods", _pod(a, "x", {"app": "x"})))
    await st.run()
    await st.step("w1 not ready", store.guaranteed_update(
        "pods", "default/w1", _not_ready))
    await st.step("relabel w2", store.guaranteed_update(
        "pods", "default/w2", _update(("metadata", "labels", "app"), "x")))
    await st.run()
    await st.step("delete service", store.delete("services", "default/web"))
    await st.run()
    st.stop()
    return st.trace


def test_endpointslice_sync_steps_match(pinned):
    trace = both(_endpointslice_script, pinned)
    q = [s for w, s in trace if w == "quiescence"]
    ready = [[(e["targetRef"]["name"], e["conditions"]["ready"])
              for e in s["endpointslices"]["default/web"]["endpoints"]]
             for s in q[:2]]
    assert sorted(ready[0]) == [("w0", True), ("w1", True), ("w2", True)]
    assert sorted(ready[1]) == [("w0", True), ("w1", False)]
    assert not q[2]["endpointslices"]


async def _quota_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    a.C.install_quota_admission(store)
    await store.create("nodes", a.types.make_node("n0"))
    st = Stepper(a, store, [a.C.ResourceQuotaController(store)],
                 ["resourcequotas", "pods"])
    await st.start()
    await st.step("quota", store.create("resourcequotas",
                                        a.C.make_resource_quota(
                                            "q", {"pods": "3",
                                                  "requests.cpu": "1",
                                                  "memory": "2Gi"})))
    await st.run()
    for i, cpu in enumerate(("300m", "300m", "500m", "300m", "100m")):
        await st.attempt(f"create p{i} cpu {cpu}", store.create(
            "pods", a.types.make_pod(f"p{i}", requests={"cpu": cpu,
                                                        "memory": "500Mi"})))
        await st.run()
    await st.attempt("finish p0", store.guaranteed_update(
        "pods", "default/p0", _update(("status", "phase"), "Succeeded")))
    await st.attempt("create p5", store.create("pods", a.types.make_pod(
        "p5", requests={"cpu": "100m", "memory": "1Gi"})))
    await st.run()
    st.stop()
    return st.trace


def test_resource_quota_sync_steps_match(pinned):
    trace = both(_quota_script, pinned)
    outcomes = [w.split(": ", 1)[1] for w, _ in trace
                if w.startswith(("create p", "finish"))]
    assert outcomes[:2] == ["ok", "ok"] and outcomes[2].startswith("Invalid")
    assert trace[-1][1]["resourcequotas"]["default/q"]["status"]["used"]


async def _disruption_script(a, clock) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    a.C.install_eviction_subresource(store)
    st = Stepper(a, store, [a.C.DisruptionController(store), kwok],
                 ["poddisruptionbudgets", "pods"],
                 idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    await st.attempt("pdb without a field", store.create(
        "poddisruptionbudgets", a.C.make_pdb("bad", {"app": "web"})))
    await st.step("pdb", store.create("poddisruptionbudgets", a.C.make_pdb(
        "web", {"app": "web"}, min_available=2)))
    for i in range(3):
        await st.step(f"pod w{i}", store.create("pods", _pod(a, f"w{i}")))
    await st.run()
    for i in range(3):
        await st.attempt(f"evict w{i}", store.subresource(
            "pods", f"default/w{i}", "eviction", {}))
        await st.run()
    await st.step("max-unavailable pdb", store.create(
        "poddisruptionbudgets", a.C.make_pdb(
            "loose", {"app": "web"}, max_unavailable=1)))
    await st.run()
    st.stop()
    return st.trace


def test_disruption_sync_steps_match(pinned):
    trace = both(_disruption_script, pinned)
    outcomes = {w.split(":")[0]: w.split(": ", 1)[1] for w, _ in trace
                if w.startswith(("evict", "pdb without"))}
    assert outcomes["pdb without a field"].startswith("Invalid")
    assert outcomes["evict w0"] == "ok"
    assert outcomes["evict w1"].startswith("Conflict")


async def _ttl_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    st = Stepper(a, store, [a.C.TTLAfterFinishedController(store)], ["jobs"])
    await st.start()
    for name, ttl, cond in (("done", 10, "Complete"), ("failed", 30, "Failed"),
                            ("running", 10, None), ("kept", None, "Complete")):
        job = a.C.make_job(name)
        if ttl is not None:
            job["spec"]["ttlSecondsAfterFinished"] = ttl
        if cond:
            job["status"]["conditions"] = [{
                "type": cond, "status": "True",
                "lastTransitionTime": "2026-01-01T00:00:00Z"}]
        await st.step(f"create {name}", store.create("jobs", job))
    for t in (5, 11, 29, 31):
        clock.t = T0 + t
        await st.run()
    st.stop()
    return st.trace


def test_ttl_after_finished_sync_steps_match(pinned):
    final = both(_ttl_script, pinned)[-1][1]
    assert sorted(final["jobs"]) == ["default/kept", "default/running"]


async def _hpa_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    await store.create("nodes", a.types.make_node("n0"))
    st = Stepper(a, store, [a.C.HorizontalPodAutoscalerController(store)],
                 ["horizontalpodautoscalers", "deployments", "pods"])
    await st.start()
    await st.step("deployment", store.create("deployments",
                                             a.C.make_deployment(
                                                 "web", 2,
                                                 {"matchLabels":
                                                  {"app": "web"}}, WEB)))
    await st.step("hpa", store.create("horizontalpodautoscalers", a.C.make_hpa(
        "web", "deployments/web", min_replicas=1, max_replicas=5)))
    for i in range(2):
        await st.step(f"pod w{i}", store.create("pods", _pod(a, f"w{i}")))
    for load in ("160", "400", "10", "0"):
        for i in range(2):
            await st.step(f"w{i} load {load}", store.guaranteed_update(
                "pods", f"default/w{i}",
                _update(("metadata", "annotations", "ktpu.dev/load"), load)))
        await st.run()
    st.stop()
    return st.trace


def test_hpa_sync_steps_match(pinned):
    trace = both(_hpa_script, pinned)
    sizes = [s["deployments"]["default/web"]["spec"]["replicas"]
             for w, s in trace if w == "quiescence"]
    # The loads stay put, so each sync scales again: 2 -> 4 -> 5 (max).
    assert sizes == [5, 5, 1, 1]
    assert 4 in [s["deployments"]["default/web"]["spec"]["replicas"]
                 for _, s in trace if s["deployments"]]


# -- ServiceAccount and tokens ------------------------------------------------


async def _serviceaccount_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    for ns in ("team", "dev"):
        await store.create("namespaces", a.types.make_namespace(ns))
    squat = a.meta.new_object("Secret", "default-token", "dev",
                              type="Opaque", data={"x": "y"})
    await store.create("secrets", squat)
    st = Stepper(a, store, [a.C.ServiceAccountController(store),
                            a.C.TokenController(store)],
                 ["namespaces", "serviceaccounts", "secrets"])
    auth = a.C.ServiceAccountAuthenticator(st.factory)
    await st.start()
    await st.run()
    await st.step("robot", store.create("serviceaccounts", a.meta.new_object(
        "ServiceAccount", "robot", "team")))
    await st.run()
    await st.step("delete team/default", store.delete(
        "serviceaccounts", "team/default"))
    await st.run()
    await st.step("delete robot", store.delete("serviceaccounts",
                                               "team/robot"))
    await st.run()
    tokens = {s["data"]["token"]: auth(s["data"]["token"])
              for s in (await store.list("secrets")).items
              if "token" in (s.get("data") or {})}
    tokens["not-a-token"] = auth("not-a-token")
    st.trace.append(("authenticator", tokens))
    st.trace.append(("quiescence", await st.snapshot()))
    st.stop()
    return st.trace


def test_serviceaccount_sync_steps_match(pinned):
    trace = both(_serviceaccount_script, pinned)
    final = [s for w, s in trace if w == "quiescence"][-1]
    assert sorted(final["serviceaccounts"]) == ["dev/default", "team/default"]
    assert "dev/default-token-uid2" in final["secrets"] or any(
        k.startswith("dev/default-token-") for k in final["secrets"])
    users = trace[-2][1]
    assert sorted(u for u in users.values() if u) == [
        "system:serviceaccount:dev:default",
        "system:serviceaccount:team:default"]


def test_authenticator_plugs_into_the_port_apiserver():
    """An issued token passes the port's `APIServer` bearer check and a
    made-up one gets 401."""
    a = api("kubernetes_tpu_torch")
    from kubernetes_tpu_torch.apiserver import APIServer

    async def main():
        store = a.new_store()
        a.install(store)
        factory = a.client.InformerFactory(store)
        auth = a.C.ServiceAccountAuthenticator(factory)
        mgr = a.C.ControllerManager(store, [
            a.C.ServiceAccountController(store), a.C.TokenController(store)])
        await store.create("namespaces", a.types.make_namespace("team"))
        factory.start()
        await mgr.start()
        server = APIServer(store, token_authenticator=auth)
        await server.start()
        try:
            token = None
            for _ in range(3000):
                items = (await store.list("secrets")).items
                token = next((s["data"]["token"] for s in items), None)
                if token and auth(token):
                    break
                await asyncio.sleep(0.02)
            codes = []
            async with aiohttp.ClientSession() as http:
                for t in (token, "made-up"):
                    async with http.get(
                            f"{server.url}/api/v1/namespaces/team/pods",
                            headers={"Authorization": f"Bearer {t}"}) as r:
                        codes.append(r.status)
            return auth(token), codes
        finally:
            await server.stop()
            await mgr.stop()
            factory.stop()
            store.stop()
    user, codes = asyncio.run(main())
    assert user == "system:serviceaccount:team:default"
    assert codes[0] != 401 and codes[1] == 401


# -- ResourceClaim and AttachDetach -------------------------------------------


async def _resourceclaim_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    await store.create("nodes", a.types.make_node("n0"))
    st = Stepper(a, store, [a.C.ResourceClaimController(store)],
                 ["resourceclaims", "resourceclaimtemplates", "pods"])
    await st.start()
    pod = a.types.make_pod("trainer")
    pod["spec"]["resourceClaims"] = [
        {"name": "gpu", "resourceClaimTemplateName": "gpus"}]
    await st.step("pod before its template", store.create("pods", pod))
    await st.run()
    await st.step("template", store.create(
        "resourceclaimtemplates", a.types.make_resource_claim_template(
            "gpus", requests=[{"name": "g", "deviceClassName": "gpu",
                               "count": 1}])))
    await st.run()
    await st.step("user claim", store.create(
        "resourceclaims", a.types.make_resource_claim("shared")))

    def reserve(uid_pod):
        def mutate(o):
            o.setdefault("status", {})["reservedFor"] = [uid_pod]
            o["status"]["allocation"] = {"devices": {"results": []}}
            return o
        return mutate
    trainer = await store.get("pods", "default/trainer")
    ref = {"resource": "pods", "name": "trainer",
           "uid": trainer["metadata"]["uid"]}
    for claim in ("default/trainer-gpu", "default/shared"):
        await st.step(f"reserve {claim}", store.guaranteed_update(
            "resourceclaims", claim, reserve(ref)))
    await st.run()
    await st.step("trainer succeeds", store.guaranteed_update(
        "pods", "default/trainer", _update(("status", "phase"), "Succeeded")))
    await st.run()
    st.stop()
    return st.trace


def test_resourceclaim_sync_steps_match(pinned):
    final = both(_resourceclaim_script, pinned)[-1][1]
    assert sorted(final["resourceclaims"]) == ["default/shared"]
    status = final["resourceclaims"]["default/shared"]["status"]
    assert status == {"reservedFor": []}


async def _attachdetach_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    for n in ("n0", "n1"):
        await store.create("nodes", a.types.make_node(n))
    for i in range(2):
        pv = a.types.make_pv(f"pv{i}")
        await store.create("persistentvolumes", pv)
        pvc = a.types.make_pvc(f"c{i}")
        pvc["spec"]["volumeName"] = f"pv{i}"
        pvc["status"] = {"phase": "Bound"}
        await store.create("persistentvolumeclaims", pvc)
    st = Stepper(a, store, [a.C.AttachDetachController(store)],
                 ["volumeattachments", "pods"], binder=True)
    await st.start()
    for i in range(2):
        pod = a.types.make_pod(f"p{i}")
        pod["spec"]["volumes"] = [{"name": "v", "persistentVolumeClaim":
                                   {"claimName": f"c{i}"}}]
        await st.step(f"pod p{i}", store.create("pods", pod))
    await st.run()
    await st.step("p0 fails", store.guaranteed_update(
        "pods", "default/p0", _update(("status", "phase"), "Failed")))
    await st.run()
    await st.step("delete p1", store.delete("pods", "default/p1"))
    await st.run()
    st.stop()
    return st.trace


def test_attachdetach_sync_steps_match(pinned):
    trace = both(_attachdetach_script, pinned)
    peak = max(len(s["volumeattachments"]) for w, s in trace)
    assert peak == 2 and not trace[-1][1]["volumeattachments"]


# -- node agent and kube-proxy ------------------------------------------------


async def _prober_script(a, clock) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    st = Stepper(a, store, [a.C.ProberController(store), kwok], ["pods"],
                 idle=(kwok_idle(kwok),), binder=True)
    await st.start()
    for name, anns in (("ready", {"kwok.x-k8s.io/fail-readiness-after": "5"}),
                       ("live", {"kwok.x-k8s.io/fail-liveness-after": "3"}),
                       ("bad", {"kwok.x-k8s.io/fail-readiness-after": "x"}),
                       ("plain", {})):
        pod = a.types.make_pod(name)
        pod["metadata"]["annotations"] = anns
        await st.step(f"pod {name}", store.create("pods", pod))
    await st.run()
    for t in (2, 4, 6, 10):
        clock.t = T0 + t
        await st.run()
    st.stop()
    return st.trace


def test_prober_sync_steps_match(pinned):
    final = both(_prober_script, pinned)[-1][1]["pods"]
    ready = {n: next(c["status"] for c in p["status"]["conditions"]
                     if c["type"] == "Ready") for n, p in final.items()}
    assert ready == {"default/bad": "True", "default/live": "True",
                     "default/plain": "True", "default/ready": "False"}
    assert final["default/live"]["status"]["restartCount"] == 1


async def _pressure_script(a, clock) -> list:
    clock.t = T0
    store = a.new_store()
    a.install(store)
    await store.create("nodes", a.types.make_node(
        "n0", allocatable={"cpu": "8", "memory": "10Gi", "pods": "110"}))
    ev = a.C.NodePressureEvictionController(store, threshold=0.8)
    st = Stepper(a, store, [ev], ["nodes", "pods"])
    await st.start()
    for name, mem, prio in (("a", "3Gi", 10), ("b", "3Gi", 0),
                            ("c", "1Gi", 0), ("d", "2Gi", 5)):
        pod = a.types.make_pod(name, node_name="n0",
                               requests={"memory": mem})
        pod["spec"]["priority"] = prio
        await st.step(f"pod {name}", store.create("pods", pod))
    await st.run()
    await st.step("pod e", store.create("pods", a.types.make_pod(
        "e", node_name="n0", requests={"memory": "2Gi"})))
    await st.run()
    st.stop()
    return st.trace


def test_node_pressure_eviction_sync_steps_match(pinned):
    trace = both(_pressure_script, pinned)
    tainted = [bool(s["nodes"]["n0"]["spec"].get("taints")) for w, s in trace]
    assert any(tainted) and not tainted[-1]


async def _kubeproxy_script(a, clock) -> list:
    clock.t = T0
    store, kwok = await kwok_cluster(a)
    a.C.install_service_ip_allocator(store)
    proxy = a.C.KubeProxyController(store, min_sync_period=0.0)
    st = Stepper(a, store, [a.C.EndpointSliceController(store), proxy, kwok],
                 ["services", "endpointslices"], idle=(kwok_idle(kwok),),
                 binder=True)
    await st.start()
    await st.step("web", store.create("services", a.C.make_service(
        "web", {"app": "web"})))
    headless = a.C.make_service("db", {"app": "db"})
    headless["spec"]["clusterIP"] = "None"
    await st.step("db", store.create("services", headless))
    pinned_vip = a.C.make_service("api", {"app": "web"}, port=8080)
    pinned_vip["spec"]["clusterIP"] = "10.96.0.3"
    await st.step("api", store.create("services", pinned_vip))
    await st.step("next", store.create("services", a.C.make_service(
        "next", {"app": "web"})))
    for i in range(3):
        await st.step(f"pod w{i}", store.create("pods", _pod(a, f"w{i}")))
    await st.run()
    st.trace.append(("rules", dict(proxy.rules)))
    picks = [proxy.lookup(svc["spec"]["clusterIP"], 80)
             for svc in (await store.list("services")).items
             for _ in range(4)]
    st.trace.append(("lookups", picks))
    await st.step("w0 not ready", store.guaranteed_update(
        "pods", "default/w0", _not_ready))
    await st.run()
    st.trace.append(("rules", dict(proxy.rules)))
    st.trace.append(("quiescence", await st.snapshot()))
    st.stop()
    return st.trace


def test_kubeproxy_sync_steps_match(pinned):
    trace = both(_kubeproxy_script, pinned)
    rules = [s for w, s in trace if w == "rules"]
    # web 10.96.0.2, api pinned at .3 (skipped by the allocator), next
    # .4; the headless db has no rule.
    assert sorted(rules[0]) == [("10.96.0.2", 80), ("10.96.0.3", 8080),
                                ("10.96.0.4", 80)]
    assert [len(b) for b in rules[0].values()] == [3, 3, 3]
    assert [len(b) for b in rules[1].values()] == [2, 2, 2]


# -- the reference's end-to-end cases against the port ------------------------

REFERENCE = {name: port_of(name) for name in (
    "test_longtail_controllers.py", "test_controller_tier2.py")}


@pytest.mark.parametrize("case", [
    f"{name}::{case}" for name, m in REFERENCE.items() for case in cases(m)])
def test_reference_case_against_the_port(case):
    name, _, rest = case.partition("::")
    run_case(REFERENCE[name], rest)
