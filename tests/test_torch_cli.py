"""The port's CLI (`kubernetes_tpu_torch.cli`, ktpuctl) on the CPU against
the JAX package's, command by command.

Each scenario takes one test of the reference's `tests/test_cli.py` and
runs its commands through both packages' `build_parser` and
`run_command`, against identically seeded stores: in process (the store
itself) and over each package's `APIServer` (a `RemoteStore` with server
discovery, as `main` builds it; the server runs a `WebhookAdmission` with
the expression-policy engine). Exit codes, stdout and stderr must be
identical byte for byte (the server's URL in stderr is replaced), and so
must the objects the commands leave in the store.

The AGE column reads the clock: both packages' `kubectl` see one pinned
time, and uids and creation timestamps are pinned as in
`test_torch_grpc.py`. Rollout history is seeded by hand (a controller's
pod names come from a per-process counter).

One `python -m kubernetes_tpu_torch.cli --server URL` subprocess runs
against a live server and prints what `run_command` prints in process;
against a closed port it exits 1 with one error line, discovery's
failure included.

Tolerance: none (exact host logic).
"""

import asyncio
import contextlib
import io
import json
import subprocess
import sys
import types as pytypes
from pathlib import Path

import pytest
import yaml

from test_torch_grpc import PACKAGES, Pinned, mod

ROOT = Path(__file__).resolve().parent.parent
#: the pinned clock: 62 minutes after the pinned creation timestamp.
NOW = 1767225600.0 + 3725.0
RESOURCES = ("pods", "nodes", "deployments", "replicasets", "events",
             "validatingadmissionpolicies")
TRANSPORTS = ("inproc", "http")


class Api:
    """One package's modules, under their reference names."""

    def __init__(self, root: str):
        self.root = root
        self.types = mod(root, "api.types")
        self.kubectl = mod(root, "cli.kubectl")
        self.store = mod(root, "store")


# -- seeding -----------------------------------------------------------------

async def seed(a: Api, store) -> None:
    """The reference's `seeded_store`: two nodes, a bound Running pod and
    a pending one."""
    for i in range(2):
        await store.create("nodes", a.types.make_node(f"n{i}"))
    await store.create("pods", a.types.make_pod(
        "web-1", labels={"app": "web"}, node_name="n0",
        requests={"cpu": "500m", "memory": "1Gi"}, phase="Running"))
    await store.create("pods", a.types.make_pod("pending-1"))


async def event(a: Api, store, name: str, reason: str, message: str,
                pod: str = "web-1") -> None:
    await store.create("events", {
        "kind": "Event", "metadata": {"name": name, "namespace": "default"},
        "involvedObject": {"kind": "Pod", "name": pod,
                           "namespace": "default"},
        "type": "Normal", "reason": reason, "message": message})


async def seed_describe(a, store):
    await event(a, store, "e1", "Scheduled", "assigned")


async def seed_deployment(a, store):
    await store.create("deployments", {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "d", "namespace": "default"},
        "spec": {"replicas": 1}})


async def seed_daemon_pod(a, store):
    ds_pod = a.types.make_pod("ds-pod", node_name="n0")
    ds_pod["metadata"]["ownerReferences"] = [
        {"kind": "DaemonSet", "name": "ds", "uid": "u1",
         "controller": True}]
    await store.create("pods", ds_pod)


async def seed_rollout(a, store):
    """A Deployment at generation 2 with two ReplicaSets of its revisions;
    its status says 1 of 2 replicas updated."""
    await store.create("deployments", {
        "apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "default",
                     "generation": 2},
        "spec": {"replicas": 2,
                 "selector": {"matchLabels": {"app": "web"}},
                 "template": {"metadata": {"labels": {"app": "web"}},
                              "spec": {"containers": [
                                  {"name": "main", "image": "app"}]}}},
        "status": {"observedGeneration": 2, "updatedReplicas": 1,
                   "readyReplicas": 1}})
    for rev, name in ((2, "web-7f9c"), (1, "web-5d4b")):
        await store.create("replicasets", {
            "apiVersion": "apps/v1", "kind": "ReplicaSet",
            "metadata": {
                "name": name, "namespace": "default",
                "annotations": {"deployment.kubernetes.io/revision":
                                str(rev)},
                "ownerReferences": [{"kind": "Deployment", "name": "web",
                                     "uid": "u-web", "controller": True}]},
            "spec": {"replicas": rev - 1}})


async def mark_rolled_out(a, store):
    def done(obj):
        obj["status"].update({"updatedReplicas": 2, "readyReplicas": 2})
        return obj
    await store.guaranteed_update("deployments", "default/web", done)


async def seed_logs(a, store):
    def mark(p):
        p["status"].update({
            "podIP": "10.20.0.1",
            "conditions": [{"type": "Ready", "status": "True"}]})
        return p
    await store.guaranteed_update("pods", "default/web-1", mark)
    await event(a, store, "ev-log", "Scheduled",
                "assigned default/web-1 to n0")


async def add_policy(a, store, name, expression, message):
    await store.create(
        "validatingadmissionpolicies",
        a.types.make_validating_admission_policy(name, [
            {"expression": expression, "message": message}]))
    await store.create("validatingadmissionpolicybindings",
                       a.types.make_vap_binding(f"{name}-b", name))


async def prio_cap(a, store):
    await add_policy(a, store, "prio-cap",
                     "not has(object.spec.priority) or "
                     "object.spec.priority <= 100", "priority capped at 100")


async def no_tier(a, store):
    await add_policy(a, store, "no-tier",
                     "not has(object.metadata.labels) or "
                     "not ('tier' in object.metadata.labels)",
                     "tier label forbidden")


# -- manifests (written to a directory both packages share) -------------------

DEPLOYMENT = {
    "apiVersion": "apps/v1", "kind": "Deployment", "metadata": {"name": "d"},
    "spec": {"replicas": 2, "selector": {"matchLabels": {"app": "d"}},
             "template": {"metadata": {"labels": {"app": "d"}},
                          "spec": {"containers": [
                              {"name": "c", "image": "x:1"}]}}}}
POD = {"apiVersion": "v1", "kind": "Pod", "metadata": {"name": "made"},
       "spec": {"containers": [{"name": "c", "image": "x"}]}}


def write(name, docs):
    def step(d: Path):
        (d / name).write_text(yaml.safe_dump_all(docs))
    return step


async def live_manifest(a, store, d: Path, name: str, change=None):
    """Write the live web-1 pod (optionally changed) as a manifest."""
    live = await store.get("pods", "default/web-1")
    if change is not None:
        live = change(live)
    (d / name).write_text(yaml.safe_dump(live))


def relabel(labels):
    def change(live):
        return dict(live, metadata={**live["metadata"], "labels": labels})
    return change


def bad_quantity(live):
    return dict(live, spec={**live["spec"], "containers": [
        {"name": "main", "image": "app",
         "resources": {"requests": {"cpu": "not-a-cpu"}}}]})


#: name -> (extra seeding, steps). A step is an argv list, a callable of
#: the shared directory (writes a manifest), or an async callable of
#: (api, backing store[, directory]) run between commands.
SCENARIOS = {
    "get_pods_table": (None, [["get", "pods"], ["get", "pods", "-A"]]),
    "get_with_selector_and_yaml": (None, [
        ["get", "pods", "-l", "app=web", "-o", "yaml"],
        ["get", "pods", "-o", "json"],
        ["get", "pods", "web-1", "-o", "json"],
        ["get", "pods", "nope"]]),
    "get_nodes_and_aliases": (None, [["get", "no"], ["get", "po"],
                                     ["get", "nodes", "n1", "-o", "yaml"]]),
    "describe_includes_events": (seed_describe, [
        ["describe", "pods", "web-1"], ["describe", "nodes", "n0"],
        ["describe", "pods", "nope"]]),
    "apply_create_then_configure": (None, [
        write("m.yaml", [DEPLOYMENT]), ["apply", "-f", "{d}/m.yaml"],
        write("m.yaml", [{**DEPLOYMENT,
                          "spec": {**DEPLOYMENT["spec"], "replicas": 5}}]),
        ["apply", "-f", "{d}/m.yaml"],
        ["get", "deployments", "d", "-o", "json"],
        write("x.yaml", [{"kind": "Widget", "metadata": {"name": "w"}}]),
        ["apply", "-f", "{d}/x.yaml"]]),
    "scale_and_delete": (seed_deployment, [
        ["scale", "deploy", "d", "--replicas", "4"],
        ["get", "deployments", "d", "-o", "json"],
        ["scale", "deploy", "nope", "--replicas", "4"],
        ["delete", "deployments", "d"], ["delete", "deployments", "d"],
        write("p.yaml", [POD]), ["create", "-f", "{d}/p.yaml"],
        ["delete", "-f", "{d}/p.yaml"]]),
    "cordon_drain_uncordon": (seed_daemon_pod, [
        ["drain", "n0"], ["get", "pods"], ["get", "nodes"],
        ["uncordon", "n0"], ["cordon", "n1"], ["get", "nodes"]]),
    "top_nodes": (None, [["top", "nodes"]]),
    "top_pods": (None, [["top", "pods"]]),
    "cli_through_apiserver": (None, [["get", "pods"], ["cordon", "n1"],
                                     ["get", "nodes", "n1", "-o", "json"]]),
    "create_f": (None, [write("p.yaml", [POD]),
                        ["create", "-f", "{d}/p.yaml"],
                        ["create", "-f", "{d}/p.yaml"],
                        ["get", "pods", "made", "-o", "json"]]),
    "patch_strategic_merge_and_policy": (None, [
        ["patch", "pods", "web-1", "-p",
         '{"metadata": {"labels": {"tier": "fe"}}, "spec": {"containers":'
         ' [{"name": "main", "image": "app:2"}]}}'],
        prio_cap,
        ["patch", "pods", "web-1", "-p", '{"spec": {"priority": 10000}}'],
        ["patch", "pods", "web-1", "-p", '{"spec": {"priority": 50}}'],
        ["patch", "pods", "web-1", "-p", "{not json"],
        ["get", "pods", "web-1", "-o", "json"]]),
    "patch_merge_and_json": (None, [
        ["patch", "pods", "web-1", "-p",
         '{"metadata": {"labels": {"x": "1"}}}'],
        ["patch", "pods", "web-1", "--type", "merge", "-p",
         '{"spec": {"containers": [{"name": "only", "image": "y"}]}}'],
        ["patch", "pods", "web-1", "--type", "json", "-p",
         '[{"op": "add", "path": "/metadata/annotations",'
         ' "value": {"j": "2"}}]'],
        ["patch", "pods", "nope", "-p", '{"metadata": {}}'],
        ["get", "pods", "web-1", "-o", "json"]]),
    "rollout_status_restart_history": (seed_rollout, [
        ["rollout", "status", "deployment", "web"],
        mark_rolled_out,
        ["rollout", "status", "deployment", "web"],
        ["rollout", "restart", "deployment", "web"],
        ["rollout", "history", "deployment", "web"],
        ["rollout", "status", "statefulset", "web"],
        ["rollout", "status", "deployment", "nope"],
        ["get", "deployments", "web", "-o", "json"]]),
    "logs": (seed_logs, [["logs", "web-1"], ["logs", "pending-1"],
                         ["logs", "nope"]]),
    "diff": (None, [
        lambda a, s, d: live_manifest(a, s, d, "same.yaml"),
        ["diff", "-f", "{d}/same.yaml"],
        lambda a, s, d: live_manifest(a, s, d, "mod.yaml",
                                      relabel({"app": "web2"})),
        ["diff", "-f", "{d}/mod.yaml"],
        lambda a, s, d: live_manifest(a, s, d, "tier.yaml", relabel(
            {"app": "web", "tier": "fe"})),
        ["diff", "-f", "{d}/tier.yaml"],
        no_tier,
        ["diff", "-f", "{d}/tier.yaml"],
        lambda a, s, d: live_manifest(a, s, d, "bad.yaml", bad_quantity),
        ["diff", "-f", "{d}/bad.yaml"],
        ["get", "pods", "web-1", "-o", "json"]]),
}


# -- running a scenario -------------------------------------------------------

async def run_scenario(root: str, name: str, transport: str,
                       d: Path) -> dict:
    a = Api(root)
    extra, steps = SCENARIOS[name]
    backing = a.store.new_cluster_store()
    a.store.install_core_validation(backing)
    await seed(a, backing)
    if extra is not None:
        await extra(a, backing)
    server = client = None
    url = "<none>"
    if transport == "http":
        policy = mod(root, "policy")
        admission = mod(root, "apiserver.admission").WebhookAdmission(
            backing, policy_engine=policy.PolicyEngine(backing))
        server = mod(root, "apiserver.server").APIServer(
            backing, admission=admission)
        await server.start()
        url = server.url
        client = mod(root, "apiserver.client").RemoteStore(url)
        await client.refresh_discovery()
    store = client or backing
    records = []
    try:
        for step in steps:
            if callable(step):
                got = step(d) if _arity(step) == 1 else (
                    step(a, backing, d) if _arity(step) == 3
                    else step(a, backing))
                if asyncio.iscoroutine(got):
                    await got
                continue
            argv = [s.replace("{d}", str(d)) for s in step]
            args = a.kubectl.build_parser().parse_args(argv)
            out, err = io.StringIO(), io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = await a.kubectl.run_command(store, args, out)
            records.append((step, rc, out.getvalue(),
                            err.getvalue().replace(url, "<url>")))
        state = {r: (await backing.list(r)).items for r in RESOURCES}
    finally:
        if client is not None:
            await client.close()
        if server is not None:
            await server.stop()
        backing.stop()
    return {"records": records, "state": state}


def _arity(fn) -> int:
    return fn.__code__.co_argcount


class PinnedClock(Pinned):
    """Pinned uids and timestamps, and `kubectl`'s clock at NOW."""

    def __enter__(self):
        super().__enter__()
        self._set(mod(self.root, "cli.kubectl"), "time",
                  pytypes.SimpleNamespace(time=lambda: NOW))
        return self


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("manifests")
    out = {}

    async def all_runs(root):
        for name in SCENARIOS:
            for transport in TRANSPORTS:
                out[(root, name, transport)] = await run_scenario(
                    root, name, transport, d)

    for root in PACKAGES:
        with PinnedClock(root):
            asyncio.run(all_runs(root))
    return out


@pytest.mark.parametrize("transport", TRANSPORTS)
@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_cli_matches_the_reference(runs, scenario, transport):
    port = runs[("kubernetes_tpu_torch", scenario, transport)]
    ref = runs[("kubernetes_tpu", scenario, transport)]
    assert port["records"] == ref["records"]
    assert port["state"] == ref["state"]


def test_the_scenarios_reach_every_outcome(runs):
    """The reference test's own assertions, on the port's output."""
    def rec(name, transport="inproc"):
        return runs[("kubernetes_tpu_torch", name, transport)]["records"]

    out = rec("get_pods_table")[0][2]
    assert "web-1" in out and "Running" in out and "n0" in out
    assert "pending-1" in out and "<none>" in out and "62m" in out
    docs = yaml.safe_load(rec("get_with_selector_and_yaml")[0][2])
    assert [i["metadata"]["name"] for i in docs["items"]] == ["web-1"]
    assert rec("get_with_selector_and_yaml")[3][1] == 1
    assert "Ready" in rec("get_nodes_and_aliases")[0][2]
    assert "Scheduled" in rec("describe_includes_events")[0][2]
    applied = rec("apply_create_then_configure")
    assert "created" in applied[0][2] and "configured" in applied[1][2]
    assert json.loads(applied[2][2])["spec"]["replicas"] == 5
    assert applied[3][1] == 1 and "unknown kind" in applied[3][3]
    drain = runs[("kubernetes_tpu_torch", "cordon_drain_uncordon",
                  "inproc")]
    pods = {p["metadata"]["name"] for p in drain["state"]["pods"]}
    assert "web-1" not in pods and "ds-pod" in pods
    assert "%" in rec("top_nodes")[0][2] and "500m" in rec("top_pods")[0][2]
    for transport in TRANSPORTS:
        created = rec("create_f", transport)
        assert [r[1] for r in created[:2]] == [0, 1]
    http_patch = rec("patch_strategic_merge_and_policy", "http")
    assert [r[1] for r in http_patch[:4]] == [0, 1, 0, 1]
    assert json.loads(http_patch[4][2])["spec"]["priority"] == 50
    rollout = rec("rollout_status_restart_history")
    assert [r[1] for r in rollout[:5]] == [3, 0, 0, 0, 1]
    assert "REVISION" in rollout[3][2]
    logs = rec("logs")[0][2]
    assert "podIP 10.20.0.1" in logs and "event Normal Scheduled" in logs
    diff = rec("diff", "http")
    assert [r[1] for r in diff[:5]] == [0, 1, 1, 2, 2]
    assert "+    tier: fe" in diff[2][2]


# -- the entry point as a process ---------------------------------------------

def test_module_entry_point_over_http():
    """`python -m kubernetes_tpu_torch.cli --server URL get pods -o json`
    prints what run_command prints in process; `cordon` flips the node;
    a closed port gives exit 1 and one error line."""
    from kubernetes_tpu_torch.cli.kubectl import build_parser, run_command
    from kubernetes_tpu_torch.apiserver.server import APIServer

    a = Api("kubernetes_tpu_torch")

    async def cli(url, *argv):
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "kubernetes_tpu_torch.cli",
            "--server", url, *argv, cwd=str(ROOT),
            stdout=asyncio.subprocess.PIPE, stderr=asyncio.subprocess.PIPE)
        out, err = await asyncio.wait_for(proc.communicate(), 60)
        return proc.returncode, out.decode(), err.decode()

    async def body():
        backing = a.store.new_cluster_store()
        a.store.install_core_validation(backing)
        await seed(a, backing)
        server = APIServer(backing)
        await server.start()
        try:
            got = await cli(server.url, "get", "pods", "-o", "json")
            want = io.StringIO()
            rc = await run_command(
                backing, build_parser().parse_args(
                    ["get", "pods", "-o", "json"]), want)
            cordon = await cli(server.url, "cordon", "n1")
            node = await backing.get("nodes", "n1")
        finally:
            await server.stop()
            backing.stop()
        refused = await cli("http://127.0.0.1:1", "get", "pods")
        return got, (rc, want.getvalue()), cordon, node, refused

    got, want, cordon, node, refused = asyncio.run(body())
    assert got[0] == 0 and want[0] == 0, got[2]
    assert got[1] == want[1]
    assert cordon[0] == 0 and "cordoned" in cordon[1]
    assert node["spec"]["unschedulable"] is True
    assert refused[0] == 1 and refused[1] == ""
    assert refused[2].startswith("Error: ") and \
        len(refused[2].strip().splitlines()) == 1
