"""The port's process entry points on the CPU: `python -m
kubernetes_tpu_torch.apiserver`, `...scheduler` and `...agent`, each a
child process started as a fresh interpreter (`chip_smoke.Child`, which
phase 19 of the smoke drives on the card), with a deadline on every wait
and a kill in `finally`.

- Each `build_parser` against the reference's: the same options, dests,
  defaults, types, choices and flags; `parse_allocatable` alike.
- The apiserver process serves `/healthz` and the KTPU wire; under
  `--fsync always` a SIGKILL loses no acknowledged write: restarted on
  the same data dir, every pod created before the kill is back at the
  resource version its create returned, and the next write continues
  the counter.
- A scheduler process with `TPUScorer` off, leader-elected, binds pods
  created over the wire; it logs that it started leading (its
  `solve_provenance` null on the host path) and, on SIGTERM, its kernel
  launch counts, and exits 0.
- With `TPUScorer` on and no CUDA device the scheduler process exits
  non-zero with the backend's own error before it schedules anything.
- An agent process registers its node and marks a pod bound to it
  Running.
- `AgentServer`'s three endpoints (`/healthz` before and after the
  agent stops, `/pods`, `/configz`) answer as the reference's, in
  process, with uids and timestamps pinned.

Tolerance: none (exact host logic).
"""

import argparse
import asyncio
import itertools
import json
import os
from importlib import import_module

import aiohttp
import pytest

from chip_smoke import (Child, LEADING, STOPPING, agent_child,
                        apiserver_addresses, apiserver_child,
                        scheduler_child)

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
ENTRY_POINTS = ("apiserver", "scheduler", "agent")
STAMP = "2026-01-01T00:00:00Z"
CONFIG = """\
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
leaderElection:
  leaderElect: true
  leaseDuration: 3s
  renewDeadline: 2s
  retryPeriod: 0.4s
"""
DEADLINE = 60.0


def mod(root: str, sub: str):
    return import_module(f"{root}.{sub}")


def parser_view(parser: argparse.ArgumentParser) -> list:
    return [parser.prog] + [
        (type(a).__name__, tuple(a.option_strings), a.dest, a.default,
         getattr(a.type, "__name__", a.type), a.choices, a.required,
         a.nargs, a.const, a.metavar)
        for a in parser._actions]


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_build_parser_matches_the_reference(entry, monkeypatch):
    monkeypatch.delenv("KTPU_DATA_DIR", raising=False)
    want, got = (parser_view(mod(r, f"{entry}.__main__").build_parser())
                 for r in PACKAGES)
    assert got == want


def test_parse_allocatable_matches_the_reference():
    spec = "cpu=4, memory=16Gi,,pods=32,ktpu.io/tpu=8"
    want, got = (mod(r, "agent.__main__").parse_allocatable(spec)
                 for r in PACKAGES)
    assert got == want == {"cpu": "4", "memory": "16Gi", "pods": "32",
                           "ktpu.io/tpu": "8"}


@pytest.fixture
def children():
    """Children started by a test; each is killed and reaped at the end."""
    started: list[Child] = []
    yield started
    for c in started:
        c.close()


async def healthz(port: int) -> tuple:
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://127.0.0.1:{port}/healthz") as r:
            return r.status, await r.text()


def test_apiserver_process_recovers_every_acknowledged_write(tmp_path,
                                                             children):
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.wire import WireStore

    data = tmp_path / "data"
    data.mkdir()

    async def body():
        api = apiserver_child(str(tmp_path), "apiserver", "--port", 0,
                              "--data-dir", data, "--fsync", "always")
        children.append(api)
        port, wire = await apiserver_addresses(api, DEADLINE)
        assert await healthz(port) == (200, "ok")
        store = WireStore(wire)
        acked = {}
        try:
            await store.create("nodes", make_node("n0"))
            for i in range(30):
                obj = await store.create("pods", make_pod(f"p{i}"))
                acked[obj["metadata"]["name"]] = \
                    obj["metadata"]["resourceVersion"]
            await store.delete("pods", "default/p0")
            del acked["p0"]
        finally:
            await store.close()
        assert await api.kill() == -9
        api2 = apiserver_child(str(tmp_path), "apiserver-2", "--port", 0,
                               "--data-dir", data)
        children.append(api2)
        port2, wire2 = await apiserver_addresses(api2, DEADLINE)
        assert await healthz(port2) == (200, "ok")
        store = WireStore(wire2)
        try:
            listed = await store.list("pods")
            back = {p["metadata"]["name"]: p["metadata"]["resourceVersion"]
                    for p in listed.items}
            nxt = await store.create("pods", make_pod("after"))
        finally:
            await store.close()
        assert back == acked
        assert int(nxt["metadata"]["resourceVersion"]) \
            == listed.resource_version + 1
        assert await api2.stop() == 0
        assert any(f.startswith("snapshot-") for f in os.listdir(data))

    asyncio.run(body())


def test_scheduler_process_binds_through_the_wire(tmp_path, children):
    from kubernetes_tpu_torch.api.types import make_node, make_pod
    from kubernetes_tpu_torch.apiserver.wire import WireStore

    config = tmp_path / "config.yaml"
    config.write_text(CONFIG)

    async def body():
        api = apiserver_child(str(tmp_path), "apiserver", "--port", 0)
        children.append(api)
        _, wire = await apiserver_addresses(api, DEADLINE)
        store = WireStore(wire)
        try:
            for i in range(4):
                await store.create("nodes", make_node(f"n{i}"))
            sched = scheduler_child(str(tmp_path), "scheduler", wire,
                                    str(config), gates="")
            children.append(sched)
            lead = await sched.line(LEADING, DEADLINE)
            for i in range(12):
                await store.create("pods", make_pod(
                    f"p{i}", requests={"cpu": "100m"}))
            for _ in range(int(DEADLINE / 0.05)):
                pods = (await store.list("pods")).items
                if all(p["spec"].get("nodeName") for p in pods):
                    break
                sched.check_alive()
                await asyncio.sleep(0.05)
            lease = await store.get("leases", "kube-system/kube-scheduler")
        finally:
            await store.close()
        assert all(p["spec"].get("nodeName") for p in pods), pods
        assert lease["spec"]["holderIdentity"] == lead.group(1)
        assert json.loads(lead.group(2)) is None  # host path: no backend
        assert await sched.stop() == 0
        stop = await sched.line(STOPPING, DEADLINE)
        assert json.loads(stop.group(1)) == {"wave_solve": 0, "probe": 0}

    asyncio.run(body())


def test_scheduler_process_with_tpuscorer_needs_a_card(tmp_path, children):
    async def body():
        sched = scheduler_child(str(tmp_path), "scheduler", "127.0.0.1:1",
                                os.devnull, env={"CUDA_VISIBLE_DEVICES": ""})
        children.append(sched)
        rc = await sched.exit_code(DEADLINE)
        return rc, sched.text()

    rc, log = asyncio.run(body())
    assert rc != 0
    assert "TorchBackend needs a CUDA device" in log
    assert "scheduler running" not in log


def test_agent_process_registers_and_runs_pods(tmp_path, children):
    from kubernetes_tpu_torch.api.types import make_pod
    from kubernetes_tpu_torch.apiserver.wire import WireStore

    async def body():
        api = apiserver_child(str(tmp_path), "apiserver", "--port", 0)
        children.append(api)
        _, wire = await apiserver_addresses(api, DEADLINE)
        agent = agent_child(str(tmp_path), "agent-node-0", wire)
        children.append(agent)
        await agent.line(r"agent agent-node-0 running against", DEADLINE)
        store = WireStore(wire)
        try:
            node = await store.get("nodes", "agent-node-0")
            await store.create("pods", make_pod(
                "p0", requests={"cpu": "100m"}, node_name="agent-node-0"))
            for _ in range(int(DEADLINE / 0.05)):
                pod = await store.get("pods", "default/p0")
                if (pod.get("status") or {}).get("phase") == "Running":
                    break
                agent.check_alive()
                await asyncio.sleep(0.05)
        finally:
            await store.close()
        assert node["status"]["allocatable"] == {
            "cpu": "8", "memory": "32Gi", "pods": "110"}
        assert pod["status"]["phase"] == "Running"
        assert await agent.stop() == 0

    asyncio.run(body())


async def agent_server_script(root: str, tmp: str) -> list:
    types = mod(root, "api.types")
    store = mod(root, "store").new_cluster_store()
    mod(root, "store").install_core_validation(store)
    agent = mod(root, "agent").NodeAgent(store, "n0", checkpoint_dir=tmp,
                                         lease_period=30.0)
    await agent.start()
    await store.create("pods", types.make_pod(
        "p0", requests={"cpu": "100m"}, node_name="n0"))
    for _ in range(int(DEADLINE / 0.02)):
        if (await store.get("pods", "default/p0"))["status"].get(
                "phase") == "Running":
            break
        await asyncio.sleep(0.02)
    await asyncio.sleep(0.1)  # the watch delivers the Running update
    server = mod(root, "agent").AgentServer(agent)
    await server.start()
    out = []
    async with aiohttp.ClientSession() as s:
        for path in ("/healthz", "/pods", "/configz"):
            async with s.get(f"http://127.0.0.1:{server.port}{path}") as r:
                out.append((path, r.status, await r.text()))
        await agent.stop()
        async with s.get(f"http://127.0.0.1:{server.port}/healthz") as r:
            out.append(("/healthz after stop", r.status, await r.text()))
    await server.stop()
    store.stop()
    return out


def test_agent_server_endpoints_match_the_reference(tmp_path, monkeypatch):
    for root in PACKAGES:
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            monkeypatch.setattr(mod(root, sub), "new_uid",
                                lambda seq=seq: f"uid-{next(seq)}")
        monkeypatch.setattr(mod(root, "api.meta"), "now_iso", lambda: STAMP)
    got = {}
    for root in PACKAGES:
        d = tmp_path / root
        d.mkdir()
        got[root] = asyncio.run(agent_server_script(root, str(d)))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = {path: (status, text) for path, status, text in got[PACKAGES[1]]}
    assert out["/healthz"] == (200, "ok")
    assert out["/healthz after stop"] == (500, "stopped")
    pods = json.loads(out["/pods"][1])
    assert [p["metadata"]["name"] for p in pods["items"]] == ["p0"]
    assert pods["items"][0]["status"]["phase"] == "Running"
    assert json.loads(out["/configz"][1])["kubeletconfig"]
