"""The port's store durability (`store/durable.py`: the write-ahead log,
its snapshots and `recover_store`) and the APIServer's `data_dir`
bootstrap, on the CPU against the JAX package's.

Each scenario is one script run through each package with uids and
creation timestamps pinned (a counter and a constant, per package), so
the files on disk can be compared byte for byte:

- three seeded 120-op create/update/delete streams with snapshots taken
  mid-stream: the WAL segments and snapshot files of the two packages
  are byte-identical, and each package's `recover_store` reads the
  other's directory to the writer's live `dump()` (resource versions
  included);
- crash recovery with resource-version continuity and a watch resumed
  across the restart (410 before the snapshot); a torn tail record; the
  orphan `.tmp` of a crashed snapshot write; a crash between segment
  rotation and the snapshot write; `stop()` racing a background
  snapshot; `KTPU_WAL=0` (snapshot-only);
- `APIServer(data_dir=...)`: a server of one package writes, the other
  package's server recovers the directory and serves it, both ways; the
  `KTPU_DATA_DIR` bootstrap.

Tolerance: none (exact host logic, identical bytes).
"""

import asyncio
import itertools
import json
import os
import random
import time
from importlib import import_module
from types import SimpleNamespace

import pytest

PACKAGES = ("kubernetes_tpu", "kubernetes_tpu_torch")
SEEDS = (7, 23, 101)
STAMP = "2026-01-01T00:00:00Z"


def api(root: str) -> SimpleNamespace:
    m = lambda sub: import_module(f"{root}.{sub}")  # noqa: E731
    store = m("store")
    types = m("api.types")
    return SimpleNamespace(
        root=root, store=store, flags=m("utils.flags"),
        make_pod=types.make_pod, make_node=types.make_node,
        apiserver=m("apiserver"))


@pytest.fixture
def pinned(monkeypatch):
    """Deterministic uids and creation timestamps in both packages: each
    store write draws `uid-<n>` from a per-package counter, reset per
    test, and every timestamp is STAMP."""
    for root in PACKAGES:
        seq = itertools.count(1)
        for sub in ("store.mvcc", "api.meta"):
            monkeypatch.setattr(import_module(f"{root}.{sub}"), "new_uid",
                                lambda seq=seq: f"uid-{next(seq)}")
        monkeypatch.setattr(import_module(f"{root}.api.meta"), "now_iso",
                            lambda: STAMP)


def dir_bytes(d: str) -> dict:
    out = {}
    for fn in sorted(os.listdir(d)):
        with open(os.path.join(d, fn), "rb") as f:
            out[fn] = f.read()
    return out


def crash(mgr) -> None:
    """Drop a DurabilityManager the way a SIGKILL would: no flush, no
    final snapshot; only the file handle is closed (fsync="always" put
    every record on disk already)."""
    mgr.wal.store.remove_event_sink(mgr.wal._on_event)
    mgr.wal._fh.close()


async def random_stream(a, d: str, seed: int) -> str:
    """The reference's randomized stream: 120 seeded creates, label
    updates and deletes of pods and nodes, a snapshot after an op with
    probability 0.05. Returns the live dump at the crash."""
    rng = random.Random(seed)
    store = a.store.new_cluster_store()
    a.store.install_core_validation(store)
    mgr = a.store.DurabilityManager(store, d, fsync="always",
                                    snapshot_interval_s=3600)
    alive = {"pods": [], "nodes": []}
    serial = 0
    for _ in range(120):
        resource = rng.choice(("pods", "nodes"))
        roll = rng.random()
        if roll < 0.5 or not alive[resource]:
            serial += 1
            name = f"s{seed}-{resource[:-1]}-{serial}"
            obj = (a.make_pod(name) if resource == "pods"
                   else a.make_node(name))
            await store.create(resource, obj)
            ns = obj["metadata"].get("namespace", "")
            alive[resource].append(f"{ns}/{name}" if ns else name)
        elif roll < 0.8:
            key = rng.choice(alive[resource])
            stamp = str(rng.randrange(10_000))

            def label(obj, stamp=stamp):
                obj["metadata"].setdefault("labels", {})["stamp"] = stamp
                return obj
            await store.guaranteed_update(resource, key, label)
        else:
            key = rng.choice(alive[resource])
            alive[resource].remove(key)
            await store.delete(resource, key)
        if rng.random() < 0.05:
            mgr.wal.snapshot()
    live = store.dump()
    crash(mgr)
    store.stop()
    return live


@pytest.fixture
def streams(pinned, tmp_path):
    """{seed: {root: (directory, live dump)}} for every seed and package."""
    out = {}
    for seed in SEEDS:
        out[seed] = {}
        for root in PACKAGES:
            d = str(tmp_path / f"{root}-{seed}")
            out[seed][root] = (d, asyncio.run(random_stream(api(root), d,
                                                            seed)))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_wal_and_snapshot_files_are_byte_identical(streams, seed):
    (jd, jlive), (td, tlive) = (streams[seed][r] for r in PACKAGES)
    assert tlive == jlive
    jfiles, tfiles = dir_bytes(jd), dir_bytes(td)
    assert list(tfiles) == list(jfiles)
    assert any(f.startswith("snapshot-") for f in jfiles), \
        f"seed {seed} took no snapshot mid-stream"
    assert any(f.startswith("wal-") and jfiles[f] for f in jfiles)
    for fn in jfiles:
        assert tfiles[fn] == jfiles[fn], fn


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("writer,reader", [(PACKAGES[0], PACKAGES[1]),
                                           (PACKAGES[1], PACKAGES[0])])
def test_recover_store_reads_the_other_package(streams, seed, writer,
                                               reader):
    d, live = streams[seed][writer]
    a = api(reader)
    store = a.store.recover_store(d)
    try:
        assert json.loads(store.dump()) == json.loads(live)
        assert store.resource_version == json.loads(live)["rv"]
    finally:
        store.stop()


async def continuity_script(a, d: str) -> dict:
    """Crash after a snapshot and two more writes; recover; the next
    write's RV, the resumed watch and the 410 before the snapshot."""
    store = a.store.new_cluster_store()
    a.store.install_core_validation(store)
    mgr = a.store.DurabilityManager(store, d, fsync="always",
                                    snapshot_interval_s=3600)
    await store.create("nodes", a.make_node("n0"))
    for i in range(5):
        await store.create("pods", a.make_pod(f"p{i}"))
    snap_rv = mgr.wal.snapshot()
    created = await store.create("pods", a.make_pod("after-snap"))
    rv_before_crash = int(created["metadata"]["resourceVersion"])
    await store.create("pods", a.make_pod("last"))
    final_rv = store.resource_version
    crash(mgr)
    store.stop()

    re_store = a.store.recover_store(d)
    a.store.install_core_validation(re_store)
    out = {"rv": re_store.resource_version, "final_rv": final_rv,
           "pods": [p["metadata"]["name"]
                    for p in (await re_store.list("pods")).items]}
    fresh = await re_store.create("pods", a.make_pod("post-restart"))
    out["fresh_rv"] = int(fresh["metadata"]["resourceVersion"])
    watch = await re_store.watch("pods", resource_version=rv_before_crash)
    got = []
    async for ev in watch:
        if ev.type == "BOOKMARK":
            continue
        got.append((ev.type, ev.object["metadata"]["name"], ev.rv))
        if len(got) == 2:
            break
    out["resumed"] = got
    try:
        await re_store.watch("pods", resource_version=snap_rv - 3)
        out["expired"] = None
    except a.store.Expired as e:
        out["expired"] = type(e).__name__
    re_store.stop()
    return out


def test_crash_recovery_continuity_and_watch_resume(pinned, tmp_path):
    got = {r: asyncio.run(continuity_script(api(r), str(tmp_path / r)))
           for r in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["rv"] == out["final_rv"] and out["fresh_rv"] == out["rv"] + 1
    assert [n for _, n, _ in out["resumed"]] == ["last", "post-restart"]
    assert out["expired"] == "Expired"


async def torn_tail_script(a, d: str) -> list:
    store = a.store.new_cluster_store()
    mgr = a.store.DurabilityManager(store, d, fsync="always",
                                    snapshot_interval_s=3600)
    await store.create("pods", a.make_pod("a"))
    await store.create("pods", a.make_pod("b"))
    crash(mgr)
    store.stop()
    wal = [f for f in os.listdir(d) if f.startswith("wal-")][0]
    with open(os.path.join(d, wal), "a") as f:
        f.write('[9999,"ADDED","po')  # a torn record: no newline
    return [fn for fn in sorted(os.listdir(d))]


@pytest.mark.parametrize("writer", PACKAGES)
def test_torn_tail_truncates_replay_in_both_packages(pinned, tmp_path,
                                                     writer):
    d = str(tmp_path / "torn")
    asyncio.run(torn_tail_script(api(writer), d))
    dumps = {}
    for reader in PACKAGES:
        store = api(reader).store.recover_store(d)
        dumps[reader] = json.loads(store.dump())
        store.stop()
    assert dumps[PACKAGES[1]] == dumps[PACKAGES[0]]
    pods = dumps[PACKAGES[1]]["tables"]["pods"]
    assert sorted(pods) == ["default/a", "default/b"]
    assert dumps[PACKAGES[1]]["rv"] < 9999


async def orphan_script(a, d: str) -> dict:
    store = a.store.new_cluster_store()
    a.store.install_core_validation(store)
    mgr = a.store.DurabilityManager(store, d, fsync="always",
                                    snapshot_interval_s=3600)
    for i in range(4):
        await store.create("pods", a.make_pod(f"p{i}"))
    mgr.wal.snapshot()
    tmp_after_snapshot = [f for f in os.listdir(d) if f.endswith(".tmp")]
    orphan = os.path.join(d, "snapshot-999999.json.tmp")
    with open(orphan, "w") as f:
        f.write('{"rv": 999999, "tables": {"pods"')
    await store.create("pods", a.make_pod("after"))
    final_rv = store.resource_version
    crash(mgr)
    store.stop()
    re_store = a.store.recover_store(d)
    out = {"tmp_after_snapshot": tmp_after_snapshot,
           "rv": re_store.resource_version, "final_rv": final_rv,
           "pods": len((await re_store.list("pods")).items)}
    mgr2 = a.store.DurabilityManager(re_store, d, fsync="always",
                                     snapshot_interval_s=3600)
    mgr2.wal.snapshot()
    out["orphan_left"] = os.path.exists(orphan)
    await mgr2.stop()
    re_store.stop()
    out["files"] = dir_bytes(d)
    return out


def test_orphan_tmp_is_ignored_then_reclaimed(pinned, tmp_path):
    got = {r: asyncio.run(orphan_script(api(r), str(tmp_path / r)))
           for r in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["tmp_after_snapshot"] == [] and not out["orphan_left"]
    assert out["rv"] == out["final_rv"] and out["pods"] == 5


async def rotate_crash_script(a, d: str) -> dict:
    store = a.store.new_cluster_store()
    a.store.install_core_validation(store)
    mgr = a.store.DurabilityManager(store, d, fsync="always",
                                    snapshot_interval_s=3600)
    for i in range(3):
        await store.create("pods", a.make_pod(f"p{i}"))
    mgr.wal.snapshot()
    await store.create("pods", a.make_pod("in-old-segment"))
    mgr.wal.begin_snapshot()  # rotation lands, the disk write never does
    await store.create("pods", a.make_pod("in-new-segment"))
    final_rv = store.resource_version
    crash(mgr)
    store.stop()
    files = dir_bytes(d)
    re_store = a.store.recover_store(d)
    out = {"files": files, "final_rv": final_rv,
           "dump": json.loads(re_store.dump())}
    re_store.stop()
    return out


def test_crash_between_rotate_and_snapshot_write(pinned, tmp_path):
    got = {r: asyncio.run(rotate_crash_script(api(r), str(tmp_path / r)))
           for r in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert sorted(n.split("/")[1] for n in out["dump"]["tables"]["pods"]) \
        == sorted(["p0", "p1", "p2", "in-old-segment", "in-new-segment"])
    assert out["dump"]["rv"] == out["final_rv"]
    assert sum(f.startswith("wal-") for f in out["files"]) == 2


async def racing_stop_script(a, d: str) -> dict:
    store = a.store.new_cluster_store()
    a.store.install_core_validation(store)
    mgr = a.store.DurabilityManager(store, d, fsync="batch",
                                    flush_interval_s=0.01,
                                    snapshot_interval_s=0.05)
    orig = mgr.wal.write_snapshot

    def slow_write(data, rv):
        time.sleep(0.3)  # widen the in-flight window
        orig(data, rv)
    mgr.wal.write_snapshot = slow_write
    mgr.start()
    for i in range(10):
        await store.create("pods", a.make_pod(f"p{i}"))
    for _ in range(400):
        if mgr._snap_inflight is not None:
            break
        await asyncio.sleep(0.01)
    inflight = mgr._snap_inflight is not None
    await mgr.stop(final_snapshot=True)  # races the worker thread
    final_rv = store.resource_version
    store.stop()
    out = {"inflight": inflight, "final_rv": final_rv,
           "tmp": [f for f in os.listdir(d) if f.endswith(".tmp")]}
    re_store = a.store.recover_store(d)
    out["dump"] = json.loads(re_store.dump())
    re_store.stop()
    return out


def test_stop_waits_for_a_background_snapshot(pinned, tmp_path):
    got = {r: asyncio.run(racing_stop_script(api(r), str(tmp_path / r)))
           for r in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["inflight"] and out["tmp"] == []
    assert out["dump"]["rv"] == out["final_rv"]
    assert len(out["dump"]["tables"]["pods"]) == 10


async def kill_switch_script(a, d: str) -> dict:
    with a.flags.scoped_set("KTPU_WAL", False), \
            a.flags.scoped_set("KTPU_WAL_FSYNC", "always"):
        store = a.store.new_cluster_store()
        mgr = a.store.DurabilityManager(store, d, snapshot_interval_s=3600)
        out = {"fsync": mgr.wal.fsync, "enabled": mgr.wal.enabled}
        await store.create("pods", a.make_pod("durable"))
        mgr.wal.snapshot()
        await store.create("pods", a.make_pod("volatile"))
        mgr.wal._fh.close()
        store.stop()
    out["files"] = dir_bytes(d)
    re_store = a.store.recover_store(d)
    out["pods"] = [p["metadata"]["name"]
                   for p in (await re_store.list("pods")).items]
    re_store.stop()
    return out


def test_wal_kill_switch_is_snapshot_only(pinned, tmp_path):
    got = {r: asyncio.run(kill_switch_script(api(r), str(tmp_path / r)))
           for r in PACKAGES}
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["fsync"] == "always" and out["enabled"] is False
    assert out["pods"] == ["durable"]
    assert all(not v for f, v in out["files"].items() if f.startswith("wal-"))


def test_wal_flags_parse_as_the_reference(monkeypatch):
    for raw in ("always", " BATCH ", "sometimes", ""):
        monkeypatch.setenv("KTPU_WAL_FSYNC", raw)
        assert [api(r).flags.get("KTPU_WAL_FSYNC") for r in PACKAGES] \
            == [api(PACKAGES[0]).flags.get("KTPU_WAL_FSYNC")] * 2
    for raw in ("0", "off", "1", "x"):
        monkeypatch.setenv("KTPU_WAL", raw)
        got = [api(r).flags.get("KTPU_WAL") for r in PACKAGES]
        assert got[0] == got[1]
    for raw in ("2.5", "bad"):
        monkeypatch.setenv("KTPU_LEASE_DURATION", raw)
        got = [api(r).flags.get("KTPU_LEASE_DURATION") for r in PACKAGES]
        assert got[0] == got[1]


async def server_write(a, d: str) -> dict:
    """A durable server: writes over HTTP, then a clean stop (its final
    snapshot)."""
    srv = a.apiserver.APIServer(data_dir=d, fsync="always")
    await srv.start()
    rs = a.apiserver.RemoteStore(srv.url)
    await rs.create("nodes", a.make_node("dur-n0"))
    await rs.create("pods", a.make_pod("dur-p0"))
    await rs.create("pods", a.make_pod("dur-p1"))
    await rs.delete("pods", "default/dur-p1")
    rv = srv.store.resource_version
    await rs.close()
    await srv.stop()
    srv.store.stop()
    return {"rv": rv, "files": sorted(os.listdir(d))}


async def server_read(a, d: str) -> dict:
    """A server recovering `d` on construction: what it serves, and the
    RV of its next write."""
    srv = a.apiserver.APIServer(data_dir=d)
    await srv.start()
    rs = a.apiserver.RemoteStore(srv.url)
    out = {"rv": srv.store.resource_version,
           "pods": [(p["metadata"]["name"], p["metadata"]["resourceVersion"])
                    for p in (await rs.list("pods")).items],
           "nodes": [n["metadata"]["name"]
                     for n in (await rs.list("nodes")).items]}
    created = await rs.create("pods", a.make_pod("dur-p2"))
    out["next_rv"] = int(created["metadata"]["resourceVersion"])
    await rs.close()
    await srv.stop()
    srv.store.stop()
    return out


@pytest.mark.parametrize("writer", PACKAGES)
def test_apiserver_data_dir_recovers_the_other_package(pinned, tmp_path,
                                                       writer):
    d = str(tmp_path / "data")
    os.makedirs(d)
    wrote = asyncio.run(server_write(api(writer), d))
    assert any(f.startswith("snapshot-") for f in wrote["files"])
    snapshot = dir_bytes(d)
    got = {}
    for reader in PACKAGES:
        # Each reader starts from the writer's files (a reader's own stop
        # writes a snapshot of its own).
        for fn in os.listdir(d):
            os.unlink(os.path.join(d, fn))
        for fn, data in snapshot.items():
            with open(os.path.join(d, fn), "wb") as f:
                f.write(data)
        got[reader] = asyncio.run(server_read(api(reader), d))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    out = got[PACKAGES[1]]
    assert out["rv"] == wrote["rv"] and out["next_rv"] == wrote["rv"] + 1
    assert [n for n, _ in out["pods"]] == ["dur-p0"]
    assert out["nodes"] == ["dur-n0"]


async def env_bootstrap(a, d: str) -> dict:
    srv = a.apiserver.APIServer()
    await srv.start()
    durable = srv.durability is not None
    await srv.store.create("pods", a.make_pod("env-p0"))
    await srv.stop()
    srv.store.stop()
    return {"durable": durable, "files": dir_bytes(d)}


def test_data_dir_env_bootstrap_matches_the_reference(pinned, tmp_path,
                                                      monkeypatch):
    got = {}
    for root in PACKAGES:
        d = str(tmp_path / root)
        os.makedirs(d)
        monkeypatch.setenv("KTPU_DATA_DIR", d)
        got[root] = asyncio.run(env_bootstrap(api(root), d))
    assert got[PACKAGES[1]] == got[PACKAGES[0]]
    assert got[PACKAGES[1]]["durable"]
    for root in PACKAGES:
        # A store given with the variable set: the variable is not read.
        a = api(root)
        store = a.store.new_cluster_store()
        srv = a.apiserver.APIServer(store)
        assert srv.store is store and srv._data_dir is None
        store.stop()
    monkeypatch.delenv("KTPU_DATA_DIR")
    for root in PACKAGES:
        with pytest.raises(ValueError, match="needs a store"):
            api(root).apiserver.APIServer()
    store = api(PACKAGES[1]).store.recover_store(str(tmp_path / PACKAGES[0]))
    try:
        assert "default/env-p0" in json.loads(store.dump())["tables"]["pods"]
    finally:
        store.stop()
