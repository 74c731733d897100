"""The port's KTPU wire (`WireServer` + `WireStore`) on the CPU against the
JAX package's: `test_torch_apiserver.store_script` over each package's
`WireServer.for_apiserver(host="unix:")`, in both frame codecs.

- The script's records (results, error types and messages, list pages,
  watch replays up to a bookmark, the 410 that arrives as an `exp`
  frame, RBAC and APF refusals, the policy and audit counters) are
  identical for the port and the reference, under msgpack and under
  JSON (the wire has no merge or JSON patch); the bulk creates and the
  RBAC refusals end as they do over HTTP.
- The frames each client sends, by op, are the same sequence in both
  packages: the bulk section's 40 creates of one tick leave as one
  `multi` frame.
- `encode_event_object` and `encode_event_object_mp` give the same bytes
  in both packages for the same event, encoded once per event.
- Each package's unix socket is there while the server serves and gone
  after `stop`. The port's default path lies under the temporary
  directory (the reference's is a fixed one under /tmp, so the
  reference here binds an explicit path in a private directory).

Tolerance: none (exact host logic; uids, timestamps and audit ids are
masked as in `test_torch_apiserver.py`).
"""

import asyncio
import os
import tempfile

import pytest

from test_torch_apiserver import (
    PACKAGES,
    Cluster,
    http_run,
    mod,
    store_script,
    webhook_server,
)

CODECS = ("msgpack", "json")


async def wire_run(root: str, hook_url: str, enc: str, host: str) -> dict:
    wire = mod(root, "apiserver.wire")
    cluster = Cluster(root)
    server = None
    path = None
    clients = []
    try:
        await cluster.start(hook_url)
        server = wire.WireServer.for_apiserver(cluster.api, host=host)
        await server.start()
        path = server.target[len("unix:"):]
        client = wire.WireStore(server.target, token="admin-token", enc=enc)
        viewer = wire.WireStore(server.target, token="viewer-token", enc=enc)
        imp = wire.WireStore(server.target, token="admin-token", enc=enc,
                             impersonate="viewer")
        clients = [client, viewer, imp]
        ops = []
        codec = client._encode is wire._packb
        encode = client._encode

        def counted(frame):
            ops.append(frame[1])
            return encode(frame)

        client._encode = counted
        out = await store_script(root, cluster, client, viewer, imp)
        out["frames"] = ops
        out["codec"] = codec
        out["socket_dir"] = os.path.dirname(path)
        out["socket"] = [os.path.exists(path)]
    finally:
        for c in clients:
            await c.close()
        if server is not None:
            await server.stop()
        await cluster.stop()
    out["socket"].append(os.path.exists(path))
    return out


@pytest.fixture(scope="module")
def runs():
    """The script over each package's wire in each codec, and through
    each package's HTTP server, once per module."""
    mvccs = [mod(root, "store.mvcc") for root in PACKAGES]
    old = [m.BOOKMARK_INTERVAL_S for m in mvccs]

    async def all_runs(d):
        hosts = {"kubernetes_tpu": f"unix:{d}/jax.sock",
                 "kubernetes_tpu_torch": "unix:"}
        hook, hook_url = await webhook_server()
        try:
            out = {(root, enc): await wire_run(root, hook_url, enc,
                                               hosts[root])
                   for root in PACKAGES for enc in CODECS}
            out[("kubernetes_tpu", "http")] = await http_run(
                "kubernetes_tpu", hook_url)
            return out
        finally:
            await hook.cleanup()

    for m in mvccs:
        m.BOOKMARK_INTERVAL_S = 0.05
    try:
        with tempfile.TemporaryDirectory(prefix="ktpu-") as d:
            return asyncio.run(all_runs(d))
    finally:
        for m, v in zip(mvccs, old):
            m.BOOKMARK_INTERVAL_S = v


SECTIONS = ("crud", "bulk", "list", "watch", "rbac", "apf", "policy",
            "frames", "codec", "socket")


@pytest.mark.parametrize("enc", CODECS)
@pytest.mark.parametrize("section", SECTIONS)
def test_wire_script_matches_the_reference(runs, section, enc):
    assert runs[("kubernetes_tpu_torch", enc)][section] == \
        runs[("kubernetes_tpu", enc)][section]


@pytest.mark.parametrize("enc", CODECS)
def test_wire_frames_codec_and_socket(runs, enc):
    out = runs[("kubernetes_tpu_torch", enc)]
    assert out["codec"] == (enc == "msgpack")
    # under the temporary directory, there while serving, gone after stop
    assert out["socket_dir"] == tempfile.gettempdir()
    assert out["socket"] == [True, False]
    # the bulk section's 40 creates left as one multi frame
    assert out["frames"].count("multi") >= 1
    assert out["watch"][2][0] == "Expired"  # the exp frame
    assert out["watch"][0][-1][0] == "BOOKMARK"


def test_wire_agrees_with_http_where_it_has_the_verb(runs):
    http = runs[("kubernetes_tpu", "http")]
    for enc in CODECS:
        out = runs[("kubernetes_tpu_torch", enc)]
        for section in ("bulk", "rbac"):
            assert [r[0] for r in out[section]] == \
                [r[0] for r in http[section]], (enc, section)


def test_event_encoders_match_the_reference():
    objs = [{"metadata": {"name": f"p{i}", "namespace": "default",
                          "resourceVersion": str(i)},
             "spec": {"n": i, "s": "x" * i, "f": i / 3}} for i in range(5)]
    got = {}
    for root in PACKAGES:
        mvcc, wire = mod(root, "store.mvcc"), mod(root, "apiserver.wire")
        evs = [mvcc.Event("ADDED", o, i) for i, o in enumerate(objs)]
        got[root] = [(wire.encode_event_object(ev),
                      wire.encode_event_object_mp(ev)) for ev in evs]
        # memoized: a second call returns the same bytes object
        assert wire.encode_event_object(evs[0]) is got[root][0][0]
    assert got["kubernetes_tpu_torch"] == got["kubernetes_tpu"]
