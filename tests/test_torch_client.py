"""The port's informers and event recorder on the CPU against the JAX
package's.

- `SharedInformer` / `InformerFactory`: one seeded sequence of pod and node
  writes gives the same handler calls (kind, name, resourceVersion) in the
  same order, the same indexer contents and namespace index, and a late
  handler gets the same synthetic adds. A handler that mutates a
  watch-delivered object fails (the store freezes stored objects under
  KTPU_DEBUG_FREEZE, which the test suite sets).
- `EventRecorder`, the bounded broadcaster with DropIfChannelFull: the same
  sequence of FailedScheduling and Scheduled events gives the same
  emitted, dropped, aggregated and spam-filtered counts (1000 pending for
  ordinary reasons, 16384 for Scheduled, which evicts ordinary events
  first), and after the drain the same Event objects in the store.

Tolerance: none.
"""

import asyncio

import numpy as np
import pytest

from kubernetes_tpu.api import types as jtypes
from kubernetes_tpu.client import events as jevents
from kubernetes_tpu.client import informer as jinformer
from kubernetes_tpu.store import mvcc as jmvcc
from kubernetes_tpu_torch.api import types as ttypes
from kubernetes_tpu_torch.client import events as tevents
from kubernetes_tpu_torch.client import informer as tinformer
from kubernetes_tpu_torch.store import mvcc as tmvcc

PACKAGES = {"jax": (jmvcc, jtypes, jinformer, jevents),
            "port": (tmvcc, ttypes, tinformer, tevents)}


def _rv(obj) -> str:
    return obj["metadata"]["resourceVersion"]


async def informer_run(pkg, seed: int) -> dict:
    mvcc, types, informer, _ = PACKAGES[pkg]
    store = mvcc.new_cluster_store()
    rng = np.random.default_rng(seed)
    for i in range(5):
        await store.create("pods", types.make_pod(f"pre{i}", namespace=(
            "default" if i % 2 else "other")))
    factory = informer.InformerFactory(store)
    calls = []

    def handler(kind):
        def record(*objs):
            calls.append((kind, objs[-1]["metadata"]["name"],
                          _rv(objs[-1]), _rv(objs[0])))
        return record

    pods = factory.informer("pods")
    assert factory.informer("pods") is pods
    pods.add_event_handler(informer.ResourceEventHandler(
        on_add=handler("add"), on_update=handler("update"),
        on_delete=handler("delete")))
    nodes = factory.informer("nodes")
    nodes.add_event_handler(informer.ResourceEventHandler(
        on_add=handler("node-add"), on_update=handler("node-update")))
    factory.start()
    await factory.wait_for_sync()
    live = [f"pre{i}" for i in range(5)]

    def key_of(name):
        other = name in ("pre0", "pre2", "pre4")
        return f"{'other' if other else 'default'}/{name}"
    for step in range(60):
        u = rng.random()
        if u < 0.4:
            name = f"p{step}"
            await store.create("pods", types.make_pod(name))
            live.append(name)
        elif u < 0.6 and live:
            name = live[int(rng.integers(0, len(live)))]

            def relabel(p):
                p["metadata"]["labels"] = {"step": str(step)}
                return p
            await store.guaranteed_update("pods", key_of(name), relabel)
        elif u < 0.75 and live:
            name = live.pop(int(rng.integers(0, len(live))))
            await store.delete("pods", key_of(name))
        else:
            await store.create("nodes", types.make_node(f"n{step}"))
        await asyncio.sleep(0)
    for _ in range(100):
        await asyncio.sleep(0.005)
        if len(pods.indexer) == len(live):
            break
    late = []
    pods.add_event_handler(informer.ResourceEventHandler(
        on_add=lambda o: late.append(o["metadata"]["name"])))
    mutated = []

    def mutate(obj):
        try:
            obj["metadata"]["labels"] = {"x": "y"}
            mutated.append("allowed")
        except TypeError:
            mutated.append("refused")
    pods.add_event_handler(informer.ResourceEventHandler(on_add=mutate))
    out = {"calls": calls, "keys": sorted(pods.indexer.keys()),
           "other": sorted(o["metadata"]["name"] for o in
                           pods.indexer.by_index("namespace", "other")),
           "late": sorted(late), "mutated": sorted(set(mutated)),
           "synced": pods.has_synced() and nodes.has_synced()}
    factory.stop()
    store.stop()
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_informers_match_reference(seed):
    want = asyncio.run(informer_run("jax", seed))
    got = asyncio.run(informer_run("port", seed))
    assert got == want
    # Watch-delivered objects are the stored (frozen) ones; the initial
    # LIST hands out copies, as in the reference.
    assert got["synced"] and "refused" in got["mutated"]
    kinds = {c[0] for c in got["calls"]}
    assert {"add", "update", "delete", "node-add"} <= kinds


def record_events(pkg) -> tuple[dict, list]:
    mvcc, types, _, events = PACKAGES[pkg]
    store = mvcc.MVCCStore()
    rec = events.EventRecorder(store, "default-scheduler")
    pods = [types.make_pod(f"p{i}") for i in range(17300)]
    # Outside a running loop nothing drains: the buffer fills exactly.
    for p in pods[:300]:
        rec.event(p, "Warning", "FailedScheduling", "0/3 nodes fit")
    for p in pods[:300]:  # repeats while pending aggregate into count 2
        rec.event(p, "Warning", "FailedScheduling", "0/3 nodes fit")
    for p in pods[300:17300]:
        rec.event(p, "Normal", "Scheduled",
                  f"assigned {p['metadata']['name']}")
    for p in pods[:50]:  # ordinary reasons beyond the 1000 bound drop
        rec.event(p, "Warning", "BackOff", "retrying")
    counts = {"emitted": rec.emitted, "dropped": rec.dropped,
              "aggregated": rec.aggregated,
              "spam_filtered": rec.spam_filtered,
              "pending": len(rec._pending)}

    async def drain():
        rec._kick_drain()
        while rec._draining:
            await asyncio.sleep(0.01)
    asyncio.run(drain())
    stored = sorted((e["reason"], e["involvedObject"]["name"], e["count"],
                     e["type"], e["message"])
                    for e in store._table("events").values())
    store.stop()
    return counts, stored


def test_event_recorder_flush_writes_every_buffered_event():
    """`flush` (the port's, which its runner calls before it closes the
    store's client) returns once every buffered event is in the store,
    those recorded while a drain is in flight included."""
    mvcc, types, _, events = PACKAGES["port"]

    async def run():
        store = mvcc.MVCCStore()
        rec = events.EventRecorder(store, "default-scheduler")
        pods = [types.make_pod(f"p{i}") for i in range(3000)]
        for p in pods[:2000]:
            rec.event(p, "Normal", "Scheduled", "assigned")
        await asyncio.sleep(0)  # the drain has started
        for p in pods[2000:]:
            rec.event(p, "Normal", "Scheduled", "assigned")
        await rec.flush()
        out = (len(store._table("events")), rec._draining, rec._pending)
        await rec.flush()  # nothing buffered: returns at once
        store.stop()
        return out

    assert asyncio.run(run()) == (3000, False, [])


def test_event_recorder_drop_semantics_match_reference():
    want = record_events("jax")
    got = record_events("port")
    assert got == want
    counts, stored = got
    assert counts["emitted"] == 300 + 300 + 17000 + 50
    assert counts["aggregated"] == 300
    # 16384 pending: 17000 Scheduled evict the 300 FailedScheduling, then
    # drop; the 50 BackOff events find the buffer full.
    assert counts["pending"] == tevents.EventRecorder.MAX_PENDING_PRIORITY
    assert counts["dropped"] == (17000 - (16384 - 300)) + 50
    assert len(stored) == 16384
    assert all(r == "Scheduled" for r, *_ in stored)
