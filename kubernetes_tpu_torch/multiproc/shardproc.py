"""Shard apiserver process: one mvcc store + WAL behind a wire socket.

`shard_main` is the spawn-child entrypoint `MultiProcessControlPlane`
launches once per shard: it owns ONE unsharded `MVCCStore` (its own
watch-cache tier and event ring), allocates RVs from the shared
cross-process counter (multiproc/rv.py), journals every commit to a
per-shard write-ahead log under `<data_dir>/shard-<i>/`, and serves
the KTPU wire on a unix socket. The parent's `ProcessShardedStore`
(multiproc/client.py) routes to these sockets with the same hash
table the in-process facade uses.

The child never imports torch (the store and apiserver layers hold no
tensor; tests/test_torch_isolation.py pins that), so a shard process
boots in interpreter-start time.

Restart-after-crash: the parent respawns with the same socket path,
data dir, and shared counter; `recover_store` rebuilds from the
newest snapshot + WAL tail, and the monotonic counter setter
guarantees replay never regresses RVs other shards handed out.

Copy of `kubernetes_tpu/multiproc/shardproc.py`.
"""

from __future__ import annotations

import asyncio
import os
import signal


def shard_main(index: int, socket_path: str, rv_counter,
               data_dir: str | None, env: dict) -> None:
    """Process target (must stay a module-level function: spawn pickles
    it by qualified name). Blocks until SIGTERM/SIGINT."""
    os.environ.update(env)
    asyncio.run(_serve(index, socket_path, rv_counter, data_dir))


async def _serve(index: int, socket_path: str, rv_counter,
                 data_dir: str | None) -> None:
    from kubernetes_tpu_torch.apiserver.wire import WireServer
    from kubernetes_tpu_torch.metrics.registry import DurabilityMetrics
    from kubernetes_tpu_torch.store import install_core_validation
    from kubernetes_tpu_torch.store.durable import DurabilityManager, recover_store
    from kubernetes_tpu_torch.store.mvcc import MVCCStore, binding_subresource

    metrics = DurabilityMetrics()
    durability = None
    if data_dir:
        shard_dir = os.path.join(data_dir, f"shard-{index}")
        os.makedirs(shard_dir, exist_ok=True)
        store = recover_store(shard_dir, rv_source=rv_counter,
                              metrics=metrics)
        durability = DurabilityManager(store, shard_dir, metrics=metrics)
    else:
        store = MVCCStore(rv_source=rv_counter)
        store.register_subresource("pods", "binding", binding_subresource)
    install_core_validation(store)

    # A crashed predecessor (SIGKILL) leaves its socket file behind;
    # binding over it needs the unlink first.
    try:
        os.unlink(socket_path)
    except OSError:
        pass

    server = WireServer(store, host=f"unix:{socket_path}")

    def _stats() -> dict:
        return {
            "shard": index,
            "rv": store.resource_version,
            "objects": sum(len(t) for t in store._tables.values()),
            "walAppends": int(metrics.appends.value()),
            "walReplayed": int(metrics.replayed.value()),
            "walFsyncs": int(metrics.fsync_seconds.count()),
            "walFsyncSeconds": round(metrics.fsync_seconds.sum(), 6),
        }

    server.stats_fn = _stats
    await server.start()
    if durability is not None:
        durability.start()

    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()

    # Graceful drain: final snapshot so the next boot replays nothing.
    if durability is not None:
        await durability.stop(final_snapshot=True)
    await server.stop()
    store.stop()
