"""Scheduler process: leader-elected active/standby pair.

`sched_main` is the spawn-child entrypoint for one scheduler replica.
Each replica builds a `ProcessShardedStore` over the shard sockets
and blocks in `LeaderElector.run` on the `ktpu-scheduler` Lease
(client/leaderelection.py — lease CAS, KTPU_LEASE_DURATION clock).
Only the LEADER constructs the Scheduler, rebuilds its assume-cache
from fresh informer LISTs (the reference's behavior: scheduler cache
state is never replicated, it is REBUILT on failover), and schedules;
the standby holds no informers and costs nothing until the lease
frees.

Measurement rides the store, not a side channel: the parent writes a
marker ConfigMap (`kube-system/ktpu-measure`, `{id, op}`) and the
leader's status loop answers on `kube-system/ktpu-sched-status` with
the acked marker id, its scheduled count, and — after an `end`
marker — exact attempt percentiles over the marked window (the
WindowedLatencyRecorder the in-process harness reads). After a
failover the new leader marks from ITS window start, so percentiles
cover the post-failover tail, and the row's `elections` then exceeds 1.

Copy of `kubernetes_tpu/multiproc/schedproc.py`, with these departures:

- the device backend is `TorchBackend(device=..., max_batch=...)`
  (`backend_spec` `{"kind": "torch", "chunk", "device"}`; no device =
  cuda:0), built before the election as the reference builds its own.
  Without a CUDA device that raises and the process exits non-zero:
  there is no host-path fallback.
- the status row also carries the leader's kernel launch counts
  (`launches`, JSON: `wave_solve` and `probe`, over the process's life)
  and its `solveProvenance` (JSON), so the parent can show that the
  leader's solves ran on the card.
- a measure window a new leader finds open starts at the start of its
  payload; the reference marks it at the status loop's first read,
  after the loop already scheduled the backlog, so the window can be
  empty.
- `elections` counts every leader's acquisitions: a new leader adds its
  own to the count in the row its predecessor left. The reference
  publishes the current leader's own count, which is 1 again after a
  failover.
- the replica imports the leader payload's modules (the scheduler, and
  with it torch: seconds of blocking imports) BEFORE it joins the
  election; the reference imports them after winning, which holds the
  loop past a short lease's renew deadline, so the new leader loses its
  lease at once.
- a replica whose election or payload ended without a stop signal (its
  lease lost to fencing, or the payload raised) exits non-zero, with that
  exception or "lost the lease", as kube-scheduler exits on a lost
  lease; the reference's replica swallows it and exits 0, and no
  replica is left to take over.
"""

from __future__ import annotations

import asyncio
import os
import signal

MARKER_KEY = "kube-system/ktpu-measure"
STATUS_KEY = "kube-system/ktpu-sched-status"
STATUS_PERIOD_S = 0.1


def sched_main(identity: str, targets: list, env: dict,
               backend_spec: dict | None = None, batch_size: int = 1,
               scheduler_kwargs: dict | None = None) -> None:
    """Process target (module-level for spawn pickling). Blocks until
    SIGTERM/SIGINT; the active replica additionally dies with the
    whole process on kill_leader() — that is the point."""
    os.environ.update(env)
    asyncio.run(_replica(identity, list(targets), backend_spec,
                         batch_size, dict(scheduler_kwargs or {})))


async def _replica(identity: str, targets: list,
                   backend_spec: dict | None, batch_size: int,
                   scheduler_kwargs: dict) -> None:
    from kubernetes_tpu_torch.client.leaderelection import LeaderElector
    from kubernetes_tpu_torch.multiproc.client import ProcessShardedStore
    # The payload's imports, here rather than after winning the lease.
    import kubernetes_tpu_torch.client.informer  # noqa: F401
    import kubernetes_tpu_torch.scheduler.scheduler  # noqa: F401

    store = ProcessShardedStore(targets)
    backend = None
    if backend_spec and backend_spec.get("kind") == "torch":
        from kubernetes_tpu_torch.ops.backend import TorchBackend
        backend = TorchBackend(device=backend_spec.get("device"),
                               max_batch=backend_spec.get("chunk"))

    elector = LeaderElector(store, "ktpu-scheduler", identity)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)

    async def lead() -> None:
        await _lead(store, identity, backend, batch_size,
                    scheduler_kwargs, elector)

    run_task = asyncio.ensure_future(elector.run(lead))
    stop_task = asyncio.ensure_future(stop.wait())
    await asyncio.wait({run_task, stop_task},
                       return_when=asyncio.FIRST_COMPLETED)
    run_task.cancel()
    await asyncio.gather(run_task, return_exceptions=True)
    stop_task.cancel()
    await store.close()
    if stop.is_set():
        return
    # The election or the leader's payload ended on its own: the process
    # exits non-zero instead of ending cleanly.
    if not run_task.cancelled() and run_task.exception() is not None:
        raise run_task.exception()
    raise RuntimeError(f"scheduler replica {identity} lost the lease")


async def _lead(store, identity: str, backend, batch_size: int,
                scheduler_kwargs: dict, elector) -> None:
    """The leader payload: assume-cache rebuild (fresh informers), the
    scheduling loop, and the status/marker responder."""
    from kubernetes_tpu_torch.client.informer import InformerFactory
    from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    metrics = SchedulerMetrics()
    metrics.registry._metrics.setdefault(
        "leader_elections_total", elector.metrics.elections)
    metrics.registry._metrics.setdefault(
        "scheduler_is_leader", elector.metrics.is_leader)
    sched = Scheduler(store, seed=42, backend=backend, metrics=metrics,
                      **scheduler_kwargs)
    factory = InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    # The stretch presets put ~1M objects behind this sync: LIST +
    # decode over the wire is minutes, not seconds, on a narrow box. A
    # tight timeout here turns "slow sync" into a leader crash-loop
    # (payload dies -> lease expires -> standby dies the same way), so
    # the deadline only guards against a truly wedged apiserver.
    await factory.wait_for_sync(timeout=900.0)
    # The window of a measure marker already open when this leader took
    # over starts here, before any attempt of its own.
    start_mark = metrics.attempt_window().mark()
    status = asyncio.ensure_future(_status_loop(
        store, identity, metrics, elector, backend, start_mark))
    try:
        await sched.run(batch_size=batch_size)
    finally:
        status.cancel()
        await asyncio.gather(status, return_exceptions=True)
        await sched.stop()
        factory.stop()


def _launch_counts() -> dict:
    from kubernetes_tpu_torch.ops import wave_kernel
    return {"wave_solve": wave_kernel.wave_solve.launches,
            "probe": wave_kernel.probe.launches}


async def _prior_elections(store, identity: str) -> int:
    """Elections of the leaders before this one: the count in the status
    row a predecessor left (0 when there is none, or when the row is this
    replica's own from an earlier term, which its own count covers)."""
    from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError
    while True:
        try:
            row = (await store.get("configmaps", STATUS_KEY)).get(
                "data") or {}
            break
        except NotFound:
            return 0
        except StoreError:
            await asyncio.sleep(STATUS_PERIOD_S)  # shard restarting
    if row.get("identity") == identity:
        return 0
    try:
        return int(row.get("elections", 0))
    except (TypeError, ValueError):
        return 0


async def _status_loop(store, identity: str, metrics, elector,
                       backend=None, start_mark: int | None = None) -> None:
    """Answer measure markers and publish leader status via ConfigMaps.
    Store writes ride the meta shard like any client's — no side
    channel to keep alive across failover."""
    import json

    from kubernetes_tpu_torch.api.meta import new_object
    from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

    prior = await _prior_elections(store, identity)
    provenance = ""
    if backend is not None:
        from kubernetes_tpu_torch.ops.backend import solve_provenance
        provenance = json.dumps(solve_provenance(backend.device))
    win = metrics.attempt_window()
    mark: int | None = None
    acked = ""
    pcts: dict | None = None
    while True:
        try:
            try:
                marker = (await store.get(
                    "configmaps", MARKER_KEY)).get("data") or {}
            except NotFound:
                marker = {}
            mid = str(marker.get("id", ""))
            if mid and mid != acked:
                if marker.get("op") == "begin":
                    # A begin this replica finds on taking over opened
                    # before it led: its window starts at its payload's
                    # start, not at this (later) read.
                    mark = win.mark() if start_mark is None else start_mark
                    pcts = None
                elif mark is not None:
                    pcts = win.percentiles_since(
                        mark, (0.50, 0.90, 0.99, 0.999))
                acked = mid
            start_mark = None
            data = {
                "identity": identity,
                "ackId": acked,
                "isLeader": "1" if elector.is_leader else "0",
                "elections": str(
                    prior + int(elector.metrics.elections.value())),
                "scheduledTotal": str(int(metrics.schedule_attempts.value(
                    result="scheduled", profile="default-scheduler"))),
            }
            if backend is not None:
                data["launches"] = json.dumps(_launch_counts())
                data["solveProvenance"] = provenance
            if pcts is not None:
                for q, label in ((0.50, "p50"), (0.90, "p90"),
                                 (0.99, "p99"), (0.999, "p999")):
                    data[label] = repr(pcts[q])

            def put(obj):
                obj["data"] = data
                return obj

            try:
                await store.guaranteed_update("configmaps", STATUS_KEY, put)
            except NotFound:
                cm = new_object("ConfigMap", "ktpu-sched-status",
                                "kube-system")
                cm["data"] = data
                await store.create("configmaps", cm)
        except asyncio.CancelledError:
            raise
        except StoreError:
            pass  # transient (shard restarting): retry next tick
        await asyncio.sleep(STATUS_PERIOD_S)
