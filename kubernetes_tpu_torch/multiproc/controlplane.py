"""Process supervisor for the multi-process control plane.

`MultiProcessControlPlane` owns the OS-process topology: S shard
apiserver processes (shardproc.py), an active/standby scheduler pair
(schedproc.py), one shared-memory RV counter (rv.py), and the
unix-socket rendezvous directory. The parent builds clients with
`client()` — a `ProcessShardedStore` routing over the shard sockets —
and drives faults with `kill_shard` / `restart_shard` / `kill_leader`
(SIGKILL, the honest crash: no atexit, no final snapshot; recovery is
snapshot + WAL replay and lease expiry, not cooperation).

Spawn (not fork) context throughout: children boot clean
interpreters, so a parent holding a CUDA context never forks it into a
shard process.

Copy of `kubernetes_tpu/multiproc/controlplane.py`, with these
departures: the children get the parent's `KTPU_`, `CUDA_`, `PYTORCH_`
and `TORCH_` variables (the reference ships `KTPU_`, `JAX_` and
`XLA_`); `kill_shard` and `kill_leader` forget a child before they kill
it, and `check_alive` raises when a child the supervisor did not kill
has exited, so a run that drives the processes fails instead of waiting
on a dead scheduler or shard.
"""

from __future__ import annotations

import asyncio
import multiprocessing
import os
import shutil
import tempfile
import time

from kubernetes_tpu_torch.multiproc.rv import SharedRVCounter
from kubernetes_tpu_torch.multiproc.schedproc import (
    MARKER_KEY,
    STATUS_KEY,
    sched_main,
)
from kubernetes_tpu_torch.multiproc.shardproc import shard_main

_READY_TIMEOUT_S = 60.0
_READY_POLL_S = 0.05
_JOIN_TIMEOUT_S = 10.0

#: environment keys shipped to children explicitly (spawn inherits the
#: parent environment anyway; the explicit copy also carries values a
#: flags.scoped_set put in place after interpreter start).
_ENV_PREFIXES = ("KTPU_", "CUDA_", "PYTORCH_", "TORCH_")


def _child_env() -> dict:
    return {k: v for k, v in os.environ.items()
            if k.startswith(_ENV_PREFIXES)}


class MultiProcessControlPlane:
    def __init__(self, processes: int, *, data_dir: str | None = None,
                 socket_dir: str | None = None,
                 backend_spec: dict | None = None,
                 batch_size: int = 1,
                 scheduler_kwargs: dict | None = None):
        self.processes = max(1, int(processes))
        self.data_dir = data_dir
        self.backend_spec = backend_spec
        self.batch_size = batch_size
        self.scheduler_kwargs = dict(scheduler_kwargs or {})
        self._ctx = multiprocessing.get_context("spawn")
        self.rv = SharedRVCounter(ctx=self._ctx)
        self._own_socket_dir = socket_dir is None
        self.socket_dir = socket_dir or tempfile.mkdtemp(prefix="ktpu-mp-")
        self.targets = [
            f"unix:{os.path.join(self.socket_dir, f'shard-{i}.sock')}"
            for i in range(self.processes)]
        self.shard_procs: list = [None] * self.processes
        #: identity -> Process for the scheduler replicas.
        self.sched_procs: dict[str, object] = {}
        self._store = None  # supervisor's own client (lease reads)

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        """Spawn every shard process, then block until each socket
        accepts a connection (interpreter boot + recovery replay)."""
        await asyncio.gather(*(
            self._spawn_shard(i) for i in range(self.processes)))
        from kubernetes_tpu_torch.multiproc.client import ProcessShardedStore
        self._store = ProcessShardedStore(self.targets)

    async def start_schedulers(self, replicas: int = 2) -> None:
        """Boot the leader-elected scheduler pool (2 = the HA pair).
        Replica order seeds no priority — whoever wins the Lease CAS
        leads; the rest idle as standbys."""
        env = _child_env()
        for i in range(replicas):
            identity = f"ktpu-sched-{i}"
            p = self._ctx.Process(
                target=sched_main,
                args=(identity, self.targets, env, self.backend_spec,
                      self.batch_size, self.scheduler_kwargs),
                name=identity, daemon=True)
            await asyncio.to_thread(p.start)
            self.sched_procs[identity] = p

    def client(self):
        from kubernetes_tpu_torch.multiproc.client import ProcessShardedStore
        return ProcessShardedStore(self.targets)

    async def stop(self) -> None:
        if self._store is not None:
            await self._store.close()
            self._store = None
        # Schedulers down first, THEN shards: a replica outliving its
        # sockets floods stderr with reflector reconnect noise.
        scheds = [p for p in self.sched_procs.values() if p is not None]
        shards = [p for p in self.shard_procs if p is not None]
        self.sched_procs.clear()
        self.shard_procs = [None] * self.processes
        for procs in (scheds, shards):
            for p in procs:
                if p.is_alive():
                    p.terminate()  # SIGTERM: shards take a final snapshot
            await asyncio.to_thread(self._join_or_kill, procs)
        if self._own_socket_dir:
            shutil.rmtree(self.socket_dir, ignore_errors=True)

    @staticmethod
    def _join_or_kill(procs: list) -> None:
        deadline = time.monotonic() + _JOIN_TIMEOUT_S
        for p in procs:
            p.join(timeout=max(0.1, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)

    # -- shard processes ---------------------------------------------------

    def _shard_dir(self, index: int) -> str | None:
        return self.data_dir

    async def _spawn_shard(self, index: int) -> None:
        path = self.targets[index][len("unix:"):]
        p = self._ctx.Process(
            target=shard_main,
            args=(index, path, self.rv, self._shard_dir(index),
                  _child_env()),
            name=f"ktpu-shard-{index}", daemon=True)
        await asyncio.to_thread(p.start)
        self.shard_procs[index] = p
        await self._wait_ready(path, p)

    @staticmethod
    async def _wait_ready(path: str, proc) -> None:
        deadline = time.monotonic() + _READY_TIMEOUT_S
        while time.monotonic() < deadline:
            if not proc.is_alive():
                raise RuntimeError(
                    f"shard process exited during boot "
                    f"(exitcode={proc.exitcode})")
            try:
                _, writer = await asyncio.open_unix_connection(path)
                writer.close()
                try:
                    await writer.wait_closed()
                except Exception:
                    pass
                return
            except OSError:
                await asyncio.sleep(_READY_POLL_S)
        raise TimeoutError(f"shard socket {path} not ready "
                           f"after {_READY_TIMEOUT_S}s")

    async def kill_shard(self, index: int) -> None:
        """SIGKILL a shard apiserver mid-flight: no flush, no final
        snapshot — exactly the crash the WAL exists for."""
        p = self.shard_procs[index]
        if p is None:
            return
        self.shard_procs[index] = None
        p.kill()
        await asyncio.to_thread(p.join, 10.0)

    async def restart_shard(self, index: int) -> None:
        """Respawn a killed shard on the same socket, data dir, and
        shared counter; returns once the socket accepts again (recovery
        replay included). Clients reconnect lazily; their expired
        watches relist — the informer contract."""
        if self.shard_procs[index] is not None:
            await self.kill_shard(index)
        await self._spawn_shard(index)

    # -- scheduler HA ------------------------------------------------------

    async def leader_identity(self) -> str | None:
        from kubernetes_tpu_torch.store.mvcc import StoreError
        if self._store is None:
            return None
        try:
            lease = await self._store.get(
                "leases", "kube-system/ktpu-scheduler")
        except StoreError:
            return None
        spec = lease.get("spec") or {}
        holder = spec.get("holderIdentity")
        expired = time.time() > (spec.get("renewTime") or 0) + (
            spec.get("leaseDurationSeconds") or 0)
        return None if expired else holder

    async def kill_leader(self) -> str | None:
        """SIGKILL the scheduler replica currently holding the lease
        (mid-renewal, no on_stopped_leading): the standby must notice
        via lease EXPIRY, not a handover. Returns the killed identity,
        or None when no live replica holds the lease."""
        holder = await self.leader_identity()
        p = self.sched_procs.get(holder) if holder else None
        if p is None or not p.is_alive():
            return None
        del self.sched_procs[holder]
        p.kill()
        await asyncio.to_thread(p.join, 10.0)
        return holder

    def check_alive(self) -> None:
        """Raise if a shard or scheduler process the supervisor did not
        kill has exited (a scheduler whose backend could not reach its
        device exits non-zero at boot)."""
        children = [(f"shard {i}", p) for i, p in
                    enumerate(self.shard_procs) if p is not None]
        children += list(self.sched_procs.items())
        for name, p in children:
            if p.exitcode is not None:
                raise RuntimeError(f"control-plane process {name} exited "
                                   f"with code {p.exitcode}")


class MeasureProtocol:
    """Parent half of the measure-marker handshake (schedproc.py doc):
    `begin()` before the measured phase, `end()` after — returns the
    leader's status row (exact attempt percentiles over the marked
    window, scheduled count, election count)."""

    def __init__(self, store, *, ack_timeout_s: float = 30.0):
        self.store = store
        self.ack_timeout_s = ack_timeout_s
        self._id = 0

    async def begin(self) -> None:
        await self._put("begin")
        await self._wait_ack()

    async def end(self) -> dict:
        await self._put("end")
        return await self._wait_ack()

    async def status(self) -> dict:
        from kubernetes_tpu_torch.store.mvcc import StoreError
        try:
            return (await self.store.get(
                "configmaps", STATUS_KEY)).get("data") or {}
        except StoreError:
            return {}

    async def _put(self, op: str) -> None:
        from kubernetes_tpu_torch.api.meta import new_object
        from kubernetes_tpu_torch.store.mvcc import NotFound
        self._id += 1
        data = {"id": str(self._id), "op": op}

        def put(obj):
            obj["data"] = data
            return obj

        try:
            await self.store.guaranteed_update("configmaps", MARKER_KEY, put)
        except NotFound:
            cm = new_object("ConfigMap", "ktpu-measure", "kube-system")
            cm["data"] = data
            await self.store.create("configmaps", cm)

    async def _wait_ack(self) -> dict:
        deadline = time.monotonic() + self.ack_timeout_s
        while time.monotonic() < deadline:
            row = await self.status()
            if row.get("ackId") == str(self._id):
                return row
            await asyncio.sleep(0.05)
        # A failover mid-window can eat one marker; measurement
        # degrades to parent-side wall-clock numbers, not an error.
        return {}
