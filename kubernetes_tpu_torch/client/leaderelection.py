"""Lease-based leader election for active/passive HA.

Parity target: staging/src/k8s.io/client-go/tools/leaderelection
(`LeaderElector.Run`: acquire → renew loop → on lost call OnStoppedLeading;
resourcelock on coordination.k8s.io/Lease). Fencing is by lease holder identity
+ RV CAS, exactly as the reference. Copy of
`kubernetes_tpu/client/leaderelection.py`.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

from kubernetes_tpu_torch.api.meta import new_object
from kubernetes_tpu_torch.store.mvcc import MVCCStore, NotFound, StoreError

LEASES = "leases"


class LeaderElector:
    def __init__(
        self,
        store: MVCCStore,
        lock_name: str,
        identity: str,
        lease_duration: float | None = None,
        renew_deadline: float | None = None,
        retry_period: float | None = None,
        namespace: str = "kube-system",
        metrics=None,
    ):
        from kubernetes_tpu_torch.utils import flags
        self.store = store
        self.lock_name = lock_name
        self.identity = identity
        # KTPU_LEASE_DURATION scales the whole election clock: the
        # renew deadline and retry period keep the reference's 15/10/2
        # proportions unless pinned explicitly, so a short-lease test
        # (or the failover bench row) tightens detection end to end.
        if lease_duration is None:
            lease_duration = float(flags.get("KTPU_LEASE_DURATION"))
        self.lease_duration = lease_duration
        self.renew_deadline = (renew_deadline if renew_deadline
                               is not None else lease_duration * (2 / 3))
        self.retry_period = (retry_period if retry_period is not None
                             else lease_duration * (2 / 15))
        self.namespace = namespace
        #: HAMetrics (metrics/registry.py): elections won + the
        #: is-leader gauge — failover is data, not log noise.
        if metrics is None:
            from kubernetes_tpu_torch.metrics.registry import HAMetrics
            metrics = HAMetrics()
        self.metrics = metrics
        self.is_leader = False

    def _key(self) -> str:
        return f"{self.namespace}/{self.lock_name}"

    async def _try_acquire_or_renew(self) -> bool:
        now = time.time()
        try:
            lease = await self.store.get(LEASES, self._key())
        except NotFound:
            lease = new_object(
                "Lease", self.lock_name, self.namespace,
                spec={"holderIdentity": self.identity,
                      "acquireTime": now, "renewTime": now,
                      "leaseDurationSeconds": self.lease_duration},
            )
            try:
                await self.store.create(LEASES, lease)
                return True
            except StoreError:  # AlreadyExists (lost race) or transient
                return False
        except StoreError:
            # Transient store failure (the lease shard restarting, a
            # wire blip): a FAILED ATTEMPT, retried on retry_period —
            # client-go's tryAcquireOrRenew contract. Fencing still
            # holds: the leader cancels its payload once renewals fail
            # past renew_deadline; a replica must never crash out of
            # the election because the apiserver bounced.
            return False
        spec = lease.get("spec", {})
        holder = spec.get("holderIdentity")
        expired = now > spec.get("renewTime", 0) + spec.get(
            "leaseDurationSeconds", self.lease_duration)
        if holder != self.identity and not expired:
            return False

        def mutate(obj):
            s = obj.setdefault("spec", {})
            if s.get("holderIdentity") != self.identity:
                if time.time() <= s.get("renewTime", 0) + s.get(
                        "leaseDurationSeconds", self.lease_duration):
                    return None  # someone else renewed first
                s["acquireTime"] = time.time()
            s["holderIdentity"] = self.identity
            s["renewTime"] = time.time()
            s["leaseDurationSeconds"] = self.lease_duration
            return obj

        try:
            updated = await self.store.guaranteed_update(LEASES, self._key(), mutate)
        except StoreError:  # Conflict (lost CAS race) or transient
            return False
        return updated.get("spec", {}).get("holderIdentity") == self.identity

    async def run(
        self,
        on_started_leading: Callable[[], Awaitable[None]],
        on_stopped_leading: Callable[[], None] | None = None,
    ) -> None:
        """Block acquiring; then run the payload while renewing. If renewal
        fails past the deadline, cancel the payload (fencing)."""
        while not await self._try_acquire_or_renew():
            await asyncio.sleep(self.retry_period)
        self.is_leader = True
        self.metrics.elections.inc()
        self.metrics.is_leader.set(1)
        payload = asyncio.ensure_future(on_started_leading())
        try:
            last_renew = time.time()
            while not payload.done():
                await asyncio.sleep(self.retry_period)
                if await self._try_acquire_or_renew():
                    last_renew = time.time()
                elif time.time() - last_renew > self.renew_deadline:
                    payload.cancel()
                    break
            res = (await asyncio.gather(payload, return_exceptions=True))[0]
            # A crashed payload must surface, not read as a clean lease
            # handover — silently absorbing it leaves a replica "running"
            # that schedules nothing.
            if isinstance(res, BaseException) and \
                    not isinstance(res, asyncio.CancelledError):
                raise res
        finally:
            # run() itself cancelled (or renewal raised): the payload must
            # not keep doing leader work without the lease.
            if not payload.done():
                payload.cancel()
                try:
                    await asyncio.gather(payload, return_exceptions=True)
                except asyncio.CancelledError:
                    pass
            self.is_leader = False
            self.metrics.is_leader.set(0)
            if on_stopped_leading:
                on_stopped_leading()
