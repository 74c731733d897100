"""Hollow-kubelet node agent: a per-node process with a real sync loop.

Parity target (SURVEY §2.5): pkg/kubelet/kubelet.go `syncLoop` (watch →
per-pod work), pod_workers.go (serialized per-pod workers, latest update
wins), cm/devicemanager (Allocate against the node's device inventory,
checkpointed locally — agent/ledger.py), nodestatus/lease heartbeats,
and kubemark's hollow kubelet (no container runtime: "running" a pod is
a status transition, same as KWOK staging).

TPU-first shape: the agent is a WATCH CONSUMER of the apiserver wire,
filtered server-side to `spec.nodeName=<me>` (the kubelet's field
selector — store/mvcc.py tracked fields), so N agents cost the control
plane one filtered watch each instead of N full pod streams. Device
allocation consumes the DRA claim status the scheduler persisted at
PreBind (plugins/dynamicresources.py `pre_bind`): the agent performs the
kubelet-side Allocate — claim devices -> local ledger -> checkpoint —
and releases on termination.

Copy of `kubernetes_tpu/agent/agent.py`. The reference also runs an
agent as a process of its own over the apiserver wire
(`kubernetes_tpu/agent/__main__.py`, with the read-only kubelet server of
`agent/server.py`); those wait for the apiserver's port, so here an agent
runs in process against a store object, and what only those serve
(the local pod view of `/pods`, the relist storm's `force_relist`) is
left out.
"""

from __future__ import annotations

import asyncio
import logging
import os

from kubernetes_tpu_torch.api.meta import (
    name_of,
    namespace_of,
    namespaced_name,
    new_object,
)
from kubernetes_tpu_torch.api.types import (
    make_node,
    make_resource_slice,
    template_devices,
)
from kubernetes_tpu_torch.agent.config import (
    ResolvedConfig,
    merge_config,
    resolve_config,
)
from kubernetes_tpu_torch.agent.ledger import DeviceLedger
from kubernetes_tpu_torch.topology.mesh import MESH_COORD_LABEL
from kubernetes_tpu_torch.store.mvcc import (
    AlreadyExists,
    Conflict,
    Expired,
    NotFound,
    StoreError,
)

logger = logging.getLogger(__name__)

COMPLETE_AFTER_ANN = "kwok.x-k8s.io/complete-after"
AGENT_ANN = "ktpu.io/agent"


class NodeAgent:
    """One node's agent: registers the Node, heartbeats its Lease, syncs
    the pods bound to it, allocates claim devices, checkpoints."""

    def __init__(self, store, node_name: str, *,
                 checkpoint_dir: str = ".",
                 node_template: dict | None = None,
                 register: bool = True,
                 lease_period: float | None = None,
                 device_driver: str | None = None,
                 device_zones: int | None = None,
                 topology_coord: str | None = None,
                 config_file: str | None = None):
        self.store = store
        self.node_name = node_name
        self.node_template = node_template or {}
        self.register = register
        # Config resolution (agent/config.py): explicit constructor
        # kwargs are the highest-precedence layer; the file + apiserver
        # layers join at start() (the store isn't reachable yet here).
        # Until then, defaults + overrides govern — same values the old
        # keyword defaults carried.
        self._config_file = config_file
        self._config_overrides = {k: v for k, v in {
            "leasePeriodSeconds": lease_period,
            "deviceDriver": device_driver,
            "deviceZones": device_zones,
            "topologyCoord": topology_coord,
        }.items() if v is not None}
        self.kubelet_config: ResolvedConfig = merge_config(
            ("override", self._config_overrides))
        self._apply_config(self.kubelet_config)
        self.ledger = DeviceLedger(
            os.path.join(checkpoint_dir,
                         f"devices-{node_name}.checkpoint.json"),
            node_name)
        self._tasks: list[asyncio.Task] = []
        self._workers: set[asyncio.Task] = set()
        #: pod key -> latest observed object (None = deleted); per-pod
        #: workers drain this map serially per key, latest state wins
        #: (pod_workers.go UpdatePod semantics).
        self._latest: dict[str, dict | None] = {}
        self._active: set[str] = set()
        #: pod keys with a staged-completion timer armed (restart-safe:
        #: _sync_pod re-arms for Running pods found after a relist).
        self._armed: set[str] = set()
        self._stopped = False
        self._ip_seq = 0
        # Pod-IP base: sha256 of the node name — a permutation-sensitive
        # hash ('n01' vs 'n10' must not share a /16; byte-sum collided).
        import hashlib
        self._ip_base = (hashlib.sha256(
            node_name.encode()).digest()[0] % 200) + 16

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> None:
        await self._start_register()
        await self._start_sync()

    @classmethod
    async def start_many(cls, agents, window: int = 512) -> None:
        """Batched cold start for an agent fleet (the r12-identified 50k
        headroom: agent STARTUP cost, not the read path). A per-agent
        `start()` serializes its own handshake — register → LIST →
        watch — so a fleet gathered over start() keeps one loop tick per
        agent per round trip. This runs the fleet in two WIDE phases
        instead: every registration first (a window's node creates
        coalesce into one multiplexed wire frame), then every
        LIST+WATCH establishment (the LISTs read one shared watch-cache
        snapshot; on a sharded control plane the S-shard fan-in serves
        windows concurrently instead of serializing per-agent
        handshakes). Windowed so a mid-boot failure still leaves every
        started agent stoppable."""
        agents = list(agents)
        for lo in range(0, len(agents), window):
            await asyncio.gather(
                *(a._start_register() for a in agents[lo:lo + window]))
        for lo in range(0, len(agents), window):
            await asyncio.gather(
                *(a._start_sync() for a in agents[lo:lo + window]))

    def _apply_config(self, cfg: ResolvedConfig) -> None:
        self.lease_period = float(cfg["leasePeriodSeconds"])
        self.device_driver = cfg["deviceDriver"]
        self.device_zones = max(1, int(cfg["deviceZones"]))
        self.topology_coord = cfg["topologyCoord"]

    async def _start_register(self) -> None:
        """Phase 1: config resolve + local checkpoint restore + Node
        registration (the config layers must land first: the lease
        period and the topology coordinate both feed registration)."""
        self.kubelet_config = await resolve_config(
            self.store, self.node_name, self._config_file,
            self._config_overrides)
        self._apply_config(self.kubelet_config)
        self.ledger.load()
        if self.register:
            await self._register_node()

    async def _start_sync(self) -> None:
        """Phase 2: startup reconcile LIST, watch + lease establishment."""
        # Startup reconcile (syncLoop HandlePodCleanups): restore the
        # checkpoint against the live bound-pod set, then prime workers.
        lst = await self.store.list(
            "pods", fields={"spec.nodeName": self.node_name})
        live = {namespaced_name(p) for p in lst.items}
        dropped = self.ledger.reconcile(live)
        if dropped:
            logger.info("agent %s: reclaimed devices of %d departed pods",
                        self.node_name, len(dropped))
        # Resume the IP sequence past every already-assigned podIP on this
        # node: _ip_seq resets with the process, but Running pods keep
        # their IPs — restarting from 0 would re-issue them.
        for p in lst.items:
            self._ip_seq = max(self._ip_seq, self._ip_seq_of(p))
        for p in lst.items:
            self._observe(namespaced_name(p), p)
        self._tasks.append(asyncio.ensure_future(
            self._watch_loop(lst.resource_version)))
        self._tasks.append(asyncio.ensure_future(self._lease_loop()))

    async def stop(self, graceful: bool = True) -> None:
        """Stop this agent — and only this agent (a shared store/wire
        keeps serving its siblings).

        graceful=True (orderly shutdown, the default): the watch and
        lease loops are cancelled first, then in-flight per-pod workers
        get a short drain window to land their current status write
        before being cancelled themselves.

        graceful=False (node DEATH — the churn battery's fault
        primitive, SURVEY §5.3): every task is cancelled immediately,
        mid-write, and awaited so nothing leaks; no further store
        writes happen, and the Node and Lease objects are deliberately
        left behind to go STALE — the nodelifecycle controller's grace
        period, not this call, decides when the cluster notices the
        death (lease expiry). Local pod/worker state is dropped too:
        a killed agent cannot be restarted in place."""
        self._stopped = True
        loops = list(self._tasks)
        for t in loops:
            t.cancel()
        workers = list(self._workers)
        if graceful and workers:
            # Drain window: a worker mid-_mark_running finishes its
            # write instead of aborting it (completion timers and other
            # long sleepers are cancelled below when the window lapses).
            _, pending = await asyncio.wait(workers, timeout=0.2)
            workers = list(pending)
        for t in workers:
            t.cancel()
        if loops or workers:
            await asyncio.gather(*loops, *workers,
                                 return_exceptions=True)
        self._tasks.clear()
        self._workers.clear()
        if not graceful:
            self._latest.clear()
            self._armed.clear()
            self._active.clear()

    async def _register_node(self) -> None:
        node = make_node(self.node_name, **self.node_template)
        node["metadata"].setdefault("annotations", {})[AGENT_ANN] = "true"
        if self.topology_coord:
            # Interconnect position (topology/mesh node_cell contract):
            # an explicit coordinate label beats the scheduler's
            # name-derived fallback.
            node["metadata"].setdefault("labels", {})[
                MESH_COORD_LABEL] = str(self.topology_coord)
        try:
            await self.store.create("nodes", node)
        except AlreadyExists:
            # Restart (or a pre-staged Node): the object survives us,
            # but the coordinate label must still land — the scheduler
            # reads it off the Node, not the agent.
            if self.topology_coord:
                coord = str(self.topology_coord)

                def stamp(existing):
                    labels = existing["metadata"].setdefault("labels", {})
                    if labels.get(MESH_COORD_LABEL) == coord:
                        return None
                    labels[MESH_COORD_LABEL] = coord
                    return existing
                try:
                    await self.store.guaranteed_update(
                        "nodes", self.node_name, stamp, return_copy=False)
                except StoreError:
                    logger.exception(
                        "agent %s: coord label stamp failed",
                        self.node_name)
        await self._publish_devices()

    async def _publish_devices(self) -> None:
        """Device-plugin registration (devicemanager ListAndWatch analog):
        extended resources publish as one ResourceSlice with NUMA-zoned
        device blocks — naming/zoning via api.types.template_devices, the
        convention shared with kwok nodes."""
        devices = template_devices(self.node_template.get("allocatable"),
                                   self.device_zones)
        if not devices:
            return
        try:
            await self.store.create(
                "resourceslices",
                make_resource_slice(self.node_name, self.device_driver,
                                    devices))
        except AlreadyExists:
            pass
        except StoreError:
            logger.exception("agent %s: device publish failed",
                             self.node_name)

    # -- watch loop (syncLoop's config source) -----------------------------

    async def _watch_loop(self, from_rv: int) -> None:
        """The kubelet's apiserver config source: a field-filtered watch.
        On disconnect, resume the watch from the last bookmark/event RV —
        the apiserver's watch cache backfills the gap from its ring — and
        fall back to the full relist ONLY on Expired (410: the server
        says the gap is gone). N agents reconnecting after a blip thus
        cost N ring backfills, not N store LISTs (reflector contract +
        bookmark-driven resync)."""
        rv = from_rv
        fields = {"spec.nodeName": self.node_name}
        while not self._stopped:
            try:
                watch = await self.store.watch(
                    "pods", resource_version=rv, fields=fields)
                async for ev in watch:
                    if ev.type == "BOOKMARK":
                        rv = ev.rv
                        continue
                    rv = max(rv, ev.rv)
                    key = namespaced_name(ev.object)
                    self._observe(
                        key, None if ev.type == "DELETED" else ev.object)
            except asyncio.CancelledError:
                raise
            except Expired:
                if self._stopped:
                    return
                new_rv = await self._relist(fields)
                if new_rv is not None:
                    rv = new_rv
            except StoreError:
                if self._stopped:
                    return
                # Transport error: the RV is (probably) still servable —
                # resume from it instead of amplifying into a LIST storm.
                # (A server that restarted with a reset RV counter makes
                # the resume Expired — the relist branch above — so this
                # cannot strand the agent on a stale RV.)
                await asyncio.sleep(0.5)
            except Exception:
                logger.exception("agent %s: watch loop error",
                                 self.node_name)
                await asyncio.sleep(0.5)

    async def _relist(self, fields: dict) -> int | None:
        """Full LIST + ledger reconcile (the 410/cold-start path).
        Returns the LIST's RV, or None if the LIST failed (after a
        backoff sleep) — callers retry or keep their RV."""
        try:
            lst = await self.store.list("pods", fields=fields)
        except Exception:
            await asyncio.sleep(0.5)
            return None
        seen = set()
        for p in lst.items:
            key = namespaced_name(p)
            seen.add(key)
            self._observe(key, p)
        # Pods that vanished while the watch was down.
        for key in self.ledger.reconcile(seen):
            self._observe(key, None)
        return lst.resource_version

    # -- pod workers -------------------------------------------------------

    def _observe(self, key: str, obj: dict | None) -> None:
        self._latest[key] = obj
        if key in self._active or self._stopped:
            return
        self._active.add(key)
        t = asyncio.ensure_future(self._worker(key))
        self._workers.add(t)
        t.add_done_callback(self._workers.discard)

    async def _worker(self, key: str) -> None:
        """Serialized per-pod worker: processes the LATEST observed state
        until none is pending, then exits (a new event respawns it)."""
        try:
            while key in self._latest:
                obj = self._latest.pop(key)
                try:
                    await self._sync_pod(key, obj)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.exception("agent %s: sync %s failed",
                                     self.node_name, key)
        finally:
            self._active.discard(key)

    async def _sync_pod(self, key: str, pod: dict | None) -> None:
        if pod is None:
            released = self.ledger.release(key)
            if released:
                logger.debug("agent %s: released %s from %s",
                             self.node_name, released, key)
            return
        phase = (pod.get("status") or {}).get("phase")
        if phase in ("Succeeded", "Failed"):
            # Terminal: the kubelet reclaims devices at termination
            # (devicemanager podDevices cleanup), before deletion.
            self.ledger.release(key)
            return
        if phase != "Pending":
            if phase == "Running":
                # Restart recovery: a pod marked Running by a PREVIOUS
                # agent incarnation still owes its staged completion —
                # re-arm with the full delay (conservative; the original
                # start time did not survive the process).
                ann = (pod.get("metadata", {}).get("annotations")
                       or {}).get(COMPLETE_AFTER_ANN)
                if ann is not None and key not in self._armed:
                    self._arm_completion(key, ann)
            return
        if not await self._allocate_devices(key, pod):
            return  # claim not ready yet; the claim update re-syncs us
        await self._mark_running(key, pod)

    def _ip_seq_of(self, pod: dict) -> int:
        """Inverse of _mark_running's podIP formula for OUR base prefix;
        0 for foreign/absent IPs."""
        ip = (pod.get("status") or {}).get("podIP") or ""
        parts = ip.split(".")
        if len(parts) != 4 or parts[0] != "10" \
                or parts[1] != str(self._ip_base):
            return 0
        try:
            hi, lo = int(parts[2]), int(parts[3])
        except ValueError:
            return 0
        return hi * 254 + (lo - 1)

    async def _allocate_devices(self, key: str, pod: dict) -> bool:
        """Kubelet-side DRA Allocate: record the scheduler's persisted
        per-claim device allocation in the local ledger."""
        ns = namespace_of(pod) or "default"
        for ref in (pod.get("spec") or {}).get("resourceClaims") or []:
            claim_name = ref.get("resourceClaimName")
            if not claim_name:
                continue
            try:
                claim = await self.store.get(
                    "resourceclaims", f"{ns}/{claim_name}")
            except NotFound:
                logger.warning("agent %s: pod %s references missing claim "
                               "%s", self.node_name, key, claim_name)
                return False
            alloc = (claim.get("status") or {}).get("allocation") or {}
            if alloc.get("nodeName") != self.node_name:
                # PreBind persists the allocation before binding, so this
                # is transient at worst; the pod re-syncs on claim update.
                return False
            devices = list(alloc.get("devices") or [])
            cname = ref.get("name") or claim_name
            try:
                self.ledger.allocate(key, cname, devices)
            except ValueError:
                # Device clash = OUR ledger is stale (a departed pod's
                # checkpoint entry survived): reconcile against the live
                # bound-pod set and retry once; a second clash is a real
                # double-allocation and the pod must stay Pending,
                # VISIBLY, until the conflicting claim resolves.
                try:
                    lst = await self.store.list(
                        "pods", fields={"spec.nodeName": self.node_name})
                except StoreError:
                    return False
                gone = self.ledger.reconcile(
                    {namespaced_name(p) for p in lst.items})
                try:
                    self.ledger.allocate(key, cname, devices)
                except ValueError:
                    logger.warning(
                        "agent %s: pod %s claim %s devices %s still "
                        "clash after reconcile (%d stale entries "
                        "dropped); leaving Pending until the claim "
                        "resolves", self.node_name, key, cname, devices,
                        len(gone))
                    return False
        return True

    async def _mark_running(self, key: str, pod: dict) -> None:
        from kubernetes_tpu_torch.utils.tracing import (
            DEFAULT_TRACER,
            traceparent_of,
        )
        if DEFAULT_TRACER.enabled:
            # The kubelet-side Running transition joins the pod's create
            # trace via the stamped traceparent — the last hop of the
            # create → schedule → bind → run journey.
            with DEFAULT_TRACER.span("agent.mark_running", pod=key,
                                     node=self.node_name,
                                     traceparent=traceparent_of(pod)):
                return await self._mark_running_inner(key, pod)
        return await self._mark_running_inner(key, pod)

    async def _mark_running_inner(self, key: str, pod: dict) -> None:
        complete_after = [None]

        def mutate(obj):
            if (obj.get("status") or {}).get("phase") != "Pending":
                return None
            self._ip_seq += 1
            hi, lo = divmod(self._ip_seq, 254)
            status = obj.setdefault("status", {})
            status["phase"] = "Running"
            status.setdefault(
                "podIP",
                f"10.{self._ip_base}.{hi % 256}.{lo + 1}")
            conds = status.setdefault("conditions", [])
            if not any(c.get("type") == "Ready" for c in conds):
                conds.append({"type": "Ready", "status": "True"})
            complete_after[0] = (obj["metadata"].get("annotations")
                                 or {}).get(COMPLETE_AFTER_ANN)
            return obj

        # Fast path: the watch just handed us the pod at its current RV,
        # so mutate a selective copy of THAT and CAS once on its RV — one
        # write instead of guaranteed_update's GET+PUT. After Bind nobody
        # else writes the pod, so the CAS nearly always lands; a Conflict
        # (racing controller, stale delivery) falls back to the full RMW
        # loop. Copies only the containers touched (binding_subresource's
        # selective-copy discipline — delivered objects are shared/frozen;
        # spec + tolerations are included because update-time admission
        # defaulting calls setdefault on them).
        spec = dict(pod.get("spec") or {})
        spec["tolerations"] = list(spec.get("tolerations") or [])
        fast = {**pod, "metadata": dict(pod["metadata"]), "spec": spec,
                "status": dict(pod.get("status") or {})}
        fast["status"]["conditions"] = [
            dict(c) for c in fast["status"].get("conditions") or []]
        try:
            if mutate(fast) is not None:
                await self.store.update("pods", fast, _owned=True,
                                        return_copy=False)
        except Conflict:
            complete_after[0] = None
            try:
                await self.store.guaranteed_update(
                    "pods", key, mutate, return_copy=False)
            except StoreError:
                return
        except StoreError:
            return
        if complete_after[0] is not None:
            self._arm_completion(key, complete_after[0])

    def _arm_completion(self, key: str, spec: str) -> None:
        try:
            delay = float(spec)
        except ValueError:
            return
        self._armed.add(key)
        t = asyncio.ensure_future(self._complete_later(key, delay))
        self._workers.add(t)
        t.add_done_callback(self._workers.discard)

    async def _complete_later(self, key: str, delay: float) -> None:
        try:
            await asyncio.sleep(delay)
        finally:
            self._armed.discard(key)

        def mutate(pod):
            if (pod.get("status") or {}).get("phase") != "Running":
                return None
            pod["status"]["phase"] = "Succeeded"
            return pod
        try:
            await self.store.guaranteed_update(
                "pods", key, mutate, return_copy=False)
        except StoreError:
            pass

    # -- heartbeats --------------------------------------------------------

    async def _lease_loop(self) -> None:
        """Heartbeats as exact-key latest-wins writes: the agent is its
        Lease's only writer, so after the first fetch seeds the local
        copy, each renewal is ONE blind update (no RV precondition, no
        read-modify-write GET) — at 1,000 agents this halves the ~200
        heartbeat ops/s riding the control plane. Any surprise (deleted
        lease, transport error) just drops the local copy and re-seeds."""
        key = f"kube-node-lease/{self.node_name}"
        lease: dict | None = None
        # Jittered first tick (client-go wait.Jitter on heartbeats): a
        # fleet cold start must not race its own boot — N first-lease
        # creates landing inside the registration/watch-establishment
        # window were ~half the boot-phase write load (the r12 50k-agent
        # headroom note). Deterministic per node name, so boots replay.
        import zlib
        await asyncio.sleep(
            min(self.lease_period, 2.0)
            * (zlib.crc32(self.node_name.encode()) % 1000) / 1000.0)
        while not self._stopped:
            try:
                if lease is None:
                    lease = await self._fetch_or_create_lease(key)
                if lease is not None:
                    self._renew(lease)
                    lease["metadata"].pop("resourceVersion", None)
                    lease = await self.store.update("leases", lease)
            except asyncio.CancelledError:
                raise
            except NotFound:
                lease = None  # deleted under us: re-seed next tick
            except Exception:
                logger.exception("agent %s: lease renew failed",
                                 self.node_name)
                lease = None
            await asyncio.sleep(self.lease_period)

    async def _fetch_or_create_lease(self, key: str) -> dict | None:
        try:
            return await self.store.get("leases", key)
        except NotFound:
            pass
        try:
            return await self.store.create(
                "leases", new_object("Lease", self.node_name,
                                     "kube-node-lease",
                                     spec={"renewTime": 0}))
        except AlreadyExists:
            return await self.store.get("leases", key)
        except StoreError:
            return None

    @staticmethod
    def _renew(lease: dict) -> dict:
        lease.setdefault("spec", {})
        lease["spec"]["renewTime"] = lease["spec"].get("renewTime", 0) + 1
        return lease
