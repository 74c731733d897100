"""DynamicResources: DRA (dynamic resource allocation) scheduling.

Parity target: `pkg/scheduler/framework/plugins/dynamicresources/` over the
resource.k8s.io structured-parameters model (SURVEY §2.3 plugin table,
§2.5 devicemanager). The modern device path: pods reference ResourceClaims;
DRA drivers publish per-node device inventories as ResourceSlices;
DeviceClasses select devices by attribute; the SCHEDULER performs the
allocation (structured parameters) and persists it to claim.status at
PreBind.

Extension points (reference order):
- PreEnqueue: pods whose claims don't exist yet are gated out of the
  active queue (the resourceclaim controller stamps template claims).
- PreFilter: resolve the pod's claim refs → per-claim device requests;
  a claim already allocated to node X restricts candidates to X.
- Filter: every claim must be satisfiable from the node's FREE devices —
  slice inventory minus devices demanded by claims of pods already on the
  node (counted per claim, so shared claims aren't double-charged) —
  honoring matchAttribute constraints (all devices of a claim agree on
  the attribute: single-NUMA alignment the DRA way).
- Reserve/Unreserve: pick concrete devices deterministically and hold
  them in the in-memory assume ledger (mirrors the claim assume cache).
- PreBind: guaranteed-update claim.status with the allocation + the pod
  in reservedFor (the durable record a kubelet/driver would consume).

Deallocation: the resourceclaim controller (controllers/resourceclaim.py)
drops reservedFor entries when consumer pods terminate and deletes
generated claims; freeing is then visible through the claims informer.

The batched backend answers Filter for all nodes at once from a dense
per-(class, attribute-group) free-count array on the host (ops/backend.py
`_dra_state` / `_dra_filter_row`), with in-batch drift handled by the
stateful re-verify — same shape as NodeResourceTopologyMatch.

Copy of `kubernetes_tpu/scheduler/plugins/dynamicresources.py`.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.scheduler.framework import CycleState, Plugin, Status
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot
from kubernetes_tpu_torch.store.mvcc import StoreError

logger = logging.getLogger(__name__)

_STATE_KEY = "DynamicResources/claims"


def pod_claim_keys(pi: PodInfo) -> list[str]:
    """Store keys of the pod's referenced claims (template refs resolve to
    the generated claim's deterministic name `<pod>-<ref name>`)."""
    keys = []
    for ref in pi.resource_claims:
        name = ref.get("resourceClaimName")
        if not name and ref.get("resourceClaimTemplateName"):
            name = f"{pi.name}-{ref.get('name', '')}"
        if name:
            keys.append(f"{pi.namespace}/{name}")
    return keys


def claim_requests(claim: dict) -> list[dict]:
    return ((claim.get("spec") or {}).get("devices") or {}) \
        .get("requests") or []


def claim_match_attrs(claim: dict) -> list[str]:
    return [c["matchAttribute"]
            for c in (((claim.get("spec") or {}).get("devices") or {})
                      .get("constraints") or [])
            if c.get("matchAttribute")]


def claim_allocated_node(claim: dict) -> str | None:
    alloc = (claim.get("status") or {}).get("allocation")
    if alloc:
        return alloc.get("nodeName") or None
    return None


class _ClaimState:
    """PreFilter output carried through the cycle."""

    __slots__ = ("claims", "pinned_node")

    def __init__(self, claims: list[dict], pinned_node: str | None):
        self.claims = claims            # resolved claim objects
        self.pinned_node = pinned_node  # pre-allocated claims pin the node


class DynamicResources(Plugin):
    NAME = "DynamicResources"
    EXTENSION_POINTS = ("PreEnqueue", "PreFilter", "Filter", "Reserve",
                        "PreBind")
    #: Claim/slice churn must requeue gated + unschedulable pods
    #: (EventsToRegister parity).
    EVENTS = ["Pod/Delete", "ResourceClaim/Add", "ResourceClaim/Update",
              "ResourceClaim/Delete", "ResourceSlice/Add",
              "ResourceSlice/Update", "DeviceClass/Add"]

    def __init__(self, args=None):
        super().__init__(args)
        self.store = None
        self._claim_informer = None
        self._slice_informer = None
        self._class_informer = None
        #: claim key -> device names chosen at Reserve, not yet persisted.
        self._assumed: dict[str, dict] = {}
        #: bumped on every assume-ledger mutation: the backend's tensor
        #: cache keys on it (len() alone misses pop+add churn at equal
        #: size, which would serve stale free counts).
        self.assume_seq = 0
        #: bumped on slice/class churn — backend tensor invalidation.
        self.dra_seq = 0
        #: incremental indexes fed by informer events: scanning the whole
        #: claim/slice tables per Filter/Reserve call is O(N·C) at scale.
        #: node name -> {claim key -> claim} for ALLOCATED claims.
        self._alloc_by_node: dict[str, dict[str, dict]] = {}
        #: claim key -> allocated node (for removal on update/delete).
        self._claim_node: dict[str, str] = {}
        #: node name -> device list from that node's slices.
        self._slices_by_node: dict[str, list[dict]] = {}
        #: slice key -> node name it last contributed to.
        self._slice_node: dict[str, str] = {}

    def set_informers(self, factory) -> None:
        self._claim_informer = factory.informer("resourceclaims")
        self._slice_informer = factory.informer("resourceslices")
        self._class_informer = factory.informer("deviceclasses")

        def bump(*_a):
            self.dra_seq += 1

        def index_claim(obj):
            key = namespaced_name(obj)
            prev = self._claim_node.pop(key, None)
            if prev is not None:
                bucket = self._alloc_by_node.get(prev)
                if bucket is not None:
                    bucket.pop(key, None)
            node = claim_allocated_node(obj)
            if node is not None:
                self._alloc_by_node.setdefault(node, {})[key] = obj
                self._claim_node[key] = node

        def claim_settled(obj):
            # The informer now reflects this claim's allocation (or its
            # deletion): the in-memory assume is no longer needed. Keyed
            # dedupe in free_devices() makes the overlap window safe.
            bump()
            index_claim(obj)
            if claim_allocated_node(obj) is not None:
                if self._assumed.pop(namespaced_name(obj), None) is not None:
                    self.assume_seq += 1

        def claim_gone(obj):
            bump()
            key = namespaced_name(obj)
            prev = self._claim_node.pop(key, None)
            if prev is not None:
                bucket = self._alloc_by_node.get(prev)
                if bucket is not None:
                    bucket.pop(key, None)
            if self._assumed.pop(key, None) is not None:
                self.assume_seq += 1

        def index_slice(obj):
            bump()
            key = namespaced_name(obj)
            prev = self._slice_node.pop(key, None)
            spec = obj.get("spec") or {}
            node = spec.get("nodeName")
            for stale in {prev, node} - {None}:
                self._slices_by_node.pop(stale, None)  # lazy rebuild
            if node:
                self._slice_node[key] = node

        def slice_gone(obj):
            bump()
            key = namespaced_name(obj)
            prev = self._slice_node.pop(key, None)
            if prev is not None:
                self._slices_by_node.pop(prev, None)

        from kubernetes_tpu_torch.client import ResourceEventHandler
        self._slice_informer.add_event_handler(ResourceEventHandler(
            on_add=index_slice,
            on_update=lambda old, new: index_slice(new),
            on_delete=slice_gone))
        self._class_informer.add_event_handler(ResourceEventHandler(
            on_add=bump, on_update=lambda old, new: bump(),
            on_delete=bump))
        self._claim_informer.add_event_handler(ResourceEventHandler(
            on_add=claim_settled,
            on_update=lambda old, new: claim_settled(new),
            on_delete=claim_gone))

    def set_scheduler(self, sched) -> None:
        self.store = sched.store

    # -- inventory ---------------------------------------------------------

    def active_for(self, pi: PodInfo) -> bool:
        return bool(pi.resource_claims)

    def _classes(self) -> dict[str, dict]:
        if self._class_informer is None:
            return {}
        return {c["metadata"]["name"]: c
                for c in self._class_informer.indexer.list()}

    def _class_matches(self, cls: dict, device: dict) -> bool:
        sel = (cls.get("spec") or {}).get("selectors") or {}
        attrs = device.get("attributes") or {}
        return all(attrs.get(k) == v for k, v in sel.items())

    def _rebuild_slice_index(self) -> None:
        by_node: dict[str, list[dict]] = {}
        for rs in self._slice_informer.indexer.list():
            spec = rs.get("spec") or {}
            node = spec.get("nodeName")
            if not node:
                continue
            driver = spec.get("driver", "")
            lst = by_node.setdefault(node, [])
            for d in spec.get("devices") or []:
                lst.append({**d, "driver": driver})
        self._slices_by_node = by_node

    def node_devices(self, node_name: str) -> list[dict]:
        """All devices the slices publish for a node (indexed; slice
        churn invalidates, a miss rebuilds the whole index once)."""
        if self._slice_informer is None:
            return []
        cached = self._slices_by_node.get(node_name)
        if cached is None:
            self._rebuild_slice_index()
            cached = self._slices_by_node.get(node_name)
            if cached is None:
                cached = self._slices_by_node[node_name] = []
        return cached

    def _claims_of_residents(self, node: NodeInfo) -> list[dict]:
        """Claims demanded by pods resident on the node — each claim
        counted ONCE even when shared by several resident pods."""
        if self._claim_informer is None:
            return []
        seen: dict[str, dict] = {}
        for pi in node.pods:
            for key in pod_claim_keys(pi):
                if key in seen:
                    continue
                claim = self._claim_informer.indexer.get(key)
                if claim is not None:
                    seen[key] = claim
        return list(seen.values())

    def free_devices(self, node: NodeInfo,
                     extra_claims: list[dict] = ()) -> list[dict]:
        """Node inventory minus consumed devices, charged from three
        ledgers (deduped by claim key):
        (a) every claim whose status.allocation names this node — the
            authoritative record, independent of pod residency;
        (b) UNALLOCATED claims of resident pods — in-batch placements the
            backend's verify path sees before Reserve/PreBind ran;
        (c) `extra_claims` — in-flight reservations of sibling cycles."""
        devices = self.node_devices(node.name)
        if not devices:
            return devices
        classes = self._classes()
        claims: list[dict] = []
        seen: set[str] = set()

        def add(claim: dict) -> None:
            key = namespaced_name(claim)
            if key not in seen:
                seen.add(key)
                claims.append(claim)

        for claim in (self._alloc_by_node.get(node.name) or {}).values():
            add(claim)
        for claim in self._claims_of_residents(node):
            add(claim)
        for claim in extra_claims:
            add(claim)

        taken: set[str] = set()
        for claim in claims:
            alloc = (claim.get("status") or {}).get("allocation")
            if alloc:
                if alloc.get("nodeName") == node.name:
                    taken.update(alloc.get("devices") or [])
                continue  # allocated elsewhere: charges the other node
            # Unallocated resident demand: charge greedily, mirroring the
            # deterministic pick order in _pick_devices.
            picked = self._pick_devices(
                claim, [d for d in devices if d["name"] not in taken],
                classes)
            if picked is not None:
                taken.update(picked)
        return [d for d in devices if d["name"] not in taken]

    def _pick_devices(self, claim: dict, free: list[dict],
                      classes: dict[str, dict]) -> list[str] | None:
        """Deterministically choose devices satisfying the claim from
        `free`, or None if unsatisfiable. Devices are considered in
        sorted-name order. matchAttribute constraints apply to the WHOLE
        claim (reference MatchAttribute semantics): every chosen device —
        across all of the claim's requests — must agree on the attribute,
        so candidate groups are tried claim-wide (smallest fitting group
        first, then lexicographic — stable across host and backend)."""
        pool = sorted(free, key=lambda d: d.get("name", ""))
        attrs = claim_match_attrs(claim)
        reqs = claim_requests(claim)
        if not attrs:
            return self._pick_from(reqs, pool, classes)
        groups: dict[tuple, list[dict]] = {}
        for d in pool:
            gkey = tuple(str((d.get("attributes") or {}).get(a))
                         for a in attrs)
            groups.setdefault(gkey, []).append(d)
        for _size, _gkey, members in sorted(
                (len(m), gkey, m) for gkey, m in groups.items()):
            picked = self._pick_from(reqs, members, classes)
            if picked is not None:
                return picked
        return None

    def _pick_from(self, reqs: list[dict], pool: list[dict],
                   classes: dict[str, dict]) -> list[str] | None:
        chosen: list[str] = []
        for req in reqs:
            cls = classes.get(req.get("deviceClassName", ""))
            if cls is None:
                return None
            count = int(req.get("count", 1))
            matching = [d for d in pool if d["name"] not in chosen
                        and self._class_matches(cls, d)]
            if len(matching) < count:
                return None
            chosen.extend(d["name"] for d in matching[:count])
        return chosen

    # -- PreEnqueue --------------------------------------------------------

    def pre_enqueue(self, pod: PodInfo) -> Status:
        if not pod.resource_claims or self._claim_informer is None:
            return Status.success()
        for key in pod_claim_keys(pod):
            if self._claim_informer.indexer.get(key) is None:
                return Status.unschedulable(
                    f"waiting for resource claim {key}")
        return Status.success()

    # -- PreFilter ---------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: PodInfo,
                   snapshot: Snapshot) -> Status:
        if not self.active_for(pod):
            return Status.skip()
        if self._claim_informer is None:
            return Status.error("DynamicResources informers not wired")
        claims = []
        pinned = None
        for key in pod_claim_keys(pod):
            claim = self._claim_informer.indexer.get(key)
            if claim is None:
                return Status.unschedulable(
                    f"resource claim {key} not found")
            node = claim_allocated_node(claim)
            if node is not None:
                if pinned is not None and pinned != node:
                    # Two claims hold devices on different nodes: no node
                    # can satisfy both — unresolvable until one
                    # deallocates, NOT a retry loop.
                    return Status.unschedulable(
                        "claims allocated on different nodes")
                pinned = node
            claims.append(claim)
        state.write(_STATE_KEY, _ClaimState(claims, pinned))
        return Status.success()

    # -- Filter ------------------------------------------------------------

    def _claim_state(self, state: CycleState,
                     pod: PodInfo) -> "_ClaimState | None":
        """Cycle state from PreFilter, or resolved on demand — the batched
        backend path reaches Reserve/PreBind with a fresh CycleState (the
        solve replaced the host Filter phase)."""
        cs = state.read(_STATE_KEY)
        if cs is not None or not self.active_for(pod) \
                or self._claim_informer is None:
            return cs
        claims = []
        for key in pod_claim_keys(pod):
            claim = self._claim_informer.indexer.get(key)
            if claim is None:
                return None
            claims.append(claim)
        cs = _ClaimState(claims, None)
        state.write(_STATE_KEY, cs)
        return cs

    def filter(self, state: CycleState, pod: PodInfo,
               node: NodeInfo) -> Status:
        cs: _ClaimState | None = state.read(_STATE_KEY)
        if cs is None:
            return Status.success()
        if cs.pinned_node is not None and node.name != cs.pinned_node:
            return Status.unschedulable(
                "resource claim is allocated on another node")
        classes = self._classes()
        free = self.free_devices(node)
        for claim in cs.claims:
            alloc = (claim.get("status") or {}).get("allocation")
            if alloc and alloc.get("nodeName") == node.name:
                continue  # already holds devices here
            picked = self._pick_devices(claim, free, classes)
            if picked is None:
                return Status.unschedulable(
                    "cannot allocate devices for resource claim")
            names = set(picked)
            free = [d for d in free if d["name"] not in names]
        return Status.success()

    # -- Reserve / Unreserve ----------------------------------------------

    def reserve(self, state: CycleState, pod: PodInfo,
                node_name: str) -> Status:
        cs = self._claim_state(state, pod)
        if cs is None:
            if self.active_for(pod):
                return Status.unschedulable(
                    "resource claims vanished before Reserve")
            return Status.success()
        classes = self._classes()
        # Recompute against live state; in-flight assumes of OTHER pods
        # are in self._assumed and must be excluded from the free pool.
        node = None
        added: list[str] = []
        for claim in cs.claims:
            key = namespaced_name(claim)
            alloc = (claim.get("status") or {}).get("allocation")
            if alloc and alloc.get("nodeName") == node_name:
                continue
            if node is None:
                node = _NodeShim(node_name, self)
            free = [d for d in self.free_devices(
                        node, extra_claims=[
                            a["claim"] for a in self._assumed.values()
                            if a["node"] == node_name])]
            picked = self._pick_devices(claim, free, classes)
            if picked is None:
                # Roll back THIS pod's earlier assumes from this call:
                # run_reserve only unreserves plugins that succeeded, so
                # a leak here would phantom-consume devices forever.
                for k in added:
                    self._assumed.pop(k, None)
                if added:
                    self.assume_seq += 1
                return Status.unschedulable(
                    f"devices for claim {key} were taken during the cycle")
            self._assumed[key] = {
                "node": node_name, "devices": picked, "pod": pod.name,
                "claim": _synthetic_allocated(claim, node_name, picked)}
            added.append(key)
        if added:
            self.assume_seq += 1
        return Status.success()

    def unreserve(self, state: CycleState, pod: PodInfo,
                  node_name: str) -> None:
        cs: _ClaimState | None = state.read(_STATE_KEY)
        if cs is None:
            return
        for claim in cs.claims:
            a = self._assumed.get(namespaced_name(claim))
            if a is not None and a.get("pod") == pod.name:
                self._assumed.pop(namespaced_name(claim), None)
                self.assume_seq += 1

    # -- PreBind: persist allocation + reservedFor -------------------------

    async def pre_bind(self, state: CycleState, pod: PodInfo,
                       node_name: str) -> Status:
        cs = self._claim_state(state, pod)
        if cs is None or self.store is None:
            if self.active_for(pod) and self.store is not None:
                return Status.error(
                    "resource claims vanished before PreBind")
            return Status.success()
        for claim in cs.claims:
            key = namespaced_name(claim)
            assumed = self._assumed.get(key)

            def persist(obj):
                status = obj.setdefault("status", {})
                alloc = status.get("allocation")
                if alloc is None:
                    if assumed is None or assumed.get("pod") != pod.name:
                        # Filter said this claim needs devices here but
                        # Reserve recorded nothing — cycle bug; abort.
                        raise StoreError(
                            f"no assumed allocation for claim {key}")
                    status["allocation"] = {
                        "nodeName": node_name,
                        "devices": list(assumed["devices"])}
                elif alloc.get("nodeName") != node_name:
                    raise StoreError(
                        f"claim {key} got allocated on "
                        f"{alloc.get('nodeName')!r} during binding")
                reserved = status.setdefault("reservedFor", [])
                if not any(r.get("name") == pod.name for r in reserved):
                    reserved.append({"resource": "pods", "name": pod.name,
                                     "uid": pod.uid})
                return obj

            try:
                await self.store.guaranteed_update(
                    "resourceclaims", key, persist, return_copy=False)
            except StoreError as e:
                a = self._assumed.get(key)
                if a is not None and a.get("pod") == pod.name:
                    self._assumed.pop(key, None)
                    self.assume_seq += 1
                return Status.error(f"persisting claim {key}: {e}")
            # Success: the assume stays until the claims informer confirms
            # the allocation (claim_settled) — popping now would open a
            # window where neither ledger charges the devices.
        return Status.success()


class _NodeShim:
    """free_devices() only needs .name and .pods; Reserve runs after the
    cache assumed the pod, so resident demand comes from the informer-fed
    claim objects plus the assume ledger — an empty pod list here."""

    __slots__ = ("name", "pods")

    def __init__(self, name: str, _plugin):
        self.name = name
        self.pods = []


def _synthetic_allocated(claim: dict, node_name: str,
                         devices: list[str]) -> dict:
    """A minimal claim-shaped dict whose allocation charges the assumed
    devices in free_devices() without mutating the informer's object."""
    return {"metadata": dict(claim.get("metadata") or {}),
            "spec": claim.get("spec") or {},
            "status": {"allocation": {"nodeName": node_name,
                                      "devices": list(devices)}}}
