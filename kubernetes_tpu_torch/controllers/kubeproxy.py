"""kube-proxy analog: the Service VIP → endpoints dataplane programmer.

Parity target: pkg/proxy (SURVEY §2.6) — `servicechangetracker.go` /
`endpointschangetracker.go` accumulate deltas from the Service and
EndpointSlice watches, and `iptables/proxier.go syncProxyRules` compiles
the WHOLE dataplane atomically on a min-sync-period cadence. There is no
kernel here, so the "dataplane" is an in-memory rules table with the same
compile-everything-atomically semantics, plus a `lookup()` that does what
the kernel's DNAT would: pick a ready endpoint for a (clusterIP, port)
round-robin. ClusterIPs are allocated at Service admission
(`install_service_ip_allocator` — the apiserver's RangeRegistry analog).

Copy of `kubernetes_tpu/controllers/kubeproxy.py`.
"""

from __future__ import annotations

import asyncio
import logging
import time

from kubernetes_tpu_torch.api.meta import name_of, namespaced_name
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller

logger = logging.getLogger(__name__)

SERVICE_CIDR_PREFIX = "10.96"


def install_service_ip_allocator(store) -> None:
    """Allocate spec.clusterIP at Service create (the apiserver's service
    IP RangeRegistry). Sequential over 10.96.0.0/16; explicit clusterIP
    (including "None" for headless Services) is respected."""
    seq = [0]

    def allocate(svc: dict) -> None:
        spec = svc.setdefault("spec", {})
        if spec.get("clusterIP"):
            return
        in_use = {(s.get("spec") or {}).get("clusterIP")
                  for s in store._table("services").values()}
        for _ in range(254 * 256):
            seq[0] += 1
            hi, lo = divmod(seq[0], 254)
            ip = f"{SERVICE_CIDR_PREFIX}.{hi % 256}.{lo + 1}"
            # Skip explicitly-claimed VIPs (the RangeRegistry behavior —
            # two Services must never share a clusterIP).
            if ip not in in_use:
                spec["clusterIP"] = ip
                return
        from kubernetes_tpu_torch.store.mvcc import Invalid
        raise Invalid("service IP range exhausted")

    store.register_mutator("services", allocate, on=("create",))


class KubeProxyController(Controller):
    """One simulated proxier (a node's dataplane view).

    Watches Services + EndpointSlices; every change marks the table dirty
    and ONE sync compiles the full rules snapshot — `syncProxyRules` is
    a full-table rewrite, never an incremental patch — throttled by
    `min_sync_period` exactly like the reference's async runner.
    """

    NAME = "kube-proxy"
    WORKERS = 1
    RESYNC_PERIOD = 5.0

    #: the single queue key: the dataplane syncs as a whole.
    _KEY = "__sync__"

    def __init__(self, store, min_sync_period: float = 0.05):
        super().__init__(store)
        self.min_sync_period = min_sync_period
        #: compiled dataplane: (clusterIP, port) → list of "ip:port" ready
        #: backends. Replaced atomically by _compile.
        self.rules: dict[tuple[str, int], list[str]] = {}
        self.sync_count = 0
        self._last_sync = 0.0
        self._rr: dict[tuple[str, int], int] = {}

    def setup(self, factory: InformerFactory) -> None:
        self.svc_informer = factory.informer("services")
        self.eps_informer = factory.informer("endpointslices")

        def dirty(*_a):
            asyncio.ensure_future(self.queue.add(self._KEY))

        for inf in (self.svc_informer, self.eps_informer):
            inf.add_event_handler(ResourceEventHandler(
                on_add=dirty, on_update=lambda o, n: dirty(),
                on_delete=dirty))

    async def resync_keys(self):
        return [self._KEY]

    async def sync(self, key: str) -> None:
        # min-sync-period batching: coalesce bursts into one rewrite.
        now = time.monotonic()
        wait = self.min_sync_period - (now - self._last_sync)
        if wait > 0:
            await asyncio.sleep(wait)
        self._last_sync = time.monotonic()
        self._compile()

    def _compile(self) -> None:
        """The syncProxyRules analog: full atomic rewrite from the caches."""
        slices = {namespaced_name(e): e
                  for e in self.eps_informer.indexer.list()}
        rules: dict[tuple[str, int], list[str]] = {}
        for svc in self.svc_informer.indexer.list():
            try:
                self._compile_service(svc, slices, rules)
            except Exception:
                # One malformed Service must not brick the whole table —
                # syncProxyRules is a full rewrite, so a raised error here
                # would freeze dataplane programming for EVERY service.
                logger.exception("kube-proxy: skipping service %s",
                                 namespaced_name(svc))
        self.rules = rules
        # Prune round-robin state for rules that no longer exist, or
        # service churn grows it without bound.
        self._rr = {k: v for k, v in self._rr.items() if k in rules}
        self.sync_count += 1

    @staticmethod
    def _compile_service(svc: dict, slices: dict,
                         rules: dict[tuple[str, int], list[str]]) -> None:
        vip = (svc.get("spec") or {}).get("clusterIP")
        if not vip or vip == "None":
            return  # headless
        eps = slices.get(namespaced_name(svc))
        for port_spec in (svc.get("spec") or {}).get("ports") or []:
            port = int(port_spec.get("port", 0))
            raw_target = port_spec.get("targetPort", port)
            try:
                target = int(raw_target)
            except (TypeError, ValueError):
                # Named targetPort: the reference resolves it via the
                # endpoint's port list; our slices carry the service
                # ports verbatim, so fall back to the service port.
                target = port
            backends: list[str] = []
            for ep in (eps or {}).get("endpoints") or []:
                if not (ep.get("conditions") or {}).get("ready"):
                    continue
                for addr in ep.get("addresses") or []:
                    backends.append(f"{addr}:{target}")
            rules[(vip, port)] = sorted(backends)

    def lookup(self, cluster_ip: str, port: int) -> str | None:
        """What the kernel DNAT would do: round-robin over ready backends
        (iptables statistic mode / IPVS rr)."""
        backends = self.rules.get((cluster_ip, port))
        if not backends:
            return None
        k = (cluster_ip, port)
        i = self._rr.get(k, 0)
        self._rr[k] = (i + 1) % len(backends)
        return backends[i % len(backends)]
