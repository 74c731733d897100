"""Controller long tail (SURVEY §2.4 bottom rows): EndpointSlice,
ResourceQuota, Disruption (PDB + eviction API), TTL-after-finished, HPA.

Parity targets:
- pkg/controller/endpointslice/ — Service selector → EndpointSlice objects
  (ready = pod Running + Ready condition; address = status.podIP).
- pkg/controller/resourcequota/ + plugin/pkg/admission/resourcequota —
  usage accounting in status.used, enforcement at pod admission.
- pkg/controller/disruption/ + pkg/registry/core/pod/storage `EvictionREST`
  — PDB accounting (currentHealthy / disruptionsAllowed) and the
  pods/eviction subresource that refuses voluntary evictions when the
  budget is exhausted (429 in the reference; Conflict here).
- pkg/controller/ttlafterfinished/ — delete finished Jobs after their
  `ttlSecondsAfterFinished`.
- pkg/controller/podautoscaler/horizontal.go — HPA. Divergence: there is
  no metrics-server in this simulator; the metric source is the pods'
  `ktpu.dev/load` annotation (average utilization per pod, percent),
  which tests/KWOK set. The scaling rule is the reference's
  desired = ceil(current × avgLoad / target).

Copy of `kubernetes_tpu/controllers/longtail.py`. The ResourceQuota and
PDB status writes go through `base.status_writer`: skipped when it would
change nothing.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time

from kubernetes_tpu_torch.api.meta import (
    name_of,
    namespaced_name,
    new_object,
    uid_of,
)
from kubernetes_tpu_torch.api.resource import parse_quantity
from kubernetes_tpu_torch.api.types import pod_is_terminal, pod_requests
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.store.mvcc import Conflict, StoreError

logger = logging.getLogger(__name__)


def make_service(name: str, selector: dict, namespace: str = "default",
                 port: int = 80) -> dict:
    return new_object("Service", name, namespace, spec={
        "selector": dict(selector),
        "ports": [{"port": port, "protocol": "TCP"}]})


def make_pdb(name: str, selector: dict, *, min_available: int | None = None,
             max_unavailable: int | None = None,
             namespace: str = "default") -> dict:
    spec: dict = {"selector": dict(selector)}
    if min_available is not None:
        spec["minAvailable"] = min_available
    if max_unavailable is not None:
        spec["maxUnavailable"] = max_unavailable
    return new_object("PodDisruptionBudget", name, namespace, spec=spec)


def make_resource_quota(name: str, hard: dict,
                        namespace: str = "default") -> dict:
    return new_object("ResourceQuota", name, namespace,
                      spec={"hard": dict(hard)})


def make_hpa(name: str, target_ref: str, *, min_replicas: int = 1,
             max_replicas: int = 10, target_utilization: int = 80,
             namespace: str = "default") -> dict:
    """targetRef: "deployments/<name>"."""
    return new_object(
        "HorizontalPodAutoscaler", name, namespace,
        api_version="autoscaling/v2",
        spec={"scaleTargetRef": target_ref,
              "minReplicas": min_replicas, "maxReplicas": max_replicas,
              "targetUtilizationPercent": target_utilization})


def _pod_ready(pod: dict) -> bool:
    if pod.get("status", {}).get("phase") != "Running":
        return False
    return any(c.get("type") == "Ready" and c.get("status") == "True"
               for c in pod.get("status", {}).get("conditions") or [])


def _selector_matches(selector: dict, labels: dict) -> bool:
    from kubernetes_tpu_torch.api.labels import from_label_selector
    sel = selector if ("matchLabels" in selector
                       or "matchExpressions" in selector) \
        else {"matchLabels": selector}
    return from_label_selector(sel).matches(labels or {})


class EndpointSliceController(Controller):
    """Service → one EndpointSlice (named after the service)."""

    NAME = "endpointslice"
    WORKERS = 2
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.svc_informer = factory.informer("services")
        self.pod_informer = factory.informer("pods")
        self.eps_informer = factory.informer("endpointslices")
        self.watch_resource(factory, "services")

        def pod_changed(obj):
            ns = obj.get("metadata", {}).get("namespace", "default")
            for svc in self.svc_informer.indexer.list():
                if svc.get("metadata", {}).get("namespace") != ns:
                    continue
                if _selector_matches(svc.get("spec", {}).get("selector")
                                     or {}, obj.get("metadata", {})
                                     .get("labels")):
                    asyncio.ensure_future(
                        self.queue.add(namespaced_name(svc)))

        def pod_updated(old, new):
            # Both label sets: a relabel can REMOVE the pod from a
            # service's selector (the reference processes old and new).
            pod_changed(old)
            pod_changed(new)

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=pod_changed,
            on_update=pod_updated,
            on_delete=pod_changed))

    async def resync_keys(self):
        return [namespaced_name(s) for s in self.svc_informer.indexer.list()]

    async def sync(self, key: str) -> None:
        svc = self.svc_informer.indexer.get(key)
        if svc is None:
            # Service deleted → its slice goes too.
            try:
                await self.store.delete("endpointslices", key)
            except StoreError:
                pass
            return
        ns = svc["metadata"].get("namespace", "default")
        selector = svc.get("spec", {}).get("selector") or {}
        endpoints = []
        for pod in self.pod_informer.indexer.list():
            if pod.get("metadata", {}).get("namespace") != ns:
                continue
            if pod_is_terminal(pod):
                continue
            if not _selector_matches(selector,
                                     pod.get("metadata", {}).get("labels")):
                continue
            ip = pod.get("status", {}).get("podIP")
            if not ip:
                continue
            endpoints.append({
                "addresses": [ip],
                "conditions": {"ready": _pod_ready(pod)},
                "targetRef": {"kind": "Pod",
                              "name": pod["metadata"]["name"],
                              "uid": uid_of(pod)},
                "nodeName": pod.get("spec", {}).get("nodeName"),
            })
        endpoints.sort(key=lambda e: e["addresses"][0])

        def mutate(eps):
            eps["endpoints"] = endpoints
            eps["ports"] = svc.get("spec", {}).get("ports") or []
            return eps
        try:
            await self.store.guaranteed_update(
                "endpointslices", key, mutate, return_copy=False)
        except StoreError:
            eps = new_object("EndpointSlice", name_of(svc), ns)
            eps["addressType"] = "IPv4"
            eps["endpoints"] = endpoints
            eps["ports"] = svc.get("spec", {}).get("ports") or []
            eps["metadata"]["ownerReferences"] = [{
                "kind": "Service", "name": name_of(svc),
                "uid": uid_of(svc), "controller": True}]
            try:
                await self.store.create("endpointslices", eps)
            except StoreError:
                pass


#: resource names ResourceQuota tracks (requests.* aliases fold onto bare).
_QUOTA_KEYS = ("pods", "cpu", "memory", "requests.cpu", "requests.memory")


def _quota_usage(pods: list[dict], namespace: str) -> dict[str, int]:
    used = {"pods": 0, "cpu": 0, "memory": 0}
    for p in pods:
        if p.get("metadata", {}).get("namespace") != namespace:
            continue
        if pod_is_terminal(p):
            continue
        used["pods"] += 1
        reqs = pod_requests(p)
        used["cpu"] += reqs.get("cpu", 0)
        used["memory"] += reqs.get("memory", 0)
    return used


class ResourceQuotaController(Controller):
    """Recompute status.used for every quota (the admission check reads
    live tables; this controller is the user-facing accounting)."""

    NAME = "resourcequota"
    WORKERS = 1
    RESYNC_PERIOD = 2.0

    def setup(self, factory: InformerFactory) -> None:
        self.rq_informer = factory.informer("resourcequotas")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "resourcequotas")

        def pod_changed(obj):
            ns = obj.get("metadata", {}).get("namespace", "default")
            for rq in self.rq_informer.indexer.list():
                if rq.get("metadata", {}).get("namespace") == ns:
                    asyncio.ensure_future(
                        self.queue.add(namespaced_name(rq)))

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=pod_changed,
            on_update=lambda old, new: pod_changed(new),
            on_delete=pod_changed))

    async def resync_keys(self):
        return [namespaced_name(r) for r in self.rq_informer.indexer.list()]

    async def sync(self, key: str) -> None:
        rq = self.rq_informer.indexer.get(key)
        if rq is None:
            return
        ns = rq["metadata"].get("namespace", "default")
        used = _quota_usage(self.pod_informer.indexer.list(), ns)

        def mutate(obj):
            hard = obj.get("spec", {}).get("hard") or {}
            st = obj.setdefault("status", {})
            st["hard"] = dict(hard)
            from kubernetes_tpu_torch.api.resource import format_quantity
            shown = {}
            for k in hard:
                base = k.split(".")[-1]
                if base == "pods":
                    shown[k] = str(used["pods"])
                elif base in ("cpu", "memory"):
                    shown[k] = format_quantity(used[base])
            st["used"] = shown
            return obj
        try:
            await self.store.guaranteed_update(
                "resourcequotas", key, status_writer(mutate),
                return_copy=False)
        except StoreError:
            pass


def install_quota_admission(store) -> None:
    """Admission enforcement (plugin/pkg/admission/resourcequota): a pod
    create that would exceed any quota in its namespace is rejected."""

    def check(pod: dict) -> None:
        ns = pod.get("metadata", {}).get("namespace", "default")
        quotas = [q for q in store._table("resourcequotas").values()
                  if q.get("metadata", {}).get("namespace") == ns]
        if not quotas:
            return
        reqs = pod_requests(pod)
        key = f"{ns}/{pod.get('metadata', {}).get('name', '')}"
        old = store._table("pods").get(key)
        delta_pods = 1
        old_cpu = old_mem = 0
        if old is not None and not pod_is_terminal(old):
            delta_pods = 0
            old_reqs = pod_requests(old)
            old_cpu = old_reqs.get("cpu", 0)
            old_mem = old_reqs.get("memory", 0)
        d_cpu = reqs.get("cpu", 0) - old_cpu
        d_mem = reqs.get("memory", 0) - old_mem
        # Quota only gates usage-INCREASING writes (the reference):
        # bindings, status flips and request-lowering updates pass without
        # even scanning the table — an over-quota namespace must not wedge
        # pod lifecycle, and this is the store's hottest write path.
        if delta_pods <= 0 and d_cpu <= 0 and d_mem <= 0:
            return
        used = _quota_usage(list(store._table("pods").values()), ns)
        want = {"pods": used["pods"] + delta_pods,
                "cpu": used["cpu"] + d_cpu,
                "memory": used["memory"] + d_mem}
        from kubernetes_tpu_torch.store.mvcc import Invalid
        for q in quotas:
            for k, limit in (q.get("spec", {}).get("hard") or {}).items():
                base = k.split(".")[-1]
                if base not in want:
                    continue
                lim = int(limit) if base == "pods" else parse_quantity(limit)
                if want[base] > lim:
                    raise Invalid(
                        f"exceeded quota {name_of(q)!r}: requested "
                        f"{base} would exceed hard limit {limit}")

    # Both operations: this store's update() is a full replace with no
    # spec-immutability validation, so PUT could otherwise raise requests
    # past the quota.
    store.register_mutator("pods", check, on=("create", "update"))


class DisruptionController(Controller):
    """PDB status accounting + the eviction gate."""

    NAME = "disruption"
    WORKERS = 1
    RESYNC_PERIOD = 2.0

    def setup(self, factory: InformerFactory) -> None:
        self.pdb_informer = factory.informer("poddisruptionbudgets")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "poddisruptionbudgets")

        def pod_changed(obj):
            ns = obj.get("metadata", {}).get("namespace", "default")
            for pdb in self.pdb_informer.indexer.list():
                if pdb.get("metadata", {}).get("namespace") != ns:
                    continue
                asyncio.ensure_future(self.queue.add(namespaced_name(pdb)))

        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=pod_changed,
            on_update=lambda old, new: pod_changed(new),
            on_delete=pod_changed))

    async def resync_keys(self):
        return [namespaced_name(p)
                for p in self.pdb_informer.indexer.list()]

    async def sync(self, key: str) -> None:
        pdb = self.pdb_informer.indexer.get(key)
        if pdb is None:
            return
        ns = pdb["metadata"].get("namespace", "default")
        selector = pdb.get("spec", {}).get("selector") or {}
        matching = [p for p in self.pod_informer.indexer.list()
                    if p.get("metadata", {}).get("namespace") == ns
                    and not pod_is_terminal(p)
                    and _selector_matches(
                        selector, p.get("metadata", {}).get("labels"))]
        healthy = sum(1 for p in matching if _pod_ready(p))
        allowed = _disruptions_allowed(pdb, len(matching), healthy)

        def mutate(obj):
            obj.setdefault("status", {}).update({
                "expectedPods": len(matching),
                "currentHealthy": healthy,
                "disruptionsAllowed": allowed,
            })
            return obj
        try:
            await self.store.guaranteed_update(
                "poddisruptionbudgets", key, status_writer(mutate),
                return_copy=False)
        except StoreError:
            pass


def _disruptions_allowed(pdb: dict, expected: int, healthy: int) -> int:
    spec = pdb.get("spec", {})
    if "minAvailable" in spec:
        return max(0, healthy - int(spec["minAvailable"]))
    if "maxUnavailable" in spec:
        unavailable = expected - healthy
        return max(0, int(spec["maxUnavailable"]) - unavailable)
    return max(0, healthy - expected)  # no constraint → allow none missing


def install_eviction_subresource(store) -> None:
    """POST pods/<key>/eviction (EvictionREST): voluntary eviction that a
    PDB with zero disruptionsAllowed refuses with Conflict (429/
    TooManyRequests in the reference's wire form). Also installs the
    reference's PDB validation (exactly one of minAvailable /
    maxUnavailable) — a field-less PDB would block every eviction."""
    from kubernetes_tpu_torch.store.mvcc import Invalid

    def validate_pdb(pdb: dict) -> None:
        spec = pdb.get("spec") or {}
        if ("minAvailable" in spec) == ("maxUnavailable" in spec):
            raise Invalid(
                "PodDisruptionBudget: exactly one of minAvailable or "
                "maxUnavailable must be set")

    store.register_validator("poddisruptionbudgets", validate_pdb)

    async def evict(store_, key: str, body) -> dict:
        pod = await store_.get("pods", key)
        ns = pod.get("metadata", {}).get("namespace", "default")
        labels = pod.get("metadata", {}).get("labels") or {}
        for pdb in store_._table("poddisruptionbudgets").values():
            if pdb.get("metadata", {}).get("namespace") != ns:
                continue
            sel = pdb.get("spec", {}).get("selector") or {}
            if not _selector_matches(sel, labels):
                continue
            # Recount LIVE (the controller's status lags events; the
            # reference's EvictionREST consumes the budget synchronously).
            matching = [
                q for q in store_._table("pods").values()
                if q.get("metadata", {}).get("namespace") == ns
                and not pod_is_terminal(q)
                and _selector_matches(
                    sel, q.get("metadata", {}).get("labels"))]
            healthy = sum(1 for q in matching if _pod_ready(q))
            if _disruptions_allowed(pdb, len(matching), healthy) <= 0:
                raise Conflict(
                    f"Cannot evict pod as it would violate the pod's "
                    f"disruption budget {name_of(pdb)!r}")
        await store_.delete("pods", key)
        return {"kind": "Status", "apiVersion": "v1", "status": "Success"}

    store.register_subresource("pods", "eviction", evict)


class TTLAfterFinishedController(Controller):
    """Delete finished Jobs `ttlSecondsAfterFinished` after completion."""

    NAME = "ttl-after-finished"
    WORKERS = 1
    RESYNC_PERIOD = 1.0

    def setup(self, factory: InformerFactory) -> None:
        self.job_informer = factory.informer("jobs")
        self.watch_resource(factory, "jobs")

    async def resync_keys(self):
        return [namespaced_name(j) for j in self.job_informer.indexer.list()
                if j.get("spec", {}).get("ttlSecondsAfterFinished")
                is not None]

    async def sync(self, key: str) -> None:
        job = self.job_informer.indexer.get(key)
        if job is None:
            return
        ttl = job.get("spec", {}).get("ttlSecondsAfterFinished")
        if ttl is None:
            return
        conds = (job.get("status") or {}).get("conditions") or []
        done = [c for c in conds
                if c.get("type") in ("Complete", "Failed")
                and c.get("status") == "True"]
        if not done:
            return
        raw = done[0].get("lastTransitionTime")
        finished_at = None
        if isinstance(raw, (int, float)):
            finished_at = float(raw)
        elif isinstance(raw, str):
            import datetime
            try:
                finished_at = datetime.datetime.fromisoformat(
                    raw.replace("Z", "+00:00")).timestamp()
            except ValueError:
                pass
        if finished_at is None:
            return  # nil completion time → never TTL-delete (reference)
        if time.time() - finished_at < float(ttl):
            return  # not due yet; the 1s resync re-enqueues it
        try:
            await self.store.delete("jobs", key, uid=uid_of(job))
            logger.info("ttl-after-finished: deleted job %s", key)
        except StoreError:
            pass


class HorizontalPodAutoscalerController(Controller):
    """HPA over the `ktpu.dev/load` annotation as the metric source (no
    metrics-server in the simulator — see module docstring)."""

    NAME = "horizontal-pod-autoscaler"
    WORKERS = 1
    RESYNC_PERIOD = 1.0

    def setup(self, factory: InformerFactory) -> None:
        self.hpa_informer = factory.informer("horizontalpodautoscalers")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "horizontalpodautoscalers")

    async def resync_keys(self):
        return [namespaced_name(h)
                for h in self.hpa_informer.indexer.list()]

    async def sync(self, key: str) -> None:
        hpa = self.hpa_informer.indexer.get(key)
        if hpa is None:
            return
        spec = hpa.get("spec", {})
        target_res, _, target_name = spec.get(
            "scaleTargetRef", "").partition("/")
        if not target_name:
            return
        ns = hpa["metadata"].get("namespace", "default")
        try:
            target = await self.store.get(target_res, f"{ns}/{target_name}")
        except StoreError:
            return
        sel = (target.get("spec", {}).get("selector") or {})
        pods = [p for p in self.pod_informer.indexer.list()
                if p.get("metadata", {}).get("namespace") == ns
                and not pod_is_terminal(p)
                and _selector_matches(
                    sel, p.get("metadata", {}).get("labels"))]
        if not pods:
            return
        loads = [float((p.get("metadata", {}).get("annotations") or {})
                       .get("ktpu.dev/load", 0)) for p in pods]
        avg = sum(loads) / len(loads)
        current = int(target.get("spec", {}).get("replicas", len(pods)))
        tgt = float(spec.get("targetUtilizationPercent", 80))
        desired = max(int(spec.get("minReplicas", 1)),
                      min(int(spec.get("maxReplicas", 10)),
                          math.ceil(current * avg / tgt) if avg else
                          int(spec.get("minReplicas", 1))))
        if desired == current:
            return

        def scale(obj):
            obj.setdefault("spec", {})["replicas"] = desired
            return obj
        try:
            await self.store.guaranteed_update(
                target_res, f"{ns}/{target_name}", scale, return_copy=False)
            logger.info("hpa %s: scaled %s/%s %d → %d (avg load %.0f%%)",
                        key, target_res, target_name, current, desired, avg)
        except StoreError:
            pass
