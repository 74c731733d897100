"""Deployment controller: Deployment → ReplicaSets (rolling update).

Parity target: pkg/controller/deployment/ (deployment_controller.go
`syncDeployment`, sync.go `getAllReplicaSetsAndSyncRevision`, rolling.go
`rolloutRolling`): one "new" RS per pod-template hash; rolling update scales
the new RS up and old RSes down within maxSurge/maxUnavailable bounds;
Recreate strategy scales old to 0 first.

Copy of `kubernetes_tpu/controllers/deployment.py`. The status write
goes through `base.status_writer`: skipped when it would change nothing.
"""

from __future__ import annotations

import hashlib
import json
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, uid_of
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.controllers.replicaset import owner_ref
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)


def make_deployment(name: str, replicas: int, selector: dict,
                    pod_template: dict, namespace: str = "default",
                    strategy: dict | None = None) -> dict:
    return new_object(
        "Deployment", name, namespace,
        spec={"replicas": replicas, "selector": selector,
              "template": pod_template,
              "strategy": strategy or {"type": "RollingUpdate",
                                       "rollingUpdate": {"maxSurge": 1,
                                                         "maxUnavailable": 0}}},
        status={})


def pod_template_hash(template: dict) -> str:
    """Deterministic hash of the pod template (util/hash ComputeHash)."""
    js = json.dumps(template, sort_keys=True)
    return hashlib.sha1(js.encode()).hexdigest()[:10]


def _resolve_bound(value, total: int) -> int:
    """maxSurge/maxUnavailable: int or percentage string."""
    if isinstance(value, str) and value.endswith("%"):
        import math
        return math.ceil(total * int(value[:-1]) / 100)
    return int(value or 0)


class DeploymentController(Controller):
    NAME = "deployment"
    WORKERS = 2
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.dep_informer = factory.informer("deployments")
        self.rs_informer = factory.informer("replicasets")
        self.watch_resource(factory, "deployments")

        import asyncio

        def rs_to_dep(obj):
            for ref in obj.get("metadata", {}).get("ownerReferences") or []:
                if ref.get("kind") == "Deployment" and ref.get("controller"):
                    ns = obj["metadata"].get("namespace", "default")
                    asyncio.ensure_future(
                        self.queue.add(f"{ns}/{ref['name']}"))

        from kubernetes_tpu_torch.client import ResourceEventHandler
        self.rs_informer.add_event_handler(ResourceEventHandler(
            on_add=rs_to_dep, on_update=lambda o, n: rs_to_dep(n),
            on_delete=rs_to_dep))

    async def resync_keys(self):
        return [namespaced_name(d) for d in self.dep_informer.indexer.list()]

    def _owned_rs(self, dep: dict) -> list[dict]:
        dep_uid = uid_of(dep)
        out = []
        for rs in self.rs_informer.indexer.list():
            for ref in rs.get("metadata", {}).get("ownerReferences") or []:
                if ref.get("kind") == "Deployment" and (
                        not ref.get("uid") or not dep_uid
                        or ref["uid"] == dep_uid):
                    if ref.get("name") == dep["metadata"]["name"]:
                        out.append(rs)
        return out

    async def sync(self, key: str) -> None:
        dep = self.dep_informer.indexer.get(key)
        if dep is None:
            return
        spec = dep["spec"]
        replicas = int(spec.get("replicas", 0))
        template = spec.get("template") or {}
        thash = pod_template_hash(template)
        ns = dep["metadata"].get("namespace", "default")
        name = dep["metadata"]["name"]

        owned = self._owned_rs(dep)
        new_rs = next((rs for rs in owned
                       if rs["metadata"].get("labels", {})
                       .get("pod-template-hash") == thash), None)
        old_rses = [rs for rs in owned if rs is not new_rs]

        if new_rs is None:
            # Create the new-revision RS with the hash folded into the
            # selector + template labels (sync.go getNewReplicaSet).
            sel = {"matchLabels": {
                **(spec.get("selector") or {}).get("matchLabels", {}),
                "pod-template-hash": thash}}
            tmpl = json.loads(json.dumps(template))  # deep copy
            tmpl.setdefault("metadata", {}).setdefault("labels", {})
            tmpl["metadata"]["labels"].update(sel["matchLabels"])
            rs = new_object(
                "ReplicaSet", f"{name}-{thash}", ns,
                labels=dict(tmpl["metadata"]["labels"]),
                spec={"replicas": 0, "selector": sel, "template": tmpl},
                status={"replicas": 0})
            rs["metadata"]["ownerReferences"] = [owner_ref(dep)]
            try:
                new_rs = await self.store.create("replicasets", rs)
            except AlreadyExists:
                await self.queue.add(key)
                return

        strategy = (spec.get("strategy") or {})
        stype = strategy.get("type", "RollingUpdate")
        old_total = sum(int(r["spec"].get("replicas", 0)) for r in old_rses)
        new_want = int(new_rs["spec"].get("replicas", 0))

        if stype == "Recreate":
            if old_total > 0:
                for rs in old_rses:
                    await self._scale(rs, 0)
                return
            if new_want != replicas:
                await self._scale(new_rs, replicas)
        else:  # RollingUpdate
            ru = strategy.get("rollingUpdate") or {}
            max_surge = _resolve_bound(ru.get("maxSurge", 1), replicas)
            max_unavail = _resolve_bound(ru.get("maxUnavailable", 0), replicas)
            if max_surge == 0 and max_unavail == 0:
                max_unavail = 1  # both zero is invalid; reference defaults

            # Scale up new RS within the surge budget.
            total = new_want + old_total
            if new_want < replicas and total < replicas + max_surge:
                up = min(replicas - new_want, replicas + max_surge - total)
                await self._scale(new_rs, new_want + up)
                new_want += up

            # Scale down old RSes. Count only READY replicas as available
            # (rolling.go; spec.replicas would overstate it while old pods
            # are not ready and let scale-down exceed maxUnavailable). First
            # remove UNHEALTHY old replicas outside the availability budget
            # (cleanupUnhealthyReplicas) — they contribute nothing to
            # availability, and without this a permanently-unready old pod
            # deadlocks the rollout at maxSurge=0.
            new_ready = int(new_rs.get("status", {}).get("readyReplicas", 0))
            old_ready = sum(
                int(r.get("status", {}).get("readyReplicas", 0))
                for r in old_rses)
            min_available = replicas - max_unavail
            new_unavail = max(0, new_want - new_ready)
            max_cleanup = max(
                0, new_want + old_total - min_available - new_unavail)
            oldest_first = sorted(
                old_rses,
                key=lambda r: r["metadata"].get("creationTimestamp", ""))
            # Indexer objects are shared/frozen — track effective replica
            # counts locally rather than mutating them.
            eff = {namespaced_name(rs): int(rs["spec"].get("replicas", 0))
                   for rs in oldest_first}
            for rs in oldest_first:
                if max_cleanup <= 0:
                    break
                k = namespaced_name(rs)
                ready = int(rs.get("status", {}).get("readyReplicas", 0))
                drop = min(max(0, eff[k] - ready), max_cleanup)
                if drop > 0:
                    await self._scale(rs, eff[k] - drop)
                    eff[k] -= drop
                    max_cleanup -= drop

            available = new_ready + old_ready
            can_remove = max(0, available - min_available)
            for rs in oldest_first:
                if can_remove <= 0:
                    break
                k = namespaced_name(rs)
                drop = min(eff[k], can_remove)
                if drop > 0:
                    await self._scale(rs, eff[k] - drop)
                    eff[k] -= drop
                    can_remove -= drop
            if old_total > 0 or new_ready < replicas:
                await self.enqueue_after(key, 0.2)  # keep rolling

        def set_status(obj):
            obj.setdefault("status", {})
            obj["status"]["updatedReplicas"] = int(
                new_rs.get("status", {}).get("replicas", 0))
            obj["status"]["readyReplicas"] = sum(
                int(r.get("status", {}).get("readyReplicas", 0))
                for r in owned)
            obj["status"]["replicas"] = sum(
                int(r.get("status", {}).get("replicas", 0)) for r in owned)
            obj["status"]["observedGeneration"] = \
                obj["metadata"].get("generation", 0)
            return obj
        try:
            await self.store.guaranteed_update("deployments", key,
                                              status_writer(set_status))
        except NotFound:
            pass

    async def _scale(self, rs: dict, replicas: int) -> None:
        def mutate(obj):
            if int(obj["spec"].get("replicas", 0)) == replicas:
                return None
            obj["spec"]["replicas"] = replicas
            return obj
        try:
            await self.store.guaranteed_update(
                "replicasets", namespaced_name(rs), mutate)
        except StoreError as e:
            logger.warning("scale %s → %d failed: %s",
                           namespaced_name(rs), replicas, e)
