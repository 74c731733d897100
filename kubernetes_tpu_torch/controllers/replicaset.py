"""ReplicaSet controller: RS → Pods.

Parity target: pkg/controller/replicaset/replica_set.go
(`ReplicaSetController.syncReplicaSet` → `manageReplicas`): list matching
pods via the RS selector, create/delete the difference, adopt via
ownerReferences, write status (replicas / readyReplicas).

Copy of `kubernetes_tpu/controllers/replicaset.py`. The status write
goes through `base.status_writer`: skipped when it would change nothing.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.labels import from_label_selector
from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, uid_of
from kubernetes_tpu_torch.api.types import pod_is_terminal
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)

#: Burst cap per sync (replica_set.go BurstReplicas=500; smaller here —
#: level-triggered resync covers the rest).
BURST_REPLICAS = 500


def make_replicaset(name: str, replicas: int, selector: dict,
                    pod_template: dict, namespace: str = "default",
                    owner: dict | None = None) -> dict:
    rs = new_object("ReplicaSet", name, namespace,
                    spec={"replicas": replicas, "selector": selector,
                          "template": pod_template},
                    status={"replicas": 0})
    if owner:
        rs["metadata"]["ownerReferences"] = [owner]
    return rs


def owner_ref(obj: dict, controller: bool = True) -> dict:
    return {
        "apiVersion": obj.get("apiVersion", "v1"),
        "kind": obj.get("kind", ""),
        "name": obj["metadata"]["name"],
        "uid": obj["metadata"].get("uid", ""),
        "controller": controller,
    }


def _controller_of(obj: dict) -> dict | None:
    for ref in obj.get("metadata", {}).get("ownerReferences") or []:
        if ref.get("controller"):
            return ref
    return None


class ReplicaSetController(Controller):
    NAME = "replicaset"
    WORKERS = 4
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.rs_informer = factory.informer("replicasets")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "replicasets")

        # Pod events map back to the owning RS key (replica_set.go addPod/
        # deletePod resolve the controllerRef).
        def pod_to_rs(obj):
            ref = _controller_of(obj)
            if ref and ref.get("kind") == "ReplicaSet":
                ns = obj["metadata"].get("namespace", "default")
                asyncio.ensure_future(self.queue.add(f"{ns}/{ref['name']}"))

        from kubernetes_tpu_torch.client import ResourceEventHandler
        self.pod_informer.add_event_handler(ResourceEventHandler(
            on_add=pod_to_rs, on_update=lambda o, n: pod_to_rs(n),
            on_delete=pod_to_rs))

    async def resync_keys(self):
        return [namespaced_name(rs) for rs in self.rs_informer.indexer.list()]

    def _matching_pods(self, rs: dict) -> list[dict]:
        sel = from_label_selector(rs["spec"].get("selector") or {})
        ns = rs["metadata"].get("namespace", "default")
        rs_uid = uid_of(rs)
        out = []
        for pod in self.pod_informer.indexer.list():
            if pod["metadata"].get("namespace", "default") != ns:
                continue
            if pod_is_terminal(pod) or pod["metadata"].get("deletionTimestamp"):
                continue
            ref = _controller_of(pod)
            if ref is not None:
                # Owned pods count iff owned by THIS RS (uid match).
                if ref.get("uid") and rs_uid and ref["uid"] != rs_uid:
                    continue
                if ref.get("kind") != "ReplicaSet" or \
                        ref.get("name") != rs["metadata"]["name"]:
                    continue
                out.append(pod)
            elif sel.matches(pod["metadata"].get("labels")):
                out.append(pod)  # orphan adoption candidate (counted)
        return out

    async def sync(self, key: str) -> None:
        rs = self.rs_informer.indexer.get(key)
        if rs is None:
            return  # deleted; pods are cleaned by GC/podgc
        want = int(rs["spec"].get("replicas", 0))
        pods = self._matching_pods(rs)
        have = len(pods)
        diff = want - have
        ns = rs["metadata"].get("namespace", "default")

        if diff > 0:
            template = rs["spec"].get("template") or {}
            base = rs["metadata"]["name"]
            for i in range(min(diff, BURST_REPLICAS)):
                pod = {
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {
                        "generateName": f"{base}-",
                        "name": f"{base}-{self._suffix()}",
                        "namespace": ns,
                        "labels": dict((template.get("metadata") or {})
                                       .get("labels")
                                       or (rs["spec"].get("selector") or {})
                                       .get("matchLabels") or {}),
                        "ownerReferences": [owner_ref(rs)],
                    },
                    "spec": dict((template.get("spec") or {})),
                    "status": {"phase": "Pending"},
                }
                if not pod["spec"].get("containers"):
                    pod["spec"]["containers"] = [
                        {"name": "main", "image": "app"}]
                try:
                    await self.store.create("pods", pod)
                except StoreError as e:
                    logger.warning("rs %s: create pod failed: %s", key, e)
                    break
        elif diff < 0:
            # Prefer deleting unscheduled, then newest (getPodsToDelete
            # ranks not-ready/pending first, then younger pods): newest-first
            # within each group, unscheduled group first.
            pods.sort(key=lambda p: p["metadata"].get("creationTimestamp", ""),
                      reverse=True)
            pods.sort(key=lambda p: bool(p["spec"].get("nodeName")))
            for pod in pods[: min(-diff, BURST_REPLICAS)]:
                try:
                    await self.store.delete("pods", namespaced_name(pod))
                except NotFound:
                    pass

        def set_status(obj):
            obj.setdefault("status", {})
            obj["status"]["replicas"] = have if diff <= 0 else want
            obj["status"]["readyReplicas"] = sum(
                1 for p in pods if p["spec"].get("nodeName"))
            obj["status"]["observedGeneration"] = \
                obj["metadata"].get("generation", 0)
            return obj
        try:
            await self.store.guaranteed_update("replicasets", key,
                                              status_writer(set_status))
        except NotFound:
            pass

    _seq = 0

    @classmethod
    def _suffix(cls) -> str:
        cls._seq += 1
        return f"{cls._seq:05d}"
