"""DaemonSet controller: one pod per matching node.

Parity target: pkg/controller/daemon/daemon_controller.go
(`DaemonSetsController.syncDaemonSet` → `manage`/`podsShouldBeOnNode`):
for every node that should run the daemon, ensure exactly one owned pod;
surplus/mismatched pods are deleted. Post-1.12 semantics: the controller
does NOT set spec.nodeName — it pins each pod with a required NodeAffinity
`matchFields: metadata.name == <node>` and lets the default scheduler place
it (daemon_controller.go `util.ReplaceDaemonSetPodNodeNameNodeAffinity`),
plus tolerations for the unschedulable/not-ready taints.

Copy of `kubernetes_tpu/controllers/daemonset.py`. The status write goes
through `base.status_writer`: skipped when it would change nothing.
"""

from __future__ import annotations

import asyncio
import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, uid_of
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.controllers.replicaset import owner_ref, _controller_of
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)


def make_daemonset(name: str, selector: dict, template: dict,
                   namespace: str = "default") -> dict:
    return new_object("DaemonSet", name, namespace,
                      spec={"selector": selector, "template": template},
                      status={})


def node_name_affinity(node_name: str) -> dict:
    """util.ReplaceDaemonSetPodNodeNameNodeAffinity: pin via matchFields."""
    return {"nodeAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": {
            "nodeSelectorTerms": [{
                "matchFields": [{"key": "metadata.name", "operator": "In",
                                 "values": [node_name]}]}]}}}


#: daemon_controller.go AddOrUpdateDaemonPodTolerations.
DAEMON_TOLERATIONS = [
    {"key": "node.kubernetes.io/not-ready", "operator": "Exists",
     "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unreachable", "operator": "Exists",
     "effect": "NoExecute"},
    {"key": "node.kubernetes.io/unschedulable", "operator": "Exists",
     "effect": "NoSchedule"},
]


class DaemonSetController(Controller):
    NAME = "daemonset"
    WORKERS = 2
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.ds_informer = factory.informer("daemonsets")
        self.pod_informer = factory.informer("pods")
        self.node_informer = factory.informer("nodes")
        self.watch_resource(factory, "daemonsets")

        self.watch_owned_pods(factory, "DaemonSet")

        # Node churn re-syncs every DaemonSet (daemon_controller.go
        # addNode/updateNode enqueue all).
        def all_ds(_obj=None, _new=None):
            for ds in self.ds_informer.indexer.list():
                asyncio.ensure_future(self.queue.add(namespaced_name(ds)))

        self.node_informer.add_event_handler(ResourceEventHandler(
            on_add=all_ds, on_update=lambda o, n: all_ds(),
            on_delete=lambda o: all_ds()))

    async def resync_keys(self):
        return [namespaced_name(ds) for ds in self.ds_informer.indexer.list()]

    def _should_run(self, ds: dict, node: dict) -> bool:
        """podsShouldBeOnNode simulation subset: template nodeSelector must
        match; NoSchedule taints must be tolerated by template+daemon
        tolerations (NoExecute handled by the eviction path, as upstream)."""
        tmpl_spec = (ds["spec"].get("template") or {}).get("spec") or {}
        node_labels = node["metadata"].get("labels") or {}
        for k, v in (tmpl_spec.get("nodeSelector") or {}).items():
            if node_labels.get(k) != v:
                return False
        tolerations = list(tmpl_spec.get("tolerations") or []) + \
            DAEMON_TOLERATIONS
        for taint in (node.get("spec") or {}).get("taints") or []:
            if taint.get("effect") != "NoSchedule":
                continue
            if not any(_tolerates(t, taint) for t in tolerations):
                return False
        return True

    def _owned_pods(self, ds: dict) -> dict[str, list[dict]]:
        """node name → owned pods on it (nominal or bound)."""
        ns = ds["metadata"].get("namespace", "default")
        ds_uid = uid_of(ds)
        by_node: dict[str, list[dict]] = {}
        for pod in self.pod_informer.indexer.list():
            if pod["metadata"].get("namespace", "default") != ns:
                continue
            ref = _controller_of(pod)
            if ref is None or ref.get("kind") != "DaemonSet" \
                    or ref.get("name") != ds["metadata"]["name"]:
                continue
            if ref.get("uid") and ds_uid and ref["uid"] != ds_uid:
                continue
            node = pod["spec"].get("nodeName") or _pinned_node(pod) or ""
            by_node.setdefault(node, []).append(pod)
        return by_node

    async def sync(self, key: str) -> None:
        ds = self.ds_informer.indexer.get(key)
        if ds is None:
            return
        ns = ds["metadata"].get("namespace", "default")
        nodes = {n["metadata"]["name"]: n
                 for n in self.node_informer.indexer.list()}
        by_node = self._owned_pods(ds)
        desired = {name for name, n in nodes.items()
                   if self._should_run(ds, n)}

        for node_name in desired:
            pods = by_node.get(node_name, [])
            if not pods:
                await self._create_pod(ds, ns, node_name)
            elif len(pods) > 1:
                # Keep the oldest, delete duplicates (manage() dedupe).
                pods.sort(key=lambda p: p["metadata"]
                          .get("creationTimestamp", ""))
                for p in pods[1:]:
                    try:
                        await self.store.delete("pods", namespaced_name(p))
                    except NotFound:
                        pass
        for node_name, pods in by_node.items():
            if node_name not in desired:
                for p in pods:
                    try:
                        await self.store.delete("pods", namespaced_name(p))
                    except NotFound:
                        pass

        def set_status(obj):
            st = obj.setdefault("status", {})
            st["desiredNumberScheduled"] = len(desired)
            st["currentNumberScheduled"] = sum(
                1 for n, ps in by_node.items() if n in desired and ps)
            st["numberReady"] = sum(
                1 for n, ps in by_node.items() if n in desired
                for p in ps if (p.get("status") or {}).get("phase") == "Running")
            st["numberMisscheduled"] = sum(
                len(ps) for n, ps in by_node.items() if n not in desired)
            st["observedGeneration"] = obj["metadata"].get("generation", 0)
            return obj
        try:
            await self.store.guaranteed_update("daemonsets", key,
                                              status_writer(set_status))
        except NotFound:
            pass

    async def _create_pod(self, ds: dict, ns: str, node_name: str) -> None:
        template = (ds["spec"].get("template") or {})
        labels = dict((template.get("metadata") or {}).get("labels")
                      or (ds["spec"].get("selector") or {})
                      .get("matchLabels") or {})
        spec = dict(template.get("spec") or {})
        spec["affinity"] = node_name_affinity(node_name)
        spec["tolerations"] = list(spec.get("tolerations") or []) + \
            DAEMON_TOLERATIONS
        if not spec.get("containers"):
            spec["containers"] = [{"name": "main", "image": "daemon"}]
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": f"{ds['metadata']['name']}-{node_name}",
                "namespace": ns, "labels": labels,
                "ownerReferences": [owner_ref(ds)],
            },
            "spec": spec,
            "status": {"phase": "Pending"},
        }
        try:
            await self.store.create("pods", pod)
        except StoreError as e:
            logger.warning("ds %s: create pod for %s failed: %s",
                           ds["metadata"]["name"], node_name, e)


def _pinned_node(pod: dict) -> str | None:
    """Inverse of node_name_affinity: which node is this pod pinned to?"""
    na = ((pod["spec"].get("affinity") or {}).get("nodeAffinity") or {})
    req = na.get("requiredDuringSchedulingIgnoredDuringExecution") or {}
    for term in req.get("nodeSelectorTerms") or []:
        for f in term.get("matchFields") or []:
            if f.get("key") == "metadata.name" and f.get("operator") == "In":
                vals = f.get("values") or []
                if len(vals) == 1:
                    return vals[0]
    return None


def _tolerates(tol: dict, taint: dict) -> bool:
    if tol.get("effect") and tol["effect"] != taint.get("effect"):
        return False
    if tol.get("operator", "Equal") == "Exists":
        return not tol.get("key") or tol["key"] == taint.get("key")
    return tol.get("key") == taint.get("key") and \
        tol.get("value", "") == taint.get("value", "")
