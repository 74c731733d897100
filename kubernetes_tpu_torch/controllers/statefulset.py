"""StatefulSet controller: ordered, stable-identity pods (+ per-pod PVCs).

Parity target: pkg/controller/statefulset/ (stateful_set.go,
stateful_set_control.go `UpdateStatefulSet`): pods named <set>-<ordinal>,
created strictly in ordinal order (OrderedReady waits for the previous
ordinal to be Running before creating the next; podManagementPolicy:
Parallel creates all at once), scaled down highest-ordinal-first, stable
`statefulset.kubernetes.io/pod-name` label, volumeClaimTemplates → one PVC
per (template × pod) that survives pod deletion.

Copy of `kubernetes_tpu/controllers/statefulset.py`. The status write
goes through `base.status_writer`: skipped when it would change nothing.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, uid_of
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.controllers.replicaset import owner_ref, _controller_of
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)


def make_statefulset(name: str, replicas: int, selector: dict, template: dict,
                     namespace: str = "default",
                     pod_management_policy: str = "OrderedReady",
                     volume_claim_templates: list | None = None) -> dict:
    spec = {"replicas": replicas, "selector": selector, "template": template,
            "podManagementPolicy": pod_management_policy,
            "serviceName": name}
    if volume_claim_templates:
        spec["volumeClaimTemplates"] = volume_claim_templates
    return new_object("StatefulSet", name, namespace, spec=spec, status={})


class StatefulSetController(Controller):
    NAME = "statefulset"
    WORKERS = 2
    RESYNC_PERIOD = 2.0

    def setup(self, factory: InformerFactory) -> None:
        self.sts_informer = factory.informer("statefulsets")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "statefulsets")

        self.watch_owned_pods(factory, "StatefulSet")

    async def resync_keys(self):
        return [namespaced_name(s) for s in self.sts_informer.indexer.list()]

    def _owned_pods(self, sts: dict) -> dict[int, dict]:
        """ordinal → pod."""
        ns = sts["metadata"].get("namespace", "default")
        base = sts["metadata"]["name"] + "-"
        suid = uid_of(sts)
        out: dict[int, dict] = {}
        for pod in self.pod_informer.indexer.list():
            if pod["metadata"].get("namespace", "default") != ns:
                continue
            ref = _controller_of(pod)
            if ref is None or ref.get("kind") != "StatefulSet" \
                    or ref.get("name") != sts["metadata"]["name"]:
                continue
            if ref.get("uid") and suid and ref["uid"] != suid:
                continue
            name = pod["metadata"]["name"]
            if not name.startswith(base):
                continue
            try:
                out[int(name[len(base):])] = pod
            except ValueError:
                continue
        return out

    @staticmethod
    def _running(pod: dict) -> bool:
        return (pod.get("status") or {}).get("phase") == "Running"

    async def sync(self, key: str) -> None:
        sts = self.sts_informer.indexer.get(key)
        if sts is None:
            return
        spec = sts.get("spec") or {}
        want = int(spec.get("replicas", 1))
        ordered = spec.get("podManagementPolicy", "OrderedReady") != "Parallel"
        ns = sts["metadata"].get("namespace", "default")
        pods = self._owned_pods(sts)

        # Scale up: create missing ordinals in order; OrderedReady stops at
        # the first ordinal whose predecessor isn't Running yet. Terminal
        # pods are deleted for recreation (stateful_set_control.go replaces
        # failed replicas) so an OrderedReady walk can't deadlock on one.
        for i in range(want):
            pod = pods.get(i)
            if pod is None:
                await self._create_pod(sts, ns, i)
                if ordered:
                    break  # wait for it to come up before the next ordinal
            elif (pod.get("status") or {}).get("phase") in ("Failed",
                                                            "Succeeded"):
                try:
                    await self.store.delete("pods", namespaced_name(pod))
                except NotFound:
                    pass
                if ordered:
                    break  # recreate on the next poke
            elif ordered and not self._running(pod):
                break  # predecessor must be Running before creating i+1

        # Scale down: delete highest ordinals first, one at a time when
        # ordered (stateful_set_control.go scale-down walk).
        excess = sorted((i for i in pods if i >= want), reverse=True)
        for i in excess if not ordered else excess[:1]:
            try:
                await self.store.delete("pods", namespaced_name(pods[i]))
            except NotFound:
                pass

        def set_status(obj):
            st = obj.setdefault("status", {})
            st["replicas"] = sum(1 for i in pods if i < want)
            st["readyReplicas"] = sum(
                1 for i, p in pods.items() if i < want and self._running(p))
            st["currentReplicas"] = st["replicas"]
            st["observedGeneration"] = obj["metadata"].get("generation", 0)
            return obj
        try:
            await self.store.guaranteed_update("statefulsets", key,
                                              status_writer(set_status))
        except NotFound:
            pass

    async def _create_pod(self, sts: dict, ns: str, ordinal: int) -> None:
        name = f"{sts['metadata']['name']}-{ordinal}"
        template = (sts["spec"].get("template") or {})
        labels = dict((template.get("metadata") or {}).get("labels")
                      or (sts["spec"].get("selector") or {})
                      .get("matchLabels") or {})
        labels["statefulset.kubernetes.io/pod-name"] = name
        spec = dict(template.get("spec") or {})
        if not spec.get("containers"):
            spec["containers"] = [{"name": "main", "image": "app"}]
        # volumeClaimTemplates → stable per-pod PVCs (<claim>-<pod>); they
        # are NOT owned by the pod — identity survives pod deletion.
        vcts = sts["spec"].get("volumeClaimTemplates") or []
        for vct in vcts:
            claim_name = f"{vct['metadata']['name']}-{name}"
            pvc = new_object(
                "PersistentVolumeClaim", claim_name, ns,
                spec=dict(vct.get("spec") or {}), status={"phase": "Pending"})
            pvc["metadata"]["labels"] = dict(labels)
            try:
                await self.store.create("persistentvolumeclaims", pvc)
            except AlreadyExists:
                pass  # stable identity: reuse the surviving claim
            except StoreError as e:
                logger.warning("sts %s: create PVC %s failed: %s",
                               key_str(sts), claim_name, e)
        if vcts:
            spec = dict(spec)
            spec["volumes"] = list(spec.get("volumes") or []) + [
                {"name": vct["metadata"]["name"],
                 "persistentVolumeClaim": {
                     "claimName": f"{vct['metadata']['name']}-{name}"}}
                for vct in vcts]
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": name, "namespace": ns, "labels": labels,
                         "ownerReferences": [owner_ref(sts)]},
            "spec": spec,
            "status": {"phase": "Pending"},
        }
        try:
            await self.store.create("pods", pod)
        except AlreadyExists:
            pass
        except StoreError as e:
            logger.warning("sts %s: create pod %s failed: %s",
                           key_str(sts), name, e)


def key_str(obj: dict) -> str:
    return namespaced_name(obj)
