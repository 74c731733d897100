"""ResourceClaim controller (DRA lifecycle).

Parity target: `pkg/controller/resourceclaim/controller.go` (SURVEY §2.4
long tail). Responsibilities:

- For pods referencing a ResourceClaimTemplate, stamp out a per-pod
  ResourceClaim named `<pod>-<ref name>` with an ownerReference to the pod
  (the generated claim dies with the pod via the GC cascade, and is also
  deleted directly here for promptness).
- When a consumer pod terminates or disappears, remove it from every
  referenced claim's status.reservedFor.
- When reservedFor drains empty on a GENERATED claim, delete it; on a
  user-created claim, clear status.allocation (deallocate) so the devices
  return to the pool.

Copy of `kubernetes_tpu/controllers/resourceclaim.py`.
"""

from __future__ import annotations

import logging

from kubernetes_tpu_torch.api.meta import (
    name_of,
    namespace_of,
    namespaced_name,
    new_object,
)
from kubernetes_tpu_torch.api.types import pod_is_terminal
from kubernetes_tpu_torch.client import InformerFactory, ResourceEventHandler
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)

#: annotation marking a claim generated from a template for one pod.
GENERATED_FOR_ANN = "resource.kubernetes.io/pod-claim-name"


class ResourceClaimController(Controller):
    NAME = "resourceclaim"
    WORKERS = 2

    def __init__(self, store):
        super().__init__(store)
        #: recently deleted pod key -> uid, so release can match
        #: reservedFor entries by uid (a recreated same-name pod's
        #: reservation must survive the OLD pod's cleanup).
        self._deleted_uids: dict[str, str] = {}
        #: consumer index (pod key -> claim keys naming it in reservedFor)
        #: so release is O(pod's claims), not O(all claims).
        self._claims_by_consumer: dict[str, set[str]] = {}
        self._claim_consumers: dict[str, set[str]] = {}

    def setup(self, factory: InformerFactory) -> None:
        self.pod_informer = factory.informer("pods")
        self.claim_informer = factory.informer("resourceclaims")
        self.template_informer = factory.informer("resourceclaimtemplates")
        self.watch_resource(factory, "pods")

        def remember_uid(obj):
            uid = (obj.get("metadata") or {}).get("uid")
            if uid:
                self._deleted_uids[namespaced_name(obj)] = uid
                if len(self._deleted_uids) > 4096:
                    for k in list(self._deleted_uids)[:2048]:
                        self._deleted_uids.pop(k, None)

        factory.informer("pods").add_event_handler(ResourceEventHandler(
            on_delete=remember_uid))
        # Claim events re-sync their consumers (reservedFor names pods)
        # and maintain the consumer index.

        def claim_event(obj, gone=False):
            import asyncio
            key = namespaced_name(obj)
            ns = namespace_of(obj) or "default"
            new = set() if gone else {
                f"{ns}/{r['name']}"
                for r in (obj.get("status") or {}).get("reservedFor") or []
                if r.get("name")}
            old = self._claim_consumers.get(key, set())
            for pod_key in old - new:
                bucket = self._claims_by_consumer.get(pod_key)
                if bucket is not None:
                    bucket.discard(key)
                    if not bucket:
                        self._claims_by_consumer.pop(pod_key, None)
            for pod_key in new - old:
                self._claims_by_consumer.setdefault(
                    pod_key, set()).add(key)
            if new:
                self._claim_consumers[key] = new
            else:
                self._claim_consumers.pop(key, None)
            for pod_key in new:
                asyncio.ensure_future(self.queue.add(pod_key))

        def tmpl_arrived(obj):
            # Pods that referenced this template before it existed parked
            # with a warning; stamp their claims now (template creation is
            # rare, so the pod scan here is off the hot path).
            import asyncio
            ns = namespace_of(obj) or "default"
            tmpl_name = name_of(obj)
            for pod in self.pod_informer.indexer.list():
                if (namespace_of(pod) or "default") != ns:
                    continue
                for ref in (pod.get("spec") or {}) \
                        .get("resourceClaims") or []:
                    if ref.get("resourceClaimTemplateName") == tmpl_name:
                        asyncio.ensure_future(
                            self.queue.add(namespaced_name(pod)))
                        break

        factory.informer("resourceclaimtemplates").add_event_handler(
            ResourceEventHandler(on_add=tmpl_arrived))
        factory.informer("resourceclaims").add_event_handler(
            ResourceEventHandler(
                on_add=claim_event,
                on_update=lambda old, new: claim_event(new),
                on_delete=lambda obj: claim_event(obj, gone=True)))

    async def sync(self, key: str) -> None:
        pod = self.pod_informer.indexer.get(key)
        if pod is None or pod_is_terminal(pod):
            await self._release_consumer(key, pod)
            return
        await self._ensure_generated_claims(pod)

    # -- template → claim stamping ----------------------------------------

    async def _ensure_generated_claims(self, pod: dict) -> None:
        ns = namespace_of(pod) or "default"
        for ref in (pod.get("spec") or {}).get("resourceClaims") or []:
            tmpl_name = ref.get("resourceClaimTemplateName")
            if not tmpl_name:
                continue
            claim_name = f"{name_of(pod)}-{ref.get('name', '')}"
            if self.claim_informer.indexer.get(f"{ns}/{claim_name}"):
                continue
            tmpl = self.template_informer.indexer.get(f"{ns}/{tmpl_name}")
            if tmpl is None:
                try:
                    tmpl = await self.store.get(
                        "resourceclaimtemplates", f"{ns}/{tmpl_name}")
                except NotFound:
                    logger.warning(
                        "pod %s references missing template %s/%s",
                        name_of(pod), ns, tmpl_name)
                    continue
            claim = new_object("ResourceClaim", claim_name, ns,
                               api_version="resource.k8s.io/v1")
            claim["spec"] = dict(tmpl.get("spec") or {})
            claim["metadata"]["annotations"] = {
                GENERATED_FOR_ANN: ref.get("name", "")}
            claim["metadata"]["ownerReferences"] = [{
                "apiVersion": "v1", "kind": "Pod", "name": name_of(pod),
                "uid": pod.get("metadata", {}).get("uid", ""),
                "controller": True}]
            try:
                await self.store.create("resourceclaims", claim,
                                        return_copy=False)
            except StoreError as e:
                logger.debug("claim %s create raced: %s", claim_name, e)

    # -- consumer release --------------------------------------------------

    async def _release_consumer(self, pod_key: str, pod: dict | None) -> None:
        """Drop `pod` from reservedFor on every claim naming it; then
        delete drained generated claims / deallocate drained user claims."""
        ns, _, pod_name = pod_key.partition("/")
        # Match by uid when we know it: a recreated same-name pod's fresh
        # reservation must NOT be dropped by the old pod's cleanup.
        pod_uid = (pod or {}).get("metadata", {}).get("uid") \
            or self._deleted_uids.get(pod_key)

        def names_pod(r) -> bool:
            if r.get("name") != pod_name:
                return False
            entry_uid = r.get("uid")
            if pod_uid and entry_uid and entry_uid != pod_uid:
                return False  # some OTHER incarnation's reservation
            return True

        claim_keys = sorted(self._claims_by_consumer.get(pod_key, ()))
        for ck in claim_keys:
            claim = self.claim_informer.indexer.get(ck)
            if claim is None:
                continue
            reserved = (claim.get("status") or {}).get("reservedFor") or []
            if not any(names_pod(r) for r in reserved):
                continue
            key = namespaced_name(claim)
            generated = GENERATED_FOR_ANN in (
                claim.get("metadata", {}).get("annotations") or {})
            owner_uids = {r.get("uid")
                          for r in claim.get("metadata", {})
                          .get("ownerReferences") or []}

            def drop(obj):
                status = obj.setdefault("status", {})
                before = status.get("reservedFor") or []
                after = [r for r in before if not names_pod(r)]
                if len(after) == len(before):
                    return None
                status["reservedFor"] = after
                if not after and not generated:
                    # Deallocate: devices return to the pool (the
                    # reference's deallocation for delayed-release claims).
                    status.pop("allocation", None)
                return obj

            try:
                await self.store.guaranteed_update(
                    "resourceclaims", key, drop, return_copy=False)
                if generated and (pod is None or pod_is_terminal(pod)) \
                        and (not pod_uid or not owner_uids
                             or pod_uid in owner_uids):
                    # Generated claims die with their pod (ownerRef GC
                    # would too; direct delete keeps the pool prompt).
                    # A claim owned by a NEWER same-name incarnation is
                    # left alone — its owner is alive.
                    await self.store.delete("resourceclaims", key)
            except NotFound:
                pass
            except StoreError:
                logger.exception("releasing claim %s failed", key)
                await self.enqueue_after(pod_key, 0.5)
