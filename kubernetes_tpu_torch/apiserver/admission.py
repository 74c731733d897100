"""Admission webhooks + CustomResourceDefinition support.

Parity targets:
- `pkg/admission/plugin/webhook/{mutating,validating}` + §3.2's handler
  chain: mutating webhooks run first (may patch the object), then
  validating webhooks (allow/deny) — both as HTTPS JSON out-calls carrying
  an AdmissionReview. Configurations are MutatingWebhookConfiguration /
  ValidatingWebhookConfiguration objects in the store; `failurePolicy:
  Ignore|Fail` governs unreachable webhooks. Patches use RFC-6902 JSON
  Patch (add/replace/remove), like the reference.
- `staging/src/k8s.io/apiextensions-apiserver`: CustomResourceDefinition
  objects register a new served resource — on this schemaless store that
  means wiring a structural-schema validator (openAPIV3Schema subset:
  type/properties/required/enum/items) and the kind→resource mapping so
  `ktpuctl apply` and the GC understand the new kind.

Copy of `kubernetes_tpu/apiserver/admission.py`.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

from kubernetes_tpu_torch.api.meta import name_of
from kubernetes_tpu_torch.store.mvcc import Invalid, StoreError

logger = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# RFC-6902 JSON Patch (add / replace / remove)
# ---------------------------------------------------------------------------

def _resolve(obj: Any, pointer: str) -> tuple[Any, str]:
    """Parent container + final token for a JSON pointer."""
    parts = [p.replace("~1", "/").replace("~0", "~")
             for p in pointer.lstrip("/").split("/")]
    cur = obj
    for p in parts[:-1]:
        cur = cur[int(p)] if isinstance(cur, list) else cur[p]
    return cur, parts[-1]


def apply_json_patch(obj: dict, patch: list[Mapping]) -> dict:
    for op in patch:
        kind = op.get("op")
        parent, tok = _resolve(obj, op.get("path", ""))
        if kind in ("add", "replace"):
            if isinstance(parent, list):
                idx = len(parent) if tok == "-" else int(tok)
                if kind == "add":
                    parent.insert(idx, op.get("value"))
                else:
                    parent[idx] = op.get("value")
            else:
                parent[tok] = op.get("value")
        elif kind == "remove":
            if isinstance(parent, list):
                parent.pop(int(tok))
            else:
                parent.pop(tok, None)
        else:
            raise Invalid(f"unsupported JSON patch op {kind!r}")
    return obj


# ---------------------------------------------------------------------------
# webhook dispatch
# ---------------------------------------------------------------------------

def _rules_match(webhook: Mapping, resource: str, operation: str) -> bool:
    op = operation.upper()  # rules carry CREATE/UPDATE/DELETE, wire-style
    for rule in webhook.get("rules") or []:
        resources = rule.get("resources") or []
        operations = [str(o).upper() for o in rule.get("operations") or ["*"]]
        if ("*" in resources or resource in resources) and \
                ("*" in operations or op in operations):
            return True
    return False


class WebhookAdmission:
    """Runs the admission chain for one (object, op, resource): mutating
    webhooks → ValidatingAdmissionPolicy expressions (policy/vap.py,
    when a PolicyEngine is attached) → validating webhooks — the
    reference plugin order (VAP sorts before ValidatingAdmissionWebhook
    in pkg/kubeapiserver/options/plugins.go)."""

    def __init__(self, store, timeout: float = 5.0, policy_engine=None):
        self.store = store
        self.timeout = timeout
        #: policy/vap.PolicyEngine or None = no expression policies.
        self.policy_engine = policy_engine
        self._session = None

    async def _post(self, url: str, review: dict) -> dict:
        import aiohttp
        if self._session is None:
            # Synchronous check+construct+assign (no await between them):
            # atomic under a single event loop, so concurrent admits can't
            # double-create the session.
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout))
        async with self._session.post(url, json=review) as resp:
            resp.raise_for_status()
            return await resp.json()

    async def close(self) -> None:
        if self._session is not None:
            await self._session.close()
            self._session = None

    def _configs(self, table: str) -> list[dict]:
        return list(self.store._table(table).values())

    async def admit(self, obj: dict, resource: str, operation: str, *,
                    user: str | None = None,
                    groups: list[str] | None = None) -> dict:
        """Mutating chain (patches applied in order), then the
        ValidatingAdmissionPolicy stage, then the validating chain.
        Raises Invalid on deny; failurePolicy Fail treats an unreachable
        webhook as deny, Ignore (default here) skips it. `user`/`groups`
        feed the policy expressions' `request.userInfo`."""
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        if DEFAULT_TRACER.enabled:
            # Admission is the chain stage between the request span and
            # the store op — its own span so a slow webhook out-call or
            # policy evaluation is visible in the attempt tree.
            with DEFAULT_TRACER.span("admission.admit", resource=resource,
                                     op=operation):
                return await self._admit_chain(
                    obj, resource, operation, user=user, groups=groups)
        return await self._admit_chain(obj, resource, operation,
                                       user=user, groups=groups)

    async def _admit_chain(self, obj: dict, resource: str, operation: str,
                           *, user: str | None = None,
                           groups: list[str] | None = None) -> dict:
        for cfg in self._configs("mutatingwebhookconfigurations"):
            for wh in cfg.get("webhooks") or []:
                if not _rules_match(wh, resource, operation):
                    continue
                resp = await self._call(wh, obj, resource, operation)
                if resp is None:
                    continue
                if not resp.get("allowed", False):
                    raise Invalid(self._deny_msg(wh, resp))
                patch = resp.get("patch")
                if patch:
                    try:
                        obj = apply_json_patch(obj, patch)
                    except (Invalid, KeyError, ValueError, IndexError,
                            TypeError) as e:
                        # A bad patch is a webhook failure, subject to its
                        # failurePolicy (the reference behavior) — not a
                        # raw 500.
                        if wh.get("failurePolicy", "Ignore") == "Fail":
                            raise Invalid(
                                f'admission webhook '
                                f'"{wh.get("name", "?")}" returned an '
                                f"invalid patch: {e}") from e
                        logger.warning(
                            "ignoring invalid patch from webhook %s: %s",
                            wh.get("name"), e)
        if self.policy_engine is not None:
            if operation == "delete":
                # DELETE: the reference evaluates expressions with
                # `object=null` and the stored object as oldObject —
                # both wires hand the current object in as `obj` here.
                self.policy_engine.validate(
                    None, resource, operation, old_object=obj,
                    user=user, groups=groups)
            else:
                # Expression policies see the POST-mutation object; the
                # stored current object rides as oldObject on updates
                # (the reference passes the existing object from
                # storage).
                old = None
                if operation == "update":
                    from kubernetes_tpu_torch.api.meta import namespaced_name
                    old = self.store._table(resource).get(
                        namespaced_name(obj))
                self.policy_engine.validate(
                    obj, resource, operation, old_object=old,
                    user=user, groups=groups)
        for cfg in self._configs("validatingwebhookconfigurations"):
            for wh in cfg.get("webhooks") or []:
                if not _rules_match(wh, resource, operation):
                    continue
                resp = await self._call(wh, obj, resource, operation)
                if resp is None:
                    continue
                if not resp.get("allowed", False):
                    raise Invalid(self._deny_msg(wh, resp))
        return obj

    @staticmethod
    def _deny_msg(wh: Mapping, resp: Mapping) -> str:
        msg = (resp.get("status") or {}).get("message", "denied")
        return f'admission webhook "{wh.get("name", "?")}" denied the ' \
               f"request: {msg}"

    async def _call(self, wh: Mapping, obj: dict, resource: str,
                    operation: str) -> dict | None:
        url = (wh.get("clientConfig") or {}).get("url")
        if not url:
            return None
        review = {
            "apiVersion": "admission.k8s.io/v1",
            "kind": "AdmissionReview",
            "request": {
                "operation": operation.upper(),
                "resource": {"resource": resource},
                "object": obj,
            },
        }
        try:
            out = await self._post(url, review)
            return out.get("response") or {}
        except Exception as e:
            if wh.get("failurePolicy", "Ignore") == "Fail":
                raise Invalid(
                    f'admission webhook "{wh.get("name", "?")}" '
                    f"unreachable and failurePolicy=Fail: {e}") from e
            logger.warning("admission webhook %s unreachable (Ignore): %s",
                           wh.get("name"), e)
            return None


# ---------------------------------------------------------------------------
# CRDs: structural-schema-lite validation + kind registration
# ---------------------------------------------------------------------------

def validate_against_schema(value: Any, schema: Mapping, path: str = "") -> None:
    t = schema.get("type")
    if t == "object":
        if not isinstance(value, dict):
            raise Invalid(f"{path or '<root>'}: expected object")
        props = schema.get("properties") or {}
        for req in schema.get("required") or []:
            if req not in value:
                raise Invalid(f"{path}.{req}: required field missing")
        for k, v in value.items():
            sub = props.get(k)
            if sub is not None:
                validate_against_schema(v, sub, f"{path}.{k}")
    elif t == "array":
        if not isinstance(value, list):
            raise Invalid(f"{path}: expected array")
        items = schema.get("items")
        if items:
            for i, v in enumerate(value):
                validate_against_schema(v, items, f"{path}[{i}]")
    elif t == "string":
        if not isinstance(value, str):
            raise Invalid(f"{path}: expected string")
    elif t == "integer":
        if not isinstance(value, int) or isinstance(value, bool):
            raise Invalid(f"{path}: expected integer")
    elif t == "number":
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            raise Invalid(f"{path}: expected number")
    elif t == "boolean":
        if not isinstance(value, bool):
            raise Invalid(f"{path}: expected boolean")
    if "enum" in schema and value not in schema["enum"]:
        raise Invalid(f"{path}: {value!r} not in {schema['enum']}")


def make_crd(plural: str, kind: str, group: str = "ktpu.dev", *,
             scope: str = "Namespaced", schema: Mapping | None = None) -> dict:
    crd = {
        "apiVersion": "apiextensions.k8s.io/v1",
        "kind": "CustomResourceDefinition",
        "metadata": {"name": f"{plural}.{group}"},
        "spec": {
            "group": group,
            "scope": scope,
            "names": {"plural": plural, "kind": kind},
            "versions": [{"name": "v1", "served": True,
                          "storage": True}],
        },
    }
    if schema is not None:
        crd["spec"]["versions"][0]["schema"] = {
            "openAPIV3Schema": dict(schema)}
    return crd


def install_crd_support(store) -> None:
    """Creating a CustomResourceDefinition registers the custom resource:
    schema validation on the new table, kind→resource mapping, and
    cluster-scope bookkeeping. (The store serves any table already — a
    CRD's job here is semantics, exactly the apiextensions-apiserver
    split.)"""

    registered: set[str] = set()

    def _crd_for(plural: str) -> dict | None:
        for crd in store._table("customresourcedefinitions").values():
            names = (crd.get("spec") or {}).get("names") or {}
            if names.get("plural") == plural:
                return crd
        return None

    def register(crd: dict) -> None:
        spec = crd.get("spec") or {}
        names = spec.get("names") or {}
        plural = names.get("plural")
        kind = names.get("kind")
        if not plural or not kind:
            raise Invalid("CRD: spec.names.plural and .kind are required")
        # Store-local registration: kind mappings must not leak into other
        # stores in the process, and scope must follow CRD delete/re-create
        # (deregister below), so the process-global KIND_TO_RESOURCE /
        # CLUSTER_SCOPED_RESOURCES stay untouched.
        store.custom_kinds.setdefault(kind, plural)
        if spec.get("scope") == "Cluster":
            store.custom_cluster_scoped.add(plural)
        else:
            store.custom_cluster_scoped.discard(plural)
        if plural in registered:
            return  # one live-reading validator per plural is enough
        registered.add(plural)

        def validate(obj, plural=plural, kind=kind):
            # Read the CURRENT CRD each time: schema updates / delete +
            # re-create take effect immediately, and a deleted CRD stops
            # validating (stale-closure validators would enforce forever).
            live = _crd_for(plural)
            if live is None:
                return
            schema = None
            for v in (live.get("spec") or {}).get("versions") or []:
                if v.get("storage") or schema is None:
                    schema = (v.get("schema") or {}).get("openAPIV3Schema")
            if schema:
                validate_against_schema(obj.get("spec", obj), schema,
                                        path=kind + ".spec"
                                        if "spec" in obj else kind)
        store.register_validator(plural, validate)
        logger.info("CRD registered: %s (kind %s)", plural, kind)

    store.register_mutator("customresourcedefinitions", register,
                           on=("create", "update"))

    def deregister(crd: dict) -> None:
        names = (crd.get("spec") or {}).get("names") or {}
        plural, kind = names.get("plural"), names.get("kind")
        if not plural:
            return  # malformed CRD (never registered) must stay deletable
        if store.custom_kinds.get(kind) == plural:
            del store.custom_kinds[kind]
        store.custom_cluster_scoped.discard(plural)
        # `registered` is deliberately NOT cleared: the live-reading
        # validator self-disables while no CRD exists and re-enables on
        # re-create; dropping the guard would stack a duplicate validator
        # per delete/create cycle. Kind/scope entries (above) are written
        # by register() before its guard, so re-creates still refresh them.

    store.register_mutator("customresourcedefinitions", deregister,
                           on=("delete",))

    # CRDs created before install (store load) register too.
    for crd in list(store._table("customresourcedefinitions").values()):
        try:
            register(crd)
        except StoreError:
            logger.exception("CRD re-registration failed for %s",
                             name_of(crd))
