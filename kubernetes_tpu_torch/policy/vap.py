"""ValidatingAdmissionPolicy evaluation over stored resources.

Parity target: `staging/src/k8s.io/apiserver/pkg/admission/plugin/
policy/validating` — ValidatingAdmissionPolicy + Binding objects
(admissionregistration.k8s.io/v1) stored via the API, evaluated in the
admission chain BEFORE validating webhooks. Shape subset:

    kind: ValidatingAdmissionPolicy
    spec:
      failurePolicy: Fail | Ignore          # default Fail, the reference
      paramKind: {kind: ConfigMap}          # optional params resource
      matchConstraints:
        resourceRules:
        - resources: ["pods"]               # "*" allowed
          operations: ["CREATE", "UPDATE"]  # default "*"
        namespaceSelector: {matchLabels: ...}   # labels of the OBJECT'S
                                                # Namespace (api/labels)
      matchConditions:                      # expression prefilter; ALL
      - name: has-containers                # must hold for the policy
        expression: "has(object.spec.containers)"   # to apply
      variables:                            # composition: lazy, memoized
      - name: cset                          # once per binding evaluation,
        expression: "object.spec.containers"    # read as `variables.cset`
      validations:
      - expression: "object.spec.replicas <= params.data.maxReplicas"
        message: "replica cap"
        messageExpression: "'cap is ' + string(params.data.maxReplicas)"
        reason: Invalid
      auditAnnotations:                     # flow into the audit event as
      - key: owner                          # annotations["<policy>/owner"]
        valueExpression: "object.metadata.labels['team']"

    kind: ValidatingAdmissionPolicyBinding
    spec:
      policyName: replica-cap
      paramRef: {name: cap, namespace: default}   # optional

A policy only runs where a binding selects it (the reference contract);
params resolve via the binding's paramRef against the policy's
paramKind. Expression failures (compile error, missing param, budget
exhaustion, matchCondition/auditAnnotation errors) obey failurePolicy:
Fail denies, Ignore skips — exactly the webhook-unreachable semantics
next door in apiserver/admission.py. On DELETE the reference passes
`object=null` with the stored object as `oldObject` — both wires route
deletes through here with exactly that shape.

**O(matching) dispatch** (the tenant-scale path, SURVEY §3.2/§5.5): a
multi-tenant control plane stores hundreds-to-thousands of policies but
only a handful match any one request, so per-request cost must be
O(matching policies), not O(stored policies). The engine pre-indexes the
active set the way store/mvcc interns watch selectors (r8):

- **exact-key reverse map** over (resource, OPERATION) built from the
  precompiled resourceRules — a bucket lookup replaces the per-policy
  rule scan. Policies with a wildcard resource/operation (or no
  matchConstraints at all) bucket into a linear **residue** list, checked
  per request like today.
- **interned namespace-selector signatures**: distinct selector contents
  get one signature id; `match_label_selector` runs once per (signature,
  namespace) and is memoized across requests, invalidated per-namespace
  by a mutator on namespace label writes. Policies sharing a selector
  share the one evaluation.
- **prebuilt param/binding closures**: paramKind→resource resolution and
  the namespaced key are computed at index build; the per-request
  resolver is a single table `.get`.

The index rebuilds lazily on the existing mutator-invalidation seam (a
policy/binding table write clears the cache, the next admit rebuilds).
`KTPU_POLICY_INDEX=0` structurally degrades candidate selection to the
linear all-entries scan (no index structures are built at all); both
paths share ONE evaluation core, so verdicts are bit-identical by
construction — the differential suite (tests/test_policy_index.py) pins
it anyway.

Metrics: `policy_evaluations_total{policy=}`,
`policy_rejections_total{policy=}`, plus the index accounting
`policy_index_hits_total` (candidates served from the exact map),
`policy_index_residue_scans_total` (residue entries linearly checked)
and `policy_index_rebuilds_total` — the bench detail JSON reports the
measured-phase deltas so a dispatch regression is data.

Copy of `kubernetes_tpu/policy/vap.py`.
"""

from __future__ import annotations

import json
import logging
# collections.abc Mapping: _LazyVars rides the expression helpers'
# isinstance(base, Mapping) hot path — the abc-cached check, not
# typing's slow __instancecheck__.
from collections.abc import Mapping
from typing import Any, Callable

from kubernetes_tpu_torch.api.labels import match_label_selector
from kubernetes_tpu_torch.api.meta import name_of, namespace_of
from kubernetes_tpu_torch.metrics.registry import Registry
from kubernetes_tpu_torch.policy.expr import (
    CompiledExpression,
    ExpressionError,
    compile_expression,
    make_env,
)
from kubernetes_tpu_torch.store.mvcc import Invalid
from kubernetes_tpu_torch.utils import flags

logger = logging.getLogger(__name__)

POLICY_RESOURCE = "validatingadmissionpolicies"
BINDING_RESOURCE = "validatingadmissionpolicybindings"


class PolicyDenied(Invalid):
    """A validation expression evaluated false (or failed with
    failurePolicy=Fail). Maps to 422/Invalid on both wires, carrying the
    policy's message in the returned Status."""


def _compile_or_error(source: str):
    try:
        return compile_expression(source)
    except ExpressionError as e:
        return e


class _LazyVars(Mapping):
    """`variables.<name>` composition: each variable evaluates lazily on
    first access and memoizes for the rest of the current binding's
    evaluation (the reference's lazy CEL variable composition; a fresh
    memo per binding keeps params-referencing variables honest when
    bindings carry different params). Evaluation shares the enclosing
    expression's environment AND cost budget, so a variable chain
    cannot multiply the per-expression budget."""

    __slots__ = ("_compiled", "_env", "_memo")

    def __init__(self, compiled: Mapping[str, Any], env: dict):
        self._compiled = compiled
        self._env = env
        self._memo: dict[str, Any] = {}

    def __getitem__(self, name: str) -> Any:
        if name in self._memo:
            return self._memo[name]
        c = self._compiled.get(name)
        if c is None:
            raise ExpressionError(f"no such variable {name!r}")
        if isinstance(c, ExpressionError):
            raise c
        value = c.evaluate_shared(self._env)
        self._memo[name] = value
        return value

    def __contains__(self, name) -> bool:
        return name in self._compiled

    def __iter__(self):
        return iter(self._compiled)

    def __len__(self) -> int:
        return len(self._compiled)


_NO_VARS: Mapping[str, Any] = {}


class _Entry:
    """One bound policy, fully precompiled for the admission hot path."""

    __slots__ = ("policy", "pname", "fail_closed", "bindings",
                 "validations", "conditions", "variables", "annotations",
                 "rule_sets", "ns_sel", "ns_sig", "ckey", "seq")

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


class PolicyEngine:
    """Evaluates the stored VAP set for one (object, resource, op).

    Reads policies/bindings live from the store tables (the reference
    watches them via informers; in-process tables are the same freshness
    for free), precompiles them into `_Entry` records on the
    mutator-invalidation seam, and dispatches per request through the
    (resource, operation) exact-key index — or the linear entry scan
    under `KTPU_POLICY_INDEX=0`."""

    def __init__(self, store, registry: Registry | None = None):
        self.store = store
        r = registry or Registry()
        self.registry = r
        self.evaluations = r.counter(
            "policy_evaluations_total",
            "ValidatingAdmissionPolicy expressions evaluated",
            labels=("policy",))
        self.rejections = r.counter(
            "policy_rejections_total",
            "Requests denied by a ValidatingAdmissionPolicy",
            labels=("policy",))
        self.index_hits = r.counter(
            "policy_index_hits_total",
            "Policy candidates dispatched from the (resource, "
            "operation) exact-key index after the namespace-signature "
            "prefilter")
        self.index_residue_scans = r.counter(
            "policy_index_residue_scans_total",
            "Residue (wildcard/unconstrained) policy entries linearly "
            "checked per request")
        self.index_rebuilds = r.counter(
            "policy_index_rebuilds_total",
            "Policy index rebuilds after a policy/binding table write")
        #: policy name -> (resourceVersion, compiled bundle) — compile
        #: once per (name, rv); entries are CompiledExpression or the
        #: ExpressionError the compile raised (so a broken expression
        #: keeps obeying failurePolicy instead of recompiling per
        #: request).
        self._compiled: dict[str, tuple[str, tuple]] = {}
        #: prebuilt [_Entry] in store-table order for the admission hot
        #: path, invalidated by store mutators on the two policy tables
        #: (O(1) per write, zero rescans per admit).
        self._active: list | None = None
        #: ({(resource, OP): [(sig id | None, [_Entry])]},
        #: [residue _Entry]) — exact-key buckets GROUPED by interned
        #: namespace-selector signature, so one memoized signature check
        #: admits or rejects a whole tenant's worth of policies. Built
        #: lazily from `_active` on the first indexed dispatch; stays
        #: None under KTPU_POLICY_INDEX=0 (the structural-degrade
        #: witness).
        self._index: tuple | None = None
        #: namespace-selector signature interning: canonical selector
        #: JSON -> stable id, shared by every policy carrying that
        #: selector content; _sig_sel maps the id back to one
        #: representative selector dict for evaluation.
        self._sig_ids: dict[str, int] = {}
        self._sig_sel: dict[int, Mapping] = {}
        #: namespace -> {signature id: matched} — one selector eval per
        #: (signature, namespace), reused across requests. Invalidated
        #: per-namespace on namespace writes (the mutator below).
        self._ns_memo: dict[str, dict[int, bool]] = {}
        #: namespace -> {(resource, OP): (candidates, n_exact,
        #: n_residue)} — the fully-resolved candidate list per request
        #: shape. Steady-state dispatch is two dict lookups; the memo
        #: shares both invalidation seams (policy writes clear it with
        #: the index, namespace writes pop their one key).
        self._cand_memo: dict[str, dict[tuple[str, str], tuple]] = {}

        def invalidate(_obj, _self=self):
            _self._active = None
            _self._index = None
            _self._cand_memo.clear()

        for table in (POLICY_RESOURCE, BINDING_RESOURCE):
            store.register_mutator(
                table, invalidate, on=("create", "update", "delete"))

        def invalidate_ns(obj, _self=self):
            ns = name_of(obj)
            _self._ns_memo.pop(ns, None)
            _self._cand_memo.pop(ns, None)

        store.register_mutator(
            "namespaces", invalidate_ns,
            on=("create", "update", "delete"))

    def register_into(self, registry: Registry) -> None:
        """Surface the counters through another registry's render (the
        WatchMetrics pattern — same Counter objects, one truth)."""
        for c in (self.evaluations, self.rejections, self.index_hits,
                  self.index_residue_scans, self.index_rebuilds):
            registry._metrics.setdefault(c.name, c)

    # -- store access ------------------------------------------------------

    def _bindings_for(self, policy_name: str) -> list[dict]:
        return [b for b in self.store._table(BINDING_RESOURCE).values()
                if (b.get("spec") or {}).get("policyName") == policy_name]

    def _compiled_policy(self, policy: Mapping) -> tuple:
        """(validations, conditions, variables, annotations), each
        precompiled, cached per (name, rv)."""
        name = name_of(policy)
        rv = policy.get("metadata", {}).get("resourceVersion", "")
        cached = self._compiled.get(name)
        if cached is not None and cached[0] == rv:
            return cached[1]
        spec = policy.get("spec") or {}
        validations = []
        for v in spec.get("validations") or []:
            msg_expr = None
            if v.get("messageExpression"):
                msg_expr = _compile_or_error(v["messageExpression"])
            validations.append((
                _compile_or_error(v.get("expression", "")),
                v.get("message", ""), msg_expr))
        conditions = [
            (c.get("name", ""), _compile_or_error(c.get("expression", "")))
            for c in spec.get("matchConditions") or []]
        variables = {
            var.get("name", ""):
                _compile_or_error(var.get("expression", ""))
            for var in spec.get("variables") or []}
        annotations = [
            (a.get("key", ""),
             _compile_or_error(a.get("valueExpression", "")))
            for a in spec.get("auditAnnotations") or []]
        bundle = (validations, conditions, variables, annotations)
        self._compiled[name] = (rv, bundle)
        return bundle

    def _namespace_labels(self, namespace: str) -> Mapping[str, str]:
        ns_obj = self.store._table("namespaces").get(namespace)
        if ns_obj is None:
            return {}
        return ns_obj.get("metadata", {}).get("labels") or {}

    def _param_resolver(self, policy: Mapping,
                        binding: Mapping) -> Callable[[], Any]:
        """Prebuild paramRef → stored-object resolution: kind→resource
        and the namespaced key resolve ONCE at index build, the
        per-request call is a single table `.get`. Raises
        ExpressionError when a configured param is missing — subject to
        failurePolicy, like the reference's paramNotFoundAction
        default."""
        param_kind = ((policy.get("spec") or {}).get("paramKind")
                      or {}).get("kind")
        ref = (binding.get("spec") or {}).get("paramRef") or {}
        if not param_kind or not ref.get("name"):
            return lambda: None
        resource = self.store.resource_for_kind(param_kind)
        if resource is None:
            err = ExpressionError(
                f"paramKind {param_kind!r} has no known resource")

            def unknown_kind(_err=err):
                raise _err
            return unknown_kind
        if self.store.is_cluster_scoped(resource):
            key = ref["name"]
        else:
            # A namespaced paramKind always needs a namespaced key — an
            # omitted paramRef.namespace defaults rather than building a
            # bare key that can never match (which, under
            # failurePolicy=Fail, would deny every request).
            key = f"{ref.get('namespace') or 'default'}/{ref['name']}"

        def resolve(_store=self.store, _resource=resource, _key=key,
                    _kind=param_kind):
            params = _store._table(_resource).get(_key)
            if params is None:
                raise ExpressionError(
                    f"param {_kind} {_key!r} not found")
            return params
        return resolve

    # -- active set + index ------------------------------------------------

    def _active_set(self) -> list:
        """One prebuilt `_Entry` per bound policy, in store-table order —
        rebuilt only after a policy/binding table write (the mutators
        above clear it). resourceRules precompile to frozenset pairs,
        expressions compile once per (name, rv), param resolution and
        counter label tuples precompute."""
        active = self._active
        if active is None:
            active = []
            # Re-intern from scratch: under policy churn with varying
            # selector contents the signature tables would otherwise
            # grow without bound (and _ns_memo would keep booleans for
            # dead ids). Rebuilds are policy-write-rare; the memo
            # refills on the next requests.
            self._sig_ids = {}
            self._sig_sel = {}
            self._ns_memo.clear()
            for policy in self.store._table(POLICY_RESOURCE).values():
                pname = name_of(policy)
                bindings = self._bindings_for(pname)
                if not bindings:
                    continue  # unbound policies are inert (reference)
                spec = policy.get("spec") or {}
                constraints = spec.get("matchConstraints") or {}
                rule_sets = None  # None = match everything (reference)
                if constraints.get("resourceRules"):
                    rule_sets = [
                        (frozenset(rule.get("resources") or ()),
                         frozenset(str(o).upper() for o in
                                   rule.get("operations") or ["*"]))
                        for rule in constraints["resourceRules"]]
                validations, conditions, variables, annotations = \
                    self._compiled_policy(policy)
                ns_sel = constraints.get("namespaceSelector")
                ns_sig = None
                if ns_sel is not None:
                    sig_key = json.dumps(ns_sel, sort_keys=True,
                                         separators=(",", ":"))
                    ns_sig = self._sig_ids.setdefault(
                        sig_key, len(self._sig_ids))
                    self._sig_sel.setdefault(ns_sig, ns_sel)
                active.append(_Entry(
                    policy=policy, pname=pname,
                    fail_closed=spec.get("failurePolicy",
                                         "Fail") != "Ignore",
                    bindings=[(b, self._param_resolver(policy, b))
                              for b in bindings],
                    validations=validations, conditions=conditions,
                    variables=variables, annotations=annotations,
                    rule_sets=rule_sets, ns_sel=ns_sel, ns_sig=ns_sig,
                    ckey=(pname,), seq=len(active)))
            self._active = active
        return active

    def _build_index(self, entries: list) -> tuple:
        """(exact {(resource, OP): [(sig, [entry])]}, residue [entry]):
        entries whose every rule is concrete land in the exact map under
        each (resource, operation) pair, grouped by namespace-selector
        signature — the per-request cost of a bucket is one memoized
        signature check per DISTINCT selector, not one per policy.
        Anything with a wildcard — or no matchConstraints — stays
        linear in the residue."""
        raw: dict[tuple[str, str], dict] = {}
        residue: list = []
        for entry in entries:
            if entry.rule_sets is None or any(
                    "*" in rs or "*" in ops
                    for rs, ops in entry.rule_sets):
                residue.append(entry)
                continue
            sig = entry.ns_sig if entry.ns_sel is not None else None
            for rs, ops in entry.rule_sets:
                for resource in rs:
                    for op in ops:
                        group = raw.setdefault(
                            (resource, op), {}).setdefault(sig, [])
                        # one rule set may repeat a pair; keep one copy
                        if not group or group[-1] is not entry:
                            group.append(entry)
        exact = {key: list(groups.items()) for key, groups in raw.items()}
        self._cand_memo.clear()  # resolved lists referenced old groups
        self._index = (exact, residue)
        self.index_rebuilds.inc()
        return self._index

    @staticmethod
    def _rules_match(entry, resource: str, op: str) -> bool:
        if entry.rule_sets is None:
            return True
        return any(("*" in rs or resource in rs)
                   and ("*" in ops or op in ops)
                   for rs, ops in entry.rule_sets)

    def _candidates_indexed(self, entries: list, resource: str,
                            op: str, ns: str) -> list:
        """Candidates for one request: the (resource, op) bucket's
        signature groups that pass the memoized namespace check, plus
        the rule/selector-checked residue — merged back into
        store-table order so first-deny verdicts stay bit-identical to
        the linear scan. The resolved list memoizes per (namespace,
        resource, op): steady-state dispatch is two dict lookups."""
        idx = self._index
        if idx is None:
            idx = self._build_index(entries)
        by_key = self._cand_memo.setdefault(ns, {})
        hit = by_key.get((resource, op))
        if hit is None:
            exact, residue = idx
            out_lists = []
            n_cand = 0
            for sig, group in exact.get((resource, op), ()):
                if sig is not None and ns \
                        and not self._sig_match(sig, ns):
                    continue
                out_lists.append(group)
                n_cand += len(group)
            n_residue = len(residue)
            if residue:
                matched = [
                    e for e in residue
                    if self._rules_match(e, resource, op)
                    and not (e.ns_sel is not None and ns
                             and not self._sig_match(e.ns_sig, ns))]
                if matched:
                    out_lists.append(matched)
            if not out_lists:
                cands: list = []
            elif len(out_lists) == 1:
                cands = out_lists[0]
            else:
                cands = [e for lst in out_lists for e in lst]
                cands.sort(key=lambda e: e.seq)
            hit = (cands, n_cand, n_residue)
            by_key[(resource, op)] = hit
        cands, n_cand, n_residue = hit
        # counters move per REQUEST (memo hit or miss): the detail
        # JSON's hits/residue deltas stay a per-request dispatch
        # measure, not a cache-population artifact.
        if n_cand:
            self.index_hits.inc(n_cand)
        if n_residue:
            self.index_residue_scans.inc(n_residue)
        return cands

    def _sig_match(self, sig: int, namespace: str) -> bool:
        """Interned-signature selector check: one match_label_selector
        eval per (signature, namespace), memoized across requests and
        shared by every policy carrying the same selector content."""
        memo = self._ns_memo.setdefault(namespace, {})
        hit = memo.get(sig)
        if hit is None:
            hit = match_label_selector(
                self._sig_sel[sig], self._namespace_labels(namespace))
            memo[sig] = hit
        return hit

    # -- evaluation --------------------------------------------------------

    def validate(self, obj: Mapping | None, resource: str,
                 operation: str, *,
                 old_object: Mapping | None = None,
                 user: str | None = None,
                 groups: list[str] | None = None) -> None:
        """Run every bound, matching policy; raise PolicyDenied on the
        first failing validation (Fail semantics) — Ignore-policy errors
        are logged and skipped. On DELETE the caller passes `obj=None`
        with the stored object as `old_object` (the reference's
        `object=null` contract); namespace/name then derive from the
        old object."""
        entries = self._active_set()
        if not entries:
            return
        op = operation.upper()
        ref = obj if obj is not None else (old_object or {})
        ns = namespace_of(ref)
        use_index = flags.get("KTPU_POLICY_INDEX")
        if use_index:
            cands = self._candidates_indexed(entries, resource, op, ns)
            if not cands:
                return
        else:
            cands = entries
        ns_labels: Mapping[str, str] | None = None
        request = {
            "operation": op,
            "resource": resource,
            "namespace": ns,
            "name": name_of(ref),
            "userInfo": {"username": user or "",
                         "groups": list(groups or [])},
        }
        #: one env shared by every expression this admit evaluates —
        #: only `params`/`variables` vary per entry/binding
        #: (expr.make_env contract).
        env: dict | None = None
        for entry in cands:
            if not use_index:
                # linear (kill-switch) path: rule + selector checks per
                # entry, today's scan shape — candidates from the index
                # already passed both at selection time.
                if not self._rules_match(entry, resource, op):
                    continue
                if entry.ns_sel is not None and ns:
                    if ns_labels is None:
                        ns_labels = self._namespace_labels(ns)
                    if not match_label_selector(entry.ns_sel, ns_labels):
                        continue
            if env is None:
                env = make_env({"object": obj,
                                "oldObject": old_object,
                                "request": request,
                                "params": None,
                                "variables": _NO_VARS})
            self._eval_entry(entry, env)

    def _eval_entry(self, entry, env: dict) -> None:
        """Shared evaluation core (both dispatch paths): matchConditions
        prefilter → per-binding params → auditAnnotations →
        validations. Raises PolicyDenied per failurePolicy. The
        evaluation counter batches into ONE inc per (entry, request) —
        counter locks were measurable at 30 evaluations/request on the
        1k-tenant shape — flushed on every exit path (deny included)
        by the finally."""
        nev = [0]
        try:
            self._eval_entry_inner(entry, env, nev)
        finally:
            if nev[0]:
                self.evaluations.inc_key(entry.ckey, nev[0])

    def _eval_entry_inner(self, entry, env: dict, nev: list) -> None:
        pname, fail_closed = entry.pname, entry.fail_closed
        if entry.conditions:
            # Prefilter stage: params is null during match evaluation
            # (conditions run before binding selection, like the
            # reference's stateless match when no paramRef applies).
            # Variables get their own memo for this stage — a value
            # computed under params=None must not leak into a
            # binding's validations.
            env["params"] = None
            env["variables"] = _LazyVars(entry.variables, env) \
                if entry.variables else _NO_VARS
            for cname, compiled in entry.conditions:
                nev[0] += 1
                try:
                    if isinstance(compiled, ExpressionError):
                        raise compiled
                    ok = compiled.evaluate_env(env)
                except ExpressionError as e:
                    if fail_closed:
                        self.rejections.inc(policy=pname)
                        raise PolicyDenied(
                            f'ValidatingAdmissionPolicy "{pname}" '
                            f"matchCondition {cname!r} failed and "
                            f"failurePolicy=Fail: {e}") from e
                    logger.warning("policy %s matchCondition %s: %s "
                                   "(Ignore)", pname, cname, e)
                    return
                if not ok:
                    return  # condition false: the policy does not apply
        annotated = False
        for binding, resolver in entry.bindings:
            try:
                params = resolver()
            except ExpressionError as e:
                if fail_closed:
                    self.rejections.inc(policy=pname)
                    raise PolicyDenied(
                        f'ValidatingAdmissionPolicy "{pname}" '
                        f"failed and failurePolicy=Fail: {e}") from e
                logger.warning("policy %s: %s (Ignore)", pname, e)
                continue
            env["params"] = params
            # Fresh variables memo per binding: each binding's params
            # differ, so a params-referencing variable must re-evaluate
            # under this binding's params rather than reuse the first
            # binding's (or the matchCondition stage's params=None)
            # value.
            env["variables"] = _LazyVars(entry.variables, env) \
                if entry.variables else _NO_VARS
            if entry.annotations and not annotated:
                annotated = True
                self._emit_annotations(entry, env, nev)
            for compiled, message, msg_expr in entry.validations:
                nev[0] += 1
                if isinstance(compiled, ExpressionError):
                    err: Exception | None = compiled
                    ok = None
                else:
                    try:
                        ok = compiled.evaluate_env(env)
                        err = None
                    except ExpressionError as e:
                        ok, err = None, e
                if err is not None:
                    if fail_closed:
                        self.rejections.inc(policy=pname)
                        raise PolicyDenied(
                            f'ValidatingAdmissionPolicy "{pname}" '
                            f"failed and failurePolicy=Fail: {err}")
                    logger.warning("policy %s: %s (Ignore)",
                                   pname, err)
                    continue
                if not ok:
                    self.rejections.inc(policy=pname)
                    msg = message
                    if msg_expr is not None:
                        # messageExpression failure falls back to the
                        # static message (reference), never failurePolicy.
                        try:
                            if not isinstance(msg_expr, ExpressionError):
                                m = msg_expr.evaluate_env(env)
                                if isinstance(m, str) and m:
                                    msg = m
                        except ExpressionError as e:
                            logger.warning(
                                "policy %s messageExpression: %s",
                                pname, e)
                    src = getattr(compiled, "source", "")
                    raise PolicyDenied(
                        f'ValidatingAdmissionPolicy "{pname}" '
                        f"denied the request: "
                        f"{msg or 'failed expression: ' + src}")

    def _emit_annotations(self, entry, env: dict, nev: list) -> None:
        """auditAnnotations: value expressions evaluated once per
        (policy, request) — a string publishes
        `annotations["<policy>/<key>"]` on the request's audit event
        (the contextvar seam in policy/audit.py), null omits, anything
        else is an error subject to failurePolicy."""
        from kubernetes_tpu_torch.policy.audit import annotate
        for key, compiled in entry.annotations:
            nev[0] += 1
            try:
                if isinstance(compiled, ExpressionError):
                    raise compiled
                value = compiled.evaluate_env(env)
                if value is not None and not isinstance(value, str):
                    raise ExpressionError(
                        f"auditAnnotation {key!r} must evaluate to a "
                        f"string or null, got {type(value).__name__}")
            except ExpressionError as e:
                if entry.fail_closed:
                    self.rejections.inc(policy=entry.pname)
                    raise PolicyDenied(
                        f'ValidatingAdmissionPolicy "{entry.pname}" '
                        f"failed and failurePolicy=Fail: {e}") from e
                logger.warning("policy %s auditAnnotation %s: %s "
                               "(Ignore)", entry.pname, key, e)
                continue
            if value is not None:
                annotate(f"{entry.pname}/{key}", value)
