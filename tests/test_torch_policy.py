"""The port's policy chain on the CPU against the JAX package's.

- `compile_expression` over a seeded corpus (field access, functions,
  string methods, comprehensions, forbidden syntax, escapes, cost bombs):
  the same values, the same error types and messages, and, for every
  expression that evaluates, the same cost (the least budget under which
  it does not raise `BudgetExceeded`).
- `PolicyEngine` on the scheduler_perf runners' uniform 10-policy set and
  on the 1000/100 tenant set, request by request (pods, config maps,
  secrets and services in labeled, unlabeled and tenant namespaces, with
  a namespace relabel and a policy write between requests): the same
  allow or deny and message, and the same evaluations, index hits, residue
  scans and rebuilds per request, with `KTPU_POLICY_INDEX` on and off.
- `AuditPolicy` levels over a grid of request attributes, and the
  `AuditPipeline`'s stage events (annotations, omitted stages,
  impersonation, request and response objects) with the audit ids and
  timestamps masked.
- The per-pod evaluation count `chip_smoke.POLICY_SCALE_EVALS_PER_POD`
  that phase 18(a) gates on: both runners over the KTPU wire with
  PolicyScale's 1000/100 layout on a small cluster.

Tolerance: none (everything here is exact host logic).
"""

import asyncio
import copy
import itertools

import numpy as np
import pytest

import chip_smoke
from kubernetes_tpu import policy as jpolicy
from kubernetes_tpu import store as jstore
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu.policy import expr as jexpr
from kubernetes_tpu_torch import policy as tpolicy
from kubernetes_tpu_torch import store as tstore
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from kubernetes_tpu_torch.policy import expr as texpr
from test_torch_apiserver import reference_wire_in_tmpdir  # noqa: F401

PACKAGES = {"jax": (jexpr, jpolicy, jstore, jperf),
            "torch": (texpr, tpolicy, tstore, tperf)}
MASKED = ("uid", "creationTimestamp", "auditID", "stageTimestamp")


def masked(value):
    """A deep copy with the per-process fields (uids, timestamps, audit
    ids) replaced by a marker."""
    if isinstance(value, dict):
        return {k: "<masked>" if k in MASKED else masked(v)
                for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [masked(v) for v in value]
    return value


# -- compile_expression ---------------------------------------------------

TEMPLATES = (
    "object.metadata.name == 'pod-{k}'",
    "object.spec.priority < {k}",
    "object.metadata.labels['app'] in ('web', 'db')",
    "size(object.spec.containers) == {k}",
    "has(object.spec.priority) and not has(object.spec.nodeName)",
    "object.metadata.name.startsWith('pod-{k}')",
    "object.metadata.name.endsWith('{k}')",
    "object.metadata.name.contains('-')",
    "object.metadata.name.matches('^pod-[0-9]+$')",
    "object.metadata.name.upperAscii() + '-' + string(object.spec.priority)",
    "string(object.spec.priority) == '{k}'",
    "int(object.metadata.labels['tier']) + {k}",
    "double(object.spec.priority) / 2",
    "object.spec.priority % ({k} - {k})",
    "all(c.name != '' for c in object.spec.containers)",
    "any(c.image.endsWith(':v{k}') for c in object.spec.containers)",
    "[c.name for c in object.spec.containers if c.name != 'c{k}']",
    "sum([int(c.cpu) for c in object.spec.containers])",
    "max([int(c.cpu) for c in object.spec.containers])",
    "min(object.spec.priority, {k})",
    "object.spec.containers[{k}].name",
    "object.metadata.labels.tier",
    "object.spec.nope == {k}",
    "has(object.spec.nope)",
    "object.keys == 'v'",
    "object.values == 1",
    "oldObject == null",
    "request.operation == 'CREATE' and request.userInfo.username == 'u{k}'",
    "params.maxPriority >= object.spec.priority",
    "variables.cset",
    "bool(object.spec.priority) or size(object.metadata.name) > {k}",
    "object.metadata.name * {k}",
    "object.spec.priority * {k}",
    "'x' * 100000",
    "size([1 for a in object.items for b in object.items "
    "for c in object.items])",
    "object.blob + object.blob",
    "object.metadata.name.matches(object.blob)",
    # rejected at compile time
    "object.__class__",
    "object._private",
    "().__class__.__bases__",
    "__import__('os')",
    "open('/etc/passwd')",
    "lambda: 1",
    "object.spec ** 2",
    "x := 3",
    "f'{{object}}'",
    "{{**object}}",
    "object.spec.run()",
    "object.spec.priority +",
    "[].append == 1",
)


def corpus(seed: int, n_objects: int = 6) -> list[tuple[str, dict]]:
    """(expression, variables) pairs: every template against seeded pod
    objects, with `k` drawn from the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_objects):
        n_containers = int(rng.integers(0, 4))
        obj = {
            "metadata": {"name": f"pod-{int(rng.integers(0, 20))}",
                         "labels": {"app": ("web", "db", "batch")[i % 3],
                                    "tier": str(int(rng.integers(0, 9)))}},
            "spec": {"priority": int(rng.integers(-5, 50)),
                     "containers": [
                         {"name": f"c{j}", "image": f"img:v{j}",
                          "cpu": str(int(rng.integers(1, 8)))}
                         for j in range(n_containers)]},
            "items": list(range(int(rng.integers(5, 40)))),
            "blob": "y" * int(rng.integers(10, 40000)),
            "keys": "v",
            "k": "v",
        }
        if i % 2:
            obj["spec"]["nodeName"] = "node-1"
        variables = {
            "object": obj, "oldObject": None,
            "request": {"operation": ("CREATE", "UPDATE")[i % 2],
                        "userInfo": {"username": f"u{i}"}},
            "params": {"maxPriority": int(rng.integers(0, 60))}
            if i % 3 else None,
            "variables": {"cset": [1, 2]},
        }
        for t in TEMPLATES:
            k = int(rng.integers(0, 4))
            out.append((t.format(k=k), variables))
    return out


def outcome(expr_mod, source: str, variables: dict, budget=None):
    """What compiling and evaluating `source` gives: a value, or the
    stage, type and message of the error."""
    try:
        compiled = expr_mod.compile_expression(source)
    except expr_mod.ExpressionError as e:
        return ("compile", type(e).__name__, str(e))
    kw = {} if budget is None else {"budget": budget}
    try:
        return ("value", repr(compiled.evaluate(copy.deepcopy(variables),
                                                **kw)))
    except expr_mod.ExpressionError as e:
        return ("eval", type(e).__name__, str(e))


def cost(expr_mod, source: str, variables: dict):
    """The least budget under which `source` evaluates without
    `BudgetExceeded` (None where it exceeds the default budget)."""
    def exceeded(b):
        return outcome(expr_mod, source, variables, b)[1] == "BudgetExceeded"

    hi = expr_mod.DEFAULT_BUDGET
    if exceeded(hi):
        return None
    lo = 0
    while lo < hi:
        mid = (lo + hi) // 2
        if exceeded(mid):
            lo = mid + 1
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("seed", [0, 1])
def test_compile_expression_corpus(seed):
    cases = corpus(seed)
    kinds = set()
    for source, variables in cases:
        want = outcome(jexpr, source, variables)
        got = outcome(texpr, source, variables)
        assert got == want, source
        kinds.add(want[:2] if want[0] != "value" else "value")
        if want[0] == "value":
            assert cost(texpr, source, variables) == \
                cost(jexpr, source, variables), source
    # The corpus reaches every outcome: values, compile errors, lookup
    # errors and the cost budget.
    assert {"value", ("compile", "ExpressionError"),
            ("eval", "ExpressionError"),
            ("eval", "BudgetExceeded")} <= kinds


def test_budget_exceeded_at_the_same_cost():
    variables = {"object": {"items": list(range(30))}}
    source = "size([1 for a in object.items for b in object.items])"
    want = cost(jexpr, source, variables)
    assert want is not None and want > 900
    assert cost(texpr, source, variables) == want
    for pkg in (jexpr, texpr):
        with pytest.raises(pkg.BudgetExceeded, match="budget"):
            pkg.compile_expression(source).evaluate(variables, budget=want - 1)
        env = pkg.make_env(variables)
        assert pkg.compile_expression(source).evaluate_env(env, want) == 900


# -- PolicyEngine ------------------------------------------------------------

def requests(api_types) -> list[tuple]:
    """The request script: (op, payload). `admit` runs the engine; `write`
    changes the store between admissions."""
    pods = []
    for i, ns in enumerate(("default", "tenant-0", "tenant-3", "tenant-7",
                            "other", "default", "tenant-7")):
        p = api_types.make_pod(f"p{i}", namespace=ns)
        if i == 5:
            p["spec"]["paused"] = True  # every pod policy denies it
        pods.append(p)
    empty = api_types.make_pod("empty")
    empty["spec"]["containers"] = []
    cm = api_types.make_config_map("cm", "tenant-4", {"a": "1"})
    out = [("admit", (p, "pods", "CREATE")) for p in pods]
    out += [("admit", (empty, "pods", "CREATE")),
            ("admit", (pods[0], "pods", "UPDATE")),
            ("admit", (cm, "configmaps", "CREATE")),
            ("admit", (cm, "configmaps", "UPDATE")),
            ("admit", ({"metadata": {"name": "s", "namespace": "tenant-1"}},
                       "secrets", "CREATE")),
            ("admit", ({"metadata": {"name": "svc", "namespace": "default"}},
                       "services", "CREATE")),
            ("relabel", ("other", {"ktpu.io/tenant": "t0"})),
            ("admit", (pods[4], "pods", "CREATE")),
            ("policy", "late-policy"),
            ("admit", (pods[0], "pods", "CREATE")),
            ("admit", (pods[2], "pods", "CREATE")),
            ("admit", (None, "pods", "DELETE"))]
    return out


def counters(engine) -> tuple:
    return (sum(engine.evaluations._values.values()),
            engine.index_hits.value(), engine.index_residue_scans.value(),
            engine.index_rebuilds.value(),
            sum(engine.rejections._values.values()))


async def engine_script(name: str, policy_count: int, tenants: int) -> list:
    """Run `requests` through one package's PolicyEngine over its
    runner's installed policy set; returns one record per step."""
    _, policy_mod, store_mod, perf = PACKAGES[name]
    api_types = __import__(f"{perf.__name__.split('.')[0]}.api.types",
                           fromlist=["make_pod"])
    store = store_mod.new_cluster_store()
    store_mod.install_core_validation(store)
    engine = policy_mod.PolicyEngine(store)
    runner = perf.PerfRunner(policy_count=policy_count,
                             policy_tenants=tenants)
    await runner._install_policies(store)
    await store.create("namespaces", api_types.make_namespace("other"))
    records = []
    for op, payload in requests(api_types):
        before = counters(engine)
        if op == "relabel":
            ns, labels = payload
            cur = await store.get("namespaces", ns)
            cur = copy.deepcopy(cur)
            cur["metadata"]["labels"] = labels
            await store.update("namespaces", cur)
            records.append(("relabel", ns))
            continue
        if op == "policy":
            await store.create(
                "validatingadmissionpolicies",
                api_types.make_validating_admission_policy(payload, [
                    {"expression": "object.metadata.name != 'p2'",
                     "message": "no p2"}],
                    match_constraints={"resourceRules": [
                        {"resources": ["pods"], "operations": ["*"]}]}))
            await store.create("validatingadmissionpolicybindings",
                               api_types.make_vap_binding(f"{payload}-b",
                                                          payload))
            records.append(("policy", payload))
            continue
        obj, resource, operation = payload
        old = None
        if obj is None:
            obj, old = None, requests(api_types)[0][1][0]
        try:
            engine.validate(copy.deepcopy(obj), resource, operation,
                            old_object=copy.deepcopy(old), user="alice",
                            groups=["dev"])
            verdict = ("allowed",)
        except policy_mod.PolicyDenied as e:
            verdict = ("denied", str(e))
        after = counters(engine)
        records.append((resource, operation, verdict,
                        tuple(a - b for a, b in zip(after, before))))
    store.stop()
    return records


@pytest.mark.parametrize("index", ["1", "0"])
@pytest.mark.parametrize("policies,tenants", [(10, 0), (1000, 100)])
def test_policy_engine_request_by_request(monkeypatch, index, policies,
                                          tenants):
    monkeypatch.setenv("KTPU_POLICY_INDEX", index)
    want = asyncio.run(engine_script("jax", policies, tenants))
    got = asyncio.run(engine_script("torch", policies, tenants))
    assert got == want
    verdicts = [r[2][0] for r in want if len(r) == 4]
    assert "denied" in verdicts and "allowed" in verdicts
    evals = sum(r[3][0] for r in want if len(r) == 4)
    hits = sum(r[3][1] for r in want if len(r) == 4)
    assert evals > 0
    assert (hits > 0) == (index == "1")


# -- audit -------------------------------------------------------------------

AUDIT_RULES = [
    {"level": "None", "users": ["system:kube-proxy"]},
    {"level": "None", "resources": ["events"], "omitStages":
     ["RequestReceived"]},
    {"level": "RequestResponse", "groups": ["admins"], "verbs": ["create",
                                                                 "update"]},
    {"level": "Request", "resources": "configmaps"},
    {"level": "Metadata", "namespaces": ["kube-system"],
     "omitStages": ["ResponseComplete"]},
    {"level": "Metadata", "verbs": ["*"], "resources": ["pods"],
     "omitStages": ["RequestReceived"]},
    {"level": "Request", "users": ["*"], "namespaces": ["tenant-1"]},
]
ATTRS = {
    "user": ("alice", "system:kube-proxy", None),
    "groups": (["admins"], ["dev"], None),
    "verb": ("create", "get", "delete"),
    "resource": ("pods", "configmaps", "events", "secrets"),
    "namespace": ("default", "kube-system", "tenant-1", None),
}


def test_audit_policy_levels():
    j = jpolicy.AuditPolicy(copy.deepcopy(AUDIT_RULES))
    t = tpolicy.AuditPolicy(copy.deepcopy(AUDIT_RULES))
    levels = set()
    for combo in itertools.product(*ATTRS.values()):
        attrs = dict(zip(ATTRS, combo))
        want = j.level_for(**attrs)
        assert t.level_for(**attrs) == want, attrs
        assert t.rule_for(**attrs) == j.rule_for(**attrs), attrs
        levels.add(want)
    assert levels == {"None", "Metadata", "Request", "RequestResponse"}
    assert tpolicy.AuditPolicy.metadata_for_all().rules == \
        jpolicy.AuditPolicy.metadata_for_all().rules


async def audit_script(policy_mod) -> tuple[list, float, float]:
    from importlib import import_module

    audit = import_module(f"{policy_mod.__name__}.audit")
    pipe = policy_mod.AuditPipeline(
        policy_mod.AuditPolicy(copy.deepcopy(AUDIT_RULES)))
    body = {"metadata": {"name": "x", "namespace": "default"}}
    for i, combo in enumerate(itertools.product(*ATTRS.values())):
        attrs = dict(zip(ATTRS, combo))
        attrs["user"] = attrs["user"] or "system:anonymous"
        ctx = pipe.begin(name=f"obj-{i}", request_object=copy.deepcopy(body),
                         **attrs)
        if i % 5 == 0:
            audit.annotate("policy.ktpu.io/note", f"n{i}")
        pipe.response_complete(
            ctx, code=(200, 201, 403, 409)[i % 4],
            response_object={"kind": "Status", "i": i},
            impersonated_user="bob" if i % 7 == 0 else None)
        if i % 50 == 0:
            await asyncio.sleep(0)
    await pipe.close()
    sink = pipe.sink
    return (masked(sink.entries), sum(sink.events_total._values.values()),
            sink.events_dropped.value())


def test_audit_pipeline_stage_events():
    want = asyncio.run(audit_script(jpolicy))
    got = asyncio.run(audit_script(tpolicy))
    assert got == want
    entries = want[0]
    stages = {e["stage"] for e in entries}
    assert stages == {"RequestReceived", "ResponseComplete"}
    assert any("annotations" in e for e in entries)
    assert any("impersonatedUser" in e for e in entries)
    assert any("responseObject" in e for e in entries)
    assert want[1] == len(entries) and want[2] == 0


# -- the per-pod evaluation count phase 18(a) gates on ----------------------

@pytest.mark.usefixtures("reference_wire_in_tmpdir")
def test_policy_scale_evals_per_pod_matches_the_reference():
    params = {"initNodes": 20, "initPods": 10, "measurePods": 40}
    template = tperf.POLICY_SCALE["workloadTemplate"]
    out = {}
    for name, perf in (("jax", jperf), ("torch", tperf)):
        runner = perf.PerfRunner(through_apiserver="wire", policy_count=1000,
                                 policy_tenants=100)
        res = asyncio.run(runner.run(copy.deepcopy(template), params,
                                     timeout=120.0))
        assert res.measured_pods == 40
        out[name] = (res.policy_evaluations_total / res.measured_pods,
                     res.policy_index_hits_total,
                     res.policy_index_residue_scans_total)
    assert out["torch"] == out["jax"]
    assert out["jax"][0] == chip_smoke.POLICY_SCALE_EVALS_PER_POD
