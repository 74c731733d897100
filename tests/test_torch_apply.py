"""The port's server-side apply, merge patches, JSON patches, CRD support
and schema validation on the CPU against the JAX package's, on the cases
of `tests/test_apply.py` and `tests/test_admission_webhooks.py`.

- `MVCCStore.apply` (`store/apply.py server_side_apply`): one script of
  applies per case (ownership on create, a foreign-field conflict then
  force, two owners over disjoint fields, same-value co-ownership, a
  scalar over a foreign subtree and a subtree under a foreign scalar):
  the same objects with their managedFields, and the same conflict type
  and message, step by step; the caller's input is left as it was.
- `strategic_merge_patch` (strategic and plain merge, null deletes, keyed
  list merges) and `apply_json_patch` (add, replace, remove, the `-`
  index, an unsupported op) over seeded objects and patches.
- CRD support (`make_crd`, `install_crd_support`) and
  `validate_against_schema`: the same accepted objects, the same Invalid
  messages, the same kind map and scope after delete and re-create.

Tolerance: none (exact host logic; uids and timestamps are masked).
"""

import asyncio
import copy

import numpy as np
import pytest

from kubernetes_tpu import store as jstore
from kubernetes_tpu.apiserver import admission as jadm
from kubernetes_tpu.store import apply as japply
from kubernetes_tpu_torch import store as tstore
from kubernetes_tpu_torch.apiserver import admission as tadm
from kubernetes_tpu_torch.store import apply as tapply

PACKAGES = {"jax": (jstore, japply, jadm), "torch": (tstore, tapply, tadm)}
MASKED = ("uid", "creationTimestamp", "time")


def masked(value):
    if isinstance(value, dict):
        return {k: "<masked>" if k in MASKED else masked(v)
                for k, v in value.items()}
    if isinstance(value, list):
        return [masked(v) for v in value]
    return value


def deployment(name="web", **spec):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"replicas": 1, **spec}}


ANNOTATOR = {"apiVersion": "apps/v1", "kind": "Deployment",
             "metadata": {"name": "web", "namespace": "default",
                          "annotations": {"team": "infra"}},
             "spec": {"paused": True}}
BARE = {"apiVersion": "apps/v1", "kind": "Deployment",
        "metadata": {"name": "web", "namespace": "default"}}

#: (case, [(object, field manager, force), ...]) after tests/test_apply.py.
SSA_CASES = {
    "create": [(deployment(), "deploy-tool", False)],
    "conflict-then-force": [
        (deployment(replicas=1), "deploy-tool", False),
        (deployment(replicas=5), "hpa", False),
        (deployment(replicas=5), "hpa", True)],
    "two-owners": [
        (deployment(replicas=2, template={"labels": {"app": "web"}}),
         "deploy-tool", False),
        (ANNOTATOR, "annotator", False),
        (deployment(replicas=3), "deploy-tool", False)],
    "same-value": [
        (deployment(replicas=4), "a", False),
        (deployment(replicas=4), "b", False),
        (BARE, "a", False)],
    "scalar-over-subtree": [
        (deployment(strategy={"rollingUpdate": {"maxSurge": 2}}), "alice",
         False),
        (deployment(strategy="Recreate"), "bob", False),
        (deployment(strategy="Recreate"), "bob", True)],
    "subtree-under-scalar": [
        (deployment(strategy="Recreate"), "alice", False),
        (deployment(strategy={"rollingUpdate": {"maxSurge": 2}}), "bob",
         False)],
}


async def ssa_script(name: str, steps: list) -> list:
    store_mod, apply_mod, _ = PACKAGES[name]
    store = store_mod.new_cluster_store()
    out = []
    try:
        for obj, manager, force in steps:
            arg = copy.deepcopy(obj)
            try:
                got = await store.apply("deployments", arg,
                                        field_manager=manager, force=force)
                out.append(("ok", masked(got)))
            except apply_mod.ApplyConflict as e:
                assert isinstance(e, store_mod.Conflict)
                out.append(("ApplyConflict", str(e)))
            assert arg == obj  # the caller's input is not mutated
        out.append(("stored", masked(await store.get("deployments",
                                                     "default/web"))))
    finally:
        store.stop()
    return out


@pytest.mark.parametrize("case", sorted(SSA_CASES))
def test_server_side_apply_script(case):
    want = asyncio.run(ssa_script("jax", SSA_CASES[case]))
    got = asyncio.run(ssa_script("torch", SSA_CASES[case]))
    assert got == want
    kinds = [step[0] for step in want]
    if case in ("conflict-then-force", "scalar-over-subtree",
                "subtree-under-scalar"):
        assert "ApplyConflict" in kinds
    assert tapply.server_side_apply is tstore.server_side_apply
    assert issubclass(tstore.ApplyConflict, tstore.Conflict)


def random_tree(rng, depth: int = 0):
    """A seeded object: nested dicts, scalars, and keyed lists under the
    fields strategic merge knows (containers, env, ports, volumes)."""
    out = {}
    for i in range(int(rng.integers(1, 4))):
        pick = int(rng.integers(0, 5 if depth < 2 else 2))
        key = f"k{i}"
        if pick == 0:
            out[key] = int(rng.integers(0, 9))
        elif pick == 1:
            out[key] = ("a", "b", None)[int(rng.integers(0, 3))]
        elif pick == 2:
            out[key] = random_tree(rng, depth + 1)
        elif pick == 3:
            field = ("containers", "env", "ports", "volumes")[
                int(rng.integers(0, 4))]
            mk = {"ports": "containerPort"}.get(field, "name")
            out[field] = [{mk: f"n{int(rng.integers(0, 4))}"
                           if mk == "name" else int(rng.integers(0, 4)),
                           "v": int(rng.integers(0, 9))}
                          for _ in range(int(rng.integers(0, 3)))]
        else:
            out[key] = [int(rng.integers(0, 9)) for _ in range(2)]
    return out


@pytest.mark.parametrize("seed", range(4))
def test_strategic_merge_patch(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        cur, pat = random_tree(rng), random_tree(rng)
        for strategic in (True, False):
            want = japply.strategic_merge_patch(copy.deepcopy(cur),
                                                copy.deepcopy(pat),
                                                strategic=strategic)
            got = tapply.strategic_merge_patch(copy.deepcopy(cur),
                                               copy.deepcopy(pat),
                                               strategic=strategic)
            assert got == want
    named = {"spec": {"containers": [{"name": "a", "image": "x"},
                                     {"name": "b", "image": "y"}]}}
    patch = {"spec": {"containers": [{"name": "b", "image": "z"},
                                     {"name": "c", "image": "w"}]}}
    for strategic in (True, False):
        assert tapply.strategic_merge_patch(named, patch,
                                            strategic=strategic) == \
            japply.strategic_merge_patch(named, patch, strategic=strategic)


JSON_PATCHES = [
    [{"op": "add", "path": "/metadata/labels/b", "value": "2"},
     {"op": "replace", "path": "/metadata/labels/a", "value": "9"},
     {"op": "remove", "path": "/spec/containers/0/name"},
     {"op": "add", "path": "/spec/containers/-",
      "value": {"name": "sidecar"}}],
    [{"op": "add", "path": "/spec/containers/0", "value": {"name": "init"}},
     {"op": "replace", "path": "/spec/containers/1", "value": {"n": 1}},
     {"op": "remove", "path": "/metadata/labels/missing"},
     {"op": "add", "path": "/metadata/annotations", "value": {"x~y": "1"}},
     {"op": "replace", "path": "/metadata/annotations/x~0y", "value": "2"}],
    [{"op": "remove", "path": "/spec/containers/0"},
     {"op": "move", "path": "/spec", "from": "/metadata"}],
    [{"op": "remove", "path": "/spec/containers/5"}],
]


@pytest.mark.parametrize("i", range(len(JSON_PATCHES)))
def test_apply_json_patch(i):
    obj = {"metadata": {"labels": {"a": "1"}},
           "spec": {"containers": [{"name": "c"}]}}

    def result(mod):
        try:
            return ("ok", mod.apply_json_patch(copy.deepcopy(obj),
                                               copy.deepcopy(JSON_PATCHES[i])))
        except Exception as e:  # the error itself is compared
            return (type(e).__name__, str(e))

    assert result(tadm) == result(jadm)


SCHEMA = {"type": "object", "required": ["slices"],
          "properties": {"slices": {"type": "integer"},
                         "topology": {"type": "string",
                                      "enum": ["2x2", "2x4", "4x4"]},
                         "tags": {"type": "array",
                                  "items": {"type": "string"}}}}
CUSTOM = [{"slices": 4, "topology": "2x4"}, {"topology": "2x4"},
          {"slices": 2, "topology": "3x3"}, {"slices": "x"},
          {"slices": 1, "tags": ["a", 3]}, {"slices": 1, "tags": ["a"]}]


async def crd_script(name: str) -> list:
    store_mod, _, adm = PACKAGES[name]
    store = store_mod.new_cluster_store()
    adm.install_crd_support(store)
    out = []
    try:
        await store.create("customresourcedefinitions",
                           adm.make_crd("tpujobs", "TPUJob", schema=SCHEMA))
        for i, spec in enumerate(CUSTOM):
            try:
                got = await store.create("tpujobs", {
                    "apiVersion": "ktpu.dev/v1", "kind": "TPUJob",
                    "metadata": {"name": f"j{i}", "namespace": "default"},
                    "spec": copy.deepcopy(spec)})
                out.append(("ok", masked(got)))
            except store_mod.Invalid as e:
                out.append(("Invalid", str(e)))
        out.append((store.resource_for_kind("TPUJob"),
                    store.is_cluster_scoped("tpujobs")))
        await store.create("customresourcedefinitions",
                           adm.make_crd("widgets", "Widget", scope="Cluster"))
        out.append((store.resource_for_kind("Widget"),
                    store.is_cluster_scoped("widgets")))
        await store.delete("customresourcedefinitions", "widgets.ktpu.dev")
        out.append((store.resource_for_kind("Widget"),
                    store.is_cluster_scoped("widgets")))
        await store.create("customresourcedefinitions",
                           adm.make_crd("widgets", "Widget"))
        out.append((store.resource_for_kind("Widget"),
                    store.is_cluster_scoped("widgets")))
    finally:
        store.stop()
    for value, schema in ((CUSTOM[0], SCHEMA), ([1, "x"], {
            "type": "array", "items": {"type": "integer"}})):
        try:
            adm.validate_against_schema(value, schema, "t")
            out.append("valid")
        except store_mod.Invalid as e:
            out.append(("Invalid", str(e)))
    return out


def test_crd_support_and_schema_validation():
    want = asyncio.run(crd_script("jax"))
    got = asyncio.run(crd_script("torch"))
    assert got == want
    assert [r[0] for r in want[:len(CUSTOM)]].count("Invalid") == 4
