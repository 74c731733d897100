"""The port's constraint-row compiler against the JAX package's on the CPU.

`ops/labelsets.py` (`LabelSigTable`, `TopologyTable`) and
`ops/affinity.py` (`AffinityCompiler`, `_seg_sum`) are host numpy in both
packages; the port's copies must build bitwise the reference's arrays.
Seeded clusters (three zones, keyless and tainted nodes, resident pods in
two namespaces with required, preferred and anti-affinity terms, some of
them namespaceSelector terms) and pending pods (required / preferred /
anti terms with namespaceSelector, hard and soft spread constraints with
minDomains deficits and `{}` namespace selectors, node selectors and
tolerations that restrict spread eligibility) go through both compilers,
each wired to a namespace resolver over the same Namespace labels.

Every row — filter, symmetry, eligibility, score, spread filter, spread raw
scores, term presence, per-node counts — is compared with
`np.testing.assert_array_equal` and equal dtypes: no tolerance.
"""

import random

import numpy as np
import pytest

from kubernetes_tpu.ops import affinity as jaffinity
from kubernetes_tpu.ops import labelsets as jlabelsets
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import interpodaffinity as jipa
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import affinity as taffinity
from kubernetes_tpu_torch.ops import labelsets as tlabelsets
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import interpodaffinity as tipa

HOST = "kubernetes.io/hostname"
ZONE = "topology.kubernetes.io/zone"
ZONES = ("z1", "z2", "z3")
APPS = ("web", "db", "cache", "batch")
NAMESPACES = {"default": {"team": "a"}, "other": {"team": "b"},
              "third": {"team": "a"}}
NS_SELECTORS = (None, None, {}, {"matchLabels": {"team": "a"}},
                {"matchLabels": {"team": "b"}})
N_PAD = 32


def _term(rng, key=None):
    t = {"labelSelector": {"matchLabels": {"app": rng.choice(APPS)}},
         "topologyKey": key or rng.choice((HOST, ZONE))}
    sel = rng.choice(NS_SELECTORS)
    if sel is not None:
        t["namespaceSelector"] = sel
    return t


def _affinity(rng, p_req=0.3, p_anti=0.4, p_pref=0.4):
    aff = {}
    if rng.random() < p_req:
        aff.setdefault("podAffinity", {})[
            "requiredDuringSchedulingIgnoredDuringExecution"] = [_term(rng)]
    if rng.random() < p_anti:
        aff.setdefault("podAntiAffinity", {})[
            "requiredDuringSchedulingIgnoredDuringExecution"] = [_term(rng)]
    if rng.random() < p_pref:
        kind = rng.choice(("podAffinity", "podAntiAffinity"))
        aff.setdefault(kind, {})[
            "preferredDuringSchedulingIgnoredDuringExecution"] = [{
                "weight": rng.choice((1, 10, 50)),
                "podAffinityTerm": _term(rng)}]
    return aff or None


def cluster_objects(seed: int, n_nodes: int = 20):
    """(node dicts, resident pod dicts by node name)."""
    rng = random.Random(seed)
    nodes, residents = [], {}
    for i in range(n_nodes):
        name = f"n{i}"
        labels = {}
        if rng.random() < 0.9:
            labels[ZONE] = rng.choice(ZONES)
        if rng.random() < 0.6:
            labels["tier"] = rng.choice(("fast", "slow"))
        taints = [{"key": "dedicated", "value": "infra",
                   "effect": "NoSchedule"}] if rng.random() < 0.15 else []
        nodes.append(make_node(name, labels=labels, taints=taints))
        residents[name] = [make_pod(
            f"res-{i}-{j}", labels={"app": rng.choice(APPS)},
            node_name=name, namespace=rng.choice(("default", "other")),
            affinity=_affinity(rng, 0.1, 0.25, 0.3))
            for j in range(rng.randrange(4))]
    return nodes, residents


def _constraint(rng, action):
    c = {"maxSkew": rng.choice((1, 2)),
         "topologyKey": rng.choice((ZONE, ZONE, HOST)),
         "whenUnsatisfiable": action,
         "labelSelector": {"matchLabels": {"app": rng.choice(APPS)}}}
    if rng.random() < 0.4:
        c["minDomains"] = rng.choice((2, 4, 6))
    if rng.random() < 0.3:
        c["namespaceSelector"] = {}
    return c


def pending_objects(seed: int, n: int = 16):
    rng = random.Random(seed)
    pods = []
    for i in range(n):
        cons = []
        if rng.random() < 0.5:
            cons = [_constraint(rng, rng.choice(
                ("DoNotSchedule", "ScheduleAnyway")))
                for _ in range(rng.choice((1, 2)))]
        pods.append(make_pod(
            f"pend-{i}", uid=f"u{i}",
            labels={"app": rng.choice(APPS)} if rng.random() < 0.9 else None,
            namespace=rng.choice(("default", "other")),
            affinity=_affinity(rng),
            node_selector={"tier": "fast"} if rng.random() < 0.3 else None,
            tolerations=[{"key": "dedicated", "operator": "Exists"}]
            if rng.random() < 0.3 else None,
            topology_spread_constraints=cons or None))
    return pods


def snapshot(types_mod, nodes, residents):
    infos = []
    for nd in nodes:
        ni = types_mod.NodeInfo(nd)
        for pd in residents[nd["metadata"]["name"]]:
            ni.add_pod(types_mod.PodInfo(pd))
        infos.append(ni)
    return types_mod.Snapshot(infos, 1)


class FakeNamespaceInformer:
    """`indexer.list()` over static Namespace objects."""

    class _Index:
        def __init__(self, items):
            self._items = items

        def list(self):
            return self._items

    def __init__(self, namespaces):
        self.indexer = self._Index([
            {"metadata": {"name": n, "labels": dict(labels)}}
            for n, labels in namespaces.items()])


def resolver(ipa_mod):
    r = ipa_mod.NamespaceResolver()
    r._informer = FakeNamespaceInformer(NAMESPACES)
    return r


def compilers(seed: int):
    nodes, residents = cluster_objects(seed)
    js = snapshot(jtypes, nodes, residents)
    ts = snapshot(ttypes, nodes, residents)
    jc = jaffinity.AffinityCompiler(js, N_PAD, ns_resolver=resolver(jipa))
    tc = taffinity.AffinityCompiler(ts, N_PAD, ns_resolver=resolver(tipa))
    return js, ts, jc, tc


def same(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("seed", range(4))
def test_label_and_topology_tables_match(seed):
    nodes, residents = cluster_objects(seed)
    js = snapshot(jtypes, nodes, residents)
    ts = snapshot(ttypes, nodes, residents)
    jt = jlabelsets.LabelSigTable(js, N_PAD)
    tt = tlabelsets.LabelSigTable(ts, N_PAD)
    assert list(tt.sigs) == list(jt.sigs)
    same(tt.node_sig_count, jt.node_sig_count, "node_sig_count")
    rng = random.Random(seed)
    for _ in range(8):
        sel = {"matchLabels": {"app": rng.choice(APPS)}}
        nses = rng.choice((("default",), ("default", "other"), ("*",)))
        same(tt.match_vec(sel, nses), jt.match_vec(sel, nses), "match_vec")
    jtop = jlabelsets.TopologyTable(js.nodes, N_PAD)
    ttop = tlabelsets.TopologyTable(ts.nodes, N_PAD)
    for key in (ZONE, HOST, "tier", "missing"):
        (jd, jn), (td, tn) = jtop.domains(key), ttop.domains(key)
        assert tn == jn
        same(td, jd, key)
        same(ttop.has_key(key), jtop.has_key(key), key)
    vals = np.arange(N_PAD, dtype=np.float32)
    ids, num = jtop.domains(ZONE)
    same(taffinity._seg_sum(vals, ids, num), jaffinity._seg_sum(vals, ids,
                                                                num), "seg")


@pytest.mark.parametrize("seed", range(6))
def test_compiler_rows_are_bitwise_the_reference(seed):
    js, ts, jc, tc = compilers(seed)
    feasible = np.zeros((N_PAD,), np.bool_)
    rng = random.Random(100 + seed)
    feasible[: len(js.nodes)] = [rng.random() < 0.8
                                 for _ in range(len(js.nodes))]
    checked = 0
    for pod in pending_objects(seed):
        jp, tp = jtypes.PodInfo(pod), ttypes.PodInfo(pod)
        what = f"seed {seed} pod {tp.key}"
        same(tc.filter_row(tp), jc.filter_row(jp), what + " filter_row")
        same(tc.symmetry_mask(tp), jc.symmetry_mask(jp), what + " symmetry")
        same(tc.eligibility_row(tp), jc.eligibility_row(jp),
             what + " eligibility")
        for hw in (1.0, 3.0):
            same(tc.score_row(tp, hw, feasible),
                 jc.score_row(jp, hw, feasible), what + " score_row")
        for t in tp.required_affinity_terms:
            jpres = jc.affinity_term_presence(t, jp.namespace)
            tpres = tc.affinity_term_presence(t, tp.namespace)
            same(tpres[0], jpres[0], what + " presence")
            same(tpres[1], jpres[1], what + " has_key")
            assert tpres[2] == jpres[2]
        cons = tp.topology_spread_constraints
        if cons:
            same(tc.spread_filter_row(tp, cons),
                 jc.spread_filter_row(jp, cons), what + " spread_filter")
            same(tc.spread_raw_scores(tp, cons),
                 jc.spread_raw_scores(jp, cons), what + " spread_raw")
            for c in cons:
                nses = tc.spread_constraint_ns(c, tp.namespace)
                assert nses == jc.spread_constraint_ns(c, jp.namespace)
                same(tc.counts_for(c.get("labelSelector"), nses),
                     jc.counts_for(c.get("labelSelector"), nses),
                     what + " counts_for")
            checked += 1
    assert checked


def test_min_domains_deficit_and_static_resolution():
    """A minDomains deficit floors the global minimum to 0 in both
    compilers; without a resolver a non-empty namespaceSelector resolves
    to the explicit namespaces only, `{}` to every namespace."""
    nodes = [make_node(f"n{i}", labels={ZONE: z})
             for i, z in enumerate(("z1", "z1", "z2"))]
    residents = {"n0": [make_pod("r0", labels={"app": "m"},
                                 node_name="n0")],
                 "n1": [make_pod("r1", labels={"app": "m"},
                                 node_name="n1")], "n2": []}
    cons = [{"maxSkew": 2, "topologyKey": ZONE, "minDomains": 3,
             "whenUnsatisfiable": "DoNotSchedule",
             "labelSelector": {"matchLabels": {"app": "m"}}}]
    pod = make_pod("p", labels={"app": "m"}, uid="u",
                   topology_spread_constraints=cons)
    jc = jaffinity.AffinityCompiler(snapshot(jtypes, nodes, residents), 8)
    tc = taffinity.AffinityCompiler(snapshot(ttypes, nodes, residents), 8)
    row = tc.spread_filter_row(ttypes.PodInfo(pod), cons)
    same(row, jc.spread_filter_row(jtypes.PodInfo(pod), cons), "deficit")
    assert list(row[:3]) == [False, False, True]
    for sel in ({}, {"matchLabels": {"team": "a"}}):
        t = {"topologyKey": ZONE, "namespaceSelector": sel,
             "namespaces": ["other"]}
        assert tipa.resolve_term_namespaces(t, "default") == \
            jipa.resolve_term_namespaces(t, "default")
    assert tipa.resolve_term_namespaces(
        {"namespaceSelector": {}}, "x") == ("*",)
