"""The port's InterPodAffinity and PodTopologySpread plugins against the
JAX package's on the CPU.

Seeded clusters and pending pods (the generators of
tests/test_torch_affinity.py: required, preferred and anti-affinity terms
with namespaceSelector terms; hard and soft spread constraints with
minDomains, `{}` namespace selectors and restricted eligibility; labeled
pods that take the system default constraints) go through each plugin's
PreFilter, Filter (every node), PreScore, Score (every node) and
NormalizeScore in both packages, each InterPodAffinity wired to a
namespace resolver over the same Namespace labels. Status codes and
reasons, and every score before and after normalization, are identical:
no tolerance.
"""

import random

import pytest

from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import interpodaffinity as jipa
from kubernetes_tpu.scheduler.plugins import podtopologyspread as jpts
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import interpodaffinity as tipa
from kubernetes_tpu_torch.scheduler.plugins import podtopologyspread as tpts
from test_torch_affinity import (cluster_objects, pending_objects, resolver,
                                 snapshot)

PTS_ARGS = (None, {"defaultingType": "List"},
            {"defaultConstraints": [{
                "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
                "whenUnsatisfiable": "ScheduleAnyway"}]})


def status(st):
    return (st.code, list(st.reasons))


def run_plugin(plugin, framework, snap, pod):
    """Every extension point of one plugin for one pod: statuses, raw
    and normalized scores."""
    out = {}
    state = framework.CycleState()
    st = plugin.pre_filter(state, pod, snap)
    out["pre_filter"] = status(st)
    out["filter"] = [status(plugin.filter(state, pod, ni))
                     for ni in snap.nodes] if not st.is_skip() else None
    nodes = list(snap.nodes)
    state = framework.CycleState()
    st = plugin.pre_score(state, pod, nodes)
    out["pre_score"] = status(st)
    if not st.is_skip():
        scores = {ni.name: plugin.score(state, pod, ni) for ni in nodes}
        out["score"] = dict(scores)
        plugin.normalize_scores(state, pod, scores)
        out["normalized"] = scores
    return out


@pytest.mark.parametrize("seed", range(6))
def test_inter_pod_affinity_matches_reference(seed):
    nodes, residents = cluster_objects(seed)
    js = snapshot(jtypes, nodes, residents)
    ts = snapshot(ttypes, nodes, residents)
    hw = random.Random(seed).choice((1, 3))
    jp = jipa.InterPodAffinity({"hardPodAffinityWeight": hw})
    tp = tipa.InterPodAffinity({"hardPodAffinityWeight": hw})
    jp.ns_resolver, tp.ns_resolver = resolver(jipa), resolver(tipa)
    active = 0
    for pod in pending_objects(seed, 24):
        want = run_plugin(jp, jframework, js, jtypes.PodInfo(pod))
        got = run_plugin(tp, tframework, ts, ttypes.PodInfo(pod))
        assert got == want, pod["metadata"]["name"]
        active += want["filter"] is not None
    assert active
    assert tp.EVENTS == jp.EVENTS and tp.hard_pod_affinity_weight == hw


@pytest.mark.parametrize("args", PTS_ARGS, ids=("system", "list", "custom"))
@pytest.mark.parametrize("seed", range(4))
def test_pod_topology_spread_matches_reference(seed, args):
    nodes, residents = cluster_objects(seed)
    js = snapshot(jtypes, nodes, residents)
    ts = snapshot(ttypes, nodes, residents)
    jp, tp = jpts.PodTopologySpread(args), tpts.PodTopologySpread(args)
    jp.ns_resolver, tp.ns_resolver = resolver(jipa), resolver(tipa)
    scored = 0
    for pod in pending_objects(seed, 24):
        jpi, tpi = jtypes.PodInfo(pod), ttypes.PodInfo(pod)
        for action in ("DoNotSchedule", "ScheduleAnyway"):
            assert tp._constraints_for(tpi, action) == \
                jp._constraints_for(jpi, action)
        want = run_plugin(jp, jframework, js, jpi)
        got = run_plugin(tp, tframework, ts, tpi)
        assert got == want, pod["metadata"]["name"]
        scored += "score" in want
    assert scored
    assert tp.EVENTS == jp.EVENTS
    assert tpts.DEFAULT_CONSTRAINTS == jpts.DEFAULT_CONSTRAINTS
