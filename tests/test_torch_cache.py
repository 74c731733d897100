"""The port's SchedulerCache and incremental ClusterTensors against the JAX
package.

One seeded event sequence — node adds, assumes, finish_binding, forget,
confirms (on the assumed node and on another), a cordon, a node removal
and a re-add, TTL expiry, pod updates and removals — runs through both
packages' caches. After each step both hand out equal snapshots: node
names and order, each node's requested / nonzero-requested resources, pod
count, pod keys, generation and spec epoch, the snapshot's generation,
`set_epoch`, `spec_seq`, and `changed_since(g)` for every earlier
snapshot's generation g. `light_snapshot` is held the same way, and the
stale-snapshot case (a light snapshot's maintenance must invalidate the
cached full snapshot) is checked on both.

ClusterTensors built incrementally off those snapshots (`prev=` the
previous build) must equal a from-scratch build of the port and the JAX
build, array for array; the O(changed) `_init_delta` path (which shares the
static arrays with `prev`) must be taken exactly when the node set and
node objects are unchanged, and not after a node add, a removal or a
cordon. Tolerance: none — everything compared is an integer, a bool or a
name.
"""

import numpy as np
import pytest

from kubernetes_tpu.ops import tensorize as jtensorize
from kubernetes_tpu.scheduler import cache as jcache
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import tensorize as ttensorize
from kubernetes_tpu_torch.scheduler import cache as tcache
from kubernetes_tpu_torch.scheduler import types as ttypes

SHAPES = ({"cpu": "4", "memory": "8Gi", "pods": "10"},
          {"cpu": "8", "memory": "32Gi", "pods": "110"},
          {"cpu": "16", "memory": "64Gi", "pods": "30",
           "example.com/gpu": "2"})
TTL = 30.0


def _node(i: int, **kw):
    taints = [{"key": "dedicated", "value": "infra",
               "effect": "NoSchedule"}] if i % 4 == 2 else None
    return make_node(f"n{i}", allocatable=dict(SHAPES[i % 3]),
                     taints=taints, **kw)


def _pod(k: int, rng, node_name: str | None = None):
    req = {"cpu": f"{int(rng.choice([100, 250, 500]))}m",
           "memory": f"{int(rng.choice([128, 256, 1024]))}Mi"}
    if k % 6 == 5:
        req = {}                            # best effort: nonzero defaults
    return make_pod(f"p{k}", uid=f"u{k}", requests=req, node_name=node_name)


def drive(cache_mod, types_mod, seed: int = 3):
    """Run the event sequence; returns the list of (tag, snapshot view,
    changed_since over every earlier snapshot generation, expired keys)
    after each step."""
    rng = np.random.default_rng(seed)
    cache = cache_mod.SchedulerCache(assumed_pod_ttl=TTL)
    views = []
    gens: list[int] = []

    def snap(tag, light=False, expired=()):
        s = cache.light_snapshot() if light else cache.update_snapshot()
        views.append((tag, view(s),
                      [None if (c := s.changed_since(g)) is None
                       else sorted(c) for g in gens],
                      list(expired)))
        gens.append(s.generation)
        return s

    for i in range(12):
        cache.add_node(_node(i))
    snap("nodes")
    names = [f"n{i}" for i in range(12)]
    placed = {}
    for k in range(24):
        node = names[int(rng.integers(0, len(names)))]
        pi = types_mod.PodInfo(_pod(k, rng))
        cache.assume_pod(pi, node)
        placed[pi.key] = (k, node)
        if k % 3 == 0:
            cache.finish_binding(pi.key, now=100.0)
        elif k % 4 == 1:
            cache.finish_binding(pi.key, now=500.0)
        if k % 5 == 2:                      # confirmed where assumed
            cache.add_pod(types_mod.PodInfo(
                _pod(k, np.random.default_rng(k), node_name=node)))
        if k % 7 == 3:
            cache.forget_pod(pi.key)
            del placed[pi.key]
        if k % 6 == 0:
            snap(f"assumes-{k}", light=bool(k % 12))
    # A confirm that names another node than the assumed one moves the pod.
    key, (k, node) = next(iter(placed.items()))
    other = names[(names.index(node) + 1) % len(names)]
    cache.add_pod(types_mod.PodInfo(
        _pod(k, np.random.default_rng(k), node_name=other)))
    snap("moved")
    cache.update_node(_node(3, unschedulable=True))
    snap("cordon")
    cache.remove_node("n5")
    snap("remove")
    cache.add_node(_node(12))
    snap("add", light=True)
    expired = cache.cleanup_expired(now=100.0 + TTL + 1)
    snap("expire", expired=expired)
    # update_pod re-homes a pod; remove_pod drops one.
    k2, node2 = next(v for v in placed.values() if v[1] != "n5")
    cache.update_pod(types_mod.PodInfo(
        _pod(k2, np.random.default_rng(k2), node_name="n12")))
    cache.remove_pod(next(iter(placed)))
    snap("update-remove")
    cache.update_snapshot()
    snap("clean")
    return views, cache


def view(s):
    return dict(
        generation=s.generation, set_epoch=s.set_epoch, spec_seq=s.spec_seq,
        nodes=[(ni.name, dict(ni.requested.res), ni.requested.pods,
                dict(ni.nonzero_requested.res), ni.generation, ni.spec_epoch,
                ni.unschedulable, [p.key for p in ni.pods])
               for ni in s.nodes],
        by_name=sorted(n.name for n in s.nodes if s.get(n.name) is n))


def test_event_sequence_gives_equal_snapshots():
    want, jc = drive(jcache, jtypes)
    got, tc = drive(tcache, ttypes)
    assert [v[0] for v in got] == [v[0] for v in want]
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert tc.pod_count() == jc.pod_count()
    # The sequence exercised every path it names.
    tags = {v[0]: v for v in got}
    assert tags["expire"][3], "no assumed pod expired"
    # A removal re-snapshots in full: the changed-log window restarts.
    assert all(c is None for c in tags["remove"][2])
    assert tags["assumes-6"][2][-1] and tags["clean"][2][-1] == []


@pytest.mark.parametrize("cache_mod,types_mod", [(jcache, jtypes),
                                                 (tcache, ttypes)])
def test_light_snapshot_invalidates_cached_full_snapshot(cache_mod,
                                                         types_mod):
    cache = cache_mod.SchedulerCache()
    for i in range(4):
        cache.add_node(make_node(f"n{i}"))
    a = cache.update_snapshot()
    pi = types_mod.PodInfo(make_pod("ls-p0", uid="ls-p0",
                                    requests={"cpu": "1"}))
    cache.assume_pod(pi, "n0")
    light = cache.light_snapshot()
    assert light.get("n0").requested.get("cpu") == 1000
    b = cache.update_snapshot()
    assert b is not a
    assert b.get("n0").requested.get("cpu") == 1000
    # the clean path still memoizes once no mutation intervenes
    assert cache.update_snapshot() is b


ARRAYS = ("alloc_q", "used_q", "used_nz_q", "alloc_pods", "used_pods",
          "taint_filter_mat", "taint_prefer_mat")


def _same(a, b) -> bool:
    if a.node_names != b.node_names or a.resources != b.resources \
            or a.scales != b.scales or a.n_pad != b.n_pad \
            or list(a.node_gens) != list(b.node_gens):
        return False
    return all(np.array_equal(getattr(a, k), getattr(b, k)) for k in ARRAYS)


def _both(cache_mods):
    """Drive one sequence of cache events through both packages, yielding
    after each step (tag, JAX snapshot, port snapshot)."""
    (jc, jt), (tc, tt) = cache_mods
    caches = (jc.SchedulerCache(), tc.SchedulerCache())
    rng = np.random.default_rng(11)

    def each(fn):
        for c, t in zip(caches, (jt, tt)):
            fn(c, t)

    def snaps(tag):
        return (tag,) + tuple(c.update_snapshot() for c in caches)

    each(lambda c, t: [c.add_node(_node(i)) for i in range(10)])
    yield snaps("nodes")
    for step in range(4):
        ks = [int(rng.integers(0, 1000)) + 1000 * step for _ in range(5)]
        nodes = [f"n{int(rng.integers(0, 10))}" for _ in ks]
        each(lambda c, t: [c.assume_pod(t.PodInfo(_pod(
            k, np.random.default_rng(k))), n) for k, n in zip(ks, nodes)])
        yield snaps(f"assumes-{step}")
    each(lambda c, t: c.add_node(_node(10)))
    yield snaps("node-add")
    each(lambda c, t: c.assume_pod(t.PodInfo(_pod(
        7, np.random.default_rng(7))), "n10"))
    yield snaps("assume-after-add")
    each(lambda c, t: c.remove_node("n2"))
    yield snaps("remove")
    each(lambda c, t: c.assume_pod(t.PodInfo(_pod(
        8, np.random.default_rng(8))), "n4"))
    yield snaps("assume-after-remove")
    each(lambda c, t: c.update_node(_node(6, unschedulable=True)))
    yield snaps("cordon")
    each(lambda c, t: c.forget_pod("default/p8"))
    yield snaps("forget")


def test_incremental_cluster_tensors_match_full_build_and_reference():
    jprev = tprev = None
    delta_taken = {}
    for tag, jsnap, tsnap in _both(((jcache, jtypes), (tcache, ttypes))):
        jct = jtensorize.ClusterTensors(jsnap, prev=jprev)
        tct = ttensorize.ClusterTensors(tsnap, prev=tprev)
        scratch = ttensorize.ClusterTensors(tsnap)
        assert _same(tct, scratch), tag
        assert _same(tct, jct), tag
        assert (tct.set_epoch, tct.spec_seq, tct.generation) \
            == (jct.set_epoch, jct.spec_seq, jct.generation), tag
        if tprev is not None:
            delta_taken[tag] = tct.alloc_q is tprev.alloc_q
            assert (jct.alloc_q is jprev.alloc_q) == delta_taken[tag], tag
        jprev, tprev = jct, tct
    assert delta_taken == {
        "assumes-0": True, "assumes-1": True, "assumes-2": True,
        "assumes-3": True, "node-add": False, "assume-after-add": True,
        "remove": False, "assume-after-remove": True, "cordon": False,
        "forget": True}


def test_full_build_copies_previous_arrays_for_bare_snapshots():
    """A snapshot without the cache's handles takes the full build; with
    the same node set it copies `prev`'s arrays and re-quantizes only the
    nodes whose generation moved, and never writes `prev`'s arrays."""
    infos = [ttypes.NodeInfo(_node(i)) for i in range(6)]
    first = ttensorize.ClusterTensors(ttypes.Snapshot(infos, 1))
    before = first.used_q.copy()
    infos[2].add_pod(ttypes.PodInfo(_pod(1, np.random.default_rng(1))))
    infos[2].generation = 5
    second = ttensorize.ClusterTensors(ttypes.Snapshot(infos, 2),
                                       prev=first)
    assert second.alloc_q is not first.alloc_q
    assert np.array_equal(first.used_q, before)
    assert _same(second, ttensorize.ClusterTensors(ttypes.Snapshot(infos, 2)))
    assert second.taints is first.taints
