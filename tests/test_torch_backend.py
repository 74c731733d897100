"""The port's batch cycle against the JAX backend, end to end on the CPU.

A seeded 48-node cluster — mixed node sizes, NoSchedule and
PreferNoSchedule taints, one unschedulable node, zone labels for a node
selector, resident pods — and ~80 pending pods from three templates, a few
pinned by nodeName (exception columns) and a few that fit nowhere, go
through the reference `TPUBackend.assign` (greedy mode, shortlist off, the
Pallas kernel in interpret mode, W=8) and the port's
`TorchBackend(device="cpu").assign` at the same width. Assignments must be
identical and the unschedulable pods' diagnostics must give the same
reasons. The fused device program is also compared directly:
`mask_solve_update` on inputs carried across by `ops/convert.py` against
`_mask_solve_update` — masks and integers equal (the program's only float
output, the spread counts, is a pass-through off this route).
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.utils import flags as jflags
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.ops import convert
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry

WAVE_W = 8
SLICE_PLUGINS = list(tregistry.DEFAULT_PLUGINS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def cluster_objects(seed: int = 7):
    """(node dicts, resident pod dicts by node name, pending pod dicts)."""
    rng = np.random.default_rng(seed)
    zones = ("zone-a", "zone-b", "zone-c")
    shapes = ({"cpu": "4", "memory": "8Gi", "pods": "10"},
              {"cpu": "8", "memory": "32Gi", "pods": "20"},
              {"cpu": "16", "memory": "64Gi", "pods": "30"})
    nodes, residents = [], {}
    for i in range(48):
        name = f"node-{i}"
        taints = []
        if i % 7 == 3:
            taints.append({"key": "dedicated", "value": "infra",
                           "effect": "NoSchedule"})
        if i % 5 == 1:
            taints.append({"key": "spot", "value": "true",
                           "effect": "PreferNoSchedule"})
        nodes.append(make_node(
            name, labels={"topology.kubernetes.io/zone": zones[i % 3]},
            allocatable=dict(shapes[int(rng.integers(0, 3))]),
            taints=taints, unschedulable=(i == 11)))
        residents[name] = [make_pod(
            f"resident-{i}-{k}", requests={"cpu": "500m", "memory": "1Gi"},
            node_name=name) for k in range(int(rng.integers(0, 3)))]
    pending = []
    for i in range(72):
        t = i % 3
        if t == 0:
            pending.append(make_pod(
                f"web-{i}", requests={"cpu": "1", "memory": "2Gi"}))
        elif t == 1:
            pending.append(make_pod(
                f"zonal-{i}", requests={"cpu": "2", "memory": "4Gi"},
                node_selector={"topology.kubernetes.io/zone": "zone-b"}))
        else:
            pending.append(make_pod(
                f"infra-{i}", requests={"cpu": "500m", "memory": "1Gi"},
                tolerations=[{"key": "dedicated", "operator": "Equal",
                              "value": "infra", "effect": "NoSchedule"}],
                affinity={"nodeAffinity": {
                    "preferredDuringSchedulingIgnoredDuringExecution": [{
                        "weight": 5, "preference": {"matchExpressions": [{
                            "key": "topology.kubernetes.io/zone",
                            "operator": "In", "values": ["zone-c"]}]}}]}}))
    for i in (2, 20, 40):
        pending.append(make_pod(f"pinned-{i}", requests={"cpu": "1"},
                                node_name=f"node-{i}"))
    pending.append(make_pod("pinned-cordoned", node_name="node-11"))
    for i in range(3):
        pending.append(make_pod(f"huge-{i}", requests={"cpu": "64"}))
    return nodes, residents, pending


def _snapshot(types_mod, nodes, residents):
    infos = []
    for nd in nodes:
        ni = types_mod.NodeInfo(nd)
        for pd in residents[nd["metadata"]["name"]]:
            ni.add_pod(types_mod.PodInfo(pd))
        infos.append(ni)
    return types_mod.Snapshot(infos, 1)


def _jax_run(nodes, residents, pending):
    snap = _snapshot(jtypes, nodes, residents)
    fwk = jframework.Framework(jregistry.build_plugins(SLICE_PLUGINS),
                               jregistry.DEFAULT_SCORE_WEIGHTS)
    pods = [jtypes.PodInfo(p) for p in pending]
    b = jbackend.TPUBackend(max_batch=32, multistart=4, mesh=None)
    with jflags.scoped_set("KTPU_SOLVE_MODE", "greedy"), \
            jflags.scoped_set("KTPU_SHORTLIST_K", 0), \
            jflags.scoped_set("KTPU_PALLAS", "interpret"), \
            jflags.scoped_set("KTPU_WAVE_WIDTH", WAVE_W):
        assignments, diagnostics = b.assign(pods, snap, fwk)
    return b, snap, fwk, pods, assignments, diagnostics


@pytest.fixture(scope="module")
def runs():
    nodes, residents, pending = cluster_objects()
    jb, jsnap, jfwk, jpods, jassign, jdiag = _jax_run(nodes, residents,
                                                      pending)
    snap = _snapshot(ttypes, nodes, residents)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    tb = tbackend.TorchBackend(device="cpu", max_batch=32, multistart=4)
    with jflags.scoped_set("KTPU_WAVE_WIDTH", WAVE_W):
        tassign, tdiag = tb.assign([ttypes.PodInfo(p) for p in pending],
                                   snap, fwk)
    return dict(jax=(jb, jsnap, jfwk, jpods, jassign, jdiag),
                torch=(tb, tassign, tdiag))


def test_assignments_identical(runs):
    jassign = runs["jax"][4]
    tassign = runs["torch"][1]
    assert tassign == jassign
    placed = sum(v is not None for v in tassign.values())
    assert 0 < placed < len(tassign)
    assert tassign["default/pinned-20"] == "node-20"
    assert tassign["default/pinned-cordoned"] is None
    assert all(tassign[f"default/huge-{i}"] is None for i in range(3))


def test_diagnostics_give_the_same_reasons(runs):
    jdiag = runs["jax"][5]
    tdiag = runs["torch"][2]
    assert set(tdiag) == set(jdiag) and tdiag
    for key, dm in jdiag.items():
        assert tdiag[key].reason_counts == dm.reason_counts, key
        assert tdiag[key].plugins == dm.plugins, key
        assert tdiag[key].resolvable == dm.resolvable, key


def test_fused_program_matches_reference(runs):
    """`mask_solve_update` vs `_mask_solve_update` on the first chunk's
    state, carried across by ops/convert.py."""
    jb, jsnap, jfwk, jpods, _, _ = runs["jax"]
    with jflags.scoped_set("KTPU_SOLVE_MODE", "greedy"), \
            jflags.scoped_set("KTPU_SHORTLIST_K", 0), \
            jflags.scoped_set("KTPU_PALLAS", "interpret"), \
            jflags.scoped_set("KTPU_WAVE_WIDTH", WAVE_W):
        ctx = jb._start(jpods, jsnap, jfwk)
        prep = jb._prep_chunk(ctx.chunks[0], ctx)
    st = jb.ensure_static(ctx.ct)
    p = ctx.params
    named = dict(alloc_q=st["alloc_q"], used_pack=jb._dev_used,
                 alloc_pods=st["alloc_pods"], class_pack=prep["dev_pack"],
                 cls_idx=prep["dev_cls"], exc_col=prep["dev_exc"],
                 taint_f_mat=st["taint_f"], taint_p_mat=st["taint_p"],
                 class_mask=prep["dev_mask"],
                 class_scores=prep["dev_scores"], perms=prep["dev_perms"])
    gang = jb._gang_args(prep, prep["batch"])
    P = prep["batch"].req_q.shape[0]
    spread = jb._spread_dummies(ctx.ct.n_pad, P)
    ref = jbackend._mask_solve_update(
        **named, fit_col_w=p["fit_col_w"], bal_col_mask=p["bal_col_mask"],
        shape_u=p["shape_u"], shape_s=p["shape_s"], w_fit=p["w_fit"],
        w_bal=p["w_bal"], w_taint=p["w_taint"],
        taint_filter_on=p["taint_filter_on"], dom_onehot=spread[0],
        cid_onehot=spread[1], dom_counts=spread[2], max_skew=spread[3],
        sp_min_ok=spread[4], sp_haskey=spread[5], sp_applies=spread[6],
        sp_contrib=spread[7], gang_onehot=gang[0],
        gang_required=gang[1], sink_iters=np.int32(1),
        sink_temp=np.float32(1.0), n_real=np.int32(ctx.ct.n_real),
        strategy=p["strategy"], use_spread=False, shortlist_k=0,
        wave_w=WAVE_W, solve_mode="greedy", pallas="interpret", block_w=0)
    ref = [np.asarray(x) for x in ref]
    kwargs = convert.mask_solve_inputs(
        **named, params=p, gang_onehot=gang[0], gang_required=gang[1],
        wave_w=WAVE_W, solve_mode="greedy", sink_iters=1, sink_temp=1.0,
        device="cpu")
    got = [x.numpy() for x in tbackend.mask_solve_update(**kwargs)]
    for name, g, r in zip(("assign", "used_pack", "fit0", "taint_ok"),
                          got, ref[:4]):
        assert g.dtype == r.dtype, name
        np.testing.assert_array_equal(g, r, err_msg=name)
    # The fifth output (the spread domain counts) passes through unchanged
    # on this non-spread route.
    np.testing.assert_array_equal(ref[4], np.asarray(spread[2]))
    assert (ref[0][:P] >= 0).any()


def test_unsupported_pods_raise():
    """Nothing a pod carries raises any more: volumes (the four volume
    plugins), resource claims and host ports are modelled (DynamicResources
    and NodePorts), as are inter-pod affinity, topology spread and gang
    labels, and each pod places or fails through its plugins (a claim with
    no claims informer wired fails DynamicResources' PreFilter, as in the
    reference; a PersistentVolumeClaim with no claims informer wired is
    skipped by VolumeBinding, VolumeZone and VolumeRestrictions, as in the
    reference; a gang label without Coscheduling in the profile means
    nothing)."""
    nodes, residents, _ = cluster_objects()
    snap = _snapshot(ttypes, nodes, residents)
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    tb = tbackend.TorchBackend(device="cpu", max_batch=32)
    claim = make_pod("claim")
    claim["spec"]["resourceClaims"] = [{"name": "gpu",
                                        "resourceClaimName": "c0"}]
    pvc = make_pod("pvc")
    pvc["spec"]["volumes"] = [{"name": "data", "persistentVolumeClaim": {
        "claimName": "data-0"}}]
    got, _ = tb.assign([ttypes.PodInfo(pvc)], snap, fwk)
    assert got["default/pvc"] is not None
    assert tb.counters["chunks"] == 1
    got, diag = tb.assign([ttypes.PodInfo(claim), ttypes.PodInfo(
        make_pod("ports", host_ports=[8080]))], snap, fwk)
    assert got["default/claim"] is None
    assert "DynamicResources" in diag["default/claim"].plugins
    assert got["default/ports"] is not None
    spread = make_pod("spread", topology_spread_constraints=[{
        "maxSkew": 1, "topologyKey": "topology.kubernetes.io/zone",
        "whenUnsatisfiable": "DoNotSchedule"}])
    anti = make_pod("anti", affinity={"podAntiAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "x"}}}]}})
    gang = make_pod("gang", labels={tbackend.POD_GROUP_LABEL: "g1"})
    got, _ = tb.assign([ttypes.PodInfo(spread), ttypes.PodInfo(anti),
                        ttypes.PodInfo(gang)], snap, fwk)
    assert got["default/spread"] is not None
    assert got["default/anti"] is not None
    assert got["default/gang"] is not None


def test_per_pod_planes_match_class_planes(runs):
    """KTPU_CLASS_PLANES=0 (per-pod planes, C == P, identity class index)
    places every pod exactly as the class-dictionary planes do."""
    nodes, residents, pending = cluster_objects()
    fwk = tframework.Framework(tregistry.build_plugins(),
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    tb = tbackend.TorchBackend(device="cpu", max_batch=32, multistart=4)
    with jflags.scoped_set("KTPU_WAVE_WIDTH", WAVE_W), \
            jflags.scoped_set("KTPU_CLASS_PLANES", 0):
        got, _ = tb.assign([ttypes.PodInfo(p) for p in pending],
                           _snapshot(ttypes, nodes, residents), fwk)
    assert got == runs["torch"][1]
