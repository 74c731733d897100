"""The port's serving tier on the CPU against the JAX package.

- `ResidentPlanes` across the node lifecycle (assumes, a node add, a
  removal, a cordon): the host mirror and the device pack equal a fresh
  pack of the ClusterTensors, and `full_rebuilds`, `row_refreshes` and
  `block_aggregates()` equal the JAX `ResidentPlanes`' over the same
  sequence (at the tuner's block width and at 8). The device pack owns its
  memory: after a refresh and before its delta is applied it still holds
  the old row.
- The randomized fast-path differential (the reference's
  `tests/test_serving_smoke.py` case, widened to a heterogeneous cluster
  and 96 rounds): the port's `try_schedule` equals the JAX `try_schedule`
  and the port's `TorchBackend(device="cpu", max_batch=16).assign([pi])`
  for every pod, and the placed / ineligible / no_fit counts equal the
  reference's.
- Ineligible shapes fall through to None (inter-pod affinity, host ports,
  spread, a gang label, preferred node affinity, a nominated node), as they
  do in the reference's default profile; a framework with a plugin outside
  the port's six raises.
- A backend with resident planes attached assigns exactly as one without,
  seeds its chain from a copy, and leaves the resident pack bit-identical.
- `AdmissionWindow` and the tuner's serving rows against the reference's
  values.

Tolerance: none — nodes, packs, planes and counters are compared exactly.
"""

import numpy as np
import pytest
import torch

from kubernetes_tpu.ops import backend as jbackend
from kubernetes_tpu.scheduler import cache as jcache
from kubernetes_tpu.scheduler import framework as jframework
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.scheduler.plugins import registry as jregistry
from kubernetes_tpu.serving import admission as jadmission
from kubernetes_tpu.serving import fastpath as jfastpath
from kubernetes_tpu.serving import resident as jresident
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.ops import backend as tbackend
from kubernetes_tpu_torch.scheduler import cache as tcache
from kubernetes_tpu_torch.scheduler import framework as tframework
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.plugins import registry as tregistry
from kubernetes_tpu_torch.serving import (
    AdmissionWindow, ResidentPlanes, SinglePodFastPath)

SLICE_PLUGINS = list(tregistry.DEFAULT_PLUGINS)
SHAPES = ({"cpu": "4", "memory": "16Gi", "pods": "32"},
          {"cpu": "8", "memory": "32Gi", "pods": "110"},
          {"cpu": "16", "memory": "64Gi", "pods": "110"})


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _node(i: int, n: int = 0, hetero: bool = True, **kw):
    taints = []
    if i % 7 == 0:
        taints.append({"key": "dedicated", "value": "infra",
                       "effect": "NoSchedule"})
    if hetero and i % 11 == 5:
        taints.append({"key": "spot", "value": "true",
                       "effect": "PreferNoSchedule"})
    alloc = SHAPES[i % 3] if hetero else {"cpu": "8", "memory": "32Gi",
                                          "pods": "110"}
    return make_node(f"n{i}", allocatable=dict(alloc), taints=taints or None,
                     **kw)


class Pair:
    """One cluster held by both packages: a cache, a fast path over its
    resident planes, and the framework of the port's six plugins."""

    def __init__(self, n: int, hetero: bool = True, cordon: int | None = None):
        self.jc = jcache.SchedulerCache()
        self.tc = tcache.SchedulerCache()
        for i in range(n):
            self.add_node(_node(i, hetero=hetero,
                                unschedulable=(i == cordon)))
        self.jfwk = jframework.Framework(
            jregistry.build_plugins(SLICE_PLUGINS),
            jregistry.DEFAULT_SCORE_WEIGHTS)
        self.tfwk = tframework.Framework(tregistry.build_plugins(),
                                         tregistry.DEFAULT_SCORE_WEIGHTS)
        self.jb = jbackend.TPUBackend(max_batch=16, mesh=None)
        self.jres = jresident.ResidentPlanes(self.jb)
        self.jfp = jfastpath.SinglePodFastPath(self.jb, self.jres)
        self.tb = tbackend.TorchBackend(device="cpu", max_batch=16)
        self.tres = ResidentPlanes(self.tb)
        self.tfp = SinglePodFastPath(self.tb, self.tres)

    def add_node(self, node):
        self.jc.add_node(node)
        self.tc.add_node(node)

    def update_node(self, node):
        self.jc.update_node(node)
        self.tc.update_node(node)

    def remove_node(self, name):
        self.jc.remove_node(name)
        self.tc.remove_node(name)

    def assume(self, pod, node):
        self.jc.assume_pod(jtypes.PodInfo(pod), node)
        self.tc.assume_pod(ttypes.PodInfo(pod), node)

    def place(self, pod, light: bool = False, nominated: str = ""):
        """(JAX fast-path node, port fast-path node, the port's PodInfo)."""
        jpi, tpi = jtypes.PodInfo(pod), ttypes.PodInfo(pod)
        jpi.nominated_node = tpi.nominated_node = nominated
        if light:
            jsnap, tsnap = self.jc.light_snapshot(), self.tc.light_snapshot()
        else:
            jsnap, tsnap = self.jc.update_snapshot(), self.tc.update_snapshot()
        want = self.jfp.try_schedule(jpi, jsnap, self.jfwk)
        got = self.tfp.try_schedule(tpi, tsnap, self.tfwk)
        return want, got, tpi

    def counters(self, fp):
        return (fp.placed, fp.ineligible, fp.no_fit)


def _fresh_pack(ct):
    return np.concatenate([ct.used_q, ct.used_nz_q,
                           ct.used_pods.astype(np.int32)[:, None]], axis=1)


def _batch(tc, tfwk, tpi):
    """The port's batch path's first step for one pod, on a fresh backend."""
    b = tbackend.TorchBackend(device="cpu", max_batch=16)
    got, _ = b.assign([tpi], tc.update_snapshot(), tfwk)
    return got[tpi.key]


def _random_pod(t: int, rng, n: int) -> tuple[dict, str]:
    kw = {"requests": {
        "cpu": f"{int(rng.choice([100, 250, 500, 900, 1700]))}m",
        "memory": f"{int(rng.choice([128, 512, 1024, 3000]))}Mi"}}
    if rng.random() < 0.3:
        kw["tolerations"] = [{"key": "dedicated", "operator": "Exists"}]
    if rng.random() < 0.25:
        kw["node_selector"] = {
            "kubernetes.io/hostname": f"n{int(rng.integers(0, n))}"}
    kind = "plain"
    u = rng.random()
    if u < 0.05:
        kw["requests"] = {"cpu": "64"}                  # fits nowhere
        kind = "huge"
    elif u < 0.09:
        kw["affinity"] = {"nodeAffinity": {
            "preferredDuringSchedulingIgnoredDuringExecution": [{
                "weight": 5, "preference": {"matchExpressions": [{
                    "key": "kubernetes.io/hostname", "operator": "In",
                    "values": ["n1"]}]}}]}}
        kind = "preferred"
    elif u < 0.12:
        kind = "nominated"
    elif u < 0.15:
        kw["requests"] = {"cpu": "100m", "example.com/fpga": "1"}
        kind = "unknown-resource"
    return make_pod(f"p{t}", uid=f"u{t}", **kw), kind


def test_randomized_fast_path_matches_reference_and_batch_path():
    n = 150
    pair = Pair(n, cordon=13)
    rng = np.random.default_rng(0xBEEF)
    checked = 0
    kinds = set()
    for t in range(96):
        pod, kind = _random_pod(t, rng, n)
        kinds.add(kind)
        want, got, tpi = pair.place(
            pod, light=bool(t % 2),
            nominated="n0" if kind == "nominated" else "")
        assert got == want, (t, kind)
        if kind == "plain":
            assert got == _batch(pair.tc, pair.tfwk, tpi), (t, kind)
        else:
            assert got is None, (t, kind)
        if got is not None:
            checked += 1
            assert got != "n13"                          # cordoned
            pair.assume(pod, got)
    assert kinds == {"plain", "huge", "preferred", "nominated",
                     "unknown-resource"}
    assert checked >= 48
    assert pair.counters(pair.tfp) == pair.counters(pair.jfp)
    assert pair.tfp.placed == checked
    assert pair.tres.row_refreshes == pair.jres.row_refreshes > 0
    assert pair.tres.full_rebuilds == pair.jres.full_rebuilds


def _check_planes(pair, tag):
    jct = pair.jb._tensors(pair.jc.update_snapshot())
    tct = pair.tb._tensors(pair.tc.update_snapshot())
    pair.jres.used_pack(jct)
    pair.tres.used_pack(tct)
    fresh = _fresh_pack(tct)
    assert np.array_equal(fresh, _fresh_pack(jct)), tag
    assert np.array_equal(pair.tres.host_mirror(), fresh), tag
    assert np.array_equal(pair.tres._dev.numpy(), fresh), tag
    assert (pair.tres.full_rebuilds, pair.tres.row_refreshes) \
        == (pair.jres.full_rebuilds, pair.jres.row_refreshes), tag
    tw, tplanes, tdev = pair.tres.block_aggregates()
    jw, jplanes, jdev = pair.jres.block_aggregates()
    assert tw == jw > 0, tag
    assert tplanes.keys() == jplanes.keys()
    for k in jplanes:
        assert np.array_equal(tplanes[k], jplanes[k]), (tag, k)
    assert np.array_equal(tdev.numpy(), np.asarray(jdev)), tag
    probe = make_pod(f"probe-{tag}", uid=f"probe-{tag}",
                     requests={"cpu": "250m", "memory": "256Mi"})
    want, got, tpi = pair.place(probe)
    assert got == want == _batch(pair.tc, pair.tfwk, tpi), tag


@pytest.mark.parametrize("block_width", [None, "8"])
def test_resident_planes_across_node_lifecycle(block_width, monkeypatch):
    if block_width is not None:
        monkeypatch.setenv("KTPU_BLOCK_WIDTH", block_width)
    pair = Pair(40, hetero=False)
    for t in range(10):
        pod = make_pod(f"w{t}", uid=f"w{t}",
                       requests={"cpu": "500m", "memory": "1Gi"})
        want, got, _ = pair.place(pod)
        assert got == want is not None
        pair.assume(pod, got)
    _check_planes(pair, "assume")
    assert pair.tres.row_refreshes > 0
    pair.add_node(make_node("extra-0"))
    _check_planes(pair, "node-add")
    pair.remove_node("n39")
    _check_planes(pair, "node-remove")
    # Cordon: NodeUnschedulable's static row flows into the fast path's
    # base mask, and the cordoned node never wins.
    pair.update_node(make_node("n0", unschedulable=True))
    _check_planes(pair, "cordon")
    want, got, _ = pair.place(make_pod("post-cordon", uid="post-cordon",
                                       requests={"cpu": "100m"}))
    assert got == want and got not in (None, "n0")


def test_resident_device_pack_owns_its_memory():
    """On the CPU `torch.from_numpy` shares the array's memory; refresh()
    writes the host mirror before the caller applies the delta, so a pack
    that shared the mirror would take the new row early."""
    cache = tcache.SchedulerCache()
    for i in range(8):
        cache.add_node(make_node(f"n{i}"))
    backend = tbackend.TorchBackend(device="cpu")
    res = ResidentPlanes(backend)
    snap = cache.update_snapshot()
    res.used_pack(backend._tensors(snap), snap)
    old = res._dev.clone()
    cache.assume_pod(ttypes.PodInfo(make_pod(
        "a", uid="a", requests={"cpu": "1", "memory": "1Gi"})), "n3")
    snap = cache.update_snapshot()
    ct = backend._tensors(snap)
    delta = res.refresh(ct, snap)
    assert delta is not None and list(delta[0]) == [3]
    assert not np.array_equal(res.host_mirror()[3], old[3].numpy())
    assert torch.equal(res._dev, old)
    res.apply_delta(delta)
    assert np.array_equal(res._dev.numpy(), _fresh_pack(ct))
    assert not np.array_equal(res._dev.numpy(), old.numpy())


def test_ineligible_shapes_fall_through():
    pair = Pair(20, hetero=False)
    aff = {"podAffinity": {
        "requiredDuringSchedulingIgnoredDuringExecution": [{
            "topologyKey": "kubernetes.io/hostname",
            "labelSelector": {"matchLabels": {"app": "x"}}}]}}
    preferred = {"nodeAffinity": {
        "preferredDuringSchedulingIgnoredDuringExecution": [{
            "weight": 1, "preference": {"matchExpressions": [{
                "key": "kubernetes.io/hostname", "operator": "In",
                "values": ["n1"]}]}}]}}
    cases = [
        make_pod("affinity", uid="u-aff", affinity=aff,
                 requests={"cpu": "100m"}),
        make_pod("ports", uid="u-port", host_ports=[8080],
                 requests={"cpu": "100m"}),
        make_pod("spread", uid="u-spr", requests={"cpu": "100m"},
                 labels={"app": "x"},
                 topology_spread_constraints=[{
                     "maxSkew": 1, "topologyKey": "kubernetes.io/hostname",
                     "whenUnsatisfiable": "DoNotSchedule",
                     "labelSelector": {"matchLabels": {"app": "x"}}}]),
        make_pod("gang", uid="u-gang", requests={"cpu": "100m"},
                 labels={tbackend.POD_GROUP_LABEL: "g1"}),
        make_pod("preferred", uid="u-pref", affinity=preferred,
                 requests={"cpu": "100m"}),
    ]
    # The reference's default profile (plus Coscheduling, which makes a
    # gang pod ineligible) rejects the same shapes.
    jfwk = jframework.Framework(
        jregistry.build_plugins(jregistry.DEFAULT_PLUGINS + ["Coscheduling"]),
        jregistry.DEFAULT_SCORE_WEIGHTS)
    jsnap, tsnap = pair.jc.update_snapshot(), pair.tc.update_snapshot()
    for pod in cases:
        name = pod["metadata"]["name"]
        assert pair.tfp.try_schedule(ttypes.PodInfo(pod), tsnap,
                                     pair.tfwk) is None, name
        assert pair.jfp.try_schedule(jtypes.PodInfo(pod), jsnap,
                                     jfwk) is None, name
    want, got, _ = pair.place(make_pod("nom", uid="u-nom",
                                       requests={"cpu": "100m"}),
                              nominated="n0")
    assert got is want is None
    assert pair.counters(pair.tfp) == (0, len(cases) + 1, 0)
    assert pair.counters(pair.jfp) == (0, len(cases) + 1, 0)
    # An eligible pod still places on this cluster.
    want, got, _ = pair.place(make_pod("ok", uid="u-ok",
                                       requests={"cpu": "100m"}))
    assert got == want is not None


def test_framework_with_an_unknown_plugin_raises():
    pair = Pair(4, hetero=False)

    class Extra:
        NAME = "InterPodAffinity"
        EXTENSION_POINTS = ("Filter",)

    fwk = tframework.Framework(tregistry.build_plugins() + [Extra()],
                               tregistry.DEFAULT_SCORE_WEIGHTS)
    pi = ttypes.PodInfo(make_pod("x", uid="x", requests={"cpu": "100m"}))
    with pytest.raises(NotImplementedError, match="InterPodAffinity"):
        pair.tfp.try_schedule(pi, pair.tc.update_snapshot(), fwk)
    with pytest.raises(NotImplementedError, match="InterPodAffinity"):
        pair.tfp.warm(pi, pair.tc.update_snapshot(), fwk)


def test_backend_with_resident_planes_assigns_as_without():
    pair = Pair(48, hetero=True, cordon=5)
    rng = np.random.default_rng(5)
    for t in range(12):                       # lone pods dirty some rows
        pod, kind = _random_pod(t, rng, 48)
        if kind != "plain":
            continue
        _, got, _ = pair.place(pod)
        if got is not None:
            pair.assume(pod, got)
    pods = [ttypes.PodInfo(_random_pod(100 + t, rng, 48)[0])
            for t in range(40)]
    pods = [pi for pi in pods if not pi.affinity]
    snap = pair.tc.update_snapshot()
    attached = pair.tb
    attached.resident = pair.tres
    ct = attached._tensors(snap)
    pair.tres.refresh(ct, snap)     # leave a delta pending for _start
    before = pair.tres.used_pack(ct, snap).clone()
    plain = tbackend.TorchBackend(device="cpu", max_batch=16)
    got, gdiag = attached.assign(pods, snap, pair.tfwk)
    want, wdiag = plain.assign(pods, snap, pair.tfwk)
    assert got == want
    assert sum(v is not None for v in got.values()) > 0
    assert set(gdiag) == set(wdiag)
    assert torch.equal(pair.tres._dev, before)
    # The chain is a copy: correcting it in place leaves the planes alone.
    attached._start(pods, snap, pair.tfwk)
    assert attached.used.pack.data_ptr() != pair.tres._dev.data_ptr()
    attached.used.fold_back(np.array([0], np.int64),
                            np.ones((1, before.shape[1]), np.int32))
    assert torch.equal(pair.tres._dev, before)


class TestAdmissionPolicy:
    """The reference's policy-row cases, on both tuners."""

    @pytest.mark.parametrize("tuner", [jbackend.AdaptiveTuner,
                                       tbackend.AdaptiveTuner])
    def test_policy_rows(self, tuner):
        assert tuner.admission_window(0.0, 0.0) == 0.0
        assert tuner.admission_window(0.0, 250.0) == 0.0
        w = tuner.admission_window(0.0, 1000.0)
        assert 0.0 < w <= tuner.ADMISSION_MAX_WINDOW_S
        assert tuner.admission_window(0.0, 100000.0) \
            == pytest.approx(8.0 / 100000.0)
        assert tuner.admission_window(0.030, 600.0) \
            > tuner.ADMISSION_MAX_WINDOW_S
        assert tuner.fast_path_cap(0.0, 0.0) == 250
        assert tuner.fast_path_cap(0.4, 2e-3) == 200
        assert tuner.fast_path_cap(0.01, 5e-3) == 8
        assert tuner.fast_path_cap(10.0, 1e-3) == 512
        assert tuner.fast_path_rate_limit(0.0) == pytest.approx(500.0)
        assert tuner.fast_path_rate_limit(0.6e-3) \
            == pytest.approx(833.3, rel=1e-3)
        assert tuner.fast_path_cap(0.0, 0.0, n_nodes=200_000) == 8
        assert tuner.fast_path_rate_limit(0.0, n_nodes=200_000) \
            == pytest.approx(12.5)

    def test_rows_equal_reference_on_a_grid(self):
        j, t = jbackend.AdaptiveTuner, tbackend.AdaptiveTuner
        names = [k for k in vars(j) if k.startswith(
            ("ADMISSION_", "FAST_PATH_"))] + ["LATENCY_BOUND_S",
                                              "BLOCK_WIDTH"]
        assert {k: getattr(t, k) for k in names} \
            == {k: getattr(j, k) for k in names}
        for lat in (0.0, 1e-3, 5e-3, 0.03):
            for rate in (0.0, 299.0, 300.0, 301.0, 2e3, 1e5):
                assert t.admission_window(lat, rate) \
                    == j.admission_window(lat, rate)
        for chunk in (0.0, 0.01, 0.25, 3.0):
            for fast in (0.0, 1e-4, 1e-3, 8e-3):
                for n in (0, 5000, 50_000, 200_000):
                    assert t.fast_path_cap(chunk, fast, n) \
                        == j.fast_path_cap(chunk, fast, n)
                    assert t.fast_path_rate_limit(fast, n) \
                        == j.fast_path_rate_limit(fast, n)

    def test_override_and_budget_gate(self, monkeypatch):
        monkeypatch.setenv("KTPU_ADMISSION_WINDOW", "2.5")
        for win in (AdmissionWindow(), jadmission.AdmissionWindow()):
            win.rate_est = 0.0
            assert win.window_for(1, 0, 64) == pytest.approx(2.5e-3)
            assert win.window_for(64, 0, 64) == 0.0
            assert win.window_for(1, 64, 64) == 0.0
        monkeypatch.setenv("KTPU_ADMISSION_WINDOW", "0")
        assert AdmissionWindow().window_for(1, 0, 64) == 0.0

    def test_rate_estimator_tracks_pops_as_reference(self):
        ours = AdmissionWindow(tbackend.AdaptiveTuner())
        ref = jadmission.AdmissionWindow()
        rng = np.random.default_rng(2)
        t = 100.0
        for _ in range(200):
            n = int(rng.integers(1, 4))
            ours.observe_pop(n, t)
            ref.observe_pop(n, t)
            assert ours.rate_est == ref.rate_est
            assert ours.window_for(n, 0, 64) == ref.window_for(n, 0, 64)
            t += float(rng.exponential(0.002))
        assert (ours.immediate_dispatches, ours.coalesce_windows) \
            == (ref.immediate_dispatches, ref.coalesce_windows)
        assert ours.coalesce_windows > 0


def test_resident_row_scatter_is_out_of_place_with_padded_rows():
    from kubernetes_tpu_torch.parallel import build_mesh, resident_row_scatter

    pack = torch.arange(40, dtype=torch.int32).reshape(8, 5)
    before = pack.clone()
    rows = torch.tensor([5, 2, 5, 5], dtype=torch.int32)   # padded bucket
    vals = torch.full((4, 5), -1, dtype=torch.int32)
    vals[1] = -2
    for mesh in (None, build_mesh(2, device="cpu")):
        got = resident_row_scatter(mesh)(pack, rows, vals)
        want = before.clone()
        want[5], want[2] = -1, -2
        assert torch.equal(got, want)
        assert torch.equal(pack, before)
