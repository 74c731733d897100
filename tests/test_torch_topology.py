"""The port's topology package (`kubernetes_tpu_torch/topology/`) against
the JAX package's on the CPU.

- The mesh model: `parse_mesh_shape` (explicit 2D/3D shapes, `:mesh`, the
  `auto` near-square torus — 64 nodes give 8x8, 256 give 16x16, 5000
  give 71x71 with 41 holes — and malformed values), `node_cell` (label
  first, the name's trailing integer, off-mesh), `normalize_shape` and
  the orientation order (the placement-id contract): equal.
- The host oracle (`oracle_scan`, `best_placement`, `placement_members`,
  `coverage`, `is_contiguous_slice`) on phase 16(a)'s small fixtures:
  equal.
- `device_scan` on the CPU against the JAX `device_scan` and the oracle on
  phase 16(a)'s fixtures at small size (the 4x4 torus, the walled 4x8
  mesh, the 3x5x2 torus, each with every shape of SCAN_SHAPES and its
  full span, under the fully free, random, symmetric-hole and wrap-band
  masks), and on the 71x71 auto torus of 5000 nodes and the 8x8x16 torus
  with a few shapes: keys, feasibility, frag and coverage bit-identical;
  `best_key` at 1, 4 and 8 shards equal to the JAX package's at each;
  `decode_key` and `fragmentation_pct` equal.
- The size contract: `device_scan` returns None at the same (mesh,
  shape) pairs as the reference, on both sides of the int32 overflow
  guard and where no orientation fits (the scan bodies are stubbed
  there: only the guard is under test).
- The coordinate planes: `TopologyPlanes` over labelled, name-indexed,
  colliding and off-mesh nodes equal; `build_topology_planes` reuses its
  planes until the mesh flag or a node's spec moves; `ClusterTensors`
  carries them in the full and the delta build only under KTPU_TOPOLOGY;
  the backend counts a rebuild once, not per assign.

Tolerance: none (integers and booleans).
"""

import numpy as np
import pytest
import torch

from chip_smoke import SCAN_SHAPES, scan_masks, scan_shapes
from kubernetes_tpu.topology import device as jdevice
from kubernetes_tpu.topology import mesh as jmesh
from kubernetes_tpu.topology import planes as jplanes
from kubernetes_tpu.topology import slices as jslices
from kubernetes_tpu.scheduler import types as jtypes
from kubernetes_tpu.api.types import make_node as jmake_node
from kubernetes_tpu_torch.api.types import make_node, make_pod
from kubernetes_tpu_torch.metrics.registry import SchedulerMetrics
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.ops.tensorize import ClusterTensors
from kubernetes_tpu_torch.scheduler import types as ttypes
from kubernetes_tpu_torch.scheduler.cache import SchedulerCache
from kubernetes_tpu_torch.scheduler.framework import Framework
from kubernetes_tpu_torch.scheduler.plugins.registry import (
    DEFAULT_SCORE_WEIGHTS, build_plugins)
from kubernetes_tpu_torch.topology import device as tdevice
from kubernetes_tpu_torch.topology import mesh as tmesh
from kubernetes_tpu_torch.topology import planes as tplanes
from kubernetes_tpu_torch.topology import slices as tslices
from kubernetes_tpu_torch.utils import flags

SMALL_MESHES = (("4x4", 16), ("4x8:mesh", 32), ("3x5x2", 30))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.mark.parametrize("raw,n", [
    ("auto", 1), ("auto", 2), ("auto", 16), ("auto", 17), ("auto", 64),
    ("auto", 256), ("auto", 5000), (None, 30), ("4x8", 0), ("2x4x4", 9),
    ("4x8:mesh", 3), (" 4X8 ", 1), ("bad", 10), ("0x3", 10), ("4x", 10),
    ("1x2x3x4", 10), ("5", 7), ("auto:mesh", 12)])
def test_parse_mesh_shape_matches_the_reference(raw, n):
    got, want = tmesh.parse_mesh_shape(raw, n), jmesh.parse_mesh_shape(raw, n)
    assert (got.dims, got.wrap, got.cells) == (want.dims, want.wrap,
                                               want.cells)


def test_auto_torus_sizes():
    for n, dims in ((64, (8, 8, 1)), (256, (16, 16, 1)),
                    (5000, (71, 71, 1))):
        spec = tmesh.parse_mesh_shape("auto", n)
        assert spec.dims == dims and spec.wrap
    assert tmesh.parse_mesh_shape("auto", 5000).cells - 5000 == 41


def test_node_cell_and_orientations_match_the_reference():
    label = tmesh.MESH_COORD_LABEL
    assert label == jmesh.MESH_COORD_LABEL
    cases = [("node-3", None), ("node-17", {}), ("n", None),
             ("node-99", None), ("node-1", {label: "1,2"}),
             ("node-1", {label: "1,2,1"}), ("node-1", {label: "9,9"}),
             ("node-1", {label: "x,y"}), ("node-1", {label: "1,2,3,4"}),
             ("node-1", {label: "-1,0"}), ("", None)]
    for raw, n in (("4x4", 16), ("3x5x2", 30), ("4x8:mesh", 32)):
        tspec, jspec = tmesh.parse_mesh_shape(raw, n), \
            jmesh.parse_mesh_shape(raw, n)
        for name, labels in cases:
            assert tmesh.node_cell(name, labels, tspec) == \
                jmesh.node_cell(name, labels, jspec), (raw, name, labels)
        for shape in list(SCAN_SHAPES) + [(3, 1, 2), (1,), (5, 5)]:
            assert tmesh.orientations(shape, tspec) == \
                jmesh.orientations(shape, jspec)
        for c in range(tspec.cells):
            assert tspec.coord_of(c) == jspec.coord_of(c)
            assert tspec.index_of(tspec.coord_of(c)) == c
    for bad in ((), (0, 2), (2, -1)):
        with pytest.raises(ValueError):
            tmesh.normalize_shape(bad)
        with pytest.raises(ValueError):
            jmesh.normalize_shape(bad)
    assert tmesh.normalize_shape((2, 3, 4, 5)) == \
        jmesh.normalize_shape((2, 3, 4, 5))


def _specs(raw, n):
    return tmesh.parse_mesh_shape(raw, n), jmesh.parse_mesh_shape(raw, n)


@pytest.mark.parametrize("raw,n", SMALL_MESHES)
def test_oracle_matches_the_reference(raw, n):
    tspec, jspec = _specs(raw, n)
    for shape in scan_shapes(tspec):
        for name, mask in scan_masks(tspec, 7):
            feas, frag = tslices.oracle_scan(mask, tspec, shape)
            jfeas, jfrag = jslices.oracle_scan(mask, jspec, shape)
            assert np.array_equal(feas, jfeas) and np.array_equal(frag, jfrag)
            pid = tslices.best_placement(feas, frag)
            assert pid == jslices.best_placement(jfeas, jfrag)
            assert np.array_equal(tslices.coverage(feas, tspec, shape),
                                  jslices.coverage(jfeas, jspec, shape))
            if pid >= 0:
                members = tslices.placement_members(pid, tspec, shape)
                assert members == jslices.placement_members(pid, jspec,
                                                            shape)
                assert tslices.is_contiguous_slice(members, tspec, shape)
                bent = list(members)
                bent[-1] = (bent[-1] + 1) % tspec.cells
                assert tslices.is_contiguous_slice(bent, tspec, shape) == \
                    jslices.is_contiguous_slice(bent, jspec, shape)


def _compare_scan(tspec, jspec, shape, mask, oracle: bool):
    got = tdevice.device_scan(mask, tspec, shape, "cpu")
    want = jdevice.device_scan(mask, jspec, shape)
    if want is None:
        assert got is None
        return None
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
        assert np.array_equal(g, np.asarray(w))
    if oracle:
        feas, frag = tslices.oracle_scan(mask, tspec, shape)
        assert np.array_equal(got[1], feas) and np.array_equal(got[2], frag)
        assert np.array_equal(got[3], tslices.coverage(feas, tspec, shape))
    return got


@pytest.mark.parametrize("raw,n", SMALL_MESHES)
def test_device_scan_matches_jax_and_the_oracle(raw, n):
    tspec, jspec = _specs(raw, n)
    feasible = 0
    for shape in scan_shapes(tspec):
        for name, mask in scan_masks(tspec, 7):
            got = _compare_scan(tspec, jspec, shape, mask, oracle=True)
            if got is None:
                continue
            key = got[0]
            want = jdevice.best_key(key)
            for s in (1, 4, 8):
                assert tdevice.best_key(key, s, device="cpu") == want \
                    == jdevice.best_key(key, s), (shape, name, s)
            pid, frag = tdevice.decode_key(want, tspec, shape)
            assert (pid, frag) == jdevice.decode_key(want, jspec, shape)
            feas, fragv = tslices.oracle_scan(mask, tspec, shape)
            assert pid == tslices.best_placement(feas, fragv)
            assert tdevice.fragmentation_pct(mask, got[3]) == \
                jdevice.fragmentation_pct(mask, got[3])
            feasible += pid >= 0
    assert feasible > 0


def test_wrap_only_and_full_span_slices():
    tspec, jspec = _specs("4x4", 16)
    band = dict(scan_masks(tspec, 7))["wrap-band"]
    got = _compare_scan(tspec, jspec, (2, 2), band, oracle=True)
    pid, _ = tdevice.decode_key(tdevice.best_key(got[0]), tspec, (2, 2))
    members = tslices.placement_members(pid, tspec, (2, 2))
    assert sorted(members) == [0, 3, 12, 15]   # the corner, through the wrap
    wspec, jwspec = _specs("4x4:mesh", 16)
    none = _compare_scan(wspec, jwspec, (2, 2), band, oracle=True)
    assert tdevice.best_key(none[0]) == -1
    free = np.ones(16, dtype=np.bool_)
    full = _compare_scan(tspec, jspec, (4, 4), free, oracle=True)
    assert tdevice.decode_key(tdevice.best_key(full[0]), tspec, (4, 4)) \
        == (0, 0)   # every anchor spans both rings: frag 0, the lowest id


@pytest.mark.parametrize("raw,n,shapes", [
    ("auto", 5000, ((2, 2), (8, 8))),
    ("8x8x16", 1024, ((2, 2, 8), (4, 4, 4)))])
def test_device_scan_matches_jax_on_large_meshes(raw, n, shapes):
    tspec, jspec = _specs(raw, n)
    masks = dict(scan_masks(tspec, 7))
    for shape in shapes:
        for name in ("free", "p0.9", "symmetric"):
            got = _compare_scan(tspec, jspec, shape, masks[name],
                                oracle=False)
            for s in (4, 8):
                assert tdevice.best_key(got[0], s, device="cpu") == \
                    jdevice.best_key(got[0], s)


def test_size_contract_matches_the_reference(monkeypatch):
    """None at the same pairs: (64,64) on 64x64x62 packs its key under
    2^31, on 64x64x63 it would overflow; no orientation of (5,5) fits a
    4x4 torus. The scan bodies are stubbed: the guard alone is compared."""
    monkeypatch.setattr(tdevice, "_scan", lambda free, dims, wrap, orients,
                        cap: (torch.zeros(len(orients) * free.numel(),
                                          dtype=torch.int32),
                              torch.zeros(free.numel(), dtype=torch.bool)))

    def stub_build(dims, wrap, orients, cap):
        cells = dims[0] * dims[1] * dims[2]
        return lambda grid: (np.zeros(len(orients) * cells, np.int32),
                             np.zeros(cells, np.bool_))

    monkeypatch.setattr(jdevice, "_build_scan", stub_build)
    monkeypatch.setattr(jdevice, "_SCAN_CACHE", {})
    pairs = [("64x64x62", (64, 64)), ("64x64x63", (64, 64)),
             ("64x64x64", (64, 64)), ("4x4", (5, 5)), ("4x4", (4, 4)),
             ("4x4:mesh", (1, 5)), ("8x8x16", (4, 4, 4))]
    seen = []
    for raw, shape in pairs:
        tspec, jspec = _specs(raw, 0)
        free = np.ones(tspec.cells, dtype=np.bool_)
        got = tdevice.device_scan(free, tspec, shape, "cpu") is None
        assert got == (jdevice.device_scan(free, jspec, shape) is None), raw
        seen.append(got)
    assert seen == [False, True, True, True, False, True, False]


def _nodes(mod_types, mk):
    label = tmesh.MESH_COORD_LABEL
    specs = [("node-0", {}), ("node-1", {label: "0,0"}),   # collides with 0
             ("edge", {}), ("node-7", {label: "3,3"}), ("node-15", {}),
             ("node-5", {label: "9,9"}), ("node-40", {}), ("node-2", {})]
    return [mod_types.NodeInfo(mk(n, labels=lb)) for n, lb in specs]


def test_topology_planes_match_the_reference():
    with flags.scoped_set("KTPU_MESH_SHAPE", "4x4"):
        got = tplanes.build_topology_planes(_nodes(ttypes, make_node), 256,
                                            None)
        want = jplanes.build_topology_planes(_nodes(jtypes, jmake_node), 256,
                                             None)
    for attr in ("cell_of_node", "node_of_cell", "coords"):
        assert np.array_equal(getattr(got, attr), getattr(want, attr)), attr
    assert got.on_mesh == want.on_mesh == 3
    node_free = np.array([True, True, True, False, True, True, True, True]
                         + [False] * 248)
    assert np.array_equal(got.free_cells(node_free),
                          want.free_cells(node_free))
    assert got.spec.dims == want.spec.dims


def test_planes_reuse_and_rebuild():
    nodes = [ttypes.NodeInfo(make_node(f"node-{i}")) for i in range(20)]
    first = tplanes.build_topology_planes(nodes, 256, None)
    assert first.rebuilt and first.spec.dims == (5, 4, 1)
    again = tplanes.build_topology_planes(nodes, 256, first)
    assert again is first and not again.rebuilt
    with flags.scoped_set("KTPU_MESH_SHAPE", "4x5"):
        moved = tplanes.build_topology_planes(nodes, 256, again)
    assert moved is not first and moved.rebuilt and moved.spec.dims == \
        (4, 5, 1)
    nodes[3].set_node(make_node("node-3", labels={
        tmesh.MESH_COORD_LABEL: "0,0"}))
    relabel = tplanes.build_topology_planes(nodes, 256, moved)
    assert relabel.rebuilt and relabel.cell_of_node[3] == -1


def test_cluster_tensors_carry_planes_only_under_the_flag():
    nodes = [ttypes.NodeInfo(make_node(f"node-{i}")) for i in range(10)]
    ct = ClusterTensors(ttypes.Snapshot(nodes, 1))
    assert ct.topology is not None and ct.topology.on_mesh == 10
    with flags.scoped_set("KTPU_TOPOLOGY", "0"):
        assert ClusterTensors(ttypes.Snapshot(nodes, 2)).topology is None
    # The delta build off a cache snapshot reuses the planes.
    cache = SchedulerCache()
    for i in range(10):
        cache.add_node(make_node(f"node-{i}"))
    ct1 = ClusterTensors(cache.update_snapshot())
    cache.assume_pod(ttypes.PodInfo(make_pod("p", requests={"cpu": "1"})),
                     "node-3")
    ct2 = ClusterTensors(cache.update_snapshot(), prev=ct1)
    assert ct2.topology is ct1.topology and not ct2.topology.rebuilt
    with flags.scoped_set("KTPU_TOPOLOGY", "0"):
        cache.assume_pod(ttypes.PodInfo(make_pod("q", requests={
            "cpu": "1"})), "node-4")
        assert ClusterTensors(cache.update_snapshot(), prev=ct2).topology \
            is None


def test_backend_counts_plane_rebuilds_not_reuse():
    nodes = [ttypes.NodeInfo(make_node(f"node-{i}")) for i in range(12)]
    fwk = Framework(build_plugins(), DEFAULT_SCORE_WEIGHTS)
    tb = TorchBackend(device="cpu", max_batch=16)
    tb.metrics = SchedulerMetrics()
    pods = [ttypes.PodInfo(make_pod(f"p{i}", requests={"cpu": "100m"}))
            for i in range(4)]
    tb.assign(pods, ttypes.Snapshot(nodes, 1), fwk)
    tb.assign(pods, ttypes.Snapshot(nodes, 2), fwk)
    assert tb.metrics.topology_plane_rebuilds.value() == 1
    with flags.scoped_set("KTPU_MESH_SHAPE", "3x4"):
        tb.assign(pods, ttypes.Snapshot(nodes, 3), fwk)
    assert tb.metrics.topology_plane_rebuilds.value() == 2
