"""A configuration, a traffic mix or a per-layer metric is a file of its
own, found by its name: adding one edits no file that is there."""

import json
from pathlib import Path

from schedbench import harness, traffic

ROOT = Path(__file__).resolve().parents[1]


def _snapshot(paths):
    return {p: p.read_bytes() for p in paths}


def test_new_config_traffic_and_metric_files_are_found(tmp_path):
    existing = [p for p in ROOT.rglob("*") if p.is_file()
                and "__pycache__" not in p.parts]
    before = _snapshot(existing)
    bench = harness.load_benchmark()
    cfg = json.loads((ROOT / "configs" / "SchedulingBasic-5000Nodes.json")
                     .read_text())
    cfg["name"] = "SchedulingBasic-1000Nodes"
    cfg["nodeGroups"] = [{"count": 1000, "labels": {}}]
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "SchedulingBasic-1000Nodes.json").write_text(
        json.dumps(cfg))
    tdir = tmp_path / "traffic"
    tdir.mkdir()
    (tdir / "burst-rounds-2000.json").write_text(json.dumps({
        "kind": "rounds", "round_pods": 2000, "gather": 256}))
    mdir = tmp_path / "metrics"
    mdir.mkdir()
    (mdir / "created_pods.py").write_text(
        "def read(rec):\n    return rec.layer.get('created') or None\n")
    bench["configs"].append({
        "name": "SchedulingBasic-1000Nodes", "source": "x",
        "file": "configs/SchedulingBasic-1000Nodes.json", "reduced": [],
        "why": "x"})
    bench["workloads"].append({
        "name": "basic-1000n-burst", "config": "SchedulingBasic-1000Nodes",
        "traffic": "burst-rounds-2000", "chips": 1, "why": "x"})
    bench["per_layer"].append({
        "name": "created_pods", "unit": "pods", "better": "higher",
        "source": "host_clock", "layer": "store and informers",
        "moves": "pods_per_s", "workloads": ["basic-1000n-burst"]})
    spec = harness.cell_spec(bench, "basic-1000n-burst", root=tmp_path,
                             traffic_dir=tdir)
    assert spec["config"]["nodeGroups"][0]["count"] == 1000
    assert spec["traffic"]["round_pods"] == 2000
    assert "created_pods" in [m["name"] for m in spec["per_layer"]]
    rec = harness.RunRecord(seconds=1.0, layer={"created": 2})
    assert harness.per_layer(rec, ["created_pods"], mdir) == {
        "created_pods": 2.0}
    assert _snapshot(existing) == before


def test_every_listed_metric_has_a_reader_and_every_cell_its_files():
    bench = harness.load_benchmark()
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for w in bench["workloads"]:
        spec = harness.cell_spec(bench, w["name"])
        assert spec["traffic"]["kind"] in traffic.DRIVERS


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    rec = harness.RunRecord(seconds=1.0)
    names = [m["name"] for m in harness.load_benchmark()["per_layer"]]
    assert harness.per_layer(rec, names) == {}
