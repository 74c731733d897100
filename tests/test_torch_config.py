"""The port's KubeSchedulerConfiguration loader and feature gates against
the JAX package's, on the CPU.

- `load_config` of each configuration below (the DeviceTopology
  workload's own, read from `performance-config.yaml` by the JAX harness
  and from the port's `DEVICE_TOPOLOGY` constant; multiPoint disable-all
  and re-enable; per-point disable and enable with weights; pluginConfig
  args, the volume plugins' `bindTimeoutSeconds` and `maxVolumesPerNode`
  among them; a YAML string): the same profiles, per-point plugin names
  and score weights, the four volume plugins included; the same scalar
  settings; and `build_framework` gives the same plugins at every
  extension point, with their args.
- Invalid configurations raise ConfigError in both (unknown plugin,
  unsupported apiVersion or kind, a duplicate profile, a plugin enabled at
  a point it does not implement, pluginConfig for an unknown plugin).
- `FeatureGate`: defaults, `set_from_spec`, the GA and unknown-name
  errors and `clone` behave alike.

Tolerance: none.
"""

from pathlib import Path

import pytest

from kubernetes_tpu.config import scheduler as jcfg
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu.utils import featuregate as jfg
from kubernetes_tpu_torch.config import scheduler as tcfg
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from kubernetes_tpu_torch.utils import featuregate as tfg

YAML = Path(__file__).resolve().parent.parent / "kubernetes_tpu" / "perf" \
    / "config" / "performance-config.yaml"
POINTS = ("Filter", "Score", "PreFilter", "PreScore", "Reserve", "PreBind",
          "PreEnqueue", "QueueSort", "PostFilter", "Bind", "Permit",
          "PostBind")

CONFIGS = {
    "default": None,
    "disable-all": {"profiles": [{"plugins": {
        "multiPoint": {"disabled": [{"name": "*"}], "enabled": [
            {"name": "PrioritySort"}, {"name": "NodeResourcesFit"},
            {"name": "DefaultBinder"},
            {"name": "NodeResourceTopologyMatch", "weight": 5}]}}}]},
    "per-point": {"apiVersion": "kubescheduler.config.k8s.io/v1beta3",
                  "percentageOfNodesToScore": 40,
                  "podInitialBackoffSeconds": 2,
                  "profiles": [
        {"schedulerName": "a", "plugins": {
            "score": {"disabled": [{"name": "ImageLocality"}],
                      "enabled": [{"name": "NodeResourceTopologyMatch",
                                   "weight": 3}]},
            "filter": {"disabled": [{"name": "NodePorts"}]}}},
        {"schedulerName": "b", "plugins": {
            "filter": {"disabled": [{"name": "*"}]},
            "preFilter": {"enabled": [{"name": "DynamicResources"}]}}}]},
    "plugin-args": {"profiles": [{
        "plugins": {"multiPoint": {"enabled": [
            {"name": "NodeResourceTopologyMatch"}]}},
        "pluginConfig": [
            {"name": "NodeResourceTopologyMatch", "args": {
                "scoringStrategy": {"type": "BalancedAllocation"}}},
            {"name": "NodeResourcesFit", "args": {
                "scoringStrategy": {"type": "MostAllocated"}}},
            {"name": "TPUScorer", "args": {"enabled": False}}]}]},
    "volume-args": {"profiles": [{"pluginConfig": [
        {"name": "VolumeBinding", "args": {"bindTimeoutSeconds": 5}},
        {"name": "NodeVolumeLimits", "args": {"maxVolumesPerNode": 3}}]}]},
    "yaml": """apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
profiles:
- schedulerName: default-scheduler
  plugins:
    multiPoint:
      disabled: [{name: DynamicResources}]
""",
}


def view(cfg) -> dict:
    """A loaded config."""
    out = {"scalars": (cfg.api_version, cfg.parallelism,
                       cfg.percentage_of_nodes_to_score,
                       cfg.pod_initial_backoff, cfg.pod_max_backoff,
                       cfg.leader_elect, cfg.feature_gates)}
    for p in cfg.profiles:
        fwk = p.build_framework()
        out[p.scheduler_name] = {
            "active": dict(p.active),
            "weights": p.weights,
            "args": {k: v for k, v in p.plugin_config.items()},
            "percentage": p.percentage_of_nodes_to_score,
            "framework": {pt: [(q.NAME, q.args) for q in getattr(
                fwk, _attr(pt))] for pt in POINTS},
            "weights_fwk": fwk.score_weights,
        }
    return out


def _attr(point: str) -> str:
    snake = "".join("_" + c.lower() if c.isupper() else c
                    for c in point).lstrip("_")
    return f"{snake}_plugins"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_load_config_matches_reference(name):
    got = view(tcfg.load_config(CONFIGS[name]))
    want = view(jcfg.load_config(CONFIGS[name]))
    assert got == want


def test_device_topology_profile_matches_reference():
    entry = next(c for c in jperf.load_config(str(YAML))
                 if c["name"] == "DeviceTopology")
    assert tperf.DEVICE_TOPOLOGY["schedulerConfig"] == entry[
        "schedulerConfig"]
    got = view(tcfg.load_config(tperf.DEVICE_TOPOLOGY["schedulerConfig"]))
    want = view(jcfg.load_config(entry["schedulerConfig"]))
    assert got == want
    prof = got["default-scheduler"]
    assert prof["weights"]["NodeResourceTopologyMatch"] == 2
    assert "NodeResourceTopologyMatch" in prof["active"]["Filter"]
    assert "NodeResourceTopologyMatch" in prof["active"]["Score"]
    assert "DynamicResources" in prof["active"]["Reserve"]


@pytest.mark.parametrize("raw", [
    {"profiles": [{"plugins": {"multiPoint": {"enabled": [
        {"name": "NoSuchPlugin"}]}}}]},
    {"apiVersion": "kubescheduler.config.k8s.io/v2"},
    {"kind": "SchedulerPolicy"},
    {"profiles": [{"schedulerName": "a"}, {"schedulerName": "a"}]},
    {"profiles": [{"plugins": {"score": {"enabled": [
        {"name": "NodePorts"}]}}}]},
    {"profiles": [{"pluginConfig": [{"name": "NoSuchPlugin"}]}]},
], ids=["unknown-plugin", "api-version", "kind", "duplicate-profile",
        "wrong-point", "unknown-plugin-config"])
def test_invalid_configs_raise(raw):
    with pytest.raises(jcfg.ConfigError) as want:
        jcfg.load_config(raw)
    with pytest.raises(tcfg.ConfigError) as got:
        tcfg.load_config(raw)
    assert str(got.value) == str(want.value)


def test_feature_gates_match_reference():
    def script(fg):
        gates = fg.DEFAULT_FEATURE_GATES.clone()
        out = [sorted(gates.known().items())]
        gates.set_from_spec("TPUScorer=true, SchedulerQueueingHints=false")
        out.append([gates.enabled(n) for n in sorted(gates.known())])
        for bad in ("PodSchedulingGates=false", "Nope=true",
                    "TPUScorer=maybe"):
            with pytest.raises((KeyError, ValueError)) as e:
                gates.set_from_spec(bad)
            out.append((type(e.value).__name__, str(e.value)))
        out.append(fg.DEFAULT_FEATURE_GATES.enabled("TPUScorer"))
        return out

    assert script(tfg) == script(jfg)
