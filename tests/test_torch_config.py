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
- `build_scheduler` on the reference's own fixtures gives the same
  profiles, plugin lists and args, score weights, percentages, backoffs,
  `backend_profiles`, extenders and elector timings; a config's gates do
  not leak; with `TPUScorer` on and no CUDA device the port raises.

Tolerance: none.
"""

from pathlib import Path

import pytest

from kubernetes_tpu.config import build_scheduler as jbuild
from kubernetes_tpu.config import scheduler as jcfg
from kubernetes_tpu.perf import scheduler_perf as jperf
from kubernetes_tpu.store import new_cluster_store as jstore
from kubernetes_tpu.utils import featuregate as jfg
from kubernetes_tpu_torch.config import scheduler as tcfg
from kubernetes_tpu_torch.ops.backend import TorchBackend
from kubernetes_tpu_torch.perf import scheduler_perf as tperf
from kubernetes_tpu_torch.store import new_cluster_store as tstore
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


# -- build_scheduler -------------------------------------------------------
# The fixtures of the reference's tests/test_config.py (its REFERENCE_YAML
# with leader election, an extender and a gang profile; per-profile
# percentages; config-level and per-profile TPUScorer gates; an unknown
# gate), built by both packages. The reference builds `TPUBackend()` where
# the gate is on; the port is handed `TorchBackend(device="cpu")` (its own
# default needs CUDA, which the last test checks).

BUILD_YAML = """
apiVersion: kubescheduler.config.k8s.io/v1
kind: KubeSchedulerConfiguration
parallelism: 8
percentageOfNodesToScore: 40
podInitialBackoffSeconds: 2
podMaxBackoffSeconds: 20
leaderElection:
  leaderElect: true
  leaseDuration: 15s
  renewDeadline: 10s
  retryPeriod: 2s
profiles:
- schedulerName: default-scheduler
  plugins:
    score:
      disabled:
      - name: ImageLocality
      enabled:
      - name: NodeResourcesBalancedAllocation
        weight: 5
  pluginConfig:
  - name: NodeResourcesFit
    args:
      scoringStrategy:
        type: MostAllocated
        resources:
        - name: cpu
          weight: 2
        - name: memory
          weight: 1
- schedulerName: gang-scheduler
  plugins:
    multiPoint:
      enabled:
      - name: Coscheduling
    filter:
      disabled:
      - name: PodTopologySpread
extenders:
- urlPrefix: http://127.0.0.1:9999/scheduler
  filterVerb: filter
  prioritizeVerb: prioritize
  weight: 2
  nodeCacheCapable: true
  ignorable: true
  managedResources:
  - name: example.com/foo
    ignoredByScheduler: true
"""

#: name -> (config, gates set on the process-wide-like gate set)
BUILDS = {
    "reference-yaml": (BUILD_YAML, {}),
    "reference-yaml-gate-on": (BUILD_YAML, {"TPUScorer": True}),
    "per-profile-percentage": ({"percentageOfNodesToScore": 100,
                                "profiles": [
                                    {"schedulerName": "a"},
                                    {"schedulerName": "b",
                                     "percentageOfNodesToScore": 10}]}, {}),
    "gate-off": (None, {}),
    "gate-on": (None, {"TPUScorer": True}),
    "config-gate": ({"featureGates": {"TPUScorer": True}}, {}),
    "unknown-gate": ({"featureGates": {"DynamicResourceAllocation": True}},
                     {}),
    "per-profile-override": ({"profiles": [
        {"schedulerName": "default-scheduler"},
        {"schedulerName": "host-only",
         "pluginConfig": [{"name": "TPUScorer",
                           "args": {"enabled": False}}]}]},
        {"TPUScorer": True}),
}


def gate_set(fg, **kw):
    g = fg.FeatureGate()
    g.add("TPUScorer", fg.ALPHA, False)
    g.add("TPUBatchSolver", fg.ALPHA, False)
    for k, v in kw.items():
        g.set(k, v)
    return g


def sched_view(sched) -> dict:
    out = {"profiles": {}, "pct": sched.percentage_of_nodes_to_score,
           "backoff": (sched.queue.initial_backoff, sched.queue.max_backoff),
           "backend": sched.backend is not None,
           "backend_profiles": sched.backend_profiles,
           "extenders": [(e.url_prefix, e.filter_verb, e.prioritize_verb,
                          e.bind_verb, e.weight, e.node_cache_capable,
                          e.ignorable, sorted(e.managed_resources),
                          e.timeout, e.name) for e in sched.extenders],
           "config": (sched.config.parallelism, sched.config.leader_elect)}
    for name, fwk in sorted(sched.profiles.items()):
        out["profiles"][name] = {
            "points": {pt: [(q.NAME, q.args) for q in getattr(
                fwk, _attr(pt))] for pt in POINTS},
            "weights": fwk.score_weights,
            "pct": getattr(fwk, "percentage_of_nodes_to_score", None)}
    el = getattr(sched, "leader_elector", None)
    out["elector"] = None if el is None else (
        el.lock_name, el.namespace, el.lease_duration, el.renew_deadline,
        el.retry_period, el.identity.startswith("scheduler-"),
        len(el.identity))
    return out


@pytest.mark.parametrize("name", sorted(BUILDS))
def test_build_scheduler_matches_reference(name):
    config, on = BUILDS[name]
    js, ts = jstore(), tstore()
    try:
        want = jbuild(js, config, feature_gates=gate_set(jfg, **on), seed=42)
        backend = TorchBackend(device="cpu")
        got = tcfg.build_scheduler(ts, config,
                                   feature_gates=gate_set(tfg, **on),
                                   backend=backend, seed=42)
        assert sched_view(got) == sched_view(want)
        assert got.backend is (backend if want.backend is not None else None)
    finally:
        js.stop()
        ts.stop()


def test_build_scheduler_gates_do_not_leak():
    for fg, store, backend in ((jfg, jstore(), None),
                               (tfg, tstore(), TorchBackend(device="cpu"))):
        build = jbuild if fg is jfg else tcfg.build_scheduler
        g = gate_set(fg)
        s1 = build(store, {"featureGates": {"TPUScorer": True}},
                   feature_gates=g, backend=backend)
        s2 = build(store, None, feature_gates=g, backend=backend)
        assert s1.backend is not None and s2.backend is None
        assert not g.enabled("TPUScorer")
        store.stop()


def test_build_scheduler_needs_the_card_with_the_gate_on(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    ts = tstore()
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            tcfg.build_scheduler(ts, None,
                                 feature_gates=gate_set(tfg, TPUScorer=True))
        assert tcfg.build_scheduler(
            ts, None, feature_gates=gate_set(tfg)).backend is None
    finally:
        ts.stop()
