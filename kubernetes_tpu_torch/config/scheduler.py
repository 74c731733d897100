"""KubeSchedulerConfiguration — the versioned component-config API.

Parity target: pkg/scheduler/apis/config/types.go +
staging/src/k8s.io/kube-scheduler/config/v1/ (SURVEY §5.6): reference-shaped
YAML loads unchanged — profiles (per-`schedulerName` plugin sets with
per-extension-point enable/disable and score weights), typed per-plugin args
(`NodeResourcesFitArgs.scoringStrategy`, …) via `pluginConfig`, the
`extenders:` list, `percentageOfNodesToScore`, `parallelism`,
`podInitialBackoffSeconds` / `podMaxBackoffSeconds`, `leaderElection`.

North-star seam #3 (SURVEY §5.6): `build_scheduler` hangs the batched
device backend off the `TPUScorer` feature gate — default off, flippable
with `--feature-gates=TPUScorer=true`, and removable per-profile with a
`pluginConfig` entry `{name: TPUScorer, args: {enabled: false}}` (our
extension; the reference reserves pluginConfig names for plugins, and
TPUScorer is exactly that: the fused device "plugin set").

Copy of `kubernetes_tpu/config/scheduler.py`. Where the reference's
`build_scheduler` builds `TPUBackend()`, this one builds `TorchBackend()`:
cuda:0, raising without a CUDA device (no host-path fallback); pass
`backend=TorchBackend(device="cpu")` to run its plain versions.
"""

from __future__ import annotations

import logging
from typing import Any, Mapping

from kubernetes_tpu_torch.scheduler.framework import Framework
from kubernetes_tpu_torch.scheduler.plugins.registry import (
    DEFAULT_PLUGINS,
    DEFAULT_SCORE_WEIGHTS,
    IN_TREE,
    build_plugins,
)
from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATES, FeatureGate

logger = logging.getLogger(__name__)

GROUP = "kubescheduler.config.k8s.io"
SUPPORTED_VERSIONS = {f"{GROUP}/v1", f"{GROUP}/v1beta3", f"{GROUP}/v1beta2"}
KIND = "KubeSchedulerConfiguration"

#: YAML field name → framework extension-point name.
POINTS = {
    "queueSort": "QueueSort",
    "preEnqueue": "PreEnqueue",
    "preFilter": "PreFilter",
    "filter": "Filter",
    "postFilter": "PostFilter",
    "preScore": "PreScore",
    "score": "Score",
    "reserve": "Reserve",
    "permit": "Permit",
    "preBind": "PreBind",
    "bind": "Bind",
    "postBind": "PostBind",
}

#: pluginConfig names that configure the harness, not a plugin.
_PSEUDO_PLUGINS = {"TPUScorer"}


class ConfigError(ValueError):
    """Invalid KubeSchedulerConfiguration (strict decoding, like the
    reference's scheme which rejects unknown plugins/fields)."""


def _points_of(name: str) -> tuple[str, ...]:
    cls = IN_TREE.get(name)
    if cls is None:
        raise ConfigError(f"unknown plugin {name!r}")
    return cls.EXTENSION_POINTS


class ProfileConfig:
    """One resolved entry of `profiles:` — per-point plugin name lists,
    score weights, per-plugin args."""

    def __init__(self, raw: Mapping | None = None):
        raw = raw or {}
        self.scheduler_name: str = raw.get("schedulerName", "default-scheduler")
        self.percentage_of_nodes_to_score: int | None = \
            raw.get("percentageOfNodesToScore")
        self.plugin_config: dict[str, Mapping] = {}
        for entry in raw.get("pluginConfig") or []:
            name = entry.get("name")
            if name not in IN_TREE and name not in _PSEUDO_PLUGINS:
                raise ConfigError(f"pluginConfig for unknown plugin {name!r}")
            self.plugin_config[name] = entry.get("args") or {}
        self.weights = dict(DEFAULT_SCORE_WEIGHTS)
        self.active = self._resolve(raw.get("plugins") or {})

    def _resolve(self, plugins_cfg: Mapping) -> dict[str, list[str]]:
        """Reference plugin-resolution semantics: defaults per point →
        multiPoint enable/disable → per-point disable ([{name:"*"}] clears)
        → per-point enable (appended, score weight honored)."""
        active: dict[str, list[str]] = {
            point: [n for n in DEFAULT_PLUGINS if point in _points_of(n)]
            for point in POINTS.values()
        }
        mp = plugins_cfg.get("multiPoint") or {}
        mp_disabled = {d.get("name") for d in mp.get("disabled") or []}
        if "*" in mp_disabled:
            active = {point: [] for point in active}
        else:
            for point in active:
                active[point] = [n for n in active[point]
                                 if n not in mp_disabled]
        for e in mp.get("enabled") or []:
            name = e["name"]
            for point in _points_of(name):
                if name not in active[point]:
                    active[point].append(name)
            if "weight" in e:
                self.weights[name] = e["weight"]
        for yaml_point, point in POINTS.items():
            spec = plugins_cfg.get(yaml_point)
            if not spec:
                continue
            disabled = {d.get("name") for d in spec.get("disabled") or []}
            if "*" in disabled:
                active[point] = []
            else:
                active[point] = [n for n in active[point] if n not in disabled]
            for e in spec.get("enabled") or []:
                name = e["name"]
                if point not in _points_of(name):
                    raise ConfigError(
                        f"plugin {name!r} does not implement {point}")
                if name not in active[point]:
                    active[point].append(name)
                if point == "Score" and "weight" in e:
                    self.weights[name] = e["weight"]
        return active

    def build_framework(self, store=None, metrics=None) -> Framework:
        names: list[str] = []
        for point_names in self.active.values():
            for n in point_names:
                if n not in names:
                    names.append(n)
        plugin_args = {k: v for k, v in self.plugin_config.items()
                       if k not in _PSEUDO_PLUGINS}
        # An explicitly-empty plugin set stays empty (build_plugins treats
        # a falsy list as "use defaults").
        plugins = build_plugins(names, plugin_args, store=store) if names else []
        # Framework filters by EXTENSION_POINTS minus `disabled`; express
        # the resolved per-point sets as the complement.
        disabled: dict[str, set[str]] = {}
        for point, point_names in self.active.items():
            off = {n for n in names
                   if point in _points_of(n) and n not in point_names}
            if off:
                disabled[point] = off
        return Framework(plugins, self.weights,
                         profile_name=self.scheduler_name,
                         metrics=metrics, disabled=disabled)

    def tpu_scorer_override(self) -> bool | None:
        args = self.plugin_config.get("TPUScorer")
        if args is None:
            return None
        return bool(args.get("enabled", True))


class SchedulerConfig:
    """Parsed KubeSchedulerConfiguration."""

    def __init__(self, raw: Mapping | None = None):
        raw = dict(raw or {})
        api_version = raw.get("apiVersion", f"{GROUP}/v1")
        if api_version not in SUPPORTED_VERSIONS:
            raise ConfigError(f"unsupported apiVersion {api_version!r} "
                              f"(want one of {sorted(SUPPORTED_VERSIONS)})")
        kind = raw.get("kind", KIND)
        if kind != KIND:
            raise ConfigError(f"unsupported kind {kind!r} (want {KIND})")
        self.api_version = api_version
        self.parallelism: int = raw.get("parallelism", 16)
        self.percentage_of_nodes_to_score: int = \
            raw.get("percentageOfNodesToScore", 0)
        self.pod_initial_backoff: float = \
            raw.get("podInitialBackoffSeconds", 1.0)
        self.pod_max_backoff: float = raw.get("podMaxBackoffSeconds", 10.0)
        le = raw.get("leaderElection") or {}
        self.leader_elect: bool = le.get("leaderElect", False)
        self.leader_lease_duration: float = _seconds(
            le.get("leaseDuration", "15s"))
        self.leader_renew_deadline: float = _seconds(
            le.get("renewDeadline", "10s"))
        self.leader_retry_period: float = _seconds(
            le.get("retryPeriod", "2s"))
        self.leader_lock_name: str = le.get("resourceName", "kube-scheduler")
        self.extenders: list[Mapping] = list(raw.get("extenders") or [])
        self.feature_gates: dict[str, bool] = dict(raw.get("featureGates") or {})
        profiles_raw = raw.get("profiles") or [{}]
        self.profiles = [ProfileConfig(p) for p in profiles_raw]
        seen = set()
        for p in self.profiles:
            if p.scheduler_name in seen:
                raise ConfigError(
                    f"duplicate profile schedulerName {p.scheduler_name!r}")
            seen.add(p.scheduler_name)


def _seconds(v: Any) -> float:
    """Duration: number = seconds; strings accept s/ms/m/h suffix
    (metav1.Duration YAML form, e.g. "15s")."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    for suffix, mult in (("ms", 0.001), ("s", 1.0), ("m", 60.0), ("h", 3600.0)):
        if s.endswith(suffix) and s[: -len(suffix)].replace(".", "").isdigit():
            return float(s[: -len(suffix)]) * mult
    return float(s)


def load_config(source) -> SchedulerConfig:
    """Load from a YAML string, a path, a parsed mapping, or None
    (all-defaults)."""
    if source is None:
        return SchedulerConfig()
    if isinstance(source, SchedulerConfig):
        return source
    if isinstance(source, Mapping):
        return SchedulerConfig(source)
    import yaml
    text = source
    if "\n" not in str(source):
        try:
            with open(source) as f:
                text = f.read()
        except OSError as e:
            raise ConfigError(f"cannot read config {source!r}: {e}") from e
    data = yaml.safe_load(text)
    if not isinstance(data, Mapping):
        raise ConfigError("config must be a YAML mapping")
    return SchedulerConfig(data)


def build_scheduler(store, config=None, *, feature_gates: FeatureGate | None = None,
                    backend=None, metrics=None, seed: int = 0):
    """Config → running-shape Scheduler.

    The `TPUScorer` feature gate selects the batched device backend per
    profile: gate default (off) < `--feature-gates=TPUScorer=true` <
    per-profile `pluginConfig {name: TPUScorer, args: {enabled: ...}}`.
    Profiles with the gate off keep the reference-shaped host path.
    """
    cfg = load_config(config)
    # Resolve gates per call on a private copy: one config's featureGates
    # must not leak into the process-wide defaults or later builds.
    gates = (feature_gates or DEFAULT_FEATURE_GATES).clone()
    for name, val in cfg.feature_gates.items():
        if name not in gates.known():
            # Reference configs carry gates far beyond the ones registered
            # here; unknown names are registered-as-given, not fatal.
            logger.info("registering unknown feature gate %s=%s from config",
                        name, val)
            gates.add(name, "Alpha", bool(val))
            continue
        try:
            gates.set(name, val)
        except ValueError as e:
            raise ConfigError(f"featureGates: {e}") from e

    from kubernetes_tpu_torch.scheduler.scheduler import Scheduler

    profiles = {}
    for p in cfg.profiles:
        fwk = p.build_framework(store=store, metrics=metrics)
        if p.percentage_of_nodes_to_score is not None:
            # Per-profile override (reference scopes this field to its
            # profile; the global value covers the rest).
            fwk.percentage_of_nodes_to_score = p.percentage_of_nodes_to_score
        profiles[p.scheduler_name] = fwk
    sched = Scheduler(
        store, profiles=profiles,
        percentage_of_nodes_to_score=cfg.percentage_of_nodes_to_score,
        seed=seed, metrics=metrics,
        pod_initial_backoff=cfg.pod_initial_backoff,
        pod_max_backoff=cfg.pod_max_backoff,
    )
    from kubernetes_tpu_torch.scheduler.extender import HTTPExtender
    sched.extenders = [HTTPExtender.from_config(e) for e in cfg.extenders]

    gate_default = gates.enabled("TPUScorer")
    backend_profiles = set()
    for p in cfg.profiles:
        override = p.tpu_scorer_override()
        if override if override is not None else gate_default:
            backend_profiles.add(p.scheduler_name)
    if backend_profiles:
        if backend is None:
            from kubernetes_tpu_torch.ops.backend import TorchBackend
            backend = TorchBackend()
        sched.attach_backend(backend)
        sched.backend_profiles = backend_profiles
    if cfg.leader_elect:
        # leaderElection.leaderElect: true → the caller runs the scheduler
        # via sched.run_with_leader_election(sched.leader_elector).
        import uuid

        from kubernetes_tpu_torch.client.leaderelection import LeaderElector
        sched.leader_elector = LeaderElector(
            store, cfg.leader_lock_name,
            identity=f"scheduler-{uuid.uuid4().hex[:8]}",
            lease_duration=cfg.leader_lease_duration,
            renew_deadline=cfg.leader_renew_deadline,
            retry_period=cfg.leader_retry_period)
    sched.config = cfg
    return sched
