"""Feature gates (component-base/featuregate `FeatureGate` +
pkg/features/kube_features.go). Copy of `kubernetes_tpu/utils/featuregate.py`.

`--feature-gates=TPUScorer=true` is north-star seam #3 (SURVEY §5.6): it flips
the scheduler's batched extension points to the tensor backend. Gates carry
Alpha/Beta/GA stages with per-stage defaults, are settable from a spec string,
and are queried at wiring time (not in hot loops).
"""

from __future__ import annotations

ALPHA = "Alpha"
BETA = "Beta"
GA = "GA"
DEPRECATED = "Deprecated"


class FeatureGate:
    def __init__(self):
        self._known: dict[str, tuple[str, bool]] = {}
        self._enabled: dict[str, bool] = {}

    def add(self, name: str, stage: str, default: bool) -> None:
        self._known[name] = (stage, default)

    def enabled(self, name: str) -> bool:
        if name not in self._known:
            raise KeyError(f"unknown feature gate {name!r}")
        if name in self._enabled:
            return self._enabled[name]
        return self._known[name][1]

    def set(self, name: str, value: bool) -> None:
        if name not in self._known:
            raise KeyError(f"unknown feature gate {name!r}")
        stage, _ = self._known[name]
        if stage == GA and not value:
            raise ValueError(f"cannot disable GA feature {name!r}")
        self._enabled[name] = value

    def set_from_spec(self, spec: str) -> None:
        """Parse "--feature-gates" syntax: "Name=true,Other=false".

        Unparseable boolean values are an error (component-base featuregate
        `Set` rejects them rather than silently disabling the feature); a
        bare name with no "=" enables, matching Go flag bool semantics.
        """
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, eq, val = part.partition("=")
            val = val.strip().lower()
            if not eq or val == "true":
                value = True
            elif val == "false":
                value = False
            else:
                raise ValueError(
                    f"invalid value {val!r} for feature gate {name.strip()!r}"
                    " (want true|false)")
            self.set(name.strip(), value)

    def known(self) -> dict[str, tuple[str, bool]]:
        return dict(self._known)

    def clone(self) -> "FeatureGate":
        """Independent copy — per-component gate resolution must not leak
        into the process-wide defaults."""
        g = FeatureGate()
        g._known = dict(self._known)
        g._enabled = dict(self._enabled)
        return g


#: Process-wide default gate set (kube_features.go `defaultKubernetesFeatureGates`).
DEFAULT_FEATURE_GATES = FeatureGate()
DEFAULT_FEATURE_GATES.add("TPUScorer", ALPHA, False)
DEFAULT_FEATURE_GATES.add("TPUBatchSolver", ALPHA, False)
DEFAULT_FEATURE_GATES.add("SchedulerQueueingHints", BETA, True)
DEFAULT_FEATURE_GATES.add("PodSchedulingGates", GA, True)
