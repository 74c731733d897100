"""InterPodAffinity: required/preferred pod (anti-)affinity.

Parity target: pkg/scheduler/framework/plugins/interpodaffinity/
{plugin.go,filtering.go,scoring.go}:

- Filter (requiredDuringSchedulingIgnoredDuringExecution):
  * anti-affinity: pod may NOT land in a topology domain (same value of
    `topologyKey` on the node) where a pod matching the term's labelSelector
    already runs — checked BOTH ways: incoming pod's terms against existing
    pods, and existing pods' required anti-affinity terms against the
    incoming pod (symmetry).
  * affinity: pod MUST land in a domain where a matching pod runs (unless no
    pod in the whole cluster matches and the pod matches its own terms —
    the "first pod in the group" rule).
- PreFilter precomputes topologyToMatchedTermCount maps (the O(pods×nodes)
  hot spot the reference parallelizes over 16 goroutines — and we tensorize).
- Score: preferred terms weighted sum, plus symmetry (existing pods'
  preferred anti/affinity terms about the incoming pod).

Namespace semantics: a term matches pods in the term's `namespaces` list
∪ the namespaces selected by its `namespaceSelector` (resolved against the
namespaces informer — the reference's GetNamespaceLabelsSnapshot merge in
PreFilter), or the owner pod's namespace when both are unset. An empty
namespaceSelector ({}) selects every namespace.

Copy of `kubernetes_tpu/scheduler/plugins/interpodaffinity.py`. The batched
backend compiles the same Filter and Score into dense rows
(ops/affinity.py); this plugin answers one-pod host dispatches, and its
`ns_resolver` is the backend's namespace resolver.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Mapping

from kubernetes_tpu_torch.api.labels import (
    ALL_NAMESPACES,
    from_label_selector,
    is_empty_label_selector,
    ns_contains,
)
from kubernetes_tpu_torch.scheduler.framework import (
    MAX_NODE_SCORE,
    CycleState,
    Plugin,
    Status,
)
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

_STATE_KEY = "PreFilterInterPodAffinity"


class NamespaceResolver:
    """Resolves an affinity term's effective namespace set, including
    `namespaceSelector` terms, against the live Namespace objects.

    Memoized per (selector, explicit namespaces) and invalidated when any
    namespace changes (epoch). Callable: resolver(term, owner_ns) ->
    tuple of namespace names."""

    def __init__(self):
        self._informer = None
        self._epoch = 0
        self._memo: dict = {}

    def wire(self, factory) -> None:
        from kubernetes_tpu_torch.client import ResourceEventHandler
        self._informer = factory.informer("namespaces")

        def bump(*_a):
            self._epoch += 1
            self._memo.clear()

        def on_update(old, new):
            # Resolution depends only on labels: an annotation/status
            # touch must not invalidate compiled affinity state (the
            # epoch gates an O(cluster) recompile downstream).
            if (old.get("metadata", {}).get("labels") or {}) != \
                    (new.get("metadata", {}).get("labels") or {}):
                bump()

        self._informer.add_event_handler(ResourceEventHandler(
            on_add=bump, on_update=on_update, on_delete=bump))

    @property
    def epoch(self) -> int:
        return self._epoch

    def __call__(self, term: Mapping, owner_ns: str) -> tuple[str, ...]:
        ns_sel = term.get("namespaceSelector")
        explicit = term.get("namespaces") or []
        if ns_sel is None:
            return tuple(explicit) if explicit else (owner_ns,)
        # Empty selector ({}) selects EVERY namespace (reference
        # semantics: it matches any label set, including namespaces with
        # no labels and namespaces with no Namespace object) — no
        # informer needed, and no namespace universe to enumerate.
        if is_empty_label_selector(ns_sel):
            return ALL_NAMESPACES
        key = (repr(ns_sel), tuple(explicit))
        got = self._memo.get(key)
        if got is None:
            names = set(explicit)
            if self._informer is not None:
                sel = from_label_selector(ns_sel)
                for ns_obj in self._informer.indexer.list():
                    labels = ns_obj.get("metadata", {}).get("labels") or {}
                    if sel.matches(labels):
                        names.add(ns_obj["metadata"]["name"])
            got = self._memo[key] = tuple(sorted(names))
        return got


def resolve_term_namespaces(term: Mapping, owner_ns: str,
                            resolver=None) -> tuple[str, ...]:
    """A term's effective namespace set, with or without a resolver.

    The resolver-less path is STATIC and resolver-consistent: an empty
    namespaceSelector ({}) is ALL_NAMESPACES either way; a non-empty
    selector without an informer matches only the term's explicit
    `namespaces` (exactly what an informer-less NamespaceResolver
    resolves to) — so compiled tensor rows and host plugin rows agree
    by construction."""
    if resolver is not None:
        return resolver(term, owner_ns)
    ns_sel = term.get("namespaceSelector")
    explicit = term.get("namespaces") or []
    if ns_sel is None:
        return tuple(explicit) if explicit else (owner_ns,)
    if is_empty_label_selector(ns_sel):
        return ALL_NAMESPACES
    return tuple(explicit)


def _term_matches(term: Mapping, pod_ns: str, other: PodInfo,
                  resolver=None) -> bool:
    """Does `other` match an affinity term owned by a pod in `pod_ns`?"""
    namespaces = resolve_term_namespaces(term, pod_ns, resolver)
    if not ns_contains(namespaces, other.namespace):
        return False
    return from_label_selector(term.get("labelSelector")).matches(other.labels)


class _PreFilterState:
    __slots__ = (
        "affinity_counts", "anti_affinity_counts", "existing_anti_counts",
    )

    def __init__(self):
        # (topologyKey, topologyValue) -> count of matching pods
        self.affinity_counts: dict[tuple[str, str], int] = defaultdict(int)
        self.anti_affinity_counts: dict[tuple[str, str], int] = defaultdict(int)
        # symmetry: existing pods' required anti-affinity terms that match the
        # incoming pod, counted per domain
        self.existing_anti_counts: dict[tuple[str, str], int] = defaultdict(int)


class InterPodAffinity(Plugin):
    NAME = "InterPodAffinity"
    EXTENSION_POINTS = ("PreFilter", "Filter", "PreScore", "Score")
    EVENTS = ["Pod/Add", "Pod/Delete", "Node/Add"]

    def __init__(self, args=None):
        super().__init__(args)
        self.hard_pod_affinity_weight = int(
            self.args.get("hardPodAffinityWeight", 1))
        #: namespaceSelector resolution (reference PreFilter namespace
        #: merge); works informer-less too (selector terms then match
        #: only their explicit namespaces).
        self.ns_resolver = NamespaceResolver()

    def set_informers(self, factory) -> None:
        self.ns_resolver.wire(factory)

    # -- PreFilter ---------------------------------------------------------

    def pre_filter(self, state: CycleState, pod: PodInfo, snapshot: Snapshot) -> Status:
        has_own_terms = bool(pod.required_affinity_terms or pod.required_anti_affinity_terms)
        if not has_own_terms and not snapshot.have_pods_with_required_anti_affinity:
            return Status.skip()
        s = _PreFilterState()
        # Incoming pod's terms vs existing pods.
        for node in snapshot:
            if not node.node:
                continue
            for existing in node.pods:
                for term in pod.required_affinity_terms:
                    tk = term.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(term, pod.namespace, existing, self.ns_resolver):
                        s.affinity_counts[(tk, tv)] += 1
                for term in pod.required_anti_affinity_terms:
                    tk = term.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(term, pod.namespace, existing, self.ns_resolver):
                        s.anti_affinity_counts[(tk, tv)] += 1
            # Symmetry: existing pods' required anti-affinity vs incoming pod.
            for existing in node.pods_with_required_anti_affinity:
                for term in existing.required_anti_affinity_terms:
                    tk = term.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(term, existing.namespace, pod, self.ns_resolver):
                        s.existing_anti_counts[(tk, tv)] += 1
        state.write(_STATE_KEY, s)
        return Status.success()

    # -- Filter ------------------------------------------------------------

    def filter(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> Status:
        s: _PreFilterState | None = state.read(_STATE_KEY)
        if s is None:
            return Status.success()
        # Anti-affinity (incoming pod's own terms).
        for term in pod.required_anti_affinity_terms:
            tk = term.get("topologyKey", "")
            tv = node.labels.get(tk)
            if tv is not None and s.anti_affinity_counts.get((tk, tv), 0) > 0:
                return Status.unschedulable(
                    "node(s) didn't match pod anti-affinity rules")
        # Symmetry: existing pods' anti-affinity forbids this pod here.
        for (tk, tv), count in s.existing_anti_counts.items():
            if count > 0 and node.labels.get(tk) == tv:
                return Status.unschedulable(
                    "node(s) didn't satisfy existing pods anti-affinity rules")
        # Affinity: every term must be satisfiable in this node's domain...
        for term in pod.required_affinity_terms:
            tk = term.get("topologyKey", "")
            tv = node.labels.get(tk)
            if tv is None:
                return Status.unschedulable(
                    "node(s) didn't match pod affinity rules")
            if s.affinity_counts.get((tk, tv), 0) == 0:
                # ...unless NO pod anywhere matches ANY affinity term and the
                # pod matches its own terms (first-pod-in-group rule,
                # filtering.go `satisfyPodAffinity` nomatchingexists check).
                if not any(s.affinity_counts.values()) and all(
                    _term_matches(t, pod.namespace, pod, self.ns_resolver)
                    for t in pod.required_affinity_terms
                ):
                    continue
                return Status.unschedulable(
                    "node(s) didn't match pod affinity rules")
        return Status.success()

    # -- Score -------------------------------------------------------------

    def pre_score(self, state: CycleState, pod: PodInfo, nodes: list[NodeInfo]) -> Status:
        has_preferred = bool(pod.preferred_affinity_terms or pod.preferred_anti_affinity_terms)
        has_existing = any(n.pods_with_affinity for n in nodes)
        if not has_preferred and not has_existing:
            return Status.skip()
        # domain -> accumulated weight for the incoming pod
        scores: dict[tuple[str, str], float] = defaultdict(float)
        for node in nodes:
            for existing in node.pods:
                for term in pod.preferred_affinity_terms:
                    t = term.get("podAffinityTerm") or {}
                    tk = t.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(t, pod.namespace, existing, self.ns_resolver):
                        scores[(tk, tv)] += term.get("weight", 1)
                for term in pod.preferred_anti_affinity_terms:
                    t = term.get("podAffinityTerm") or {}
                    tk = t.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(t, pod.namespace, existing, self.ns_resolver):
                        scores[(tk, tv)] -= term.get("weight", 1)
            # Symmetry: existing pods' preferred terms about the incoming pod.
            for existing in node.pods_with_affinity:
                for term in existing.preferred_affinity_terms:
                    t = term.get("podAffinityTerm") or {}
                    tk = t.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(t, existing.namespace, pod, self.ns_resolver):
                        scores[(tk, tv)] += term.get("weight", 1)
                for term in existing.preferred_anti_affinity_terms:
                    t = term.get("podAffinityTerm") or {}
                    tk = t.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(t, existing.namespace, pod, self.ns_resolver):
                        scores[(tk, tv)] -= term.get("weight", 1)
                # Hard-affinity symmetry weighted by hardPodAffinityWeight.
                for t in existing.required_affinity_terms:
                    tk = t.get("topologyKey", "")
                    tv = node.labels.get(tk)
                    if tv is not None and _term_matches(t, existing.namespace, pod, self.ns_resolver):
                        scores[(tk, tv)] += self.hard_pod_affinity_weight
        state.write(_STATE_KEY + "/score", dict(scores))
        return Status.success()

    def score(self, state: CycleState, pod: PodInfo, node: NodeInfo) -> float:
        scores: dict[tuple[str, str], float] = state.read(_STATE_KEY + "/score") or {}
        total = 0.0
        for (tk, tv), w in scores.items():
            if node.labels.get(tk) == tv:
                total += w
        return total

    def normalize_scores(self, state: CycleState, pod: PodInfo,
                         scores: dict[str, float]) -> None:
        if not scores:
            return
        mx, mn = max(scores.values()), min(scores.values())
        spread = mx - mn
        for k, v in scores.items():
            scores[k] = MAX_NODE_SCORE * (v - mn) / spread if spread else 0.0
