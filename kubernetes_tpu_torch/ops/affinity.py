"""Tensorized InterPodAffinity filter (BASELINE config #2 hot path).

Replaces the host plugin's O(pods × nodes × terms) Python walk
(pkg/scheduler/framework/plugins/interpodaffinity/filtering.go — "the
classic hot spot", SURVEY §2.3) with dense algebra over interned label
signatures (ops/labelsets.py):

    counts_t (N,)  = node_sig_count @ match_vec(term)        # matvec
    D_t (K,)       = segment_sum(counts_t · has_key, domains) # per-domain
    per_node (N,)  = D_t[domain_ids]                          # gather
    anti mask      = ¬has_key ∨ (per_node == 0)
    affinity mask  = has_key ∧ (per_node > 0)   [+ first-pod-in-group rule]
    symmetry mask  = ¬has_key ∨ (forbidden-domain count == 0), applied to
                     pods the resident term matches

Numpy, deliberately: U (label signatures) and T (unique terms) are tiny for
template-derived workloads, so per-term cost is a (N×U) matvec — far below
one device dispatch. The rows become host filter and score rows of the
backend's class planes (ops/backend.py); parity with the host plugin is
differential-tested in the reference (tests/test_affinity_tensor.py), and
this copy against the reference (tests/test_torch_affinity.py).

namespaceSelector terms COMPILE like everything else: the term's
effective namespace set resolves at table-build time
(interpodaffinity.resolve_term_namespaces) — through the plugin's
NamespaceResolver when one is wired (the reference's PreFilter namespace
merge), else statically ({} = ALL_NAMESPACES, non-empty selectors match
their explicit namespaces only, exactly what an informer-less resolver
resolves). Either way the result is just a (possibly wildcard) namespace
tuple in the interned-count keys, so no term shape routes a pod off the
tensor path; `supported()` is always True.

Copy of `kubernetes_tpu/ops/affinity.py`, host numpy as there, so every row
is bitwise the reference's.
"""

from __future__ import annotations

import numpy as np

from kubernetes_tpu_torch.api.labels import from_label_selector, ns_contains
from kubernetes_tpu_torch.ops.labelsets import LabelSigTable, TopologyTable
from kubernetes_tpu_torch.scheduler.plugins.interpodaffinity import (
    resolve_term_namespaces as _term_ns,
)
from kubernetes_tpu_torch.scheduler.types import PodInfo, Snapshot


def _seg_sum(values: np.ndarray, ids: np.ndarray, num: int) -> np.ndarray:
    out = np.zeros((num,), dtype=values.dtype)
    np.add.at(out, ids, values)
    return out


class AffinityCompiler:
    """Per-snapshot compiled state for batched affinity filtering.

    `ns_resolver` (plugins.interpodaffinity.NamespaceResolver) resolves
    namespaceSelector terms against live Namespace labels; without one
    the static resolution of resolve_term_namespaces applies ({} = every
    namespace, non-empty selectors = explicit namespaces only). Every
    term shape compiles — there is no host-fallback routing here."""

    def __init__(self, snapshot: Snapshot, n_pad: int, ns_resolver=None):
        self.ns_resolver = ns_resolver
        self.snapshot = snapshot
        self.n_pad = n_pad
        self.n_real = len(snapshot.nodes)
        self.sigs = LabelSigTable(snapshot, n_pad)
        self.topo = TopologyTable(snapshot.nodes, n_pad)
        # Resident pods' required anti-affinity terms (symmetry source):
        # term signature -> (carrier-count vector over nodes, term, owner_ns).
        self.resident_anti: dict[str, tuple[np.ndarray, dict, str]] = {}
        for n, ni in enumerate(snapshot.nodes):
            if not ni.pods_with_required_anti_affinity:
                continue
            for pi in ni.pods_with_required_anti_affinity:
                for term in pi.required_anti_affinity_terms:
                    key = repr((term, pi.namespace))
                    got = self.resident_anti.get(key)
                    if got is None:
                        vec = np.zeros((n_pad,), dtype=np.float32)
                        self.resident_anti[key] = (vec, term, pi.namespace)
                        got = self.resident_anti[key]
                    got[0][n] += 1.0
        # Resident pods' PREFERRED terms + required-affinity terms (score
        # symmetry sources — scoring.go's second loop): term signature →
        # (weight-summed carrier vector over nodes, term, owner_ns).
        # Preferred anti-affinity carriers get negative weights.
        self.resident_score: dict[
            str, tuple[np.ndarray, dict, str, bool]] = {}

        def _carrier(term: dict, ns: str, n: int, w: float,
                     is_hard: bool = False) -> None:
            key = repr((term, ns, is_hard))
            got = self.resident_score.get(key)
            if got is None:
                got = self.resident_score[key] = (
                    np.zeros((n_pad,), dtype=np.float32), term, ns, is_hard)
            got[0][n] += w

        for n, ni in enumerate(snapshot.nodes):
            for pi in ni.pods_with_affinity:
                for t in pi.preferred_affinity_terms:
                    _carrier(t.get("podAffinityTerm") or {}, pi.namespace,
                             n, float(t.get("weight", 1)))
                for t in pi.preferred_anti_affinity_terms:
                    _carrier(t.get("podAffinityTerm") or {}, pi.namespace,
                             n, -float(t.get("weight", 1)))
                for t in pi.required_affinity_terms:
                    # hardPodAffinityWeight multiplies at score_row time.
                    _carrier(t, pi.namespace, n, 1.0, is_hard=True)
        #: per-pending-pod-signature symmetry-match cache
        self._sym_match_cache: dict[tuple, bool] = {}
        #: per-(term,ns) per-node matching-count cache
        self._count_cache: dict[str, np.ndarray] = {}
        #: per-term-signature compiled masks
        self._mask_cache: dict[str, np.ndarray] = {}
        #: full-row caches keyed by pod CONTENT signature (namespace,
        #: labels, term list): template-stamped batches share one row —
        #: the per-pod O(N) row assembly was the 5k families' top host
        #: cost. Cached rows are shared and IDENTITY-STABLE per
        #: signature; callers must not mutate them. The backend's
        #: class-dictionary build leans on that stability: its row
        #: interning memoizes by object identity, so a template's
        #: thousand pods hash the row bytes once and land in one device
        #: plane class (ops/backend._prep_chunk).
        self._filter_row_cache: dict[tuple, np.ndarray] = {}
        self._score_row_cache: dict[tuple, np.ndarray] = {}

    # -- primitives --------------------------------------------------------

    def counts_for(self, selector: dict | None,
                   namespaces: tuple[str, ...]) -> np.ndarray:
        """(n_pad,) count of resident pods matching selector per node."""
        key = repr((selector, namespaces))
        c = self._count_cache.get(key)
        if c is None:
            c = self.sigs.node_sig_count @ self.sigs.match_vec(
                selector, namespaces)
            self._count_cache[key] = c
        return c

    def _domain_presence(self, counts: np.ndarray,
                         topology_key: str) -> tuple[np.ndarray, np.ndarray]:
        """(per_node_domain_count (n_pad,), has_key (n_pad,))."""
        dom_ids, num = self.topo.domains(topology_key)
        has_key = dom_ids > 0
        d = _seg_sum(np.where(has_key, counts, 0.0), dom_ids, num)
        d[0] = 0.0
        return d[dom_ids], has_key

    # -- per-term masks (cached by term signature) -------------------------

    def supported(self, pod: PodInfo) -> bool:
        """Every term shape compiles (namespaceSelector included) —
        retained as a seam for future exotic term shapes."""
        return True

    def anti_term_mask(self, term: dict, owner_ns: str) -> np.ndarray:
        key = "anti/" + repr((term, owner_ns))
        m = self._mask_cache.get(key)
        if m is None:
            counts = self.counts_for(term.get("labelSelector"),
                                     _term_ns(term, owner_ns, self.ns_resolver))
            per_node, has_key = self._domain_presence(
                counts, term.get("topologyKey", ""))
            m = ~has_key | (per_node == 0)
            self._mask_cache[key] = m
        return m

    def affinity_term_presence(self, term: dict,
                               owner_ns: str) -> tuple[np.ndarray, np.ndarray, float]:
        """(per_node matching count, has_key, total matches anywhere)."""
        key = "aff/" + repr((term, owner_ns))
        got = self._mask_cache.get(key)
        if got is None:
            counts = self.counts_for(term.get("labelSelector"),
                                     _term_ns(term, owner_ns, self.ns_resolver))
            tk = term.get("topologyKey", "")
            per_node, has_key = self._domain_presence(counts, tk)
            # `total` drives the first-pod-in-group escape: the host plugin
            # only counts matches on nodes that HAVE the topology key
            # (pre_filter skips tv-None nodes), so mask accordingly.
            total = float(np.sum(np.where(
                has_key[: self.n_real], counts[: self.n_real], 0.0)))
            got = (per_node, has_key, total)
            self._mask_cache[key] = got
        return got

    def symmetry_mask(self, pod: PodInfo) -> np.ndarray:
        """Nodes forbidden to `pod` by resident pods' required anti-affinity
        (the both-ways check in filtering.go)."""
        mask = np.ones((self.n_pad,), dtype=np.bool_)
        if not self.resident_anti:
            return mask
        from kubernetes_tpu_torch.api.labels import from_label_selector
        pod_sig = (pod.namespace, tuple(sorted(pod.labels.items())))
        for key, (carriers, term, owner_ns) in self.resident_anti.items():
            mk = (key, pod_sig)
            hit = self._sym_match_cache.get(mk)
            if hit is None:
                nses = _term_ns(term, owner_ns, self.ns_resolver)
                hit = ns_contains(nses, pod.namespace) and \
                    from_label_selector(
                        term.get("labelSelector")).matches(pod.labels)
                self._sym_match_cache[mk] = hit
            if not hit:
                continue
            skey = "sym/" + key
            m = self._mask_cache.get(skey)
            if m is None:
                per_node, has_key = self._domain_presence(
                    carriers, term.get("topologyKey", ""))
                m = ~has_key | (per_node == 0)
                self._mask_cache[skey] = m
            mask &= m
        return mask

    # -- the batch entry ----------------------------------------------------

    def filter_row(self, pod: PodInfo) -> np.ndarray:
        """(n_pad,) bool feasibility row for one pending pod — exact
        InterPodAffinity.Filter semantics over the snapshot. Cached by
        pod CONTENT signature (template batches share one row); the
        returned array is shared — do not mutate."""
        ck = (pod.namespace, tuple(sorted(pod.labels.items())),
              repr(pod.required_affinity_terms),
              repr(pod.required_anti_affinity_terms))
        cached = self._filter_row_cache.get(ck)
        if cached is not None:
            return cached
        row = self.symmetry_mask(pod).copy()
        for term in pod.required_anti_affinity_terms:
            row &= self.anti_term_mask(term, pod.namespace)
        if pod.required_affinity_terms:
            # first-pod-in-group rule: if NO term matches anything anywhere
            # and the pod matches its own terms, terms don't reject (nodes
            # still need the topology keys).
            presences = [
                self.affinity_term_presence(t, pod.namespace)
                for t in pod.required_affinity_terms]
            total_any = sum(p[2] for p in presences)
            if total_any == 0 and self._self_matches(pod):
                for _, has_key, _ in presences:
                    row &= has_key
            else:
                for per_node, has_key, _ in presences:
                    row &= has_key & (per_node > 0)
        row[self.n_real:] = False
        self._filter_row_cache[ck] = row
        return row

    def score_supported(self, pod: PodInfo) -> bool:
        """Preferred terms compile like required ones (namespaceSelector
        included) — retained as a seam, always True."""
        return True

    def _masked_presence(self, counts: np.ndarray, topology_key: str,
                         feasible: np.ndarray
                         ) -> tuple[np.ndarray, np.ndarray]:
        """_domain_presence restricted to feasible nodes — the host
        pre_score iterates only the FILTERED node list, so residents on
        infeasible nodes contribute nothing (per-pod, so uncached)."""
        dom_ids, num = self.topo.domains(topology_key)
        has_key = dom_ids > 0
        d = _seg_sum(np.where(has_key & feasible, counts, 0.0),
                     dom_ids, num)
        d[0] = 0.0
        return d[dom_ids], has_key

    def score_row(self, pod: PodInfo, hard_weight: float,
                  feasible: np.ndarray) -> np.ndarray:
        """(n_pad,) raw InterPodAffinity score — exactly pre_score's
        domain-weight accumulation (scoring.go) over the pod's FEASIBLE
        nodes, vectorized: the pod's preferred (anti-)terms weigh matching
        residents by domain; residents' preferred terms + required terms
        (× hardPodAffinityWeight) weigh back symmetrically. Cached by
        (pod content signature, feasible-mask bytes): template batches
        share one row per distinct feasibility class. Shared array — do
        not mutate."""
        ck = (pod.namespace, tuple(sorted(pod.labels.items())),
              repr(pod.preferred_affinity_terms),
              repr(pod.preferred_anti_affinity_terms),
              hard_weight, feasible.tobytes())
        cached = self._score_row_cache.get(ck)
        if cached is not None:
            return cached
        row = np.zeros((self.n_pad,), dtype=np.float32)
        for term in pod.preferred_affinity_terms:
            t = term.get("podAffinityTerm") or {}
            counts = self.counts_for(t.get("labelSelector"),
                                     _term_ns(t, pod.namespace, self.ns_resolver))
            per_node, has_key = self._masked_presence(
                counts, t.get("topologyKey", ""), feasible)
            row += float(term.get("weight", 1)) * np.where(
                has_key, per_node, 0.0)
        for term in pod.preferred_anti_affinity_terms:
            t = term.get("podAffinityTerm") or {}
            counts = self.counts_for(t.get("labelSelector"),
                                     _term_ns(t, pod.namespace, self.ns_resolver))
            per_node, has_key = self._masked_presence(
                counts, t.get("topologyKey", ""), feasible)
            row -= float(term.get("weight", 1)) * np.where(
                has_key, per_node, 0.0)
        from kubernetes_tpu_torch.api.labels import from_label_selector
        pod_sig = (pod.namespace, tuple(sorted(pod.labels.items())))
        for key, (carriers, term, owner_ns, is_hard) in \
                self.resident_score.items():
            mk = ("score", key, pod_sig)
            hit = self._sym_match_cache.get(mk)
            if hit is None:
                nses = _term_ns(term, owner_ns, self.ns_resolver)
                hit = ns_contains(nses, pod.namespace) and \
                    from_label_selector(
                        term.get("labelSelector")).matches(pod.labels)
                self._sym_match_cache[mk] = hit
            if not hit:
                continue
            per_node, has_key = self._masked_presence(
                carriers, term.get("topologyKey", ""), feasible)
            w = hard_weight if is_hard else 1.0
            row += w * np.where(has_key, per_node, 0.0)
        row[self.n_real:] = 0.0
        self._score_row_cache[ck] = row
        return row

    def _self_matches(self, pod: PodInfo) -> bool:
        from kubernetes_tpu_torch.api.labels import from_label_selector
        for t in pod.required_affinity_terms:
            if not ns_contains(
                    _term_ns(t, pod.namespace, self.ns_resolver),
                    pod.namespace):
                return False
            if not from_label_selector(t.get("labelSelector")).matches(pod.labels):
                return False
        return True

    # -- PodTopologySpread (same primitives, skew semantics) ---------------

    def eligibility_row(self, pod: PodInfo) -> np.ndarray:
        """(n_pad,) nodes eligible for domain counting under this pod's
        nodeSelector/affinity/tolerations (podtopologyspread._node_eligible),
        cached by the pod's eligibility signature."""
        key = "elig/" + repr((pod.node_selector,
                              pod.affinity.get("nodeAffinity"),
                              pod.tolerations))
        row = self._mask_cache.get(key)
        if row is None:
            from kubernetes_tpu_torch.scheduler.plugins.podtopologyspread import (
                _node_eligible,
            )
            row = np.zeros((self.n_pad,), dtype=np.bool_)
            for n, ni in enumerate(self.snapshot.nodes):
                row[n] = _node_eligible(pod, ni)
            self._mask_cache[key] = row
        return row

    def spread_constraint_ns(self, constraint: dict,
                             pod_ns: str) -> tuple[str, ...]:
        """A spread constraint's effective namespace set (plain
        constraints count within the pod's own namespace;
        namespaceSelector resolves like an affinity term's)."""
        return _term_ns(constraint, pod_ns, self.ns_resolver)

    def _spread_domain_counts(self, pod: PodInfo, constraint: dict):
        """Per-constraint: (per_node_count, has_key, eligible, min_count).

        Host semantics (_build_state): only eligible nodes' pods count and
        only eligible domains exist; min is over eligible domains, floored
        to 0 when fewer eligible domains exist than minDomains."""
        key = "spread/" + repr((constraint, pod.namespace,
                                pod.node_selector,
                                pod.affinity.get("nodeAffinity"),
                                pod.tolerations))
        got = self._mask_cache.get(key)
        if got is None:
            sel = constraint.get("labelSelector")
            counts = self.counts_for(
                sel, self.spread_constraint_ns(constraint, pod.namespace))
            elig = self.eligibility_row(pod)
            tk = constraint["topologyKey"]
            dom_ids, num = self.topo.domains(tk)
            has_key = dom_ids > 0
            active = has_key & elig
            d = _seg_sum(np.where(active, counts, 0.0), dom_ids, num)
            # Domains with at least one eligible node "exist" (count ≥ 0);
            # others are fresh (None in the host dict → constraint passes).
            exists = _seg_sum(active.astype(np.float32), dom_ids, num) > 0
            exists[0] = False
            n_existing = int(exists.sum())
            md = int(constraint.get("minDomains") or 0)
            if md and n_existing < md:
                min_count = 0.0
            else:
                min_count = float(d[exists].min()) if n_existing else 0.0
            got = (d[dom_ids], has_key, exists[dom_ids], min_count)
            self._mask_cache[key] = got
        return got

    def spread_filter_row(self, pod: PodInfo,
                          constraints: list[dict]) -> np.ndarray:
        """(n_pad,) DoNotSchedule skew feasibility
        (podtopologyspread.filter)."""
        row = np.ones((self.n_pad,), dtype=np.bool_)
        for c in constraints:
            per_node, has_key, exists, min_count = \
                self._spread_domain_counts(pod, c)
            max_skew = c.get("maxSkew", 1)
            # selfMatchNum (filtering.go): count the incoming pod only if
            # the constraint's selector + namespace set match the pod.
            self_match = 1 if ns_contains(
                self.spread_constraint_ns(c, pod.namespace),
                pod.namespace) and from_label_selector(
                c.get("labelSelector")).matches(pod.labels) else 0
            ok = (~exists) | (per_node + self_match - min_count <= max_skew)
            row &= has_key & ok
        row[self.n_real:] = False
        return row

    def spread_raw_scores(self, pod: PodInfo,
                          constraints: list[dict]) -> np.ndarray:
        """(n_pad,) raw ScheduleAnyway score: Σ matching-pod count in the
        node's domains (podtopologyspread.score; NormalizeScore inverts)."""
        raw = np.zeros((self.n_pad,), dtype=np.float32)
        for c in constraints:
            per_node, has_key, _, _ = self._spread_domain_counts(pod, c)
            raw += np.where(has_key, per_node, 0.0)
        return raw
