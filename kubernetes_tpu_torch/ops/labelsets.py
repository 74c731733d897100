"""Label-set interning: the dense bridge for irregular label algebra.

Label-selector matching is set algebra over
irregular data. The observation that makes it dense: resident pods come from
templates, so the number of DISTINCT (namespace, label-dict) signatures is
tiny (tens) even in 150k-pod clusters. Interning signatures turns
"pods × selector" matching into:

    node_sig_count (N × U)   — how many resident pods of signature u on node n
    match_vec      (U,)      — does signature u match this selector (host,
                               U evaluations of the exact host Selector)
    counts (N,) = node_sig_count @ match_vec      — a matvec

Topology domains intern the same way: `domain_ids (N,)` for a topology key
maps nodes to dense domain indices, so per-domain aggregation is a
segment-sum and per-node lookup is a gather — the affinity rows
(ops/affinity.py) are built entirely from these three primitives.

Copy of `kubernetes_tpu/ops/labelsets.py`: host numpy, so the rows built
from it are bitwise the reference's.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np

from kubernetes_tpu_torch.api.labels import from_label_selector, ns_contains
from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot


def _sig(pi: PodInfo) -> tuple:
    return (pi.namespace, tuple(sorted(pi.labels.items())))


class LabelSigTable:
    """Unique (namespace, labels) signatures of resident pods + per-node
    counts, split by pod population (all pods / pods with required
    anti-affinity terms need separate counting)."""

    def __init__(self, snapshot: Snapshot, n_pad: int):
        self.sigs: dict[tuple, int] = {}
        self.sig_examples: list[PodInfo] = []   # one pod per signature
        rows = []
        for ni in snapshot.nodes:
            counts: dict[int, int] = {}
            for pi in ni.pods:
                u = self._intern(pi)
                counts[u] = counts.get(u, 0) + 1
            rows.append(counts)
        U = max(1, len(self.sigs))
        self.node_sig_count = np.zeros((n_pad, U), dtype=np.float32)
        for n, counts in enumerate(rows):
            for u, c in counts.items():
                self.node_sig_count[n, u] = c
        #: selector-signature -> (U,) match vector cache
        self._match_cache: dict[str, np.ndarray] = {}

    def _intern(self, pi: PodInfo) -> int:
        s = _sig(pi)
        u = self.sigs.get(s)
        if u is None:
            u = self.sigs[s] = len(self.sig_examples)
            self.sig_examples.append(pi)
        return u

    def match_vec(self, label_selector: Mapping | None,
                  namespaces: Sequence[str]) -> np.ndarray:
        """(U,) float32: 1.0 where the signature's namespace ∈ namespaces and
        its labels match the selector — the exact host Selector semantics.
        `namespaces` may be labels.ALL_NAMESPACES ("*",) = every namespace."""
        key = repr((label_selector, tuple(namespaces)))
        vec = self._match_cache.get(key)
        if vec is None:
            sel = from_label_selector(label_selector)
            nset = set(namespaces)
            vec = np.zeros((max(1, len(self.sig_examples)),), dtype=np.float32)
            for u, pi in enumerate(self.sig_examples):
                if ns_contains(nset, pi.namespace) and sel.matches(pi.labels):
                    vec[u] = 1.0
            self._match_cache[key] = vec
        return vec


class TopologyTable:
    """Per-topology-key dense domain ids (lazily built, cached)."""

    def __init__(self, nodes: Sequence[NodeInfo], n_pad: int):
        self._nodes = nodes
        self._n_pad = n_pad
        self._cache: dict[str, tuple[np.ndarray, int]] = {}

    def domains(self, topology_key: str) -> tuple[np.ndarray, int]:
        """(domain_ids (n_pad,) int32, num_domains). Nodes WITHOUT the key
        get the reserved domain 0 ("no domain" — always treated separately
        via the has_key mask); real domains start at 1."""
        got = self._cache.get(topology_key)
        if got is None:
            ids = np.zeros((self._n_pad,), dtype=np.int32)
            interned: dict[str, int] = {}
            for n, ni in enumerate(self._nodes):
                v = ni.labels.get(topology_key)
                if v is None:
                    continue
                d = interned.get(v)
                if d is None:
                    d = interned[v] = len(interned) + 1
                ids[n] = d
            got = (ids, len(interned) + 1)
            self._cache[topology_key] = got
        return got

    def has_key(self, topology_key: str) -> np.ndarray:
        return self.domains(topology_key)[0] > 0
