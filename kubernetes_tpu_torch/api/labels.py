"""Label and field selectors.

Capability parity with the reference's label machinery
(staging/src/k8s.io/apimachinery/pkg/labels/selector.go: `Parse`, `Selector.Matches`;
pkg/apis/meta/v1 `LabelSelector` with matchLabels + matchExpressions operators
In/NotIn/Exists/DoesNotExist; node-affinity adds Gt/Lt in
pkg/apis/core/v1/nodeaffinity).

Copy of `kubernetes_tpu/api/labels.py`: the store, the informers and node
affinity match one object at a time through these functions.
"""

from __future__ import annotations

import re
from typing import Iterable, Mapping


class Requirement:
    """One selector term: key op values."""

    __slots__ = ("key", "op", "values")

    def __init__(self, key: str, op: str, values: Iterable[str] = ()):
        self.key = key
        self.op = op  # In | NotIn | Exists | DoesNotExist | Gt | Lt
        self.values = list(values)

    def matches(self, labels: Mapping[str, str]) -> bool:
        has = self.key in labels
        if self.op == "Exists":
            return has
        if self.op == "DoesNotExist":
            return not has
        if self.op == "In":
            return has and labels[self.key] in self.values
        if self.op == "NotIn":
            # Reference semantics (labels.Requirement.Matches): NotIn matches
            # when the key is absent OR the value is not in the set.
            return (not has) or labels[self.key] not in self.values
        if self.op in ("Gt", "Lt"):
            if not has:
                return False
            try:
                v = int(labels[self.key])
                bound = int(self.values[0])
            except (ValueError, IndexError):
                return False
            return v > bound if self.op == "Gt" else v < bound
        raise ValueError(f"unknown selector operator {self.op!r}")

    def __repr__(self) -> str:
        return f"Requirement({self.key} {self.op} {self.values})"


class Selector:
    """Conjunction of requirements. Empty selector matches everything."""

    __slots__ = ("requirements",)

    def __init__(self, requirements: Iterable[Requirement] = ()):
        self.requirements = list(requirements)

    def matches(self, labels: Mapping[str, str] | None) -> bool:
        labels = labels or {}
        return all(r.matches(labels) for r in self.requirements)

    def __repr__(self) -> str:
        return f"Selector({self.requirements})"


def from_label_selector(sel: Mapping | None) -> Selector:
    """Compile a meta/v1 LabelSelector dict → Selector.

    A nil LabelSelector matches nothing in the reference's
    metav1.LabelSelectorAsSelector only for *nil*; empty ({}) matches everything.
    Callers that need match-nothing-on-nil handle it themselves (we return a
    match-all for None for symmetry with labels.Everything(); workload
    controllers guard for nil explicitly).
    """
    if sel is None:
        return Selector()
    reqs: list[Requirement] = []
    for k, v in (sel.get("matchLabels") or {}).items():
        reqs.append(Requirement(k, "In", [v]))
    for expr in sel.get("matchExpressions") or []:
        reqs.append(Requirement(expr["key"], expr["operator"], expr.get("values") or []))
    return Selector(reqs)


def match_label_selector(sel: Mapping | None, labels: Mapping[str, str] | None) -> bool:
    return from_label_selector(sel).matches(labels)


#: Sentinel namespace set: "every namespace". An empty namespaceSelector
#: ({}) selects all namespaces in the reference (it matches any label set,
#: including namespaces with no labels or no Namespace object at all), so
#: resolution returns this instead of enumerating a namespace universe.
#: "*" cannot collide with a real namespace (DNS-1123 forbids it).
ALL_NAMESPACES = ("*",)


def ns_contains(namespaces, ns: str) -> bool:
    """Membership in a resolved namespace set, honoring ALL_NAMESPACES."""
    return "*" in namespaces or ns in namespaces


def is_empty_label_selector(sel: Mapping | None) -> bool:
    """True for the match-everything selector ({} or requirement-less)."""
    return sel is not None and not sel.get("matchLabels") \
        and not sel.get("matchExpressions")


def parse_selector(s: str) -> Selector:
    """Parse the string selector grammar: "a=b,c!=d,e in (x,y),f,!g".

    Mirrors labels.Parse (staging/src/k8s.io/apimachinery/pkg/labels/selector.go)
    for the common forms used by kubectl and field selectors.
    """
    reqs: list[Requirement] = []
    if not s.strip():
        return Selector()
    # Split on commas not inside parens.
    parts, depth, cur = [], 0, []
    for ch in s:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))

    for part in parts:
        part = part.strip()
        if not part:
            continue
        if part.startswith("!"):
            reqs.append(Requirement(part[1:].strip(), "DoesNotExist"))
            continue
        m = re.match(r"^([\w./-]+)\s+(in|notin)\s+\(([^)]*)\)$", part)
        if m:
            values = [v.strip() for v in m.group(3).split(",") if v.strip()]
            reqs.append(Requirement(m.group(1), "In" if m.group(2) == "in" else "NotIn", values))
            continue
        m = re.match(r"^([\w./-]+)\s*(==|!=|=)\s*([\w./-]*)$", part)
        if m:
            op = "NotIn" if m.group(2) == "!=" else "In"
            reqs.append(Requirement(m.group(1), op, [m.group(3)]))
            continue
        m = re.match(r"^([\w./-]+)$", part)
        if m:
            reqs.append(Requirement(m.group(1), "Exists"))
            continue
        raise ValueError(f"cannot parse selector clause {part!r}")
    return Selector(reqs)


def parse_field_selector(s: str) -> dict[str, str]:
    """Parse the `fieldSelector` query grammar: "spec.nodeName=n0,
    status.phase=Running" (fields.ParseSelector — the apiserver supports
    only exact-match terms, which is also what the store's tracked-field
    index serves)."""
    fields: dict[str, str] = {}
    for part in s.split(","):
        part = part.strip()
        if not part:
            continue
        m = re.match(r"^([\w./-]+)\s*==?\s*([^,]*)$", part)
        if m is None:
            raise ValueError(f"cannot parse field selector clause {part!r}")
        fields[m.group(1)] = m.group(2).strip()
    return fields


def field_selector_to_string(fields: Mapping[str, str] | None) -> str:
    """Serialize a field map back to the query grammar."""
    if not fields:
        return ""
    return ",".join(f"{k}={v}" for k, v in sorted(fields.items()))


def selector_to_string(sel: Selector | None) -> str:
    """Serialize a Selector back to the string grammar parse_selector reads
    (the `labelSelector` query-parameter wire form)."""
    if sel is None or not sel.requirements:
        return ""
    parts: list[str] = []
    for r in sel.requirements:
        if r.op == "Exists":
            parts.append(r.key)
        elif r.op == "DoesNotExist":
            parts.append("!" + r.key)
        elif r.op == "In" and len(r.values) == 1:
            parts.append(f"{r.key}={r.values[0]}")
        elif r.op == "NotIn" and len(r.values) == 1:
            parts.append(f"{r.key}!={r.values[0]}")
        elif r.op in ("In", "NotIn"):
            parts.append(
                f"{r.key} {'in' if r.op == 'In' else 'notin'} "
                f"({','.join(r.values)})")
        else:
            raise ValueError(
                f"operator {r.op!r} has no string-selector form")
    return ",".join(parts)


def match_node_selector_terms(
    terms: list | None,
    node_labels: Mapping[str, str],
    node_name: str = "",
) -> bool:
    """RequiredDuringScheduling nodeSelectorTerms: OR of terms, AND within a term.

    Mirrors component-helpers' nodeaffinity.GetRequiredNodeAffinity /
    MatchNodeSelectorTerms semantics: empty/nil term list matches nothing here
    (callers treat absent affinity as match-all before calling). `node_name`
    backs matchFields on metadata.name — the only field selector the reference
    supports there.
    """
    if not terms:
        return False
    for term in terms:
        ok = True
        for expr in term.get("matchExpressions") or []:
            r = Requirement(expr["key"], expr["operator"], expr.get("values") or [])
            if not r.matches(node_labels):
                ok = False
                break
        if ok:
            for expr in term.get("matchFields") or []:
                if expr["key"] != "metadata.name":
                    ok = False
                    break
                r = Requirement("name", expr["operator"], expr.get("values") or [])
                ok = r.matches({"name": node_name})
                if not ok:
                    break
        if ok:
            return True
    return False
