"""Server-side apply: field ownership, conflicts, three-way merge.

Parity target: structured-merge-diff + the apply handler
(`pkg/endpoints/handlers/fieldmanager`, SURVEY §2.7 kubectl
`apply --server-side`):

- every applied field is OWNED by the applying fieldManager, recorded in
  metadata.managedFields as {manager, operation: "Apply", fieldsV1};
- applying a field another manager owns WITH A DIFFERENT VALUE is a
  CONFLICT (409 listing the owners) unless force=true, which transfers
  ownership (the reference's conflict/force semantics); equal values
  co-own;
- fields a manager applied before but omits now are REMOVED from the
  object unless another manager also owns them (apply is declarative:
  the config IS the manager's full intent).

Simplification vs the reference, by design: lists are ATOMIC leaves
(no listType=map granular merge) — the whole list is one owned field.
That is exactly how the reference treats `x-kubernetes-list-type:
atomic` lists; granular keyed-list merging is not modeled.

Copy of `kubernetes_tpu/store/apply.py`.
"""

from __future__ import annotations

import copy
from typing import Iterable, Mapping

from kubernetes_tpu_torch.store.mvcc import Conflict, NotFound

#: metadata fields the SERVER owns; appliers never take these over.
_SERVER_META = {"name", "namespace", "uid", "resourceVersion",
                "creationTimestamp", "managedFields", "generation"}


class ApplyConflict(Conflict):
    """409 with the owning managers listed (reference conflict error)."""

    def __init__(self, conflicts: list[tuple[tuple, str]]):
        self.conflicts = conflicts
        lines = ", ".join(
            f"{'.'.join(path)} (owned by {mgr!r})"
            for path, mgr in conflicts)
        super().__init__(f"Apply failed with conflicting fields: {lines}")


def field_paths(obj: Mapping, prefix: tuple = ()) -> set[tuple]:
    """Leaf paths of the applied configuration. Lists are atomic leaves;
    metadata server-owned keys are excluded at the top level."""
    out: set[tuple] = set()
    for k, v in obj.items():
        if prefix == () and k in ("apiVersion", "kind"):
            continue
        if prefix == ("metadata",) and k in _SERVER_META:
            continue
        path = prefix + (k,)
        if isinstance(v, Mapping) and v:
            out |= field_paths(v, path)
        else:
            out.add(path)
    return out


def fields_v1(paths: Iterable[tuple]) -> dict:
    """Upstream's fieldsV1 wire shape: nested {"f:<key>": {...}}."""
    root: dict = {}
    for path in sorted(paths):
        node = root
        for part in path:
            node = node.setdefault(f"f:{part}", {})
    return root


def paths_from_fields_v1(doc: Mapping, prefix: tuple = ()) -> set[tuple]:
    out: set[tuple] = set()
    for k, v in doc.items():
        if not k.startswith("f:"):
            continue
        path = prefix + (k[2:],)
        if v:
            out |= paths_from_fields_v1(v, path)
        else:
            out.add(path)
    return out


def _related(p: tuple, q: tuple) -> bool:
    """True when one path is a (non-strict) prefix of the other."""
    n = len(p) if len(p) < len(q) else len(q)
    return p[:n] == q[:n]


def get_path(obj: Mapping, path: tuple):
    cur = obj
    for part in path:
        if not isinstance(cur, Mapping) or part not in cur:
            return None
        cur = cur[part]
    return cur


def _set_path(obj: dict, path: tuple, value) -> None:
    cur = obj
    for part in path[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            nxt = cur[part] = {}
        cur = nxt
    cur[path[-1]] = value


def _del_path(obj: dict, path: tuple) -> None:
    cur = obj
    parents = []
    for part in path[:-1]:
        nxt = cur.get(part)
        if not isinstance(nxt, dict):
            return
        parents.append((cur, part))
        cur = nxt
    cur.pop(path[-1], None)
    # prune now-empty parents
    for parent, part in reversed(parents):
        if parent[part] == {}:
            parent.pop(part, None)
        else:
            break


def _owners(current: Mapping) -> dict[str, set[tuple]]:
    out: dict[str, set[tuple]] = {}
    for entry in (current.get("metadata") or {}) \
            .get("managedFields") or []:
        mgr = entry.get("manager", "")
        out[mgr] = paths_from_fields_v1(entry.get("fieldsV1") or {})
    return out


async def server_side_apply(store, resource: str, obj: Mapping, *,
                            field_manager: str, force: bool = False,
                            max_retries: int = 16) -> dict:
    """Apply `obj` as `field_manager`'s full declarative intent.

    Explicit CAS loop (not guaranteed_update): conflicts must be
    computed against the SAME object version the write lands on — a
    stale-read check would let a concurrent owner's write be silently
    overwritten — and ApplyConflict must escape, not be retried as an
    optimistic-concurrency conflict (it subclasses Conflict so the HTTP
    layer maps it to 409)."""
    from kubernetes_tpu_torch.api.meta import namespaced_name
    from kubernetes_tpu_torch.store.mvcc import AlreadyExists
    applied = dict(obj)
    key = namespaced_name(applied)
    applied_paths = field_paths(applied)
    for _ in range(max_retries):
        try:
            current = await store.get(resource, key)
        except NotFound:
            # Deep copy HERE (create path only): managedFields is injected
            # into metadata and must not mutate the caller's input; the
            # update path never writes into `applied`.
            fresh = copy.deepcopy(applied)
            meta = fresh.setdefault("metadata", {})
            meta["managedFields"] = [{
                "manager": field_manager, "operation": "Apply",
                "fieldsV1": fields_v1(applied_paths)}]
            try:
                return await store.create(resource, fresh)
            except AlreadyExists:
                continue  # create race: re-apply against the winner

        want_rv = current["metadata"]["resourceVersion"]
        owners = _owners(current)
        # An applied path collides with an owned path when one is a
        # prefix of the other, not only on exact match: applying a
        # scalar where another manager owns deeper leaves (or a subtree
        # under another manager's leaf) is a structural overwrite that
        # structured-merge-diff flags (advisor r4). Value-equal exact
        # overlaps co-own, as before.
        conflicts: list[tuple[tuple, str]] = []
        force_strip: dict[str, set[tuple]] = {}
        for path in applied_paths:
            new_val = get_path(applied, path)
            if get_path(current, path) == new_val:
                continue  # no change at this leaf → no conflict
            for mgr, owned in owners.items():
                if mgr == field_manager:
                    continue
                overlap = {q for q in owned if _related(path, q)}
                if overlap:
                    conflicts.append((path, mgr))
                    force_strip.setdefault(mgr, set()).update(overlap)
        if conflicts and not force:
            raise ApplyConflict(sorted(set(conflicts)))

        prev_own = owners.get(field_manager, set())
        removed = {
            p for p in prev_own - applied_paths
            if not any(p in owned for mgr, owned in owners.items()
                       if mgr != field_manager)}

        merged = current
        for path in sorted(applied_paths):
            _set_path(merged, path, get_path(applied, path))
        for path in sorted(removed):
            _del_path(merged, path)
        # Ownership bookkeeping: this manager owns exactly its applied
        # set; forced conflicts strip the field from the losers.
        new_owners: dict[str, set[tuple]] = {}
        for mgr, owned in owners.items():
            if mgr == field_manager:
                continue
            keep = set(owned)
            if force:
                keep -= force_strip.get(mgr, set())
            keep -= removed
            if keep:
                new_owners[mgr] = keep
        new_owners[field_manager] = set(applied_paths)
        merged["metadata"]["managedFields"] = [
            {"manager": mgr, "operation": "Apply",
             "fieldsV1": fields_v1(paths)}
            for mgr, paths in sorted(new_owners.items())]
        merged["metadata"]["resourceVersion"] = want_rv
        try:
            return await store.update(resource, merged)
        except ApplyConflict:
            raise
        except Conflict:
            continue  # CAS retry against the newer version
    raise Conflict(f"{resource} {key!r}: too many apply retries")


# ---------------------------------------------------------------------------
# kubectl patch: strategic-merge / merge patch
# ---------------------------------------------------------------------------

#: patchMergeKey per list field (apimachinery strategic-merge tags): lists
#: of objects under these keys merge entry-by-entry on the key instead of
#: replacing wholesale.
_MERGE_KEYS = {"containers": "name", "initContainers": "name",
               "tolerations": "key", "env": "name", "ports": "containerPort",
               "volumes": "name", "volumeMounts": "mountPath"}


def strategic_merge_patch(current: Mapping, patch: Mapping, *,
                          strategic: bool = True) -> dict:
    """RFC-7386 merge patch, plus the strategic keyed-list merge subset
    (`kubectl patch` default): dicts merge recursively, explicit null
    deletes, lists replace — except, when `strategic`, lists of objects
    under a known patchMergeKey field merge per entry on that key."""

    def merge(cur, pat, field=""):
        if isinstance(cur, Mapping) and isinstance(pat, Mapping):
            out = dict(cur)
            for k, v in pat.items():
                if v is None:
                    out.pop(k, None)
                elif k in out:
                    out[k] = merge(out[k], v, k)
                else:
                    out[k] = copy.deepcopy(v)
            return out
        if strategic and isinstance(cur, list) and isinstance(pat, list):
            mk = _MERGE_KEYS.get(field)
            if mk and all(isinstance(e, Mapping) and mk in e
                          for e in [*cur, *pat]):
                out = [copy.deepcopy(e) for e in cur]
                index = {e[mk]: i for i, e in enumerate(out)}
                for e in pat:
                    i = index.get(e[mk])
                    if i is None:
                        index[e[mk]] = len(out)
                        out.append(copy.deepcopy(e))
                    else:
                        out[i] = merge(out[i], e)
                return out
        return copy.deepcopy(pat)

    return merge(dict(current), patch)
