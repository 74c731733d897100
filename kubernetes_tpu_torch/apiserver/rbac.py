"""RBAC-lite authorization for the API server.

Parity target: plugin/pkg/auth/authorizer/rbac (`RBACAuthorizer.Authorize`)
over the rbac.authorization.k8s.io ClusterRole / ClusterRoleBinding shapes,
trimmed to the verb × resource decision the rest of this framework needs
(no apiGroups/resourceNames/nonResourceURLs distinctions; namespaced Role
scoping collapses onto the cluster scope).

Copy of `kubernetes_tpu/apiserver/rbac.py`.
"""

from __future__ import annotations

from typing import Iterable, Mapping

#: verbs the request-info middleware produces, plus the impersonation
#: filter's `impersonate` check (resource "users").
VERBS = ("get", "list", "watch", "create", "update", "patch", "delete",
         "impersonate")


def make_cluster_role(name: str, rules: list[Mapping]) -> dict:
    """rbac.authorization.k8s.io/v1 ClusterRole:
    rules entries {"verbs": [...], "resources": [...]}."""
    return {"apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRole",
            "metadata": {"name": name},
            "rules": [dict(r) for r in rules]}


def make_cluster_role_binding(name: str, role: str,
                              users: Iterable[str]) -> dict:
    return {"apiVersion": "rbac.authorization.k8s.io/v1",
            "kind": "ClusterRoleBinding",
            "metadata": {"name": name},
            "roleRef": {"kind": "ClusterRole", "name": role},
            "subjects": [{"kind": "User", "name": u} for u in users]}


class RBACAuthorizer:
    """Allow iff some binding grants the user a role whose rules cover
    (verb, resource). Deny-by-default, like the reference."""

    def __init__(self, roles: Iterable[Mapping] = (),
                 bindings: Iterable[Mapping] = ()):
        #: role name -> rules
        self._rules: dict[str, list[dict]] = {}
        #: user -> set of role names ("*" user = everyone)
        self._grants: dict[str, set[str]] = {}
        #: group -> set of role names — kept apart from users so a binding
        #: to Group "admins" never empowers a USER literally named "admins"
        #: (the reference keys its rule index by subject kind too).
        self._group_grants: dict[str, set[str]] = {}
        for r in roles:
            self.add_role(r)
        for b in bindings:
            self.add_binding(b)

    def add_role(self, role: Mapping) -> None:
        self._rules[role["metadata"]["name"]] = [
            dict(r) for r in role.get("rules") or []]

    def add_binding(self, binding: Mapping) -> None:
        role = (binding.get("roleRef") or {}).get("name")
        if not role:
            return
        for subj in binding.get("subjects") or []:
            kind = subj.get("kind")
            name = subj.get("name", "")
            if kind == "Group":
                self._group_grants.setdefault(name, set()).add(role)
            elif kind == "ServiceAccount":
                # SA subjects authenticate as their token username. No
                # namespace ⇒ matches nothing (upstream RBAC ignores such
                # subjects rather than guessing a namespace).
                ns = subj.get("namespace")
                if ns:
                    self._grants.setdefault(
                        f"system:serviceaccount:{ns}:{name}",
                        set()).add(role)
            elif kind in (None, "User"):
                self._grants.setdefault(name, set()).add(role)

    def allowed(self, user: str, verb: str, resource: str,
                groups: Iterable[str] = ()) -> bool:
        roles = self._grants.get(user, set()) | self._grants.get("*", set())
        for g in groups:
            roles = roles | self._group_grants.get(g, set())
        for role in roles:
            for rule in self._rules.get(role, ()):
                verbs = rule.get("verbs") or ()
                resources = rule.get("resources") or ()
                if ("*" in verbs or verb in verbs) and \
                        ("*" in resources or resource in resources):
                    return True
        return False
