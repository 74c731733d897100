"""ktpuctl: the kubectl-equivalent CLI (SURVEY §2.7).

Parity target: staging/src/k8s.io/kubectl `pkg/cmd/` — the operational
verbs an operator needs against the API server: get, describe, apply,
create, patch, diff, logs, delete, scale, cordon/uncordon, drain, top,
rollout.
Talks HTTP to an APIServer (`--server`), or to an in-process store when
a caller passes one (tests, embedded tools).

    python -m kubernetes_tpu_torch.cli get pods -n default
    python -m kubernetes_tpu_torch.cli apply -f manifest.yaml
    python -m kubernetes_tpu_torch.cli create -f manifest.yaml
    python -m kubernetes_tpu_torch.cli patch pods web -p '{"spec": {...}}'
    python -m kubernetes_tpu_torch.cli diff -f manifest.yaml
    python -m kubernetes_tpu_torch.cli logs web-1
    python -m kubernetes_tpu_torch.cli drain node-3

Copy of `kubernetes_tpu/cli/kubectl.py`. It is host code and loads
neither `torch` nor `jax`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Any

from kubernetes_tpu_torch.api.meta import (
    CLUSTER_SCOPED_RESOURCES,
    KIND_TO_RESOURCE,
    namespaced_name,
)
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

#: short names (kubectl's builtin aliases).
ALIASES = {
    "po": "pods", "no": "nodes", "ns": "namespaces",
    "deploy": "deployments", "rs": "replicasets", "sts": "statefulsets",
    "ds": "daemonsets", "pv": "persistentvolumes",
    "pvc": "persistentvolumeclaims", "sc": "storageclasses", "ev": "events",
}


def _resource(arg: str) -> str:
    return ALIASES.get(arg, arg)


def _cluster_scoped(store, resource: str) -> bool:
    # In-process stores know their own CRD-registered scopes; remote
    # clients fall back to the built-in set.
    f = getattr(store, "is_cluster_scoped", None)
    return f(resource) if f else resource in CLUSTER_SCOPED_RESOURCES


def _kind_map(store) -> dict:
    f = getattr(store, "kind_map", None)
    return f() if f else KIND_TO_RESOURCE


def _key(store, resource: str, name: str, namespace: str) -> str:
    if _cluster_scoped(store, resource):
        return name
    return f"{namespace}/{name}"


def _age(obj: dict) -> str:
    ts = obj.get("metadata", {}).get("creationTimestamp")
    if not ts:
        return "<none>"
    try:
        import datetime
        created = datetime.datetime.fromisoformat(ts.replace("Z", "+00:00"))
        secs = max(0, time.time() - created.timestamp())
    except ValueError:
        return "<invalid>"
    if secs < 120:
        return f"{int(secs)}s"
    if secs < 7200:
        return f"{int(secs // 60)}m"
    if secs < 172800:
        return f"{int(secs // 3600)}h"
    return f"{int(secs // 86400)}d"


def _pod_row(p: dict) -> list[str]:
    status = p.get("status", {}).get("phase", "Unknown")
    if p.get("metadata", {}).get("deletionTimestamp"):
        status = "Terminating"
    return [p["metadata"]["name"], status,
            p.get("spec", {}).get("nodeName") or "<none>", _age(p)]


def _node_row(n: dict) -> list[str]:
    ready = "Unknown"
    for c in n.get("status", {}).get("conditions") or []:
        if c.get("type") == "Ready":
            ready = "Ready" if c.get("status") == "True" else "NotReady"
    if n.get("spec", {}).get("unschedulable"):
        ready += ",SchedulingDisabled"
    return [n["metadata"]["name"], ready, _age(n)]


def _print_table(headers: list[str], rows: list[list[str]], out) -> None:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    print("  ".join(h.ljust(w) for h, w in zip(headers, widths)), file=out)
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)), file=out)


def _dump(obj: Any, fmt: str, out) -> None:
    if fmt == "json":
        print(json.dumps(obj, indent=2), file=out)
    else:
        import yaml
        print(yaml.safe_dump(obj, sort_keys=False).rstrip(), file=out)


async def cmd_get(store, args, out) -> int:
    resource = _resource(args.resource)
    if args.name:
        try:
            obj = await store.get(resource,
                                  _key(store, resource, args.name, args.namespace))
        except NotFound as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        if args.output in ("yaml", "json"):
            _dump(obj, args.output, out)
            return 0
        items = [obj]
    else:
        # Namespace filtering happens server-side (store.list supports
        # namespace=), not by transferring the whole cluster and sifting.
        ns = None if (_cluster_scoped(store, resource) or args.all_namespaces) \
            else args.namespace
        sel = None
        if args.selector:
            from kubernetes_tpu_torch.api.labels import parse_selector
            sel = parse_selector(args.selector)
        lst = await store.list(resource, namespace=ns, selector=sel)
        items = lst.items
        if args.output in ("yaml", "json"):
            _dump({"kind": "List", "items": items}, args.output, out)
            return 0
    if resource == "pods":
        _print_table(["NAME", "STATUS", "NODE", "AGE"],
                     [_pod_row(o) for o in items], out)
    elif resource == "nodes":
        _print_table(["NAME", "STATUS", "AGE"],
                     [_node_row(o) for o in items], out)
    else:
        _print_table(["NAME", "AGE"],
                     [[o["metadata"]["name"], _age(o)] for o in items], out)
    return 0


async def cmd_describe(store, args, out) -> int:
    resource = _resource(args.resource)
    key = _key(store, resource, args.name, args.namespace)
    try:
        obj = await store.get(resource, key)
    except NotFound as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    _dump(obj, "yaml", out)
    # Trailing Events section (kubectl describe's most-used part).
    try:
        events = (await store.list("events")).items
    except StoreError:
        events = []
    want_kind = {k for k, r in _kind_map(store).items() if r == resource}
    related = []
    for e in events:
        inv = e.get("involvedObject") or {}
        if inv.get("name") != args.name:
            continue
        if inv.get("kind") and want_kind and inv["kind"] not in want_kind:
            continue
        if not _cluster_scoped(store, resource) and \
                inv.get("namespace", args.namespace) != args.namespace:
            continue
        related.append(e)
    if related:
        print("\nEvents:", file=out)
        for e in related[-10:]:
            print(f"  {e.get('type', '')}\t{e.get('reason', '')}\t"
                  f"{e.get('message', '')}", file=out)
    return 0


def _load_manifests(path: str) -> list[dict]:
    import yaml
    text = sys.stdin.read() if path == "-" else open(path).read()
    return [d for d in yaml.safe_load_all(text) if d]


async def cmd_apply(store, args, out) -> int:
    rc = 0
    for obj in _load_manifests(args.filename):
        resource = _kind_map(store).get(obj.get("kind", ""))
        if resource is None:
            print(f"Error: unknown kind {obj.get('kind')!r}", file=sys.stderr)
            rc = 1
            continue
        meta = obj.setdefault("metadata", {})
        if not _cluster_scoped(store, resource):
            meta.setdefault("namespace", args.namespace)
        if getattr(args, "server_side", False):
            # kubectl apply --server-side: field ownership + conflicts
            # live on the server (store/apply.py).
            from kubernetes_tpu_torch.store.mvcc import Conflict
            try:
                await store.apply(
                    resource, obj,
                    field_manager=getattr(args, "field_manager", "kubectl"),
                    force=getattr(args, "force_conflicts", False))
                print(f"{resource}/{meta.get('name')} serverside-applied",
                      file=out)
            except Conflict as e:
                print(f"Error: {e}", file=sys.stderr)
                rc = 1
            continue
        key = _key(store, resource, meta.get("name", ""),
                   meta.get("namespace", args.namespace))
        try:
            current = await store.get(resource, key)
        except NotFound:
            await store.create(resource, obj)
            print(f"{resource}/{meta.get('name')} created", file=out)
            continue
        await store.update(resource, _apply_merge(current, obj))
        print(f"{resource}/{meta.get('name')} configured", file=out)
    return rc


def _apply_merge(current: dict, obj: dict) -> dict:
    """Client-side apply merge: replace spec-ish fields, keep
    server-owned metadata (shared by apply and diff)."""
    merged = dict(current)
    for k, v in obj.items():
        if k != "metadata":
            merged[k] = v
    merged["metadata"] = dict(current["metadata"])
    meta = obj.get("metadata") or {}
    for k in ("labels", "annotations"):
        if k in meta:
            merged["metadata"][k] = meta[k]
    return merged


async def cmd_diff(store, args, out) -> int:
    """kubectl diff (SURVEY §2.7): local manifests vs the server's live
    objects, with the desired state routed through the server's DRY-RUN
    admission chain (?dryRun=All) when the store supports it — the diff
    shows what admission mutation/defaulting would ACTUALLY persist,
    not the raw manifest. rc 0 = no differences, 1 = differences found,
    2 = error — e.g. admission REJECTED the desired state (kubectl's
    exit-code contract: >1 means the diff itself failed)."""
    import difflib

    import yaml
    differs = False
    errored = False
    for obj in _load_manifests(args.filename):
        resource = _kind_map(store).get(obj.get("kind", ""))
        if resource is None:
            print(f"Error: unknown kind {obj.get('kind')!r}",
                  file=sys.stderr)
            errored = True
            continue
        meta = obj.setdefault("metadata", {})
        if not _cluster_scoped(store, resource):
            meta.setdefault("namespace", args.namespace)
        name = meta.get("name", "")
        key = _key(store, resource, name, meta.get("namespace",
                                                   args.namespace))
        try:
            live = await store.get(resource, key)
        except NotFound:
            live = None
        desired = obj if live is None else _apply_merge(live, obj)
        dry = getattr(store, "dry_run", None)
        if dry is not None:
            try:
                desired = await dry(
                    resource, desired,
                    "create" if live is None else "update")
            except StoreError as e:
                print(f"Error: {resource}/{name} rejected by the "
                      f"dry-run admission chain: {e}", file=sys.stderr)
                errored = True
                continue
        a = yaml.safe_dump(live, sort_keys=True).splitlines() if live \
            else []
        b = yaml.safe_dump(desired, sort_keys=True).splitlines()
        diff = list(difflib.unified_diff(
            a, b, fromfile=f"LIVE/{resource}/{name}",
            tofile=f"MERGED/{resource}/{name}", lineterm=""))
        if diff:
            differs = True
            for line in diff:
                print(line, file=out)
    if errored:
        return 2
    return 1 if differs else 0


async def cmd_logs(store, args, out) -> int:
    """kubectl logs, minimal read path: there is no container runtime,
    so the "log" is reconstructed from the agent-recorded status — the
    hollow kubelet's phase/podIP/condition writes (agent/agent.py
    _mark_running) — followed by the pod's recorded events."""
    key = _key(store, "pods", args.name, args.namespace)
    try:
        pod = await store.get("pods", key)
    except NotFound as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    meta = pod.get("metadata") or {}
    spec = pod.get("spec") or {}
    status = pod.get("status") or {}
    if meta.get("creationTimestamp"):
        print(f"created {meta['creationTimestamp']}", file=out)
    if spec.get("nodeName"):
        print(f"scheduled to node {spec['nodeName']}", file=out)
    for c in status.get("conditions") or []:
        print(f"condition {c.get('type')}={c.get('status')}", file=out)
    if status.get("podIP"):
        print(f"podIP {status['podIP']}", file=out)
    print(f"phase {status.get('phase', 'Unknown')}", file=out)
    try:
        events = (await store.list("events")).items
    except StoreError:
        events = []
    for e in events:
        inv = e.get("involvedObject") or {}
        if inv.get("kind") not in (None, "Pod") or \
                inv.get("name") != args.name:
            continue
        if inv.get("namespace", args.namespace) != args.namespace:
            continue
        print(f"event {e.get('type', '')} {e.get('reason', '')}: "
              f"{e.get('message', '')}", file=out)
    return 0


async def cmd_create(store, args, out) -> int:
    """kubectl create -f: create-only (unlike apply, an existing object
    is an error — pkg/cmd/create semantics)."""
    rc = 0
    for obj in _load_manifests(args.filename):
        resource = _kind_map(store).get(obj.get("kind", ""))
        if resource is None:
            print(f"Error: unknown kind {obj.get('kind')!r}",
                  file=sys.stderr)
            rc = 1
            continue
        meta = obj.setdefault("metadata", {})
        if not _cluster_scoped(store, resource):
            meta.setdefault("namespace", args.namespace)
        try:
            await store.create(resource, obj)
            print(f"{resource}/{meta.get('name')} created", file=out)
        except StoreError as e:
            print(f"Error: {e}", file=sys.stderr)
            rc = 1
    return rc


async def cmd_patch(store, args, out) -> int:
    """kubectl patch: strategic-merge (default) / merge / json patch.
    Against a RemoteStore the server merges and the result runs the
    FULL admission chain (webhooks + expression policies); in-process
    stores fall back to a local merge + guaranteed_update."""
    resource = _resource(args.resource)
    key = _key(store, resource, args.name, args.namespace)
    try:
        patch = json.loads(args.patch)
    except json.JSONDecodeError as e:
        print(f"Error: bad patch JSON: {e}", file=sys.stderr)
        return 1
    try:
        remote_patch = getattr(store, "patch", None)
        if remote_patch is not None:
            await remote_patch(resource, key, patch,
                               patch_type=args.type)
        elif args.type == "json":
            from kubernetes_tpu_torch.apiserver.admission import (
                apply_json_patch,
            )
            await store.guaranteed_update(
                resource, key,
                lambda cur: apply_json_patch(cur, patch),
                return_copy=False)
        else:
            from kubernetes_tpu_torch.store.apply import strategic_merge_patch
            await store.guaranteed_update(
                resource, key,
                lambda cur: strategic_merge_patch(
                    cur, patch, strategic=args.type == "strategic"),
                return_copy=False)
    except StoreError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"{resource}/{args.name} patched", file=out)
    return 0


async def cmd_delete(store, args, out) -> int:
    if args.filename:
        rc = 0
        for obj in _load_manifests(args.filename):
            resource = _kind_map(store).get(obj.get("kind", ""))
            if resource is None:
                print(f"Error: unknown kind {obj.get('kind')!r}",
                      file=sys.stderr)
                rc = 1
                continue
            meta = obj.get("metadata", {})
            key = _key(store, resource, meta.get("name", ""),
                       meta.get("namespace", args.namespace))
            try:
                await store.delete(resource, key)
                print(f"{resource}/{meta.get('name')} deleted", file=out)
            except StoreError as e:
                print(f"Error: {e}", file=sys.stderr)
                rc = 1
        return rc
    resource = _resource(args.resource)
    try:
        await store.delete(resource,
                           _key(store, resource, args.name, args.namespace))
    except StoreError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"{resource}/{args.name} deleted", file=out)
    return 0


async def cmd_scale(store, args, out) -> int:
    resource = _resource(args.resource)
    key = _key(store, resource, args.name, args.namespace)

    def mutate(obj):
        if resource == "jobs":
            obj.setdefault("spec", {})["parallelism"] = args.replicas
        else:
            obj.setdefault("spec", {})["replicas"] = args.replicas
        return obj
    try:
        await store.guaranteed_update(resource, key, mutate,
                                     return_copy=False)
    except StoreError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    print(f"{resource}/{args.name} scaled to {args.replicas}", file=out)
    return 0


async def _set_unschedulable(store, node: str, value: bool) -> None:
    def mutate(obj):
        if value:
            obj.setdefault("spec", {})["unschedulable"] = True
        else:
            obj.get("spec", {}).pop("unschedulable", None)
        return obj
    await store.guaranteed_update("nodes", node, mutate, return_copy=False)


async def cmd_cordon(store, args, out) -> int:
    await _set_unschedulable(store, args.node, True)
    print(f"node/{args.node} cordoned", file=out)
    return 0


async def cmd_uncordon(store, args, out) -> int:
    await _set_unschedulable(store, args.node, False)
    print(f"node/{args.node} uncordoned", file=out)
    return 0


async def cmd_drain(store, args, out) -> int:
    """cordon + evict: delete the node's pods except DaemonSet-owned
    (kubectl drain --ignore-daemonsets semantics)."""
    await _set_unschedulable(store, args.node, True)
    pods = (await store.list("pods")).items
    failed = 0
    for p in pods:
        if p.get("spec", {}).get("nodeName") != args.node:
            continue
        refs = p.get("metadata", {}).get("ownerReferences") or []
        if any(r.get("kind") == "DaemonSet" for r in refs):
            continue
        try:
            # Eviction API first (honors PodDisruptionBudgets); plain
            # delete when the subresource isn't installed.
            try:
                await store.subresource(
                    "pods", namespaced_name(p), "eviction", {})
            except NotFound as e:
                if "not registered" not in str(e):
                    raise
                await store.delete("pods", namespaced_name(p))
            print(f"pod/{p['metadata']['name']} evicted", file=out)
        except StoreError as e:
            failed += 1
            print(f"Error evicting {p['metadata']['name']}: {e}",
                  file=sys.stderr)
    if failed:
        print(f"Error: {failed} pod(s) could not be evicted from "
              f"{args.node}", file=sys.stderr)
        return 1
    print(f"node/{args.node} drained", file=out)
    return 0


async def cmd_top(store, args, out) -> int:
    """top nodes|pods: requested/allocatable (the scheduler's view —
    there is no metrics-server; requests are the capacity signal here)."""
    from kubernetes_tpu_torch.api.resource import format_quantity, parse_quantity
    from kubernetes_tpu_torch.api.types import pod_is_terminal, pod_requests
    if args.what == "pods":
        rows = []
        for p in (await store.list(
                "pods", namespace=args.namespace)).items:
            if pod_is_terminal(p):
                continue
            reqs = pod_requests(p)
            rows.append([
                p["metadata"]["name"],
                format_quantity(reqs.get("cpu", 0)),
                format_quantity(reqs.get("memory", 0)),
                p.get("spec", {}).get("nodeName", "<none>"),
            ])
        _print_table(["NAME", "CPU(req)", "MEM(req)", "NODE"], rows, out)
        return 0
    nodes = (await store.list("nodes")).items
    pods = (await store.list("pods")).items
    used: dict[str, dict[str, int]] = {}
    for p in pods:
        node = p.get("spec", {}).get("nodeName")
        if not node or pod_is_terminal(p):
            continue  # Succeeded/Failed pods hold no capacity
        agg = used.setdefault(node, {})
        for r, v in pod_requests(p).items():
            agg[r] = agg.get(r, 0) + v
    rows = []
    for n in nodes:
        name = n["metadata"]["name"]
        alloc = n.get("status", {}).get("allocatable") or {}
        cpu_a = parse_quantity(alloc.get("cpu", 0))
        mem_a = parse_quantity(alloc.get("memory", 0))
        cpu_u = used.get(name, {}).get("cpu", 0)
        mem_u = used.get(name, {}).get("memory", 0)
        rows.append([
            name,
            f"{format_quantity(cpu_u)}/{format_quantity(cpu_a)}",
            f"{100 * cpu_u // cpu_a if cpu_a else 0}%",
            f"{format_quantity(mem_u)}/{format_quantity(mem_a)}",
            f"{100 * mem_u // mem_a if mem_a else 0}%",
        ])
    _print_table(["NAME", "CPU(req/alloc)", "CPU%",
                  "MEM(req/alloc)", "MEM%"], rows, out)
    return 0



async def cmd_rollout(store, args, out) -> int:
    """rollout status|restart|history for deployments (kubectl rollout).

    status: observedGeneration + updated/ready vs desired (the reference
    rollout_status.go readiness math); restart: stamps
    kubectl.kubernetes.io/restartedAt into the pod template, which hashes
    to a new revision and rolls every pod (kubectl rollout restart).
    """
    from kubernetes_tpu_torch.api.meta import now_iso
    if args.resource not in ("deployment", "deployments"):
        print("Error: rollout supports deployments", file=sys.stderr)
        return 1
    key = _key(store, "deployments", args.name, args.namespace)
    try:
        dep = await store.get("deployments", key)
    except NotFound:
        print(f"Error: deployment {args.name!r} not found", file=sys.stderr)
        return 1
    if args.action == "status":
        spec = dep.get("spec") or {}
        status = dep.get("status") or {}
        desired = int(spec.get("replicas", 1))
        updated = int(status.get("updatedReplicas", 0))
        ready = int(status.get("readyReplicas", 0))
        gen_ok = int(status.get("observedGeneration", 0)) >= \
            int(dep["metadata"].get("generation", 0) or 0)
        if gen_ok and updated == desired and ready == desired:
            print(f'deployment "{args.name}" successfully rolled out',
                  file=out)
            return 0
        print(f"Waiting for deployment {args.name!r} rollout to finish: "
              f"{updated} out of {desired} new replicas have been "
              f"updated, {ready} ready...", file=out)
        return 3  # kubectl's non-zero while in progress (watch loop)
    if args.action == "restart":
        stamp = now_iso()

        def bump(obj):
            tmpl = obj.setdefault("spec", {}).setdefault("template", {})
            md = tmpl.setdefault("metadata", {})
            md.setdefault("annotations", {})[
                "kubectl.kubernetes.io/restartedAt"] = stamp
            return obj
        await store.guaranteed_update("deployments", key, bump,
                                      return_copy=False)
        print(f"deployment.apps/{args.name} restarted", file=out)
        return 0
    if args.action == "history":
        rss = (await store.list("replicasets",
                                namespace=args.namespace)).items
        rows = []
        for rs in rss:
            for ref in rs["metadata"].get("ownerReferences") or []:
                if ref.get("kind") == "Deployment" and \
                        ref.get("name") == args.name:
                    rows.append([
                        rs["metadata"].get("annotations", {}).get(
                            "deployment.kubernetes.io/revision", "?"),
                        rs["metadata"]["name"],
                        str(rs.get("spec", {}).get("replicas", 0)),
                    ])
        rows.sort(key=lambda r: int(r[0]) if r[0].isdigit() else 1 << 30)
        _print_table(["REVISION", "REPLICASET", "REPLICAS"], rows, out)
        return 0
    print(f"Error: unknown rollout action {args.action!r}",
          file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpuctl", description=__doc__)
    ap.add_argument("--server", "-s", default="http://127.0.0.1:8080",
                    help="API server URL")
    ap.add_argument("--token", default=None, help="bearer token")
    ap.add_argument("--namespace", "-n", default="default")
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("get")
    g.add_argument("resource")
    g.add_argument("name", nargs="?")
    g.add_argument("-o", "--output", choices=["table", "yaml", "json"],
                   default="table")
    g.add_argument("-l", "--selector", default=None)
    g.add_argument("-A", "--all-namespaces", action="store_true")
    g.set_defaults(fn=cmd_get)

    d = sub.add_parser("describe")
    d.add_argument("resource")
    d.add_argument("name")
    d.set_defaults(fn=cmd_describe)

    a = sub.add_parser("apply")
    a.add_argument("-f", "--filename", required=True)
    a.add_argument("--server-side", action="store_true",
                   help="server-side apply: declarative field ownership "
                        "with managedFields + conflict detection")
    a.add_argument("--field-manager", default="kubectl",
                   help="field owner name for --server-side")
    a.add_argument("--force-conflicts", action="store_true",
                   help="take ownership of conflicting fields")
    a.set_defaults(fn=cmd_apply)

    cr = sub.add_parser("create")
    cr.add_argument("-f", "--filename", required=True)
    cr.set_defaults(fn=cmd_create)

    df = sub.add_parser("diff")
    df.add_argument("-f", "--filename", required=True)
    df.set_defaults(fn=cmd_diff)

    lg = sub.add_parser("logs")
    lg.add_argument("name")
    lg.set_defaults(fn=cmd_logs)

    pa = sub.add_parser("patch")
    pa.add_argument("resource")
    pa.add_argument("name")
    pa.add_argument("-p", "--patch", required=True,
                    help="patch document (JSON)")
    pa.add_argument("--type", choices=["strategic", "merge", "json"],
                    default="strategic")
    pa.set_defaults(fn=cmd_patch)

    rm = sub.add_parser("delete")
    rm.add_argument("resource", nargs="?")
    rm.add_argument("name", nargs="?")
    rm.add_argument("-f", "--filename", default=None)
    rm.set_defaults(fn=cmd_delete)

    sc = sub.add_parser("scale")
    sc.add_argument("resource")
    sc.add_argument("name")
    sc.add_argument("--replicas", type=int, required=True)
    sc.set_defaults(fn=cmd_scale)

    for verb, fn in (("cordon", cmd_cordon), ("uncordon", cmd_uncordon),
                     ("drain", cmd_drain)):
        c = sub.add_parser(verb)
        c.add_argument("node")
        c.set_defaults(fn=fn)

    t = sub.add_parser("top")
    t.add_argument("what", choices=["nodes", "pods"])
    t.set_defaults(fn=cmd_top)

    ro = sub.add_parser("rollout")
    ro.add_argument("action", choices=["status", "restart", "history"])
    ro.add_argument("resource")
    ro.add_argument("name")
    ro.set_defaults(fn=cmd_rollout)
    return ap


async def run_command(store, args, out=None) -> int:
    """Entry for tests/embedding: run one parsed command against any
    MVCCStore-shaped object (RemoteStore or in-process)."""
    return await args.fn(store, args, out or sys.stdout)


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)

    async def body() -> int:
        from kubernetes_tpu_torch.apiserver.client import RemoteStore
        rs = RemoteStore(args.server, token=args.token)
        try:
            try:
                # Learn CRD kinds/scopes from server discovery (RESTMapper
                # pattern); a failed fetch just leaves the built-ins.
                await rs.refresh_discovery()
            except Exception:
                pass
            return await run_command(rs, args)
        finally:
            await rs.close()

    try:
        return asyncio.run(body())
    except StoreError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except OSError as e:  # file not found, connection refused, ...
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except ValueError as e:  # bad selector / quantity / YAML scalar
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except Exception as e:  # aiohttp client errors etc. — one line, rc 1
        print(f"Error: {type(e).__name__}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
