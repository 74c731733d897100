"""kube-apiserver analog: `python -m kubernetes_tpu_torch.apiserver`.

Serves an MVCC store over BOTH wires — HTTP/1.1+JSON (kubectl,
controllers) and the multiplexed KTPU wire (core components) — with
optional WAL durability (crash recovery on restart), bearer-token authn,
and RBAC loaded from a manifest.

    python -m kubernetes_tpu_torch.apiserver --port 8080 \
        --data-dir /var/lib/ktpu --wire-port 8081

Parity target: cmd/kube-apiserver (SURVEY §2.1). Copy of
`kubernetes_tpu/apiserver/__main__.py`; a request that accepts the
protobuf content type is refused with 406 (see server.py).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpu-apiserver", description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--wire-port", type=int, default=0,
                    help="KTPU wire listener port (0 = ephemeral; "
                         "'off' via --no-wire)")
    ap.add_argument("--no-wire", action="store_true")
    from kubernetes_tpu_torch.utils import flags
    ap.add_argument("--data-dir", default=flags.get("KTPU_DATA_DIR"),
                    help="durability directory (WAL + snapshots); "
                         "recovers state on startup when present "
                         "(default: $KTPU_DATA_DIR)")
    ap.add_argument("--fsync", choices=["batch", "always"], default="batch")
    ap.add_argument("--token", action="append", default=[],
                    metavar="TOKEN=USER",
                    help="static bearer token (repeatable)")
    ap.add_argument("--rbac", default=None,
                    help="YAML manifest of ClusterRole/ClusterRoleBinding "
                         "objects enabling RBAC authz")
    ap.add_argument("--audit-log", action="store_true")
    ap.add_argument("--audit-policy", default=None,
                    help="audit.k8s.io/v1 Policy YAML enabling the "
                         "stage-event audit pipeline (levels None/"
                         "Metadata/Request/RequestResponse, first "
                         "matching rule wins)")
    ap.add_argument("--audit-log-path", default=None,
                    help="JSON-lines audit sink with size/age rotation "
                         "(the reference's --audit-log-path)")
    ap.add_argument("--audit-log-maxsize-mb", type=int, default=10,
                    help="rotate the audit log past this size")
    ap.add_argument("--audit-log-maxage-s", type=float, default=None,
                    help="rotate the audit log past this segment age "
                         "in seconds (default: size-only rotation)")
    ap.add_argument("--audit-log-maxbackups", type=int, default=5,
                    help="rotated audit segments kept (.1 newest)")
    ap.add_argument("--audit-webhook-config", default=None,
                    help="YAML {url, batch: {maxSize}, retry: "
                         "{backoff, maxAttempts}} enabling the batching "
                         "audit webhook sink (the reference's "
                         "--audit-webhook-config)")
    ap.add_argument("--trace", action="store_true",
                    help="enable OTel-style request spans")
    return ap


def build_audit_pipeline(args):
    """AuditPipeline from the CLI options, or None when no audit policy
    / sink was asked for. Sink precedence: webhook config > rotated
    file > in-memory (policy with no sink still collects in memory)."""
    if not (args.audit_policy or args.audit_log_path
            or args.audit_webhook_config):
        return None
    from kubernetes_tpu_torch.policy.audit import (
        AuditPipeline,
        AuditPolicy,
        RotatingFileSink,
        WebhookSink,
    )
    policy = AuditPolicy.from_file(args.audit_policy) \
        if args.audit_policy else AuditPolicy.metadata_for_all()
    sink = None
    if args.audit_webhook_config:
        sink = WebhookSink.from_config(args.audit_webhook_config)
    elif args.audit_log_path:
        sink = RotatingFileSink(
            args.audit_log_path,
            max_bytes=args.audit_log_maxsize_mb * 2 ** 20,
            max_age_s=args.audit_log_maxage_s,
            backups=args.audit_log_maxbackups)
    return AuditPipeline(policy, sink=sink)


async def serve(args) -> None:
    from kubernetes_tpu_torch.store import install_core_validation, \
        new_cluster_store
    store = None
    if not args.data_dir:
        # No durability: plain in-memory store. With --data-dir the
        # APIServer owns the whole lifecycle (recover on construction,
        # background flusher/snapshotter, final snapshot on stop).
        store = new_cluster_store()
        install_core_validation(store)

    tokens = {}
    for spec in args.token:
        token, _, user = spec.partition("=")
        if token and user:
            tokens[token] = user

    authorizer = None
    if args.rbac:
        import yaml

        from kubernetes_tpu_torch.apiserver.rbac import RBACAuthorizer
        authorizer = RBACAuthorizer()
        with open(args.rbac) as f:
            for doc in yaml.safe_load_all(f):
                if not doc:
                    continue
                if doc.get("kind") == "ClusterRole":
                    authorizer.add_role(doc)
                elif doc.get("kind") == "ClusterRoleBinding":
                    authorizer.add_binding(doc)

    if args.trace:
        from kubernetes_tpu_torch.utils.tracing import DEFAULT_TRACER
        DEFAULT_TRACER.enabled = True

    from kubernetes_tpu_torch.apiserver.server import APIServer
    from kubernetes_tpu_torch.apiserver.wire import WireServer
    api = APIServer(store, host=args.host, port=args.port,
                    bearer_tokens=tokens, authorizer=authorizer,
                    audit_log=args.audit_log,
                    audit=build_audit_pipeline(args),
                    data_dir=args.data_dir, fsync=args.fsync)
    store = api.store
    await api.start()
    wire = None
    if not args.no_wire:
        wire = WireServer.for_apiserver(api, host=args.host,
                                        port=args.wire_port)
        await wire.start()
        logging.info("wire listening on %s", wire.target)
    logging.info("apiserver listening on %s", api.url)

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    if wire is not None:
        await wire.stop()
    await api.stop()  # owns the durability stop + final snapshot
    store.stop()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    asyncio.run(serve(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
