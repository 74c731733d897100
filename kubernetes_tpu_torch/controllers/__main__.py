"""kube-controller-manager analog: `python -m
kubernetes_tpu_torch.controllers`.

Hosts the full controller set over one informer factory against a remote
apiserver, with leader election.

    python -m kubernetes_tpu_torch.controllers --server http://127.0.0.1:8080 \
        --controllers deployment,replicaset,job,cronjob,gc

Parity target: cmd/kube-controller-manager (SURVEY §2.1).

Copy of `kubernetes_tpu/controllers/__main__.py`; under `--leader-elect` its
start line also names the replica's lease identity.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal

#: name -> constructor(store); the default set mirrors the reference's
#: always-on controllers.
REGISTRY = {
    "deployment": "DeploymentController",
    "replicaset": "ReplicaSetController",
    "statefulset": "StatefulSetController",
    "daemonset": "DaemonSetController",
    "job": "JobController",
    "cronjob": "CronJobController",
    "nodelifecycle": "NodeLifecycleController",
    "podgc": "PodGCController",
    "gc": "GarbageCollectorController",
    "namespace": "NamespaceController",
    "endpointslice": "EndpointSliceController",
    "resourcequota": "ResourceQuotaController",
    "disruption": "DisruptionController",
    "ttl": "TTLAfterFinishedController",
    "hpa": "HorizontalPodAutoscalerController",
    "pvbinder": "PVBinderController",
    "attachdetach": "AttachDetachController",
    "resourceclaim": "ResourceClaimController",
    "serviceaccount": "ServiceAccountController",
    "serviceaccount-token": "TokenController",
    "kubeproxy": "KubeProxyController",
}

DEFAULT_SET = [n for n in REGISTRY if n not in ("kubeproxy",)]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpu-controller-manager",
                                 description=__doc__)
    ap.add_argument("--server", default=None)
    ap.add_argument("--wire", default=None)
    ap.add_argument("--token", default=None)
    ap.add_argument("--controllers", default=",".join(DEFAULT_SET),
                    help="comma list (default: all but kubeproxy)")
    ap.add_argument("--leader-elect", action="store_true")
    return ap


async def serve(args) -> None:
    if args.wire:
        from kubernetes_tpu_torch.apiserver.wire import WireStore
        store = WireStore(args.wire, token=args.token,
                          user_agent="ktpu-controller-manager")
    elif args.server:
        from kubernetes_tpu_torch.apiserver.client import RemoteStore
        store = RemoteStore(args.server, token=args.token,
                            user_agent="ktpu-controller-manager")
    else:
        raise SystemExit("one of --server / --wire is required")

    import kubernetes_tpu_torch.controllers as C
    wanted = [n.strip() for n in args.controllers.split(",") if n.strip()]
    controllers = []
    for name in wanted:
        cls_name = REGISTRY.get(name)
        if cls_name is None:
            raise SystemExit(f"unknown controller {name!r}")
        controllers.append(getattr(C, cls_name)(store))
    mgr = C.ControllerManager(store, controllers)

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass

    if args.leader_elect:
        import uuid

        from kubernetes_tpu_torch.client.leaderelection import LeaderElector
        identity = f"ktpu-cm-{uuid.uuid4().hex[:8]}"
        elector = LeaderElector(store, "kube-controller-manager",
                                identity=identity)
        # ControllerManager owns the fencing: losing the lease STOPS
        # every controller so the standby replica converges instead of
        # double-reconciling.
        task = asyncio.ensure_future(
            mgr.run_with_leader_election(elector))
        logging.info("controller-manager %s (leader-elected): %s",
                     identity, ", ".join(wanted))
        stop_task = asyncio.ensure_future(stop.wait())
        await asyncio.wait({task, stop_task},
                           return_when=asyncio.FIRST_COMPLETED)
        task.cancel()
        stop_task.cancel()
        await asyncio.gather(task, return_exceptions=True)
    else:
        await mgr.start()
        logging.info("controller-manager running: %s", ", ".join(wanted))
        await stop.wait()
        await mgr.stop()
    close = getattr(store, "close", None)
    if close is not None:
        await close()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    asyncio.run(serve(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
