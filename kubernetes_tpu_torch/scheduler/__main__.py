"""kube-scheduler analog: `python -m kubernetes_tpu_torch.scheduler`.

Connects to an apiserver (KTPU wire preferred, HTTP fallback), builds the
scheduler from a KubeSchedulerConfiguration file (profiles, plugins,
TPUScorer gate → batched `TorchBackend` on cuda:0), and runs the
scheduling loop — with leader election when the config enables it.

    python -m kubernetes_tpu_torch.scheduler --server http://127.0.0.1:8080 \
        --config scheduler-config.yaml --batch-size 4096

Parity target: cmd/kube-scheduler (SURVEY §2.1). Copy of
`kubernetes_tpu/scheduler/__main__.py`, with two INFO lines of its own: one
when the process starts leading (its identity and `solve_provenance()`),
and one when a signal stops it (the backend's kernel launch counts). With
`TPUScorer` on and no CUDA device the process exits non-zero with the
backend's error; it does not schedule on the host path.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpu-scheduler", description=__doc__)
    ap.add_argument("--server", default=None,
                    help="HTTP apiserver URL (e.g. http://127.0.0.1:8080)")
    ap.add_argument("--wire", default=None,
                    help="KTPU wire target (host:port or unix:/path) — "
                         "preferred transport when given")
    ap.add_argument("--token", default=None)
    ap.add_argument("--config", default=None,
                    help="KubeSchedulerConfiguration YAML")
    ap.add_argument("--batch-size", type=int, default=1024)
    ap.add_argument("--feature-gates", default="",
                    help='e.g. "TPUScorer=true"')
    return ap


def _log_leadership(sched, identity: str) -> None:
    """Log one line as the elected payload starts: the identity and where
    the batched solve runs (`solve_provenance()`; null on the host path)."""
    run = sched.run

    async def run_logged(batch_size: int = 1) -> None:
        prov = None
        if sched.backend is not None:
            from kubernetes_tpu_torch.ops.backend import solve_provenance
            prov = solve_provenance(sched.backend.device)
        logging.info("scheduler %s started leading; solve_provenance %s",
                     identity, json.dumps(prov))
        await run(batch_size=batch_size)

    sched.run = run_logged


def _launch_counts() -> dict:
    from kubernetes_tpu_torch.ops import wave_kernel
    return {"wave_solve": wave_kernel.wave_solve.launches,
            "probe": wave_kernel.probe.launches}


async def serve(args) -> None:
    if args.wire:
        from kubernetes_tpu_torch.apiserver.wire import WireStore
        store = WireStore(args.wire, token=args.token,
                          user_agent="ktpu-scheduler")
    elif args.server:
        from kubernetes_tpu_torch.apiserver.client import RemoteStore
        store = RemoteStore(args.server, token=args.token,
                            user_agent="ktpu-scheduler")
    else:
        raise SystemExit("one of --server / --wire is required")

    from kubernetes_tpu_torch.client import InformerFactory
    from kubernetes_tpu_torch.config.scheduler import build_scheduler
    from kubernetes_tpu_torch.utils.featuregate import DEFAULT_FEATURE_GATES
    if args.feature_gates:
        DEFAULT_FEATURE_GATES.set_from_spec(args.feature_gates)
    cfg = None
    if args.config:
        import yaml
        with open(args.config) as f:
            cfg = yaml.safe_load(f)
    sched = build_scheduler(store, cfg,
                            feature_gates=DEFAULT_FEATURE_GATES)
    factory = InformerFactory(store)
    await sched.setup_informers(factory)
    factory.start()
    await factory.wait_for_sync()

    stop = asyncio.Event()
    stopped_by: list[str] = []
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(
                sig, lambda s=sig: (stopped_by.append(s.name), stop.set()))
        except NotImplementedError:
            pass
    elector = getattr(sched, "leader_elector", None)
    if elector is not None:
        _log_leadership(sched, elector.identity)
        run_task = asyncio.ensure_future(
            sched.run_with_leader_election(elector,
                                           batch_size=args.batch_size))
    else:
        run_task = asyncio.ensure_future(
            sched.run(batch_size=args.batch_size))
    logging.info("scheduler running (batch=%d)", args.batch_size)
    await stop.wait()
    logging.info("scheduler stopping on %s; kernel launches %s",
                 stopped_by[0], json.dumps(_launch_counts()))
    await sched.stop()
    run_task.cancel()
    factory.stop()
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
