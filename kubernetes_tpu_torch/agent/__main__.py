"""kubelet analog: `python -m kubernetes_tpu_torch.agent`.

One process per node (kubemark hollow-kubelet shape): connects to the
apiserver's KTPU wire, registers its Node, then runs the sync loop —
field-filtered pod watch, per-pod workers, DRA device Allocate with a
local checkpoint that survives restart.

    python -m kubernetes_tpu_torch.agent --node n0 \
        --server unix:/tmp/ktpu-wire.sock \
        --checkpoint-dir /var/lib/ktpu-agent \
        --allocatable cpu=4,memory=16Gi,pods=32,ktpu.io/tpu=8

Parity target: cmd/kubelet + cmd/kubemark (SURVEY §2.1 rows 14/18). Copy of
`kubernetes_tpu/agent/__main__.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal


def parse_allocatable(spec: str) -> dict:
    out: dict = {}
    for part in spec.split(","):
        if not part:
            continue
        k, _, v = part.partition("=")
        out[k.strip()] = v.strip()
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ktpu-agent", description=__doc__)
    ap.add_argument("--node", required=True, help="this node's name")
    ap.add_argument("--server", required=True,
                    help="apiserver wire target (host:port or unix:PATH)")
    ap.add_argument("--checkpoint-dir", default=".",
                    help="device-allocation checkpoint directory")
    ap.add_argument("--allocatable",
                    default="cpu=4,memory=16Gi,pods=110",
                    help="node allocatable, k=v comma list; extended "
                         "resources (with '/') also publish ResourceSlices")
    ap.add_argument("--token", default=None, help="bearer token")
    ap.add_argument("--lease-period", type=float, default=2.0)
    ap.add_argument("--no-register", action="store_true",
                    help="assume the Node object already exists")
    return ap


async def serve(args) -> None:
    from kubernetes_tpu_torch.agent import NodeAgent
    from kubernetes_tpu_torch.apiserver.wire import WireStore

    store = WireStore(args.server, token=args.token,
                      user_agent=f"ktpu-agent/{args.node}")
    agent = NodeAgent(
        store, args.node,
        checkpoint_dir=args.checkpoint_dir,
        node_template={"allocatable": parse_allocatable(args.allocatable)},
        register=not args.no_register,
        lease_period=args.lease_period)
    await agent.start()
    logging.info("agent %s running against %s", args.node, args.server)

    stop = asyncio.Event()
    loop = asyncio.get_event_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            loop.add_signal_handler(sig, stop.set)
        except NotImplementedError:
            pass
    await stop.wait()
    await agent.stop()
    await store.close()


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO)
    args = build_parser().parse_args(argv)
    asyncio.run(serve(args))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
