"""Kubelet read-only server: /pods, /healthz, /configz.

Parity target: the kubelet's server (pkg/kubelet/server) read
endpoints — the debugging surface an operator curls at a node:

- `/healthz`  — liveness ("ok" while the sync loop owns the process);
- `/pods`     — the agent's LOCAL view of its bound pods (a PodList of
  what the sync loop has observed, which is the interesting object
  when diagnosing agent/apiserver drift — it can legitimately trail
  the apiserver);
- `/configz`  — the RESOLVED kubelet configuration plus per-field
  source attribution (agent/config.py merge_config), so precedence
  questions ("which layer set this lease period") are answerable
  without reading three files.

Bound to loopback by default, port 0 = ephemeral (tests read
`server.port` after start). Read-only by construction: no mutating
route exists. Copy of `kubernetes_tpu/agent/server.py`.
"""

from __future__ import annotations

import logging

from aiohttp import web

logger = logging.getLogger(__name__)


class AgentServer:
    """The read-only HTTP surface of one NodeAgent."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 0):
        self.agent = agent
        self.host = host
        self.port = port
        self._runner: web.AppRunner | None = None

    async def start(self) -> None:
        app = web.Application()
        app.router.add_get("/healthz", self._healthz)
        app.router.add_get("/pods", self._pods)
        app.router.add_get("/configz", self._configz)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        server = site._server
        if server is not None and server.sockets:
            self.port = server.sockets[0].getsockname()[1]
        logger.info("agent %s: serving on %s:%d",
                    self.agent.node_name, self.host, self.port)

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None

    # -- handlers ----------------------------------------------------------

    async def _healthz(self, request: web.Request) -> web.Response:
        healthy = not getattr(self.agent, "_stopped", False)
        return web.Response(text="ok" if healthy else "stopped",
                            status=200 if healthy else 500)

    async def _pods(self, request: web.Request) -> web.Response:
        return web.json_response(
            {"kind": "PodList", "apiVersion": "v1",
             "items": self.agent.resident_pods()})

    async def _configz(self, request: web.Request) -> web.Response:
        cfg = getattr(self.agent, "kubelet_config", None)
        if cfg is None:
            return web.json_response(
                {"error": "config not resolved yet"}, status=503)
        return web.json_response(cfg.as_configz())
