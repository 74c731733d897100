"""Scheduler extender: the out-of-process HTTP webhook seam.

Parity target: pkg/scheduler/extender.go (`HTTPExtender` —
`Filter`/`Prioritize`/`Bind`, node-cache option, ignorable errors,
managed-resources interest check) with the wire types from
pkg/scheduler/apis/config/types.go:

- ExtenderArgs       {"pod": Pod, "nodes": NodeList | "nodenames": [str]}
- ExtenderFilterResult {"nodes"|"nodenames", "failedNodes": {name: reason},
                        "failedAndUnresolvableNodes": {...}, "error": str}
- HostPriorityList   [{"host": str, "score": int}]   (0..MaxExtenderPriority,
                      multiplied by the extender's weight by the caller)
- ExtenderBindingArgs {"podName","podNamespace","podUID","node"}
- ExtenderBindingResult {"error": str}

`ExtenderServer` below serves the verbs over aiohttp, so a stock
kube-scheduler can delegate filter/prioritize to this framework with no
in-process integration. Copy of `kubernetes_tpu/scheduler/extender.py`.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, Mapping, Sequence

import aiohttp
from aiohttp import web

from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo

logger = logging.getLogger(__name__)

#: extender.go MaxExtenderPriority.
MAX_EXTENDER_PRIORITY = 10


class ExtenderError(Exception):
    pass


class HTTPExtender:
    """One configured extender webhook (config API `Extender`)."""

    def __init__(self, url_prefix: str, *,
                 filter_verb: str = "",
                 prioritize_verb: str = "",
                 bind_verb: str = "",
                 preempt_verb: str = "",
                 weight: int = 1,
                 node_cache_capable: bool = False,
                 ignorable: bool = False,
                 managed_resources: Sequence[str] = (),
                 timeout: float = 5.0,
                 name: str = ""):
        self.url_prefix = url_prefix.rstrip("/")
        self.filter_verb = filter_verb
        self.prioritize_verb = prioritize_verb
        self.bind_verb = bind_verb
        self.preempt_verb = preempt_verb
        self.weight = weight
        self.node_cache_capable = node_cache_capable
        self.ignorable = ignorable
        self.managed_resources = set(managed_resources)
        self.timeout = timeout
        self.name = name or url_prefix
        self._session: aiohttp.ClientSession | None = None

    @classmethod
    def from_config(cls, cfg: Mapping) -> "HTTPExtender":
        """Build from a KubeSchedulerConfiguration `extenders:` entry
        (reference YAML field names)."""
        return cls(
            cfg["urlPrefix"],
            filter_verb=cfg.get("filterVerb", ""),
            prioritize_verb=cfg.get("prioritizeVerb", ""),
            bind_verb=cfg.get("bindVerb", ""),
            preempt_verb=cfg.get("preemptVerb", ""),
            weight=cfg.get("weight", 1),
            node_cache_capable=cfg.get("nodeCacheCapable", False),
            ignorable=cfg.get("ignorable", False),
            managed_resources=[
                m["name"] for m in cfg.get("managedResources", [])],
            timeout=_parse_duration(cfg.get("httpTimeout", "5s")),
            name=cfg.get("urlPrefix", ""),
        )

    def _sess(self) -> aiohttp.ClientSession:
        if self._session is None or self._session.closed:
            self._session = aiohttp.ClientSession(
                timeout=aiohttp.ClientTimeout(total=self.timeout))
        return self._session

    async def close(self) -> None:
        if self._session is not None and not self._session.closed:
            await self._session.close()

    def is_binder(self) -> bool:
        return bool(self.bind_verb)

    def is_interested(self, pod: PodInfo) -> bool:
        """extender.go IsInterested: no managedResources = all pods;
        otherwise only pods requesting one of them."""
        if not self.managed_resources:
            return True
        return any(r in self.managed_resources for r in pod.requests)

    async def _post(self, verb: str, payload: dict) -> dict:
        url = f"{self.url_prefix}/{verb}"
        async with self._sess().post(url, json=payload) as resp:
            if resp.status != 200:
                raise ExtenderError(
                    f"extender {self.name}: {verb} returned {resp.status}")
            return await resp.json()

    async def filter(self, pod: PodInfo, nodes: list[NodeInfo]
                     ) -> tuple[list[NodeInfo], dict[str, str],
                                dict[str, str]]:
        """→ (feasible, failed{name: reason}, failed_unresolvable).

        On error: ignorable → all nodes pass; else ExtenderError
        (extender.go findNodesThatPassExtenders).
        """
        if not self.filter_verb or not self.is_interested(pod):
            return nodes, {}, {}
        by_name = {ni.name: ni for ni in nodes}
        args: dict = {"pod": pod.pod}
        if self.node_cache_capable:
            args["nodenames"] = list(by_name)
        else:
            args["nodes"] = {"items": [ni.node for ni in nodes]}
        try:
            res = await self._post(self.filter_verb, args)
        except (ExtenderError, aiohttp.ClientError, asyncio.TimeoutError) as e:
            if self.ignorable:
                logger.warning(
                    "ignoring ignorable extender %s filter error: %s",
                    self.name, e)
                return nodes, {}, {}
            raise ExtenderError(str(e)) from e
        if res.get("error"):
            if self.ignorable:
                return nodes, {}, {}
            raise ExtenderError(res["error"])
        if self.node_cache_capable and res.get("nodenames") is not None:
            keep = [by_name[n] for n in res["nodenames"] if n in by_name]
        elif res.get("nodes") is not None:
            keep = [by_name[o["metadata"]["name"]]
                    for o in res["nodes"].get("items", [])
                    if o["metadata"]["name"] in by_name]
        else:
            keep = nodes
        return (keep, dict(res.get("failedNodes") or {}),
                dict(res.get("failedAndUnresolvableNodes") or {}))

    async def prioritize(self, pod: PodInfo, nodes: list[NodeInfo]
                         ) -> dict[str, float]:
        """→ {node: score × weight}; errors score 0 (prioritizeNodes
        swallows extender priority errors)."""
        if not self.prioritize_verb or not self.is_interested(pod):
            return {}
        args: dict = {"pod": pod.pod}
        if self.node_cache_capable:
            args["nodenames"] = [ni.name for ni in nodes]
        else:
            args["nodes"] = {"items": [ni.node for ni in nodes]}
        try:
            res = await self._post(self.prioritize_verb, args)
        except (ExtenderError, aiohttp.ClientError, asyncio.TimeoutError) as e:
            logger.warning("extender %s prioritize error (scored 0): %s",
                           self.name, e)
            return {}
        return {h["host"]: float(h["score"]) * self.weight
                for h in res or []}

    async def bind(self, pod: PodInfo, node_name: str) -> None:
        """ExtenderBindingArgs POST; raises ExtenderError on failure."""
        res = await self._post(self.bind_verb, {
            "podName": pod.name,
            "podNamespace": pod.namespace,
            "podUID": pod.pod.get("metadata", {}).get("uid", ""),
            "node": node_name,
        })
        if res and res.get("error"):
            raise ExtenderError(res["error"])


def _parse_duration(s) -> float:
    if isinstance(s, (int, float)):
        return float(s)
    s = str(s)
    if s.endswith("ms"):
        return float(s[:-2]) / 1000
    if s.endswith("s"):
        return float(s[:-1])
    if s.endswith("m"):
        return float(s[:-1]) * 60
    return float(s)


class ExtenderServer:
    """In-repo demo extender: serves the webhook verbs over aiohttp.

    Callbacks get plain wire dicts and return wire results — exactly what a
    real out-of-process extender (e.g. this framework packaged as a
    scoring sidecar for a stock kube-scheduler) would implement.

    filter_fn(pod, nodes|nodenames) -> (kept_names, failed{name: reason})
    prioritize_fn(pod, names) -> {name: score 0..10}
    bind_fn(args) -> None | error string
    """

    def __init__(self, *,
                 filter_fn: Callable | None = None,
                 prioritize_fn: Callable | None = None,
                 bind_fn: Callable | None = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.filter_fn = filter_fn
        self.prioritize_fn = prioritize_fn
        self.bind_fn = bind_fn
        self.host, self.port = host, port
        self._runner: web.AppRunner | None = None
        self.requests: list[tuple[str, dict]] = []  # observability for tests

        app = web.Application()
        app.router.add_post("/filter", self._filter)
        app.router.add_post("/prioritize", self._prioritize)
        app.router.add_post("/bind", self._bind)
        self.app = app

    @staticmethod
    def _names(args: dict) -> list[str]:
        if args.get("nodenames") is not None:
            return list(args["nodenames"])
        return [o["metadata"]["name"]
                for o in (args.get("nodes") or {}).get("items", [])]

    async def _filter(self, request: web.Request) -> web.Response:
        args = await request.json()
        self.requests.append(("filter", args))
        names = self._names(args)
        if self.filter_fn is None:
            kept, failed = names, {}
        else:
            kept, failed = self.filter_fn(args["pod"], names)
        body: dict = {"failedNodes": failed, "error": ""}
        if args.get("nodenames") is not None:
            body["nodenames"] = kept
        else:
            by_name = {o["metadata"]["name"]: o
                       for o in (args.get("nodes") or {}).get("items", [])}
            body["nodes"] = {"items": [by_name[n] for n in kept]}
        return web.json_response(body)

    async def _prioritize(self, request: web.Request) -> web.Response:
        args = await request.json()
        self.requests.append(("prioritize", args))
        names = self._names(args)
        scores = (self.prioritize_fn(args["pod"], names)
                  if self.prioritize_fn else {})
        return web.json_response(
            [{"host": n, "score": int(scores.get(n, 0))} for n in names])

    async def _bind(self, request: web.Request) -> web.Response:
        args = await request.json()
        self.requests.append(("bind", args))
        err = self.bind_fn(args) if self.bind_fn else None
        return web.json_response({"error": err or ""})

    async def start(self) -> None:
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, self.host, self.port)
        await site.start()
        server = site._server  # noqa: SLF001
        if server and server.sockets:
            self.port = server.sockets[0].getsockname()[1]

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
