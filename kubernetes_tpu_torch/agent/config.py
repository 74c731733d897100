"""Kubelet configuration sources, merged with documented precedence.

Parity target: the kubelet's config story (KubeletConfiguration from
--config plus the retired DynamicKubeletConfig apiserver source, now
the per-node config object pattern): an agent resolves its runtime
knobs from three layers, LOWEST to HIGHEST precedence —

    built-in defaults  <  config FILE  <  APISERVER object

i.e. a field set in the apiserver's per-node config wins over the
same field in the local file, which wins over the default. Merging is
FIELD-BY-FIELD (a source only overrides the keys it actually sets —
setting `leasePeriodSeconds` in the file does not reset the
apiserver's `deviceZones`), unknown keys are ignored with a warning
(a newer control plane must not brick an older agent), and every
resolved field remembers which source set it — the `/configz`
endpoint (agent/server.py) serves both the values and the
attribution, so "why is this agent heartbeating at 5s" is one curl.

The apiserver source is a `kubeletconfigs` object named after the
node, falling back to the cluster-wide `default` object; neither
existing is normal (defaults + file apply).

Copy of `kubernetes_tpu/agent/config.py`, without `as_configz` (the
payload of the reference's `/configz` endpoint, `agent/server.py`, not
ported).
"""

from __future__ import annotations

import json
import logging
from typing import Any, Mapping

logger = logging.getLogger(__name__)

#: resolved-config fields and their built-in defaults. Values are
#: plain JSON scalars; topologyCoord is the "x,y"/"x,y,z" string the
#: registration label carries (mesh.parse_coord_label's format).
DEFAULTS: dict[str, Any] = {
    "leasePeriodSeconds": 2.0,
    "deviceDriver": "dra.ktpu",
    "deviceZones": 2,
    "topologyCoord": None,
}

#: per-field value coercions — config files are hand-edited, so "5"
#: for a float field must resolve, not crash the agent.
_COERCE = {
    "leasePeriodSeconds": float,
    "deviceDriver": str,
    "deviceZones": int,
    "topologyCoord": lambda v: None if v is None else str(v),
}


class ResolvedConfig:
    """Merged config: `values` (field -> resolved value) + `sources`
    (field -> name of the source that set it)."""

    __slots__ = ("values", "sources")

    def __init__(self, values: dict[str, Any], sources: dict[str, str]):
        self.values = values
        self.sources = sources

    def __getitem__(self, field: str) -> Any:
        return self.values[field]



def merge_config(*sources: tuple[str, Mapping[str, Any] | None]) \
        -> ResolvedConfig:
    """Merge (name, fields) layers, LAST one wins per field. Callers
    pass layers in precedence order: defaults, file, apiserver."""
    values = dict(DEFAULTS)
    origin = {f: "default" for f in DEFAULTS}
    for name, fields in sources:
        if not fields:
            continue
        for key, raw in fields.items():
            if key not in DEFAULTS:
                logger.warning("kubelet config source %s: unknown field "
                               "%r ignored", name, key)
                continue
            try:
                values[key] = _COERCE[key](raw)
            except (TypeError, ValueError):
                logger.warning("kubelet config source %s: bad value %r "
                               "for %s ignored", name, raw, key)
                continue
            origin[key] = name
    return ResolvedConfig(values, origin)


def load_file_source(path: str | None) -> dict[str, Any]:
    """The --config file layer: a flat JSON object. A missing or
    malformed file is an empty layer (the agent must come up on
    defaults), logged — never fatal."""
    if not path:
        return {}
    try:
        with open(path, encoding="utf-8") as f:
            cfg = json.load(f)
    except FileNotFoundError:
        return {}
    except (OSError, ValueError) as e:
        logger.warning("kubelet config file %s unreadable (%s); "
                       "ignoring", path, e)
        return {}
    if not isinstance(cfg, dict):
        logger.warning("kubelet config file %s is not an object; "
                       "ignoring", path)
        return {}
    return cfg


async def fetch_apiserver_source(store, node_name: str) -> dict[str, Any]:
    """The apiserver layer: the `kubeletconfigs` object named after
    this node, else the cluster-wide `default` object, else empty."""
    from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError
    for name in (node_name, "default"):
        try:
            obj = await store.get("kubeletconfigs", f"default/{name}")
        except NotFound:
            continue
        except StoreError:
            logger.warning("kubelet config fetch for %s failed; "
                           "continuing without the apiserver layer",
                           node_name, exc_info=True)
            return {}
        return (obj.get("spec") or {})
    return {}


async def resolve_config(store, node_name: str,
                         config_file: str | None = None,
                         overrides: Mapping[str, Any] | None = None) \
        -> ResolvedConfig:
    """The full three-layer resolve (plus constructor `overrides` as a
    fourth, highest layer — explicit NodeAgent kwargs beat everything,
    the same way a command-line flag beats the kubelet's config file)."""
    return merge_config(
        ("file", load_file_source(config_file)),
        ("apiserver", await fetch_apiserver_source(store, node_name)),
        ("override", overrides),
    )
