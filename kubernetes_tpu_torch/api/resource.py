"""Resource quantities.

Parity with the reference's resource.Quantity parsing
(staging/src/k8s.io/apimachinery/pkg/api/resource/quantity.go
`ParseQuantity`): the Kubernetes quantity grammar —
decimal SI suffixes (k, M, G, T, P, E), binary suffixes (Ki, Mi, Gi, Ti, Pi, Ei),
milli ("500m"), bare integers and decimals ("0.5", "2e3").

Every quantity canonicalizes to an **integer milli-value** (int64-safe for
realistic cluster sizes), so a node's allocatable vector becomes one row of an
(N × R) int array. Copy of `kubernetes_tpu/api/resource.py`, cut to parsing
and `format_quantity`.
"""

from __future__ import annotations

import re
from typing import Union

_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {
    "n": 10**-9, "u": 10**-6, "m": 10**-3, "": 1,
    "k": 10**3, "M": 10**6, "G": 10**9, "T": 10**12, "P": 10**15, "E": 10**18,
}

_QTY_RE = re.compile(
    r"^\s*([+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)\s*"
    r"(Ki|Mi|Gi|Ti|Pi|Ei|n|u|m|k|M|G|T|P|E)?\s*$"
)


#: Memo for string quantities: workloads come from pod templates, so a
#: handful of distinct strings are parsed millions of times at perf scale.
_PARSE_CACHE: dict[str, int] = {}
_PARSE_CACHE_MAX = 4096


def parse_quantity(s: Union[str, int, float, None]) -> int:
    """Parse a quantity into integer milli-units.

    "1" → 1000, "500m" → 500, "2Gi" → 2*2**30*1000, 1.5 → 1500.
    None/"" → 0. Raises ValueError on malformed input (the reference's
    ParseQuantity errors likewise).
    """
    if s is None or s == "":
        return 0
    if isinstance(s, bool):
        raise ValueError(f"invalid quantity: {s!r}")
    if isinstance(s, int):
        return s * 1000
    if isinstance(s, float):
        return round(s * 1000)
    cached = _PARSE_CACHE.get(s)
    if cached is not None:
        return cached
    m = _QTY_RE.match(s)
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    num, suffix = m.group(1), m.group(2) or ""
    if suffix in _BIN:
        mult = _BIN[suffix]
    else:
        mult = _DEC[suffix]
    val = round(float(num) * mult * 1000)
    if len(_PARSE_CACHE) < _PARSE_CACHE_MAX:
        _PARSE_CACHE[s] = val
    return val


def format_quantity(milli: int) -> str:
    """Format integer milli-units back to a canonical quantity string:
    whole units print bare ("2"), sub-unit values in milli ("500m")."""
    if milli % 1000 == 0:
        return str(milli // 1000)
    return f"{milli}m"


def parse_resource_list(resources: dict | None) -> dict[str, int]:
    """Parse a ResourceList ({"cpu": "500m", "memory": "1Gi"}) → {name: milli}."""
    if not resources:
        return {}
    return {name: parse_quantity(v) for name, v in resources.items()}
