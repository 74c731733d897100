"""The one traffic generator. A traffic mix is a JSON file of parameters
under `schedbench/traffic/`, named by the cell's `traffic`; its `kind`
picks the arrival pattern. There is one:

- `rounds`: `round_pods` pods created as fast as the store takes them, in
  gathers of `gather`; the next round starts once every pod of the round
  is bound (a burst under a backlog: scheduler_perf's measured phase,
  repeated while the window lasts).

It stops creating when the window closes. `trace_slice_s` is the traced
run's profiler slice, which starts in the window's last `trace_tail_s`
seconds; the per-layer numbers are taken from the rounds before them.
`Creator` is the harness's side: `mark()` notes where a round begins,
`create(n, gather)` returns the new pods' keys, and `wait_bound(keys)`
returns once all of them are bound or the window has closed.
"""

from __future__ import annotations

import json
import time
from pathlib import Path

TRAFFIC_DIR = Path(__file__).resolve().parent / "traffic"


def load(name: str, directory: Path = TRAFFIC_DIR) -> dict:
    with open(directory / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("kind") not in DRIVERS:
        raise ValueError(f"traffic {name!r}: unknown kind {mix.get('kind')!r}")
    return mix


async def _rounds(mix: dict, creator, window_end: float) -> None:
    while time.monotonic() < window_end:
        creator.mark()
        t0 = time.monotonic()
        keys = await creator.create(int(mix["round_pods"]),
                                    gather=int(mix.get("gather", 512)))
        t1 = time.monotonic()
        done = await creator.wait_bound(keys)
        creator.rounds.append((len(keys), t1 - t0, time.monotonic() - t0,
                               done))


DRIVERS = {"rounds": _rounds}


async def drive(mix: dict, creator, window_end: float) -> None:
    await DRIVERS[mix["kind"]](mix, creator, window_end)
