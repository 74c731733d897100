"""Readings the check's limits are set from, in one process.

    python -m schedbench.control --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out FILE]

For each seed: one run of the cell as the benchmark makes it, the numbers
the check compares for the program, and the same numbers for the plain
reference put in the program's place (its own placements of every dispatch
the run recorded, from that dispatch's starting state) twice: with ties
broken to the highest node index (the check's control, which breaks the
configuration's guarantee of the lowest-indexed among equal nodes), and in
bfloat16 (read beside it; see PERF.md for why it cannot fail this cell).
One JSON line per seed; not run by the benchmark itself.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from schedbench import run as _run  # noqa: F401  (sets the cache directories)
from schedbench import check, harness


def readings(spec: dict, seed: int, seconds: float, device: str = "cuda:0",
             fault=None) -> dict:
    rec, check_in = asyncio.run(harness.run_cell(spec, seed, seconds, False,
                                                 device=device, fault=fault))
    prog = check.judge(check_in)
    t0 = time.monotonic()
    ties = check.judge(check_in, placements=check.control_placements(
        check_in))
    t1 = time.monotonic()
    bf16 = check.judge(check_in, placements=check.control_placements(
        check_in, "bfloat16", "low"))
    keep = [k for k in check.LIMITS if k in prog] + ["judged", "misplaced",
                                                    "worst_gap"]
    return {
        "seed": seed,
        "program": {k: float(prog[k]) for k in keep},
        "control_bfloat16": {k: float(bf16[k]) for k in
                             ("misplaced_per_kpod", "misplaced", "judged",
                              "worst_gap")},
        "control_ties_high": {k: float(ties[k]) for k in
                              ("misplaced_per_kpod", "misplaced", "judged")},
        "control_s": t1 - t0,
        "pods_per_s": rec.bound_in_window / rec.seconds,
        "dispatches": len(check_in["dispatches"]),
        "detail": prog["detail"][:8],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = harness.cell_spec(harness.load_benchmark(), args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            line = json.dumps(readings(spec, seed, args.seconds))
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
