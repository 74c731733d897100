"""The `KTPU_*` environment flags this package reads.

Counterpart of `kubernetes_tpu/utils/flags.py`, cut to the flags this
package reads: the batch solve (the greedy wavefront, the shortlist and
its block index, and the Sinkhorn optimal mode) and its solve-mode
policy, the serving tier (its kill switch, the resident planes' block
index and the admission window), the store (the watch cache, the shard
count and its threshold, the debug freeze), the control plane's process
count, the lock check, the trace threshold, the
descheduler pair (its default and its disruption budget) and the
topology pair (the slice placement kill switch and the mesh shape), the
admission-policy index, the apiserver's durability directory with its
write-ahead log and fsync policy, and the leader-election lease. Names,
defaults and parsing are the reference's: every read is a LIVE
`os.environ` lookup, and a malformed value degrades to the flag's
default.
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable

__all__ = ["Flag", "FLAGS", "get", "scoped_set", "render_markdown_table"]

_FALSE = frozenset(("0", "false", "off", "no"))


def _parse_bool(raw: str) -> bool:
    return raw.strip().lower() not in _FALSE


def _parse_int(raw: str) -> int:
    return int(raw.strip())


def _parse_float(raw: str) -> float:
    return float(raw.strip())


def _parse_ms(raw: str) -> float:
    return max(0.0, float(raw.strip()))


def _parse_str(raw: str) -> str:
    return raw


def _parse_wal_fsync(raw: str) -> str:
    v = raw.strip().lower()
    if v not in ("batch", "always"):
        raise ValueError(raw)  # degrades to the default, per read()
    return v


def _parse_solve_mode(raw: str) -> str:
    v = raw.strip().lower()
    if v not in ("greedy", "optimal", "auto"):
        raise ValueError(raw)  # degrades to the default, per read()
    return v


@dataclass(frozen=True)
class Flag:
    name: str
    default: Any
    parse: Callable[[str], Any] = field(repr=False)
    doc: str
    #: structural kill switch: flipping it degrades a subsystem to its
    #: pre-feature shape (the differential-test contract), rather than
    #: tuning a knob.
    kill_switch: bool = False

    def read(self) -> Any:
        raw = os.environ.get(self.name)
        if raw is None or raw == "":
            return self.default
        try:
            return self.parse(raw)
        except (ValueError, TypeError):
            return self.default


FLAGS: dict[str, Flag] = {f.name: f for f in (
    Flag("KTPU_SERVING", True, _parse_bool,
         "Online serving tier (admission window + resident planes + "
         "single-pod fast path). `0` degrades the dispatch loop "
         "structurally to the pre-serving shape.",
         kill_switch=True),
    Flag("KTPU_CLASS_PLANES", True, _parse_bool,
         "Class-dictionary (C,N) device planes. `0` falls back to "
         "per-pod planes (C == P identity), identical assignments.",
         kill_switch=True),
    Flag("KTPU_BLOCK_INDEX", True, _parse_bool,
         "Two-level block-sparse node index for the shortlist "
         "prefilter: per-block aggregate planes + an O(C·B) bound scan "
         "gate which node columns the chunk-start score pass touches, "
         "exactly (a block whose score upper bound loses to the "
         "(K+1)-th shortlist value cannot hold a top-K column). `0` "
         "degrades structurally to the full-width r18/r21 prefilter "
         "call graph, bit-identical assignments. It also gates the "
         "block aggregate planes the serving tier's resident planes "
         "maintain.",
         kill_switch=True),
    Flag("KTPU_WAVEFRONT", True, _parse_bool,
         "Speculative wavefront solve (W pods per scan step with exact "
         "conflict replay). `0` degrades structurally to the "
         "one-pod-per-step W=1 scans, bit-identical assignments.",
         kill_switch=True),
    Flag("KTPU_SHORTLIST_K", None, _parse_int,
         "Shortlist width override for the pruned solve; `0` disables "
         "pruning. Unset = the tuner derives K from chunk width and "
         "fallback rate."),
    Flag("KTPU_WAVE_WIDTH", None, _parse_int,
         "Wavefront width override (pods evaluated per wave). Unset = "
         "the tuner picks W and shrinks it when replays climb."),
    Flag("KTPU_SOLVE_MODE", "auto", _parse_solve_mode,
         "Batch solve mode: `greedy` pins the greedy wavefront scan, "
         "`optimal` routes every eligible chunk (class planes, no "
         "spread) through the Sinkhorn transport plan and its W=1 "
         "multistart rounding, `auto` routes drain-scale chunks (at "
         "least OPTIMAL_MIN_PODS real pods, below the large-N row) "
         "there and keeps the greedy scan for the rest.",
         kill_switch=True),
    Flag("KTPU_SINKHORN_ITERS", 24, _parse_int,
         "Sinkhorn iterations per optimal-mode chunk (the temperature "
         "annealing's 3 stages split this count)."),
    Flag("KTPU_SINKHORN_TEMP", 0.05, _parse_float,
         "Final Sinkhorn temperature (entropic regularization weight "
         "on the row-normalized cost); annealing runs 4x -> 2x -> 1x "
         "this value."),
    Flag("KTPU_CLASS_PAD", 31, _parse_int,
         "Max real pod-equivalence classes per chunk before the "
         "per-pod fallback (plane rows bucket to the next power of "
         "two)."),
    Flag("KTPU_BLOCK_WIDTH", None, _parse_int,
         "Block width override (node columns per block) for the "
         "block-sparse index; `0` disables it like KTPU_BLOCK_INDEX=0. "
         "Unset = the AdaptiveTuner's structural policy row picks the "
         "width from the node count."),
    Flag("KTPU_DESCHEDULER", False, _parse_bool,
         "Default-enable the rebalance descheduler "
         "(controllers/descheduler.py) in churnOpenLoop phases that "
         "don't pin it: periodic evict-and-replace consolidation "
         "moves scored on the device (solver.consolidation_scores)."),
    Flag("KTPU_DESCHEDULER_BUDGET", 8, _parse_int,
         "Disruption budget: max evict-and-replace moves the "
         "descheduler may issue per sync cycle."),
    Flag("KTPU_TOPOLOGY", True, _parse_bool,
         "Topology-aware slice placement (kubernetes_tpu_torch/topology): "
         "interconnect coordinate planes on the cluster tensors, the "
         "device-side contiguous sub-mesh scan behind the TopologySlice "
         "plugin, and Coscheduling's sliceShape contiguity check at "
         "Permit. `0` degrades structurally to flat capacity vectors: "
         "count-only gangs, no coordinate planes, identical assignments "
         "on topology-free workloads.",
         kill_switch=True),
    Flag("KTPU_MESH_SHAPE", "auto", _parse_str,
         "Interconnect mesh dimensions, e.g. `4x8` (2D torus), `2x4x4` "
         "(3D torus) or `4x8:mesh` (no wraparound). `auto` derives a "
         "near-square 2D torus from the node count. Nodes map to "
         "coordinates via the `ktpu.io/topology-coord` label agents "
         "stamp at registration, falling back to the trailing integer "
         "in the node name (row-major)."),
    Flag("KTPU_WATCH_CACHE", True, _parse_bool,
         "Watch-cache serving tier (store/cacher.py). `0` degrades "
         "every LIST/watch to the direct-mvcc path.",
         kill_switch=True),
    Flag("KTPU_POLICY_INDEX", True, _parse_bool,
         "Pre-indexed ValidatingAdmissionPolicy matching (policy/"
         "vap.py): exact (resource, operation) reverse maps + interned "
         "namespace-selector signatures make admission O(matching "
         "policies). `0` degrades structurally to the linear "
         "all-policies scan, bit-identical verdicts.",
         kill_switch=True),
    Flag("KTPU_SHARDS", None, _parse_int,
         "Control-plane shard count override; `1` is the kill switch "
         "(plain single MVCCStore). Unset = the node-count threshold "
         "policy picks.",
         kill_switch=True),
    Flag("KTPU_SHARD_THRESHOLD", 100_000, _parse_int,
         "Node count at which the flagless shard policy switches from "
         "1 shard to 8 (store/sharded.control_plane_shards)."),
    Flag("KTPU_PROCESSES", None, _parse_int,
         "Control-plane OS-process count (multiproc/): each store "
         "shard becomes its own apiserver process on a unix-socket "
         "KTPU wire, the scheduler an active/standby process pair. "
         "`1` is the kill switch — the classic in-process tree, "
         "identical call graph. Unset = in-process.",
         kill_switch=True),
    Flag("KTPU_ADMISSION_WINDOW", None, _parse_ms,
         "Serving admission coalesce window in MILLISECONDS (pinned "
         "for sweeps; `0` = always dispatch immediately). Unset = the "
         "AdaptiveTuner policy row sizes it."),
    Flag("KTPU_TRACE_THRESHOLD_MS", None, _parse_float,
         "Slow-attempt threshold in ms: root span trees and attempt "
         "traces slower than this log a step breakdown. Unset = no "
         "tree dumps; the scheduler's per-attempt logger falls back "
         "to the reference's 100 ms."),
    Flag("KTPU_WAL", True, _parse_bool,
         "Write-ahead log between KTPU_DATA_DIR snapshots (store/"
         "durable.py): append every committed mvcc write, replay from "
         "the snapshot RV on recovery. `0` degrades durability to "
         "snapshot-only (the pre-WAL r16 shape).",
         kill_switch=True),
    Flag("KTPU_WAL_FSYNC", "batch", _parse_wal_fsync,
         "WAL fsync policy: `always` fsyncs per commit (the etcd "
         "posture: an acknowledged write is on disk), `batch` group-"
         "commits on the flush tick (durability window = one flush "
         "interval, fsync off the commit path)."),
    Flag("KTPU_LEASE_DURATION", 15.0, _parse_float,
         "Leader-election lease duration in seconds (client/"
         "leaderelection.py). Renew deadline and retry period scale "
         "with it (2/3 and 2/15 of the lease, the reference's "
         "15/10/2 shape): shorter lease = faster failover detection "
         "at more lease-write traffic."),
    Flag("KTPU_DATA_DIR", None, _parse_str,
         "Durability directory (WAL + snapshots); the apiserver "
         "recovers state from it on construction when set."),
    Flag("KTPU_LOCK_CHECK", False, _parse_bool,
         "Runtime lock-order / dispatch-hygiene detector "
         "(utils/locking.py): instrumented locks record per-thread "
         "acquisition order and raise on observed inversions and on "
         "locks held across device-fetch seams. Off = plain "
         "`threading.Lock`, zero overhead."),
    Flag("KTPU_DEBUG_FREEZE", False, _parse_bool,
         "Recursively freeze stored/watch-delivered objects so a "
         "mutating handler fails loudly (enabled by the test suite)."),
)}


def get(name: str) -> Any:
    """Parsed live read of a registered flag (KeyError on a typo)."""
    return FLAGS[name].read()


@contextmanager
def scoped_set(name: str, value):
    """Set a flag for the duration of a block, restoring it on exit."""
    FLAGS[name]
    prev = os.environ.get(name)
    os.environ[name] = str(value)
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def render_markdown_table() -> str:
    """The README "Flags" table, generated — the flag pass fails when
    the README's copy drifts from this render."""
    lines = [
        "| Flag | Default | Kill switch | What it does |",
        "|---|---|---|---|",
    ]
    for f in FLAGS.values():
        default = "unset" if f.default is None else str(f.default)
        ks = "yes" if f.kill_switch else ""
        doc = " ".join(f.doc.split())
        lines.append(f"| `{f.name}` | `{default}` | {ks} | {doc} |")
    return "\n".join(lines)
