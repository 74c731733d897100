"""TorchBackend: the batched scheduling backend on one CUDA device.

Counterpart of `kubernetes_tpu/ops/backend.py`'s `TPUBackend`, cut to the
greedy wavefront route, the shortlist-pruned solve, the Sinkhorn optimal
route and the spread scan of its batch cycle: `assign(pods, snapshot,
fwk)` compiles the snapshot to dense tensors (ops/tensorize.py), dedupes
each chunk's pods into equivalence classes with (C, N) class planes (the
host filter and score rows of the plugins without device kernels), and
runs one device pass per chunk — `mask_solve_update`: plugin masks →
scores → the solve → the used-state update. The reference's solve-mode
policy (`AdaptiveTuner.solve_mode`, `KTPU_SOLVE_MODE`) picks the solve per
chunk:

- greedy: the multistart wavefront solve through the hand-written kernel
  (ops/wave_kernel.py) at the tuner's width W. On the CPU, from 8192
  real nodes on (n_real >= 4 x (K + chunk), `AdaptiveTuner.shortlist_k`)
  a class-mode chunk takes the shortlist-pruned solve instead, as in the
  reference: a prefilter keeps each class's top K = 1024 columns and the
  (K+1)-th score (from LARGE_N = 32768 nodes through the two-pass block
  prefilter, `solver.block_bound_prefilter`), the multistart narrow
  scans re-score only those columns and the nodes debited so far, and a
  chunk with a step they cannot prove exact reruns whole through the
  kernel at W=1. On the card the same route runs only when
  KTPU_SHORTLIST_K sets K, and its block prefilter only when
  KTPU_BLOCK_WIDTH sets the width (PyTorch ops, one CUDA graph replay per
  wave, as the reference's are XLA scans outside its Pallas kernel): at
  50000 nodes each is slower than its full-width form, which the card
  keeps;
- optimal (flagless, every chunk of 64 or more real pods with class
  planes below 32768 nodes and no spread): the chunk-start scores are the
  cost of `solver.sinkhorn_plan` over the class planes, and its log-plan,
  with the live weights zeroed, is rounded by the W=1 multistart scan —
  one launch of the same kernel at W=1;
- spread (a chunk with pods gated by hard PodTopologySpread constraints,
  or counted by them while a later chunk is gated): the spread scan
  (`solver.greedy_assign_rescoring_spread` and its wave form) in identity
  order at the tuner's W, the domain counts of one union spread table
  riding its carry.

Gangs (Coscheduling's PodGroups, when the profile holds the plugin and its
PodGroup informer is wired) are all-or-nothing inside the solve, as in the
reference: each chunk carries a (P, 16) gang one-hot and the members each
gang still needs (minMember less the members already bound or parked at
Permit, at most its members in the chunk); every route drops the
placements of a gang below its quota (`solver.gang_filter`), the spread
route folding the dropped pods out of the chained domain counts, and a
gang chunk takes the optimal route at any node count. Gangs beyond 16 in
one chunk are left to the Permit barrier alone and counted in
`backend_degradations{kind="gang_overflow"}`.

The constraint families are host rows, as in the reference:
InterPodAffinity's filter and score rows and PodTopologySpread's score rows
compile over interned label signatures (ops/affinity.py) against the
snapshot, and hard spread constraints ride the spread scan. Pods placed
earlier in the same assign() are checked by the host verify's delta
affinity check (a conflict is rejected and requeues).

The device-topology plugins are host rows too, as in the reference:
NodeResourceTopologyMatch's filter and score rows come from per-node zone
arrays packed once per snapshot (`_nrt_state`), DynamicResources' filter
rows from per-(node, device class) free-device counts charged from the
claim ledgers once per snapshot (`_dra_state`; a claim shape those counts
cannot answer takes the plugin's own host row), and NodePorts' from the
plugin's own filter. The four volume plugins (VolumeBinding,
VolumeRestrictions, VolumeZone, NodeVolumeLimits) are the plugin's own
host row for each pod with PersistentVolumeClaims, counted as
`host_fallback`, as in the reference. These pods are "stateful": the host
verify re-checks host ports against the working node, and a chunk holding
any pod of NodeResourceTopologyMatch, DynamicResources or a volume plugin
(or another stateful plugin but NodePorts) re-runs every placement through
the framework's PreFilter and Filter against a working snapshot that
carries this assign()'s earlier placements (`_verify`), so zone usage,
devices, a ReadWriteOncePod claim or a node's last volume slot taken
earlier in the same assign() are seen. ImageLocality is a static score
row, cached by the pod's image list.

The (N, 2R+1) used-state pack stays on the device and chains from chunk to
chunk with no host round trip. It is seeded at each assign() from the
snapshot, or, when the serving tier's resident planes are attached
(`resident`, serving/resident.py), from a copy of their refreshed pack.
Chunks are pipelined as in the reference: up to `pipeline_depth` chunks
are dispatched ahead of the host verify of the oldest. Assignments are
then verified on the host with exact integer arithmetic, and unassigned
pods get per-plugin diagnostics. Lone pods have a route of their own
beside this one: the serving fast path (serving/fastpath.py,
`solver.solve_one`), which places a pod where this cycle's first scan step
would.

Slice-shaped gangs (a PodGroup with `spec.sliceShape`) are gangs as the
reference treats them: TopologySlice's PreFilter plans the gang's
contiguous sub-mesh and its Filter admits only the member's planned node,
an nnz==1 host row that becomes a `pod_pin` exception column of the solve;
such a pod takes the full re-check.

Not covered, and refused with NotImplementedError rather than scheduled on
a partial model: any plugin at a PreFilter, Filter, PreScore or Score
point beyond the seventeen of `MODELLED_PLUGINS`. Plugins at none of
those points (queue sort, gates, bind) are the scheduler loop's and pass.
Where the reference falls back to host rows and a stateful verify
for spread pods that miss the union table (`spread_poisoned`), this
package raises.

When the scheduler attaches its metrics (`metrics`, `tracer`), each chunk
observes `scheduler_tpu_solve_seconds` (dispatch to fetched) and the
solver_* counters the reference's chunk finalization updates, for the
counters this backend keeps, the shortlist's and the block index's
among them, and the control-plane shard accounting: per-shard tensor
rebuilds (`scheduler_tpu_shard_tensor_rebuilds_total`, only the shards
whose rows a build rewrote), and, above one shard (`control_shards`, set
by the scheduler from its store), the solve wall labelled with the shard
count and one cross-shard reduction per pod. For perf output,
`solve_provenance(device)` names the card and the solve route, and
`start_profile` / `stop_profile` write a torch.profiler Chrome trace of
a window (raising where the reference logs and goes on). Multi-device
sharding of the node axis is a later slice.
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
import os
import subprocess
import time
from collections import deque
from typing import Mapping, Sequence

import numpy as np
import torch

from kubernetes_tpu_torch.api.labels import from_label_selector, ns_contains
from kubernetes_tpu_torch.api.meta import namespaced_name
from kubernetes_tpu_torch.ops import kernels, solver, wave_kernel
from kubernetes_tpu_torch.ops.affinity import AffinityCompiler, _seg_sum
from kubernetes_tpu_torch.ops.tensorize import ClusterTensors, PodBatch
from kubernetes_tpu_torch.scheduler.framework import (
    UNSCHEDULABLE_AND_UNRESOLVABLE,
    CycleState,
    Framework,
    Status,
)
from kubernetes_tpu_torch.scheduler.plugins.coscheduling import (
    POD_GROUP_LABEL,  # noqa: F401 (the gang label, re-exported)
)
from kubernetes_tpu_torch.scheduler.plugins.dynamicresources import (
    claim_allocated_node,
    claim_match_attrs,
    claim_requests,
    pod_claim_keys,
)
from kubernetes_tpu_torch.scheduler.plugins.interpodaffinity import (
    resolve_term_namespaces,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesources import (
    insufficient_resources,
)
from kubernetes_tpu_torch.scheduler.plugins.noderesourcetopology import (
    SINGLE_NUMA_POLICIES,
    _zone_caps,
    pack_zones,
)
from kubernetes_tpu_torch.scheduler.plugins.registry import IN_TREE
from kubernetes_tpu_torch.scheduler.types import PodInfo, Snapshot
from kubernetes_tpu_torch.utils import flags
from kubernetes_tpu_torch.utils.locking import check_dispatch_seam

logger = logging.getLogger(__name__)

#: The Filter/Score plugins the backend models, on the device or as host
#: rows; a plugin at any of `_MODELLED_POINTS` must be one of them.
MODELLED_PLUGINS = frozenset((
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "NodeAffinity",
    "NodeName", "NodeUnschedulable", "TaintToleration", "InterPodAffinity",
    "PodTopologySpread", "NodePorts", "ImageLocality", "VolumeBinding",
    "VolumeRestrictions", "VolumeZone", "NodeVolumeLimits",
    "NodeResourceTopologyMatch", "DynamicResources", "TopologySlice"))
_MODELLED_POINTS = frozenset(("PreFilter", "Filter", "PreScore", "Score"))

#: Plugins with full device kernels.
DEVICE_FILTER_PLUGINS = {"NodeResourcesFit", "TaintToleration"}
DEVICE_SCORE_PLUGINS = {
    "NodeResourcesFit", "NodeResourcesBalancedAllocation", "TaintToleration"}

#: Static node-predicate plugins whose (pod-spec → node row) is cacheable by
#: spec signature while the node set is unchanged.
STATIC_ROW_PLUGINS = {"NodeAffinity", "NodeName", "NodeUnschedulable"}
STATIC_SCORE_PLUGINS = {"NodeAffinity", "ImageLocality"}

#: O(1)-per-pod activity gates mirroring each stateful plugin's own
#: PreFilter/PreScore Skip condition (the reference's, for the plugins
#: this package has): a gate may only say "inactive" when the plugin would
#: Skip — PodTopologySpread's asks the plugin for its effective
#: constraints, since the system default constraints apply to every
#: labeled pod.
_FILTER_ACTIVE = {
    "InterPodAffinity": lambda plugin, pi, snap: bool(
        pi.required_affinity_terms or pi.required_anti_affinity_terms
        or snap.have_pods_with_required_anti_affinity),
    "PodTopologySpread": lambda plugin, pi, snap: bool(
        plugin._constraints_for(pi, "DoNotSchedule")),
    "NodePorts": lambda plugin, pi, snap: bool(pi.host_ports),
    "VolumeBinding": lambda plugin, pi, snap: bool(pi.pvc_names),
    "VolumeRestrictions": lambda plugin, pi, snap: bool(pi.pvc_names),
    "VolumeZone": lambda plugin, pi, snap: bool(pi.pvc_names),
    "NodeVolumeLimits": lambda plugin, pi, snap: bool(pi.pvc_names),
    "NodeResourceTopologyMatch":
        lambda plugin, pi, snap: plugin.active_for(pi),
    "DynamicResources":
        lambda plugin, pi, snap: plugin.active_for(pi),
    "TopologySlice":
        lambda plugin, pi, snap: plugin.active_for(pi),
}
_SCORE_ACTIVE = {
    "InterPodAffinity": lambda plugin, pi, snap: bool(
        pi.preferred_affinity_terms or pi.preferred_anti_affinity_terms
        or snap.have_pods_with_affinity),
    "PodTopologySpread": lambda plugin, pi, snap: bool(
        plugin._constraints_for(pi, "ScheduleAnyway")),
    "NodeResourceTopologyMatch":
        lambda plugin, pi, snap: plugin.active_for(pi),
}

#: Solve chunk when the caller does not pin one.
_DEFAULT_CHUNK = 1024

#: Gang (PodGroup) slots per chunk in the solver's all-or-nothing masking;
#: overflow gangs keep the Permit barrier alone.
_GANG_PAD = 16

#: Diagnostic reasons of the host filter rows; NodeResourceTopologyMatch
#: and DynamicResources read the default "node(s) filtered", as in the
#: reference.
_HOST_REASONS = {
    "NodeAffinity": "node(s) didn't match Pod's node affinity/selector",
    "NodeName": "node didn't match the requested node name",
    "NodeUnschedulable": "node(s) were unschedulable",
    "NodePorts": "node(s) didn't have free ports for the requested pod ports",
    "InterPodAffinity": "node(s) didn't match pod affinity/anti-affinity rules",
    "PodTopologySpread": "node(s) didn't match pod topology spread constraints",
}
_UNRESOLVABLE = {"NodeAffinity", "NodeName", "NodeUnschedulable"}


def class_pad() -> int:
    """Effective class cap: 0 = class planes off (per-pod fallback).
    Read per assign() so callers can flip the env knobs live."""
    if not flags.get("KTPU_CLASS_PLANES"):
        return 0
    return max(0, flags.get("KTPU_CLASS_PAD"))


def _class_rows_bucket(n_classes: int) -> int:
    """Plane row count for n_classes real classes + the reserved empty
    row 0, bucketed to a power of two (≥ 2) so plane shapes repeat."""
    rows = 2
    while rows < n_classes + 1:
        rows <<= 1
    return rows


def compress_score_wire(host_scores: np.ndarray) -> np.ndarray:
    """Wire dtype for a dirty host-score plane: f16 only while it is
    faithful (|score| ≤ 1024), else f32; non-finite scores raise."""
    import math
    if host_scores.size:
        lo, hi = float(host_scores.min()), float(host_scores.max())
        if not (math.isfinite(lo) and math.isfinite(hi)):
            raise ValueError("host score plane contains non-finite values")
        amax = max(-lo, hi)
    else:
        amax = 0.0
    return host_scores.astype(np.float16 if amax <= 1024.0 else np.float32)


def solve_provenance(device=None) -> dict:
    """Solve-backend provenance for perf output: the platform, the card
    (`card_name` and `power_limit`, as nvidia-smi gives them) where there
    is one, the visible card count, the torch and CUDA versions, the
    host's core count, and which route an eligible greedy wave chunk
    takes on `device` (cuda:0 when None): the hand-written `wave_solve`
    ("cuda") or its plain PyTorch version ("plain", CPU tensors). A CPU
    row and a card row can then never be taken for one another. On a
    CUDA device a failed nvidia-smi query raises; on the CPU there is no
    card field."""
    dev = torch.device("cuda:0" if device is None else device)
    out = {"platform": dev.type,
           "device_count": torch.cuda.device_count(),
           "torch_version": torch.__version__,
           "cuda_version": torch.version.cuda,
           "cpu_count": os.cpu_count(),
           "solve_kernel": "cuda" if dev.type == "cuda" else "plain"}
    if dev.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", f"--id={dev.index or 0}",
             "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        name, limit = smi.stdout.strip().splitlines()[0].rsplit(",", 1)
        out["card_name"] = name.strip()
        out["power_limit"] = limit.strip()
    return out


class AdaptiveTuner:
    """The policy rows of the reference's `AdaptiveTuner` that this
    package runs:

    - the wavefront width (`wave_width` and its replay-ratio shrink): W
      pods per wave, WAVE_WIDTH_SMALL below LARGE_N nodes and
      WAVE_WIDTH_LARGE above, halved at assign() boundaries while the
      measured replay fraction exceeds the ratio; KTPU_WAVE_WIDTH
      overrides it;
    - the solve mode (`solve_mode`, the KTPU_SOLVE_MODE row), with its
      OPTIMAL_MIN_PODS threshold;
    - the serving rows: the admission window (`admission_window`), the
      fast-path dispatch cap (`fast_path_cap`) and rate limit
      (`fast_path_rate_limit`), pure host policy over measured walls;
    - the shortlist width (`shortlist_k`): K = chunk x boost for a
      class-mode chunk once n_real >= SHORTLIST_FACTOR x (K + chunk),
      the boost doubling (to SHORTLIST_MAX_BOOST) at assign() boundaries
      while the observed fallback rate exceeds SHORTLIST_FALLBACK_RATIO;
      KTPU_SHORTLIST_K overrides it (0 disables);
    - the block-index width (`block_width`, BLOCK_WIDTH), which the
      two-pass block prefilter and the resident planes' block aggregates
      use. With `prune_auto` False (a CUDA backend) neither engages on
      its own: on the card the narrow scans ran slower than the
      full-width wave_solve kernel at 50000 nodes, and the block
      prefilter slower than the full-width prefilter (chip_smoke.py
      phase 13(b)), so only KTPU_SHORTLIST_K and KTPU_BLOCK_WIDTH engage
      them there;
    - the pipeline depth (`decide`): the reference's local-device rows,
      4 chunks in flight until WARMUP_CHUNKS chunks were observed (or from
      the first assign() at LARGE_N nodes or more), then 2. The solve
      chunk of those rows (1024) is the default `max_batch` already."""

    LARGE_N = 32768
    #: The shortlist engages when n_real >= FACTOR x (K + chunk): with
    #: K = chunk = 1024 that is 8192 nodes (the reference's values).
    SHORTLIST_FACTOR = 4
    SHORTLIST_MAX_BOOST = 8
    SHORTLIST_FALLBACK_RATIO = 0.25
    #: minimum solved pods before the fallback rate is trusted.
    SHORTLIST_MIN_SAMPLE = 512
    #: a device round trip at or above this is relay-attached.
    LATENCY_BOUND_S = 5e-3
    #: node columns per aggregate block of the block index.
    BLOCK_WIDTH = 128
    WAVE_WIDTH_SMALL = 32
    WAVE_WIDTH_LARGE = 64
    WAVE_REPLAY_RATIO = 0.25
    WAVE_MIN_SAMPLE = 512
    #: chunks observed before the pipeline-depth decision lands.
    WARMUP_CHUNKS = 8
    #: pipeline depth before and after the decision (a local device).
    DEPTH_WARMUP = 4
    DEPTH_LOCAL = 2
    #: Under `auto`, a non-gang chunk of fewer real pods keeps the greedy
    #: scan (the reference's value).
    OPTIMAL_MIN_PODS = 64
    #: Admission-window row (serving/admission.py): at or below the idle
    #: rate every pod dispatches immediately; above it the window is sized
    #: to coalesce ADMISSION_TARGET_PODS at the estimated offered rate,
    #: capped at ADMISSION_MAX_WINDOW_S (4x that on a relay-attached
    #: device). The reference's values, seeded from its 5k-node churn
    #: knee sweep.
    ADMISSION_IDLE_RATE = 300.0
    ADMISSION_TARGET_PODS = 8.0
    ADMISSION_MAX_WINDOW_S = 4e-3
    #: Fast-path dispatch cap: the largest popped dispatch worth draining
    #: pod by pod through the single-pod solve instead of one padded
    #: chunk — the ratio of the measured chunk wall to the measured
    #: fast-path wall, clamped; these seed both before any measurement.
    FAST_PATH_SEED_CHUNK_S = 0.25
    FAST_PATH_SEED_SOLVE_S = 1e-3
    #: node count the solve seed stands for; an unmeasured fast wall seeds
    #: at SEED_SOLVE_S x (n / CALIB_N), because solve_one is a full-N scan.
    FAST_PATH_SEED_CALIB_N = 5000
    FAST_PATH_CAP_MIN = 8
    FAST_PATH_CAP_MAX = 512
    #: highest share of the fast path's serial capacity (1 / fast wall)
    #: the offered rate may take before the batch path takes over.
    FAST_PATH_UTILIZATION = 0.5

    def __init__(self, prune_auto: bool = True):
        #: whether `shortlist_k` and `block_width` engage on their own.
        self.prune_auto = prune_auto
        #: the device's put+fetch round trip, seconds. The reference
        #: measures it with a probe transfer; this package has no probe
        #: yet, so the admission window reads None as a local device (0).
        self.latency_s: float | None = None
        self.n_nodes = 0
        self.wave_shrink = 1
        self.shortlist_boost = 1
        self.solve_pods = 0
        self.solve_fallbacks = 0
        self.wave_commits = 0
        self.wave_replays = 0
        self.total_chunks = 0
        self.depth = self.DEPTH_WARMUP

    def observe_chunk(self) -> None:
        self.total_chunks += 1

    def solve_mode(self, p_real: int, has_gang: bool, spread: bool,
                   class_mode: bool) -> tuple[str, bool]:
        """('greedy' | 'optimal', structural_fallback) for one chunk, row
        for row the reference's policy: `greedy` pins greedy; optimal needs
        class planes and no spread; under `auto` a non-gang chunk below
        OPTIMAL_MIN_PODS real pods, or at n_nodes >= LARGE_N, stays greedy;
        a chunk the policy wants optimal but that is not eligible becomes
        greedy with the structural-fallback bit set."""
        raw = flags.get("KTPU_SOLVE_MODE")
        if raw == "greedy":
            return "greedy", False
        eligible = class_mode and not spread
        if raw == "optimal":
            return ("optimal", False) if eligible else ("greedy", True)
        if not (has_gang or p_real >= self.OPTIMAL_MIN_PODS):
            return "greedy", False
        if not has_gang and self.n_nodes >= self.LARGE_N:
            return "greedy", False
        return ("optimal", False) if eligible else ("greedy", True)

    def observe_solve(self, pods: int, fallbacks: int) -> None:
        """Shortlist hit-rate sample from one finalized chunk."""
        self.solve_pods += pods
        self.solve_fallbacks += fallbacks

    def observe_wave(self, commits: int, replays: int) -> None:
        """Wavefront commit/replay sample from one finalized chunk."""
        self.wave_commits += commits
        self.wave_replays += replays

    def shortlist_k(self, chunk: int, n_real: int) -> int:
        """Shortlist width for a chunk, 0 = keep the full N-wide scan."""
        override = flags.get("KTPU_SHORTLIST_K")
        if override is not None:
            return override if 0 < override < n_real else 0
        if not self.prune_auto:
            return 0
        k = chunk * self.shortlist_boost
        if n_real < self.SHORTLIST_FACTOR * (k + chunk):
            return 0
        return k

    def block_width(self, n_pad: int, n_real: int, shortlist_k: int) -> int:
        """Block width of the two-pass block prefilter, 0 = the full-width
        prefilter. Only with a shortlist and from LARGE_N real nodes (the
        structural row), and only where the selection leaves a block
        unselected (M + 1 <= B); KTPU_BLOCK_INDEX=0 or KTPU_BLOCK_WIDTH=0
        disables it, and KTPU_BLOCK_WIDTH overrides the width (without
        `prune_auto`, only a set KTPU_BLOCK_WIDTH engages it)."""
        if not flags.get("KTPU_BLOCK_INDEX"):
            return 0
        override = flags.get("KTPU_BLOCK_WIDTH")
        if override is None and not self.prune_auto:
            return 0
        bw = self.BLOCK_WIDTH if override is None else override
        if bw <= 0 or shortlist_k <= 0 or n_real < self.LARGE_N:
            return 0
        return bw if solver.block_selection_fits(n_pad, shortlist_k, bw) \
            else 0

    def wave_width(self, chunk: int) -> int:
        override = flags.get("KTPU_WAVE_WIDTH")
        if override is not None:
            return max(1, min(override, chunk))
        w = self.WAVE_WIDTH_LARGE if self.n_nodes >= self.LARGE_N \
            else self.WAVE_WIDTH_SMALL
        return max(1, min(w // self.wave_shrink, chunk))

    @classmethod
    def _fast_wall_seed(cls, n_nodes: int) -> float:
        """Unmeasured-wall seed for the fast-path gates: SEED_SOLVE_S at
        the calibration node count, scaled linearly above it (the solve
        is a full-N scan)."""
        return cls.FAST_PATH_SEED_SOLVE_S \
            * max(1, n_nodes / cls.FAST_PATH_SEED_CALIB_N)

    @classmethod
    def fast_path_cap(cls, chunk_wall_s: float, fast_wall_s: float,
                      n_nodes: int = 0) -> int:
        """Largest dispatch the serving tier drains pod by pod through the
        fast path — pure policy over the two measured walls (the node
        count only shapes the seed while the fast wall is unmeasured)."""
        if fast_wall_s <= 0:
            fast_wall_s = cls._fast_wall_seed(n_nodes)
        if chunk_wall_s <= 0:
            chunk_wall_s = cls.FAST_PATH_SEED_CHUNK_S
        return int(min(max(chunk_wall_s / fast_wall_s,
                           cls.FAST_PATH_CAP_MIN), cls.FAST_PATH_CAP_MAX))

    @classmethod
    def fast_path_rate_limit(cls, fast_wall_s: float,
                             n_nodes: int = 0) -> float:
        """Highest estimated offered rate (pods/s) the serving tier still
        drains serially — pure policy over the measured wall."""
        if fast_wall_s <= 0:
            fast_wall_s = cls._fast_wall_seed(n_nodes)
        return cls.FAST_PATH_UTILIZATION / fast_wall_s

    @classmethod
    def admission_window(cls, latency_s: float, rate_est: float) -> float:
        """Coalesce window (seconds) for the serving admission tier — pure
        policy. 0.0 = dispatch immediately."""
        if rate_est <= cls.ADMISSION_IDLE_RATE:
            return 0.0
        cap = cls.ADMISSION_MAX_WINDOW_S
        if latency_s >= cls.LATENCY_BOUND_S:
            cap = 4.0 * cls.ADMISSION_MAX_WINDOW_S
        return min(cls.ADMISSION_TARGET_PODS / rate_est, cap)

    def decide(self) -> int:
        """At an assign() boundary: apply the shortlist and replay feedback
        once enough pods were observed, and return the pipeline depth."""
        if self.total_chunks >= self.WARMUP_CHUNKS \
                or self.n_nodes >= self.LARGE_N:
            self.depth = self.DEPTH_LOCAL
        if self.solve_pods >= self.SHORTLIST_MIN_SAMPLE:
            if self.solve_fallbacks > self.SHORTLIST_FALLBACK_RATIO \
                    * self.solve_pods \
                    and self.shortlist_boost < self.SHORTLIST_MAX_BOOST:
                self.shortlist_boost *= 2
                logger.info("shortlist fallback rate %.0f%% -> boost x%d",
                            100.0 * self.solve_fallbacks / self.solve_pods,
                            self.shortlist_boost)
            self.solve_pods = self.solve_fallbacks = 0
        total = self.wave_commits + self.wave_replays
        if total >= self.WAVE_MIN_SAMPLE:
            if self.wave_replays > self.WAVE_REPLAY_RATIO * total \
                    and self.wave_shrink < self.WAVE_WIDTH_LARGE:
                self.wave_shrink *= 2
                logger.info("wavefront replay fraction %.0f%% -> shrink x%d",
                            100.0 * self.wave_replays / total,
                            self.wave_shrink)
            self.wave_commits = self.wave_replays = 0
        return self.depth


def _signature(plugin_name: str, pi: PodInfo) -> str:
    if plugin_name == "NodeName":
        return pi.node_name
    if plugin_name == "NodeUnschedulable":
        return repr(sorted(
            (t.get("key", ""), t.get("operator", ""))
            for t in pi.tolerations))
    if plugin_name == "NodeAffinity":
        return repr((pi.node_selector, pi.affinity.get("nodeAffinity")))
    if plugin_name == "ImageLocality":
        return repr(sorted(
            c.get("image", "") for c in pi.pod.get("spec", {}).get("containers") or []))
    raise KeyError(plugin_name)


def chunk_planes(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                 taint_f_mat, taint_p_mat, class_mask, class_scores,
                 w_taint, taint_filter_on) -> dict:
    """The first half of a chunk's device pass: plugin masks and
    capacity-independent scores over (C, N) class planes, and the solver's
    inputs (per-pod request rows, free capacity, the gated class mask, the
    static score plane). Argument meanings as in `mask_solve_update`."""
    dev = alloc_q.device
    n = alloc_q.shape[0]
    # Wire decompression: masks arrive bit-packed uint8 (C, N/8)
    # big-endian, scores float16 or float32.
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=dev)
    cmask = ((class_mask[:, :, None] >> shifts) & 1).reshape(
        class_mask.shape[0], -1).to(torch.bool)[:, :n]
    host_scores = class_scores.to(torch.float32)

    r = alloc_q.shape[1]
    tf = taint_f_mat.shape[1]
    used_q = used_pack[:, :r]
    used_pods = used_pack[:, 2 * r]
    c_req_q = class_pack[:, :r]
    c_untol_f = class_pack[:, 2 * r:2 * r + tf].to(torch.bool)
    c_untol_p = class_pack[:, 2 * r + tf:].to(torch.bool)
    # Per-pod request rows are class gathers; every plane stays (C, N).
    cls_long = cls_idx.long()

    fit0 = kernels.fit_filter_mask(
        alloc_q, used_q, used_pods, alloc_pods, c_req_q)         # (C,N)
    taint_ok = kernels.taint_filter_mask(taint_f_mat, c_untol_f)
    if not taint_filter_on:
        taint_ok = torch.ones_like(taint_ok)
    mask = cmask & taint_ok
    # Capacity-independent score components; fit/balanced are re-scored
    # live inside the solve. Taint normalization runs over the CLASS
    # feasible set.
    static_scores = host_scores + w_taint * kernels.taint_toleration_score(
        taint_p_mat, c_untol_p, mask & fit0)
    return dict(
        req_q=c_req_q[cls_long], req_nz_q=class_pack[:, r:2 * r][cls_long],
        free_q=alloc_q - used_q, free_pods=alloc_pods - used_pods,
        used_nz_q=used_pack[:, r:2 * r].contiguous(), mask=mask,
        static_scores=static_scores, fit0=fit0, taint_ok=taint_ok)


def plan_inputs(pl: dict, alloc_q, class_pack, cls_idx, fit_col_w,
                bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                strategy: str):
    """The optimal mode's transport problem over a chunk's class planes
    (`pl` from `chunk_planes`): (feasible (C,N) = mask ∧ chunk-start fit,
    cost (C,N) = the chunk-start live scores, row_counts (C,) f32 = pods
    per class row, padding pods counted into the empty row 0 as in the
    reference, col_cap (N,) = remaining pod slots, at least 0)."""
    r = alloc_q.shape[1]
    dev = alloc_q.device
    cost = kernels.chunk_start_scores(
        alloc_q, pl["used_nz_q"], class_pack[:, r:2 * r],
        pl["static_scores"], fit_col_w, bal_col_mask, shape_u, shape_s,
        w_fit, w_bal, strategy)
    row_counts = torch.zeros((class_pack.shape[0],), dtype=torch.float32,
                             device=dev).index_add_(
        0, cls_idx.long(),
        torch.ones(cls_idx.shape, dtype=torch.float32, device=dev))
    return (pl["mask"] & pl["fit0"], cost, row_counts,
            torch.clamp_min(pl["free_pods"], 0))


def mask_solve_update(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                      exc_col, taint_f_mat, taint_p_mat, class_mask,
                      class_scores, fit_col_w, bal_col_mask, shape_u,
                      shape_s, w_fit, w_bal, w_taint, taint_filter_on,
                      perms, gang_onehot, gang_required, strategy: str,
                      wave_w: int, solve_mode: str, sink_iters: int,
                      sink_temp: float, spread=None, shortlist_k: int = 0,
                      block_w: int = 0, n_real: int = 0,
                      p_real: int | None = None):
    """One device pass per chunk: plugin masks → scores → assignment →
    state (the reference's `_mask_solve_update`, its greedy wavefront,
    W=1, shortlist and optimal branches).

    class_mask: (C, N/8) uint8 bit-packed host filter rows per class (row
    0 = the reserved empty class); class_scores: (C, N) f16/f32 host score
    rows; class_pack: (C, 2R+tf+tp) int32 — req_q ‖ req_nz_q ‖ untol_f ‖
    untol_p of each class's representative pod; cls_idx: (P,) pod → class
    row; exc_col: (P,) exception column (-1 = none). used_pack is the
    chained (N, 2R+1) int32 used_q ‖ used_nz_q ‖ used_pods.

    solve_mode "optimal": the Sinkhorn plan (`sink_iters` iterations, final
    temperature `sink_temp`) over the class planes, costed by the
    chunk-start scores, becomes the static scores, and the W=1 multistart
    scan rounds it with w_fit = w_bal = 0. wave_w < 2 (and every optimal
    chunk) solves with the W=1 multistart scan, wider waves with the
    wavefront scan.

    spread: None, or (table, dom_counts, applies, contrib) — the union
    spread table (`solver.SpreadTable`), its chained (D,) int32 domain
    counts and the chunk's (P, C) applies / contributes matrices. The
    chunk then runs the spread scan in identity order (W=1 below wave_w
    2, its wave form above), as the reference's `use_spread` branch does.

    shortlist_k > 0 prunes the solve to each class's top-K columns
    (`solver.shortlist_prefilter` over the chunk-start scores, or with
    block_w > 0 the two-pass `solver.block_bound_prefilter`, whose block
    aggregates exclude the padding columns from `n_real` on): the
    multistart shortlist scans (W=1, or waves of W), or with spread the
    spread shortlist scan at W=1. `p_real`: the chunk's real pods; the
    spread and shortlist scans do not run the padding after them (its
    class row is empty). Nothing here reads a value back from the device,
    except on a shortlist chunk: one read of the block prefilter's
    exactness predicate (the full-width prefilter runs only when it
    fails) and one of the scans' poison bits (a poisoned multistart chunk
    reruns whole through the W=1 kernel, a poisoned spread scan reruns
    with the full row at the steps it could not prove).

    Returns (assign (P+5,) — the tail is [shortlist fallbacks, wave
    commits, wave replays, blocks scanned, blocks pruned] — used_pack',
    fit0 (C,N), taint_ok (C,N), dom_counts' (D,) int32, empty without
    spread); the diagnostic planes are class-level.
    """
    pl = chunk_planes(alloc_q, used_pack, alloc_pods, class_pack, cls_idx,
                      taint_f_mat, taint_p_mat, class_mask, class_scores,
                      w_taint, taint_filter_on)
    static_scores = pl["static_scores"]
    dev = alloc_q.device
    if solve_mode == "optimal":
        # Batch-optimal mode: the transport plan over the class planes,
        # then the W=1 scan rounds it against live capacity with the
        # re-scoring weights zeroed.
        static_scores, _ = solver.sinkhorn_plan(
            *plan_inputs(pl, alloc_q, class_pack, cls_idx, fit_col_w,
                         bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                         strategy), sink_iters, sink_temp)
        w_fit = w_bal = 0.0
        wave_w = 0
    solve_args = (pl["req_q"], pl["req_nz_q"], pl["free_q"], pl["free_pods"],
                  pl["used_nz_q"], alloc_q, pl["mask"], static_scores,
                  fit_col_w, bal_col_mask, shape_u, shape_s, w_fit, w_bal,
                  strategy)
    n = alloc_q.shape[0]
    nfall = blk_scanned = blk_pruned = 0
    if shortlist_k:
        # The shortlist prefilter over the class rows: chunk-start live
        # scores, top-K columns and the (K+1)-th value per class, with
        # chunk-start capacity folded into feasibility (spread gating is
        # not: it is non-monotone and checked in the scan).
        r = alloc_q.shape[1]
        c_req_nz = class_pack[:, r:2 * r]
        feasible = pl["mask"] & pl["fit0"]
        score_args = (fit_col_w, bal_col_mask, shape_u, shape_s, w_fit,
                      w_bal, strategy)
        if block_w > 0:
            sc0, cand_s, thresh_s, blk_scanned, blk_pruned = \
                solver.block_bound_prefilter(
                    alloc_q, pl["used_nz_q"], c_req_nz, static_scores,
                    feasible, *score_args, n_real, shortlist_k, block_w)
        else:
            sc0 = kernels.chunk_start_scores(
                alloc_q, pl["used_nz_q"], c_req_nz, static_scores,
                *score_args)
            cand_s, thresh_s = solver.shortlist_prefilter(feasible, sc0,
                                                          shortlist_k)
        cls_long = cls_idx.long()
        # has_node: the class row has a column, or for a pinned pod its
        # one column is in its class row.
        has_node = torch.where(
            exc_col >= 0,
            pl["mask"][cls_long, torch.clamp(exc_col, 0, n - 1).long()],
            pl["mask"].any(dim=1)[cls_long])
        sl_args = (sc0, cls_idx, cand_s[cls_long], thresh_s[cls_long],
                   has_node)
    dom_counts2 = torch.zeros((0,), dtype=torch.int32, device=dev)
    if spread is not None:
        # Spread chunks run the identity order only (domain counts and
        # permutations do not commute cheaply); gang masking still applies.
        table, dom_counts, applies, contrib = spread
        if shortlist_k:
            a0, dom_counts2, nfall = \
                solver.greedy_assign_rescoring_spread_shortlist(
                    *solve_args, table, dom_counts, applies, contrib,
                    *sl_args, rows=cls_idx, exc=exc_col, n_real=p_real)
            wave_com = wave_rep = 0
        elif wave_w > 1:
            a0, dom_counts2, wave_com, wave_rep = \
                solver.greedy_assign_rescoring_spread_wave(
                    *solve_args, wave_w, table, dom_counts, applies,
                    contrib, rows=cls_idx, exc=exc_col, n_real=p_real)
        else:
            a0, dom_counts2 = solver.greedy_assign_rescoring_spread(
                *solve_args, table, dom_counts, applies, contrib,
                rows=cls_idx, exc=exc_col, n_real=p_real)
            wave_com = wave_rep = 0
        assign = solver.gang_filter(a0, gang_onehot, gang_required)
        # Gang-dropped pods bumped the chained counts in-scan (for the
        # constraints they contribute to): fold them back out so later
        # chunks see the truth, in the table's index form (integer
        # gathers and index_add, no float product).
        dropped = (a0 >= 0) & (assign < 0)
        safe = torch.clamp(a0, 0, alloc_q.shape[0] - 1).long()
        dom_counts2 = table.add(dom_counts2, safe, dropped, -contrib)
    elif shortlist_k and wave_w > 1:
        assign, nfall, wave_com, wave_rep = \
            solver.multistart_greedy_assign_shortlist_wave(
                *solve_args, wave_w, perms, gang_onehot, gang_required,
                *sl_args, rows=cls_idx, exc=exc_col, n_real=p_real)
    elif shortlist_k:
        assign, nfall = solver.multistart_greedy_assign_shortlist(
            *solve_args, perms, gang_onehot, gang_required, *sl_args,
            rows=cls_idx, exc=exc_col, n_real=p_real)
        wave_com = wave_rep = 0
    elif wave_w > 1:
        assign, wave_com, wave_rep = \
            solver.multistart_greedy_assign_wave_kernel(
                *solve_args, wave_w, perms, gang_onehot, gang_required,
                rows=cls_idx, exc=exc_col)
    else:
        assign = solver.multistart_greedy_assign_kernel(
            *solve_args, perms, gang_onehot, gang_required, rows=cls_idx,
            exc=exc_col)
        wave_com = wave_rep = 0

    # Post-assignment state update (scatter-add of assigned requests);
    # unassigned rows scatter to a dummy row N, dropped.
    hit = assign >= 0
    tgt = torch.where(hit, assign, n).long()
    inc = torch.cat([pl["req_q"], pl["req_nz_q"],
                     hit.to(torch.int32)[:, None]], dim=1)
    delta = torch.zeros((n + 1, used_pack.shape[1]), dtype=used_pack.dtype,
                        device=dev).index_add_(
        0, tgt, torch.where(hit[:, None], inc, 0))
    used_pack2 = used_pack + delta[:n]
    # Filled on the device: a tensor built from a host list is a copy that
    # waits for the card.
    tail = torch.zeros((5,), dtype=torch.int32, device=dev)
    for slot, v in enumerate((nfall, wave_com, wave_rep, blk_scanned,
                              blk_pruned)):
        tail[slot].fill_(v.reshape(()) if torch.is_tensor(v) else v)
    return (torch.cat([assign, tail]), used_pack2, pl["fit0"],
            pl["taint_ok"], dom_counts2)


class UsedStateChain(torch.nn.Module):
    """The device-resident (N, 2R+1) int32 used-state pack (used_q ‖
    used_nz_q ‖ used_pods): seeded from the snapshot at each assign()
    entry, replaced by each chunk's post-solve pack, and corrected in
    place when the host verify rejects a placement."""

    def __init__(self, device: torch.device):
        super().__init__()
        self.register_buffer(
            "pack", torch.zeros((0, 0), dtype=torch.int32, device=device))

    def seed(self, pack_np: np.ndarray) -> None:
        self.pack = torch.from_numpy(pack_np).to(self.pack.device)

    def advance(self, pack: torch.Tensor) -> None:
        self.pack = pack

    def fold_back(self, idx: np.ndarray, rows: np.ndarray) -> None:
        """Subtract rejected placements' (2R+1) rows at node indices."""
        self.pack.index_add_(
            0, torch.from_numpy(idx).to(self.pack.device),
            torch.from_numpy(-rows).to(self.pack.device))


class TorchBackend:
    """Batched backend: `assign(pods, snapshot, fwk)` →
    ({pod_key: node_name|None}, {pod_key: {node_name: Status}}).

    device=None means cuda:0 and raises RuntimeError when CUDA is
    unavailable; pass device="cpu" to run the kernels' plain versions."""

    def __init__(self, device=None, max_batch: int | None = None,
                 multistart: int = 4):
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchBackend needs a CUDA device; pass device='cpu' to "
                    "run the plain PyTorch versions of its kernels")
            device = "cuda:0"
        self.device = torch.device(device)
        if self.device.type == "cuda":
            # The probe-kernel gate in front of the real kernel: builds the
            # kernel library if this process has not, then checks x + 1.
            wave_kernel.probe_check()
        self.max_batch = max_batch if max_batch is not None \
            else _DEFAULT_CHUNK
        #: control-plane shard count of the backing store, injected by
        #: Scheduler.attach_backend when the store advertises one
        #: (ShardedNodeStore.node_shards); None = the flagless policy.
        self.control_shards = None
        #: parallel permuted-order solves per chunk (1 = queue order only).
        self.multistart = max(1, int(multistart))
        self._tuner = AdaptiveTuner(prune_auto=self.device.type != "cuda")
        self._ct: ClusterTensors | None = None
        # (plugin, sig) -> host row; valid while _row_fp matches.
        self._row_cache: dict[tuple[str, str], tuple[np.ndarray, bool]] = {}
        self._row_fp: tuple | None = None
        # Device-resident constants: clean class planes per shape, node
        # statics per snapshot, framework params, permutations, zero gangs.
        self._dev_base_mask: dict[tuple, torch.Tensor] = {}
        self._dev_zero_scores: dict[tuple, torch.Tensor] = {}
        self._dev_static: dict[str, object] = {}
        self._dev_static_fp: tuple | None = None
        self._fwk_params_cache: dict[tuple, tuple] = {}
        self._dev_perms_cache: dict[tuple, torch.Tensor] = {}
        self._dev_zero_gang: dict[int, tuple] = {}
        #: ops/affinity.AffinityCompiler of the current snapshot, dropped
        #: when the resident pods change (a new ClusterTensors) or the
        #: namespace resolver's epoch moves (a Namespace relabel).
        self._affinity = None
        self._affinity_ns_epoch = -1
        #: the namespace resolver of the framework's InterPodAffinity (or
        #: PodTopologySpread) plugin, picked at each assign().
        self._ns_resolver = None
        #: (snapshot generation, any resident pod contributes
        #: InterPodAffinity score symmetry).
        self._ipa_resident_relevant: tuple | None = None
        #: (key, state) of NodeResourceTopologyMatch's zone arrays and
        #: DynamicResources' free-device counts (see _nrt_state,
        #: _dra_state).
        self._nrt_cache: tuple | None = None
        self._dra_cache: tuple | None = None
        #: chunks dispatched ahead of the oldest chunk's host verify (the
        #: tuner's decision at each assign()).
        self.pipeline_depth = self._tuner.depth
        self.used = UsedStateChain(self.device)
        #: serving/resident.ResidentPlanes, attached by the caller that
        #: serves lone pods: assign() then seeds the chain from a copy of
        #: its refreshed pack instead of a full upload.
        self.resident = None
        #: cumulative solve counters: chunks solved, wavefront commits and
        #: replays (a poisoned chunk counts all its pods as replays);
        #: chunks solved in the optimal mode (the reference's
        #: solver_optimal_solves_total) and chunks the solve-mode policy
        #: wanted optimal but that were not eligible (no class planes) and
        #: ran greedy (solver_optimal_fallbacks_total); and the Sinkhorn
        #: iterations of the latest optimal chunk, a gauge
        #: (solver_sinkhorn_iterations).
        #: Spread chunks: chunks solved by the spread scan. Verify
        #: rejects: placements the host verify rejected (affinity conflicts
        #: with pods placed earlier in the same assign(), or capacity).
        #: Shortlist pods and fallbacks: real pods of shortlist chunks and
        #: those the exactness check sent to a full row (a poisoned
        #: multistart chunk counts all of them); blocks scanned and pruned:
        #: (class, block) pairs of the block prefilter's chunks.
        self.counters = {"chunks": 0, "wave_commits": 0, "wave_replays": 0,
                         "optimal_solves": 0, "optimal_fallbacks": 0,
                         "sinkhorn_iterations": 0, "spread_chunks": 0,
                         "verify_rejects": 0, "shortlist_pods": 0,
                         "shortlist_fallbacks": 0, "blocks_scanned": 0,
                         "blocks_pruned": 0}
        #: cumulative host-clock seconds of assign() and of its per-chunk
        #: phases: host prep, the device pass up to the assignment fetch
        #: (which waits for the device), and host verify + diagnostics.
        self.timings = {"assign_s": 0.0, "prep_s": 0.0, "device_s": 0.0,
                        "verify_s": 0.0}
        #: metrics/registry.SchedulerMetrics and utils/tracing.Tracer,
        #: attached by Scheduler.attach_backend (None: nothing observed).
        self.metrics = None
        self.tracer = None
        #: (torch.profiler.profile, trace directory) between
        #: start_profile and stop_profile; traces written so far.
        self._profile: tuple | None = None
        self._traces = 0

    # -- profiling (torch.profiler; the reference's jax.profiler hook) -----

    def start_profile(self, log_dir: str) -> None:
        """Begin a torch.profiler trace of this process (CPU activity,
        plus CUDA on a card) until `stop_profile`, which writes it under
        `log_dir`. Unlike the reference, which logs and returns False
        when its profiler is unavailable, a profiler that cannot start
        raises here."""
        if self._profile is not None:
            raise RuntimeError("start_profile: a profile is already running")
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.start()
        self._profile = (prof, log_dir)

    def stop_profile(self) -> str | None:
        """End the running trace and write it to `log_dir` as a Chrome
        trace (`trace-<pid>-<n>.json`); returns its path, or None when no
        profile runs."""
        if self._profile is None:
            return None
        prof, log_dir = self._profile
        self._profile = None
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        self._traces += 1
        path = os.path.join(log_dir,
                            f"trace-{os.getpid()}-{self._traces}.json")
        prof.export_chrome_trace(path)
        return path

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _tensors(self, snapshot: Snapshot) -> ClusterTensors:
        if self._ct is None or self._ct.generation != snapshot.generation:
            self._ct = ClusterTensors(snapshot, prev=self._ct,
                                      shards=self.control_shards)
            self._affinity = None  # resident pods changed: recompile
            if self.metrics is not None:
                # Per-shard host-prep accounting: only shards whose rows
                # this build rewrote count a rebuild (the delta build's
                # witness). Coordinate-plane rebuilds: reuse does not
                # count.
                for sh in self._ct.shard_rebuilds:
                    self.metrics.shard_tensor_rebuilds.inc(shard=str(sh))
                topo = self._ct.topology
                if topo is not None and topo.rebuilt:
                    self.metrics.topology_plane_rebuilds.inc()
        if self._row_fp != self._ct._static_fp:
            self._row_cache.clear()
            self._row_fp = self._ct._static_fp
        return self._ct

    def _affinity_compiler(self, snapshot: Snapshot, ct: ClusterTensors):
        resolver = self._ns_resolver
        epoch = resolver.epoch if resolver is not None else -1
        if self._affinity is not None and self._affinity_ns_epoch != epoch:
            self._affinity = None  # namespace relabel: resolved sets stale
        if self._affinity is None:
            self._affinity = AffinityCompiler(snapshot, ct.n_pad,
                                              ns_resolver=resolver)
            self._affinity_ns_epoch = epoch
        return self._affinity

    def _ipa_score_relevant(self, pi: PodInfo, snapshot: Snapshot) -> bool:
        """InterPodAffinity Score is nonzero only if the pod has preferred
        terms, or some resident pod contributes symmetry weight (preferred
        terms, or required affinity terms × hardPodAffinityWeight)."""
        if pi.preferred_affinity_terms or pi.preferred_anti_affinity_terms:
            return True
        cached = self._ipa_resident_relevant
        if cached is not None and cached[0] == snapshot.generation:
            return cached[1]
        relevant = any(
            e.preferred_affinity_terms or e.preferred_anti_affinity_terms
            or e.required_affinity_terms
            for ni in snapshot.have_pods_with_affinity
            for e in ni.pods_with_affinity)
        self._ipa_resident_relevant = (snapshot.generation, relevant)
        return relevant

    # -- host rows -----------------------------------------------------------

    def _static_filter_row(self, plugin, pi: PodInfo, snapshot: Snapshot,
                           ct: ClusterTensors) -> tuple[np.ndarray, bool]:
        """(row, all_true), cached per (plugin, pod signature)."""
        key = (plugin.NAME, _signature(plugin.NAME, pi))
        hit = self._row_cache.get(key)
        if hit is None:
            state = CycleState()
            st = plugin.pre_filter(state, pi, snapshot)
            if st.is_skip() or st.is_success():
                row = np.fromiter(
                    (plugin.filter(state, pi, ni).is_success()
                     for ni in snapshot.nodes),
                    dtype=np.bool_, count=ct.n_real)
            else:
                row = np.zeros((ct.n_real,), dtype=np.bool_)
            hit = self._row_cache[key] = (row, bool(row.all()))
        return hit

    def _static_score_row(self, plugin, pi: PodInfo, snapshot: Snapshot,
                          ct: ClusterTensors) -> tuple[np.ndarray, bool]:
        """(row, any_nonzero); see _static_filter_row on caching."""
        key = (plugin.NAME + "/score", _signature(plugin.NAME, pi))
        hit = self._row_cache.get(key)
        if hit is None:
            state = CycleState()
            row = np.fromiter(
                (plugin.score(state, pi, ni) for ni in snapshot.nodes),
                dtype=np.float32, count=ct.n_real)
            hit = self._row_cache[key] = (row, bool(row.any()))
        return hit

    # -- NodeResourceTopologyMatch rows --------------------------------------

    def _nrt_state(self, plugin, snapshot: Snapshot,
                   ct: ClusterTensors) -> dict:
        """Batch-start zone arrays for NodeResourceTopologyMatch: free/cap
        (N, Zmax, T), zone_valid (N, Zmax), tracked (N, T) over the union T
        of zone-listed resources. Each node is packed ONCE per snapshot
        (`pack_zones`), and rows are answered with numpy broadcasting;
        within-batch drift is caught by the full re-check in _verify."""
        # nrt_seq moves on NRT object churn (which does not move the
        # snapshot generation); id(plugin) separates per-profile instances.
        key = (ct.generation, id(snapshot), id(plugin), plugin.nrt_seq)
        if self._nrt_cache is not None and self._nrt_cache[0] == key:
            return self._nrt_cache[1]
        T = sorted(plugin._zone_resources)
        t_index = {r: j for j, r in enumerate(T)}
        N = ct.n_real
        per_node: list[tuple | None] = []
        zmax = 1
        for ni in snapshot.nodes:
            nrt = plugin._nrt(ni.name)
            if nrt is None or not (
                    set(nrt.get("topologyPolicies") or [])
                    & SINGLE_NUMA_POLICIES):
                per_node.append(None)
                continue
            caps = [c for _, c in _zone_caps(nrt)]
            per_node.append((pack_zones(nrt, ni), caps))
            zmax = max(zmax, len(caps))
        free = np.zeros((N, zmax, len(T)), dtype=np.int64)
        cap = np.zeros_like(free)
        zone_valid = np.zeros((N, zmax), dtype=np.bool_)
        tracked = np.zeros((N, len(T)), dtype=np.bool_)
        for n, entry in enumerate(per_node):
            if entry is None:
                continue
            zfree, zcaps = entry
            for z, (zf, zc) in enumerate(zip(zfree, zcaps)):
                zone_valid[n, z] = True
                for r, v in zc.items():
                    j = t_index[r]
                    cap[n, z, j] = v
                    tracked[n, j] = True
                for r, v in zf.items():
                    free[n, z, t_index[r]] = v
        state = {"T": T, "t_index": t_index, "free": free, "cap": cap,
                 "zone_valid": zone_valid, "tracked": tracked,
                 "strategy": plugin.strategy,
                 # zone-tracked request bytes -> evaluation, filter row,
                 # score row: a template's pods compute each once.
                 "by_request": {}, "filter_rows": {}, "score_rows": {}}
        self._nrt_cache = (key, state)
        return state

    @staticmethod
    def _nrt_req_vec(st: dict, pi: PodInfo) -> np.ndarray:
        q = np.zeros(len(st["T"]), dtype=np.int64)
        for r, v in pi.requests.items():
            j = st["t_index"].get(r)
            if j is not None and v > 0:
                q[j] = v
        return q

    def _nrt_pod_eval(self, st: dict, pi: PodInfo, memo: dict, i: int):
        """Per-pod (q, constrained, zone_fit), memoized per chunk index and
        per zone-tracked request vector (the state's `by_request`, which
        lives as long as the snapshot's zone arrays): the Filter and Score
        rows share the (N, Zmax, T) reduction, and a template's pods run
        it once."""
        hit = memo.get(i)
        if hit is None:
            q = self._nrt_req_vec(st, pi)
            hit = st["by_request"].get(q.tobytes())
            if hit is None:
                qpos = (q > 0)[None, None, :]
                constrained = (st["tracked"] & (q > 0)[None, :]).any(-1)
                viol = st["tracked"][:, None, :] & qpos \
                    & (st["free"] < q[None, None, :])
                zone_fit = st["zone_valid"] & ~viol.any(-1)
                hit = st["by_request"][q.tobytes()] = (q, constrained,
                                                       zone_fit)
            memo[i] = hit
        return hit

    def _nrt_filter_row(self, st: dict, pi: PodInfo, memo: dict,
                        i: int) -> np.ndarray:
        """(n_real,) bool: the plugin's filter() over every node (one
        shared row per zone-tracked request vector)."""
        q, constrained, zone_fit = self._nrt_pod_eval(st, pi, memo, i)
        row = st["filter_rows"].get(q.tobytes())
        if row is None:
            row = st["filter_rows"][q.tobytes()] = \
                ~constrained | zone_fit.any(-1)
        return row

    def _nrt_score_row(self, st: dict, pi: PodInfo, memo: dict,
                       i: int) -> np.ndarray:
        """(n_real,) float64: the plugin's score() over every node (best
        zone by the configured strategy; 0 for unconstrained or unfitting
        nodes), in the reference's arithmetic order; one shared row per
        zone-tracked request vector."""
        q, constrained, zone_fit = self._nrt_pod_eval(st, pi, memo, i)
        row = st["score_rows"].get(q.tobytes())
        if row is None:
            row = st["score_rows"][q.tobytes()] = self._nrt_zone_score(
                st, q, constrained, zone_fit)
        return row

    @staticmethod
    def _nrt_zone_score(st: dict, q: np.ndarray, constrained: np.ndarray,
                        zone_fit: np.ndarray) -> np.ndarray:
        qpos = (q > 0)[None, None, :]
        m = (st["cap"] > 0) & qpos
        cnt = m.sum(-1)
        safe_cap = np.maximum(st["cap"], 1)
        fr = np.where(m, (st["free"] - q[None, None, :]) / safe_cap, 0.0)
        denom = np.maximum(cnt, 1)
        mean = fr.sum(-1) / denom
        if st["strategy"] == "MostAllocated":
            s = 100.0 * (1.0 - mean)
        elif st["strategy"] == "BalancedAllocation":
            var = (np.where(m, fr * fr, 0.0).sum(-1) / denom) - mean * mean
            s = 100.0 * (1.0 - np.sqrt(np.maximum(var, 0.0)))
        else:  # LeastAllocated
            s = 100.0 * mean
        s = np.where(zone_fit & (cnt > 0), s, -np.inf)
        best = s.max(-1)
        return np.where(constrained & np.isfinite(best),
                        np.maximum(best, 0.0), 0.0)

    # -- DynamicResources rows ------------------------------------------------

    def _dra_state(self, plugin, snapshot: Snapshot,
                   ct: ClusterTensors) -> dict:
        """Batch-start free-device counts for DynamicResources: per (node,
        class) free counts plus, per device-attribute key, the largest
        single-value group — enough to answer count-N claims with or
        without one matchAttribute constraint as numpy rows. Claims are
        charged ONCE per snapshot from three ledgers: allocations
        (`plugin._alloc_by_node`), unallocated claims of resident pods, and
        the assume ledger (`plugin._assumed`: reserved claims whose PreBind
        has not written yet). In-batch drift is caught by the full
        re-check in _verify."""
        # dra_seq moves on claim, slice and class churn, assume_seq on
        # every assume-ledger change: both key the cache.
        key = (ct.generation, id(snapshot), id(plugin), plugin.dra_seq,
               plugin.assume_seq)
        if self._dra_cache is not None and self._dra_cache[0] == key:
            return self._dra_cache[1]
        classes = plugin._classes()
        class_names = sorted(classes)
        c_index = {c: j for j, c in enumerate(class_names)}
        N, C = ct.n_real, len(class_names)
        free_total = np.zeros((N, C), dtype=np.int32)
        #: attr key -> (N, C) best single-value group size
        max_group: dict[str, np.ndarray] = {}

        # One pass over the claim ledgers, grouped per node.
        charges: dict[str, dict[str, dict]] = {}

        def charge(node_name: str, claim: dict) -> None:
            charges.setdefault(node_name, {})[namespaced_name(claim)] = claim

        for n, bucket in plugin._alloc_by_node.items():
            for claim in bucket.values():
                charge(n, claim)
        for ni in snapshot.nodes:
            for pi in ni.pods:
                for ckey in pod_claim_keys(pi):
                    claim = plugin._claim_informer.indexer.get(ckey) \
                        if plugin._claim_informer is not None else None
                    if claim is not None and \
                            claim_allocated_node(claim) is None:
                        charge(ni.name, claim)
        for a in plugin._assumed.values():
            charge(a["node"], a["claim"])

        attr_keys: set[str] = set()
        per_node_free: list[list[dict]] = []
        for ni in snapshot.nodes:
            devices = plugin.node_devices(ni.name)
            if not devices:
                per_node_free.append([])
                continue
            taken: set[str] = set()
            for claim in (charges.get(ni.name) or {}).values():
                alloc = (claim.get("status") or {}).get("allocation")
                if alloc:
                    if alloc.get("nodeName") == ni.name:
                        taken.update(alloc.get("devices") or [])
                    continue
                picked = plugin._pick_devices(
                    claim, [d for d in devices if d["name"] not in taken],
                    classes)
                if picked is not None:
                    taken.update(picked)
            free = [d for d in devices if d["name"] not in taken]
            per_node_free.append(free)
            for d in free:
                attr_keys.update((d.get("attributes") or {}).keys())
        for a in attr_keys:
            max_group[a] = np.zeros((N, C), dtype=np.int32)
        for idx, free in enumerate(per_node_free):
            if not free:
                continue
            for j, cname in enumerate(class_names):
                cls = classes[cname]
                matching = [d for d in free
                            if plugin._class_matches(cls, d)]
                free_total[idx, j] = len(matching)
                for a in attr_keys:
                    groups: dict = {}
                    for d in matching:
                        v = (d.get("attributes") or {}).get(a)
                        groups[v] = groups.get(v, 0) + 1
                    if groups:
                        max_group[a][idx, j] = max(groups.values())
        state = {"c_index": c_index, "free_total": free_total,
                 "max_group": max_group, "_name_idx": ct.name_to_idx,
                 # claim shapes -> row (False: not answerable here): a
                 # template's pods compute each once.
                 "by_shape": {}}
        self._dra_cache = (key, state)
        return state

    @staticmethod
    def _dra_filter_row(st: dict, plugin, pi: PodInfo,
                        memo: dict, i: int) -> np.ndarray | None:
        """(n_real,) bool row, or None when the pod's claims use a shape
        the counts cannot answer (several matchAttribute constraints, a
        constraint over several requests, an unknown claim): the caller
        then takes the plugin's own host row. Memoized per chunk index
        and per claim shape (the allocated node, or the requests and
        constraints of each claim): pods of one template share a row."""
        hit = memo.get(i)
        if hit is not None:
            return hit if hit is not False else None
        claims = []
        for ckey in pod_claim_keys(pi):
            claim = plugin._claim_informer.indexer.get(ckey) \
                if plugin._claim_informer is not None else None
            if claim is None:
                memo[i] = False
                return None
            claims.append(claim)
        shape = tuple(
            (claim_allocated_node(c), repr(claim_requests(c)),
             tuple(claim_match_attrs(c))) for c in claims)
        hit = st["by_shape"].get(shape)
        if hit is None:
            hit = st["by_shape"][shape] = TorchBackend._dra_claims_row(
                st, claims)
        memo[i] = hit
        return hit if hit is not False else None

    @staticmethod
    def _dra_claims_row(st: dict, claims: list):
        """The row of `_dra_filter_row` for resolved claims, or False."""
        N = st["free_total"].shape[0]
        row = np.ones((N,), dtype=np.bool_)
        for claim in claims:
            pinned = claim_allocated_node(claim)
            if pinned is not None:
                # PreFilter's pin: only the allocated node survives.
                pin_row = np.zeros((N,), dtype=np.bool_)
                j = st["_name_idx"].get(pinned)
                if j is not None:
                    pin_row[j] = True
                row &= pin_row
                continue
            attrs = claim_match_attrs(claim)
            if len(attrs) > 1 or (attrs and
                                  len(claim_requests(claim)) > 1):
                return False
            for req in claim_requests(claim):
                j = st["c_index"].get(req.get("deviceClassName", ""))
                if j is None:
                    row[:] = False
                    continue
                count = int(req.get("count", 1))
                if attrs:
                    mg = st["max_group"].get(attrs[0])
                    avail = mg[:, j] if mg is not None else 0
                else:
                    avail = st["free_total"][:, j]
                row &= avail >= count
        return row

    @staticmethod
    def _dynamic_filter_row(plugin, pi: PodInfo, snapshot: Snapshot,
                            ct: ClusterTensors,
                            state: CycleState) -> np.ndarray | None:
        """A stateful plugin's own host row (NodePorts, the volume
        plugins, and DynamicResources' claim shapes the counts cannot
        answer): None when the plugin skips the pod at PreFilter."""
        st = plugin.pre_filter(state, pi, snapshot)
        if st.is_skip():
            return None
        if not st.is_success():
            return np.zeros((ct.n_real,), dtype=np.bool_)
        return np.fromiter(
            (plugin.filter(state, pi, ni).is_success()
             for ni in snapshot.nodes),
            dtype=np.bool_, count=ct.n_real)

    # -- main entry ----------------------------------------------------------

    def assign(self, pods: Sequence[PodInfo], snapshot: Snapshot,
               fwk: Framework):
        """Schedule `pods` in chunks of max_batch; each chunk's solve reads
        the used state the previous chunk left on the device. Chunks are
        pipelined as in the reference: up to `pipeline_depth` chunks are
        dispatched before the oldest one's assignments are fetched and
        verified, so a verify rejection folds out of the state that later
        dispatches read (chunks already in flight saw it consumed)."""
        pods = list(pods)
        self._check_supported(pods, fwk)
        t0 = time.perf_counter()
        ctx = self._start(pods, snapshot, fwk)
        self._run_chunks(ctx)
        self.timings["assign_s"] += time.perf_counter() - t0
        return ctx.assignments, ctx.diagnostics

    async def assign_async(self, pods: Sequence[PodInfo], snapshot: Snapshot,
                           fwk: Framework):
        """`assign` for the scheduler's event loop: the chunks of
        `assign_stream`, drained; the waits for the card yield to the
        loop's other tasks."""
        ctx = None
        async for _chunk_pods, ctx in self.assign_stream(pods, snapshot, fwk):
            pass
        if ctx is None:  # empty batch
            return {}, {}
        return ctx.assignments, ctx.diagnostics

    async def assign_stream(self, pods: Sequence[PodInfo],
                            snapshot: Snapshot, fwk: Framework):
        """Chunk-streaming `assign`: yields (chunk_pods, ctx) as each
        chunk's host verify completes, so the caller's per-pod work
        (assume, Reserve, the binding cycle) overlaps the next chunks'
        device passes. ctx.assignments and ctx.diagnostics accumulate; a
        chunk's keys are final once it is yielded. The same pipeline as
        `assign` (`_pipeline`), so the assignments, diagnostics, counters,
        solver metrics and `timings` are assign()'s. `timings` charge the
        generator's own wall: not the caller's between yields, nor other
        tasks' inside its waits for the card (`_await_event`), which the
        blocking `assign` would have run after it.

        The wait for the card runs on the loop's thread: the dispatch
        queued the assignments' copy into pinned host memory and an event
        behind it (`_dispatch_chunk`), and the wait polls that event
        between short sleeps (`_await_event`). So no CUDA call runs off
        the loop thread, where PyTorch's current stream is another and a
        graph capture of another loop task (a spread scan, a victim
        proposal) could be open."""
        pods = list(pods)
        self._check_supported(pods, fwk)
        tm = self.timings
        t0 = time.perf_counter()
        ctx = self._start(pods, snapshot, fwk)
        for run in self._pipeline(ctx):
            t2 = time.perf_counter()
            with self._fetch_span(run):
                others = await self._await_event(run.get("assign_ev"))
                assign_np = self._host_assign(run)
            t3 = time.perf_counter()
            run["solve_wall_s"] = run["dispatch_s"] + t3 - t2
            if self.metrics is not None:
                self.metrics.solve_duration.observe(run["solve_wall_s"])
            diag_others = 0.0
            if (assign_np[: run["batch"].p_real] < 0).any():
                # Solver failures: _finalize_chunk's diagnostics read the
                # unsat planes. Their copies are queued and awaited here,
                # so finalize does not stall the loop on a device read.
                diag_others = await self._await_event(
                    self._queue_diag_planes(run))
            self._finalize_chunk(run, assign_np, ctx)
            t4 = time.perf_counter()
            # The time other tasks ran inside the waits is theirs, not
            # this assign()'s (the blocking `assign` runs it afterwards).
            tm["device_s"] += t3 - t2 - others
            tm["verify_s"] += t4 - t3 - diag_others
            tm["assign_s"] += t4 - t0 - others - diag_others
            yield run["pods"], ctx
            t0 = time.perf_counter()
        tm["assign_s"] += time.perf_counter() - t0

    #: the event poll's first sleeps are 0 (a pass of the loop's ready
    #: tasks) until the wait reaches _SPIN_S seconds, then _POLL_S each; a
    #: sleep that returns more than _IDLE_SLACK_S after it asked to ran
    #: other tasks for the excess.
    _SPIN_S = 0.002
    _POLL_S = 0.0005
    _IDLE_SLACK_S = 0.001

    @classmethod
    async def _await_event(cls, ev) -> float:
        """Wait on the loop's thread until a CUDA event has completed
        (None: nothing to wait for, the CPU), letting other tasks run.
        Returns the seconds other tasks held the loop inside the wait:
        each sleep's return past its request and _IDLE_SLACK_S (the
        selector's millisecond rounding)."""
        if ev is None:
            return 0.0
        t0 = time.perf_counter()
        others = 0.0
        while not ev.query():
            before = time.perf_counter()
            delay = 0.0 if before - t0 < cls._SPIN_S else cls._POLL_S
            await asyncio.sleep(delay)
            others += max(0.0, time.perf_counter() - before - delay
                          - cls._IDLE_SLACK_S)
        return others

    def _queue_diag_planes(self, run: dict):
        """Start the device-to-host copies of a chunk's diagnostic unsat
        planes (`fit0_d`, `taint_ok_d`) into pinned memory, behind one
        event: the event (None on the CPU, where the planes are host
        arrays already). `_finalize_chunk` reads them from
        `run["fit0_np"]` / `run["taint_ok_np"]`."""
        for k in ("fit0", "taint_ok"):
            dev = run[f"{k}_d"]
            if not dev.is_cuda:
                run[f"{k}_np"] = dev.numpy()
                continue
            host = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            host.copy_(dev, non_blocking=True)
            run[f"{k}_np"] = host.numpy()
        if not run["fit0_d"].is_cuda:
            return None
        ev = torch.cuda.Event()
        ev.record()
        return ev

    @staticmethod
    def _host_assign(run: dict) -> np.ndarray:
        """A chunk's assignments on the host, once its event completed (or
        at once on the CPU)."""
        host = run.pop("assign_host", None)
        if host is not None:
            return host.numpy()
        return run["assign_d"].numpy()

    def _pipeline(self, ctx: "_AssignCtx"):
        """Prep and dispatch every chunk of an assign() context, yielding
        the dispatched runs in finalize order, `pipeline_depth` dispatches
        ahead of the oldest (the reference's `_pipeline`); charges
        `timings["prep_s"]` and the dispatch's part of `["device_s"]`."""
        tm = self.timings
        pending: deque = deque()
        for chunk in ctx.chunks:
            t1 = time.perf_counter()
            prep = self._prep_chunk(chunk, ctx)
            t2 = time.perf_counter()
            pending.append(self._dispatch_chunk(prep, ctx))
            prep["dispatch_s"] = time.perf_counter() - t2
            tm["prep_s"] += t2 - t1
            tm["device_s"] += prep["dispatch_s"]
            if len(pending) > self.pipeline_depth:
                yield pending.popleft()
        while pending:
            yield pending.popleft()

    def _run_chunks(self, ctx: "_AssignCtx") -> None:
        """Prep, dispatch and finish every chunk of an assign() context,
        `pipeline_depth` dispatches ahead of the oldest finish."""
        for run in self._pipeline(ctx):
            self._finish_chunk(run, ctx)

    def _finish_chunk(self, run: dict, ctx: "_AssignCtx") -> None:
        """Fetch one dispatched chunk's assignments (waiting for its
        device pass), then verify and finalize it."""
        tm = self.timings
        t2 = time.perf_counter()
        assign_np = self._fetch_assign(run)
        t3 = time.perf_counter()
        run["solve_wall_s"] = run["dispatch_s"] + t3 - t2
        if self.metrics is not None:
            self.metrics.solve_duration.observe(run["solve_wall_s"])
        self._finalize_chunk(run, assign_np, ctx)
        tm["device_s"] += t3 - t2
        tm["verify_s"] += time.perf_counter() - t3

    def _fetch_span(self, run: dict):
        """The `solver.solve` span of a chunk's fetch when tracing is on.
        The dispatch seam raises under KTPU_LOCK_CHECK when a lock is held
        across the fetch."""
        check_dispatch_seam("backend.fetch_assign")
        tr = self.tracer
        if tr is None or not tr.enabled:
            return contextlib.nullcontext()
        return tr.span("solver.solve", chunk=run["chunk_idx"],
                       pods=run["batch"].p_real)

    def _fetch_assign(self, run: dict) -> np.ndarray:
        """Blocking device→host fetch of a chunk's assignments (it waits
        for the device pass)."""
        with self._fetch_span(run):
            ev = run.get("assign_ev")
            if ev is not None:
                ev.synchronize()
            return self._host_assign(run)

    @staticmethod
    def _check_supported(pods: list[PodInfo], fwk: Framework) -> None:
        for p in fwk.plugins:
            if _MODELLED_POINTS.isdisjoint(p.EXTENSION_POINTS):
                continue
            if p.NAME not in MODELLED_PLUGINS \
                    or IN_TREE.get(p.NAME) is not type(p):
                raise NotImplementedError(
                    f"plugin {p.NAME!r}: this slice models only "
                    f"{sorted(MODELLED_PLUGINS)} at "
                    f"{sorted(_MODELLED_POINTS)}")

    def _start(self, pods: list[PodInfo], snapshot: Snapshot,
               fwk: Framework) -> "_AssignCtx":
        self._tuner.n_nodes = len(snapshot.nodes)
        self.pipeline_depth = self._tuner.decide()
        ct = self._tensors(snapshot)
        # namespaceSelector terms resolve through the framework's
        # InterPodAffinity plugin (its namespaces informer); spread
        # constraints share the mechanism, so PodTopologySpread's resolver
        # backs it when the profile has no InterPodAffinity. Without
        # either, resolve_term_namespaces' static rule applies.
        src = next((p for p in fwk.plugins
                    if p.NAME == "InterPodAffinity"), None) or next(
            (p for p in fwk.plugins if p.NAME == "PodTopologySpread"), None)
        self._ns_resolver = getattr(src, "ns_resolver", None)
        ctx = _AssignCtx()
        ctx.snapshot, ctx.fwk, ctx.ct = snapshot, fwk, ct
        ctx.class_pad = class_pad()
        ctx.chunks = [pods[lo:lo + self.max_batch]
                      for lo in range(0, len(pods), self.max_batch)]
        ctx.assignments, ctx.diagnostics = {}, {}
        # Shared verify state: later chunks are checked against earlier
        # chunks' accepted placements (working nodes + delta list).
        ctx.working = {}
        ctx.wsnap = None
        ctx.delta = []
        ctx.delta_has_terms = False
        ctx.sel_cache = {}
        ctx.delta_idx = _DeltaAffinityIndex(ctx.sel_cache, self._ns_resolver)
        ctx.chunk_seq = -1
        # The union spread table, built EAGERLY when any pod of the batch
        # carries spread constraints, so chunks dispatched before the
        # first spread pod still count their selector-matching placements.
        ctx.spread = None
        ctx.spread_last_gated = -1
        if any(pj.topology_spread_constraints
               for chunk in ctx.chunks for pj in chunk):
            sp_plugin = next((p for p in fwk.filter_plugins
                              if p.NAME == "PodTopologySpread"), None)
            if sp_plugin is not None:
                self._build_spread_table(
                    ctx, snapshot, ct,
                    self._affinity_compiler(snapshot, ct), sp_plugin)
                # The last chunk with scan-GATED pods: contribute-only
                # chunks after it keep the multistart solver (their counts
                # no longer influence any gating decision).
                if ctx.spread["cons"]:
                    cols = ctx.spread["tpl_cols"]
                    for k, chunk in enumerate(ctx.chunks):
                        for pj in chunk:
                            if not pj.topology_spread_constraints:
                                continue
                            cs = sp_plugin._constraints_for(
                                pj, "DoNotSchedule")
                            if cs and self._spread_tpl_key(cs, pj) in cols:
                                ctx.spread_last_gated = k
                                break
        ctx.params = self._fwk_params(fwk, ct)
        if self.resident is not None:
            # The chain is corrected in place (fold_back), so it takes a
            # copy: a batch never writes the resident planes the fast path
            # reads.
            self.used.advance(self.resident.used_pack(ct, snapshot).clone())
        else:
            self.used.seed(np.concatenate(
                [ct.used_q, ct.used_nz_q,
                 ct.used_pods.astype(np.int32)[:, None]], axis=1))
        return ctx

    # -- PodTopologySpread: the union spread table ---------------------------

    @staticmethod
    def _spread_tpl_key(cs: list, pj: PodInfo) -> str:
        # EVERY semantic field participates: two templates differing only
        # in minDomains/namespaceSelector must not collide. The pod's
        # node-eligibility signature participates too: eligibility folds
        # into the template's constraint columns.
        return repr((sorted((c.get("topologyKey", ""),
                             repr(c.get("labelSelector")),
                             c.get("maxSkew", 1),
                             repr(c.get("minDomains")),
                             repr(c.get("namespaceSelector")))
                            for c in cs), pj.namespace,
                     pj.node_selector,
                     pj.affinity.get("nodeAffinity"), pj.tolerations))

    def _build_spread_table(self, ctx, snapshot, ct, compiler,
                            plugin) -> None:
        """The union spread table, built once per assign() from all
        chunks (the reference's `_build_spread_table`, in the scans' index
        form — `solver.SpreadTable`).

        Every distinct DoNotSchedule template of the batch contributes its
        constraints to one union list C; the scan gates each pod on its
        template's columns (`applies`) and counts every placed pod in the
        constraints its labels match (`contributes`). namespaceSelector
        resolves to a namespace set here, minDomains becomes the
        per-constraint `min_ok`, restricted node eligibility folds into the
        template's domain membership, and non-self-matching selectors ride
        the per-pod selfMatch term. A template whose constraints have no
        eligible domain anywhere takes a static has-key row instead (exact:
        placements never move its counts)."""
        templates: dict[str, dict] = {}
        for chunk in ctx.chunks:
            for pj in chunk:
                if not pj.topology_spread_constraints:
                    continue
                cs = plugin._constraints_for(pj, "DoNotSchedule")
                if not cs:
                    continue
                key = self._spread_tpl_key(cs, pj)
                if key not in templates:
                    templates[key] = {
                        "cons": cs, "ns": pj.namespace, "rep": pj,
                        "sels": [from_label_selector(
                            c.get("labelSelector")) for c in cs],
                    }

        cons: list[dict] = []      # union constraint list
        con_ns: list[tuple] = []   # resolved namespace set per constraint
        con_sels: list = []
        con_elig: list[np.ndarray] = []
        tpl_cols: dict[str, list[int]] = {}
        static_rows: dict[str, np.ndarray] = {}
        for key, t in templates.items():
            elig = compiler.eligibility_row(t["rep"])
            if not any(
                    (compiler.topo.has_key(c["topologyKey"]) & elig).any()
                    for c in t["cons"]):
                row = np.ones((ct.n_real,), dtype=np.bool_)
                for c in t["cons"]:
                    row &= compiler.topo.has_key(
                        c["topologyKey"])[: ct.n_real]
                static_rows[key] = row
                continue
            cols = []
            for cidx, c in enumerate(t["cons"]):
                cols.append(len(cons))
                cons.append(c)
                con_ns.append(compiler.spread_constraint_ns(c, t["ns"]))
                con_sels.append(t["sels"][cidx])
                con_elig.append(elig)
            tpl_cols[key] = cols
        ctx.spread = {"cons": cons, "tpl_cols": tpl_cols,
                      "static_rows": static_rows}
        if not cons:
            return

        N, C = ct.n_pad, len(cons)
        node_dom = np.full((N, C), -1, dtype=np.int64)
        has_key = np.zeros((N, C), dtype=np.bool_)
        min_ok = np.ones((C,), dtype=np.bool_)
        dom_cid: list[int] = []
        counts0: list[int] = []
        for cidx, c in enumerate(cons):
            dom_ids, num = compiler.topo.domains(c["topologyKey"])
            counts = compiler.counts_for(c.get("labelSelector"),
                                         con_ns[cidx])
            elig = con_elig[cidx]
            active = (dom_ids > 0) & elig
            d = _seg_sum(np.where(active, counts, 0.0), dom_ids, num)
            has_key[:, cidx] = dom_ids > 0
            existing = np.unique(dom_ids[active])
            md = int(c.get("minDomains") or 0)
            if md and len(existing) < md:
                min_ok[cidx] = False  # minDomains deficit: global min 0
            for k in existing:
                # Domain membership over ELIGIBLE nodes only: placements
                # on keyed-but-ineligible nodes neither count nor gate.
                node_dom[(dom_ids == k) & elig, cidx] = len(dom_cid)
                dom_cid.append(cidx)
                counts0.append(int(d[k]))
        ctx.spread.update({
            "con_ns": con_ns, "con_sels": con_sels,
            "node_dom_host": node_dom,
            "table": solver.SpreadTable(
                self._put(node_dom), self._put(np.asarray(dom_cid, np.int64)),
                self._put(np.array([int(c.get("maxSkew", 1)) for c in cons],
                                   np.int32)),
                self._put(min_ok), self._put(has_key)),
            "dev_counts": self._put(np.asarray(counts0, np.int32)),
        })

    def _process_spread_pods(self, spread_pods, ctx,
                             apply_row) -> list[int]:
        """Hard (DoNotSchedule) PodTopologySpread routing: every pod whose
        template is in the union table rides the spread scan; a
        zero-domain template's pods take its static has-key row. A pod in
        neither raises: the reference's host-row escape hatch for pods
        that miss the table (`spread_poisoned`) is not ported."""
        sp = ctx.spread   # built at _start: the pods' plugin is in the profile
        active: list[int] = []
        missed: list[str] = []
        for i, pi, cs in spread_pods:
            key = self._spread_tpl_key(cs, pi)
            if key in sp["tpl_cols"]:
                active.append(i)
                continue
            srow = sp["static_rows"].get(key)
            if srow is not None:
                if not srow.all():
                    apply_row("PodTopologySpread", i, srow)
                continue
            missed.append(pi.key)
        if missed:
            raise RuntimeError(
                f"pods {missed} missed the union spread table built at "
                f"assign() start; the reference's host-row fallback "
                f"(spread_poisoned) is not ported")
        return active

    def _fwk_params(self, fwk: Framework, ct: ClusterTensors) -> dict:
        """Score-plugin parameters as device tensors and float32-valued
        weights, cached per (framework, resource columns)."""
        key = (id(fwk), tuple(ct.resources))
        cached = self._fwk_params_cache.get(key)
        if cached is not None and cached[0] is fwk:
            return cached[1]
        if len(self._fwk_params_cache) > 64:
            self._fwk_params_cache.clear()
        score_plugins = {p.NAME: p for p in fwk.score_plugins}
        fit_plugin = score_plugins.get("NodeResourcesFit")
        strategy = getattr(fit_plugin, "strategy_type", "LeastAllocated")
        fit_col_w = np.zeros((len(ct.resources),), dtype=np.float32)
        if fit_plugin is not None:
            for spec in fit_plugin.score_resources:
                j = ct.r_index.get(spec["name"])
                if j is not None:
                    fit_col_w[j] = spec.get("weight", 1)
        bal_plugin = score_plugins.get("NodeResourcesBalancedAllocation")
        bal_col_mask = np.zeros((len(ct.resources),), dtype=np.bool_)
        if bal_plugin is not None:
            for r in bal_plugin.resources:
                j = ct.r_index.get(r)
                if j is not None:
                    bal_col_mask[j] = True
        shape_pts = getattr(fit_plugin, "shape", None) or [
            {"utilization": 0, "score": 0}, {"utilization": 100, "score": 10}]
        w = fwk.score_weights
        filter_names = {p.NAME for p in fwk.filter_plugins}

        def f32(x) -> float:
            return float(np.float32(x))

        params = {
            "strategy": strategy,
            "fit_col_w": self._put(fit_col_w),
            "bal_col_mask": self._put(bal_col_mask),
            "shape_u": self._put(
                np.array([p["utilization"] for p in shape_pts], np.float32)),
            "shape_s": self._put(
                np.array([p["score"] for p in shape_pts], np.float32)),
            "w_fit": f32(w.get("NodeResourcesFit", 1) if fit_plugin else 0),
            "w_bal": f32(w.get("NodeResourcesBalancedAllocation", 1)
                         if bal_plugin else 0),
            "w_taint": f32(w.get("TaintToleration", 3)
                           if "TaintToleration" in score_plugins else 0),
            "taint_filter_on": "TaintToleration" in filter_names,
            "filter_names": filter_names,
        }
        self._fwk_params_cache[key] = (fwk, params)
        return params

    def _prep_chunk(self, pods: list[PodInfo], ctx: "_AssignCtx") -> dict:
        """Host side of one chunk: the host filter and score rows (the
        constraint families' among them), the class dictionary and its
        planes, the spread matrices, the multistart permutations, the
        solve mode and the wavefront width."""
        ct, snapshot, fwk = ctx.ct, ctx.snapshot, ctx.fwk
        ctx.chunk_seq += 1
        chunk_idx = ctx.chunk_seq
        P = self.max_batch
        batch = PodBatch(pods, ct, P)
        N = ct.n_pad
        filter_names = {p.NAME for p in fwk.filter_plugins}
        score_plugins = {p.NAME: p for p in fwk.score_plugins}

        # Host filter rows accumulate as INTERNED references, never a (P,N)
        # plane: each applied row is content-interned once, each pod
        # carries the list of its row ids, and the class build materializes
        # ONE AND-folded row per distinct row-set. Rows with exactly one
        # allowed column (NodeName) become the pod's sparse EXCEPTION
        # column instead of splitting every pinned pod into its own class.
        row_store: dict[int, np.ndarray] = {}      # cid -> ok row (n_real,)
        _row_bytes: dict[bytes, int] = {}
        _row_memo: dict[int, tuple] = {}           # id(row) -> (cid,nnz,col)
        _row_refs: list = []                       # pin ids against reuse
        pod_rows: dict[int, list[int]] = {}        # pod -> ordered cids
        pod_pin: dict[int, int] = {}               # pod -> exception column
        infeasible: set[int] = set()               # empty mask (class 0)

        def _intern_row(row: np.ndarray) -> tuple:
            got = _row_memo.get(id(row))
            if got is None:
                b = row.tobytes()
                cid = _row_bytes.get(b)
                if cid is None:
                    cid = _row_bytes[b] = len(_row_bytes)
                    row_store[cid] = row
                nnz = int(row.sum())
                col = int(np.argmax(row)) if nnz == 1 else -1
                got = _row_memo[id(row)] = (cid, nnz, col)
                _row_refs.append(row)
            return got

        # Pods requesting resources no tracked column covers are infeasible
        # everywhere.
        unknown_res: set[int] = set()
        for i, pi in enumerate(pods):
            if ct.has_unknown_resource(pi.requests):
                infeasible.add(i)
                unknown_res.add(i)

        #: plugin -> {pod -> its (n_real,) ok row} for the diagnostics.
        host_filter_fail: dict[str, dict[int, np.ndarray]] = {}
        #: hard-spread pods: (chunk index, PodInfo, constraints).
        spread_pods: list[tuple[int, PodInfo, list[dict]]] = []
        #: per-pod CycleState of the plugins' own host rows, and the
        #: per-chunk memos of the NRT evaluation and the DRA rows.
        dyn_states: dict[int, CycleState] = {}
        nrt_memo: dict[int, tuple] = {}
        dra_memo: dict[int, object] = {}
        #: pods of NodeResourceTopologyMatch or DynamicResources: their
        #: chunk takes the verify's full host re-check.
        stateful_pods: set[int] = set()
        #: DISTINCT pods that took a plugin's own per-pod host row,
        #: counted once into backend_degradations{kind="host_fallback"}.
        fallback_pods: set[int] = set()

        def _apply_interned(i: int, cid: int, nnz: int, col: int) -> None:
            if nnz == 0:
                infeasible.add(i)
            elif col >= 0:
                prev = pod_pin.get(i)
                if prev is None:
                    pod_pin[i] = col
                elif prev != col:    # two pins disagree: no node survives
                    infeasible.add(i)
            else:
                lst = pod_rows.setdefault(i, [])
                if cid not in lst:
                    lst.append(cid)

        def apply_row(pname: str, i: int, row: np.ndarray) -> None:
            if row.all():
                return
            fmap = host_filter_fail.setdefault(pname, {})
            prev = fmap.get(i)
            fmap[i] = row if prev is None else (prev & row)
            _apply_interned(i, *_intern_row(row))

        #: shared-row groups of the InterPodAffinity rows: template batches
        #: produce ONE row object per signature (the compiler's cache), so
        #: each distinct row is interned once (id-keyed).
        ipa_groups: dict[int, tuple[np.ndarray, list[int]]] = {}
        compiler = None

        for plugin in fwk.filter_plugins:
            if plugin.NAME in DEVICE_FILTER_PLUGINS:
                continue
            if plugin.NAME in STATIC_ROW_PLUGINS:
                for i, pi in enumerate(pods):
                    if i in unknown_res:
                        continue
                    row, all_true = self._static_filter_row(
                        plugin, pi, snapshot, ct)
                    if not all_true:
                        apply_row(plugin.NAME, i, row)
                continue
            # The stateful plugins (_check_supported admits no other),
            # each behind its activity gate.
            gate = _FILTER_ACTIVE[plugin.NAME]
            for i, pi in enumerate(pods):
                if i in unknown_res or not gate(plugin, pi, snapshot):
                    continue
                if plugin.NAME == "InterPodAffinity":
                    if compiler is None:
                        compiler = self._affinity_compiler(snapshot, ct)
                    row_full = compiler.filter_row(pi)
                    grp = ipa_groups.get(id(row_full))
                    if grp is None:
                        grp = ipa_groups[id(row_full)] = (row_full, [])
                    grp[1].append(i)
                elif plugin.NAME == "PodTopologySpread":
                    constraints = plugin._constraints_for(
                        pi, "DoNotSchedule")
                    if constraints:
                        spread_pods.append((i, pi, constraints))
                elif plugin.NAME == "NodeResourceTopologyMatch":
                    # Zone-alignment rows from the snapshot's zone
                    # arrays; in-batch drift -> the full re-check.
                    row = self._nrt_filter_row(
                        self._nrt_state(plugin, snapshot, ct), pi,
                        nrt_memo, i)
                    apply_row(plugin.NAME, i, row)
                    stateful_pods.add(i)
                elif plugin.NAME == "DynamicResources":
                    # Claim-fit rows from the snapshot's free-device
                    # counts, or the plugin's own row for a claim shape
                    # they cannot answer; in-batch consumption -> the full
                    # re-check.
                    row = self._dra_filter_row(
                        self._dra_state(plugin, snapshot, ct), plugin, pi,
                        dra_memo, i)
                    if row is None:
                        row = self._dynamic_filter_row(
                            plugin, pi, snapshot, ct,
                            dyn_states.setdefault(i, CycleState()))
                        if row is not None:
                            fallback_pods.add(i)
                    if row is not None:
                        apply_row(plugin.NAME, i, row)
                    stateful_pods.add(i)
                else:
                    # NodePorts and the volume plugins: the plugin's own
                    # row. NodePorts' conflicts are per pod, so the
                    # verify's port check covers the placements earlier in
                    # the same assign(); a volume plugin's (one RWOP claim,
                    # a node's last volume slot) cross pods, so its pod
                    # takes the full re-check. None: the plugin skipped.
                    row = self._dynamic_filter_row(
                        plugin, pi, snapshot, ct,
                        dyn_states.setdefault(i, CycleState()))
                    if row is not None:
                        apply_row(plugin.NAME, i, row)
                        fallback_pods.add(i)
                        if plugin.NAME != "NodePorts":
                            stateful_pods.add(i)

        if fallback_pods and self.metrics is not None:
            self.metrics.backend_degradations.inc(
                len(fallback_pods), kind="host_fallback")

        for row_full, idxs in ipa_groups.values():
            row = row_full[: ct.n_real]
            if row.all():
                continue
            # One interned row per signature group; every member pod
            # references it.
            cid, nnz, col = _intern_row(row)
            fmap = host_filter_fail.setdefault("InterPodAffinity", {})
            for i in idxs:
                prev = fmap.get(i)
                fmap[i] = row if prev is None else (prev & row)
                _apply_interned(i, cid, nnz, col)

        spread_active_idx = self._process_spread_pods(
            spread_pods, ctx, apply_row)
        # Per-pod constraint matrices over the union spread table: applies
        # gates the pod's own template's columns; contributes marks the
        # constraints that count the pod when placed — built for EVERY pod
        # (a pod without constraints can match a template's selector).
        sp_applies = sp_contrib = None
        spt = ctx.spread
        if spt is not None and spt["cons"]:
            C = len(spt["cons"])
            sp_applies = np.zeros((P, C), dtype=np.bool_)
            sp_contrib = np.zeros((P, C), dtype=np.int32)
            active_set = set(spread_active_idx)
            for i, pi, cs in spread_pods:
                if i in active_set:
                    for c in spt["tpl_cols"][self._spread_tpl_key(cs, pi)]:
                        sp_applies[i, c] = True
            memo = spt.setdefault("contrib_memo", {})
            con_ns, con_sels = spt["con_ns"], spt["con_sels"]
            for i, pi in enumerate(pods):
                sig = (pi.namespace,
                       tuple(sorted(pi.labels.items())) if pi.labels
                       else ())
                row = memo.get(sig)
                if row is None:
                    row = memo[sig] = np.fromiter(
                        (1 if (ns_contains(con_ns[c], pi.namespace)
                               and con_sels[c].matches(pi.labels))
                         else 0 for c in range(C)),
                        dtype=np.int32, count=C)
                if row.any():
                    sp_contrib[i] = row

        # Host score rows: computed over each pod's *feasible* node set only
        # (static rows ∧ taints ∧ exact fit), then the plugin's own
        # NormalizeScore, then the profile weight — interned as parts.
        score_store: dict[int, np.ndarray] = {}    # sid -> weighted row
        _score_bytes: dict[bytes, int] = {}
        pod_parts: dict[int, list[int]] = {}       # pod -> ordered sids
        fit_np: np.ndarray | None = None
        taint_np: np.ndarray | None = None
        #: pod FEASIBILITY-CLASS key: (fit class, taint class, the pod's
        #: host filter-row ids, exception column, infeasible) — pods of one
        #: template share it, so the per-pod O(N) work below runs once per
        #: class.
        feas_memo: dict[tuple, np.ndarray] = {}
        #: the constraint families' normalized score rows, memoized per
        #: (feasibility class, pod signature): (feasible idx, weighted
        #: normalized values or None, member pods).
        norm_memo: dict[tuple, tuple] = {}
        #: id(NRT score row) -> its interned weighted part (-1: all 0).
        nrt_parts: dict[int, int] = {}
        _pck_memo: dict[int, tuple] = {}

        def pod_class_key(i: int) -> tuple:
            got = _pck_memo.get(i)
            if got is None:
                got = _pck_memo[i] = (
                    batch.req_class[i], batch.untol_class[i],
                    tuple(pod_rows.get(i, ())), pod_pin.get(i, -1),
                    i in infeasible)
            return got

        def _intern_score(row: np.ndarray) -> int:
            b = row.tobytes()
            sid = _score_bytes.get(b)
            if sid is None:
                sid = _score_bytes[b] = len(_score_bytes)
                score_store[sid] = row
            return sid

        def feasible_idx(i: int) -> np.ndarray:
            nonlocal fit_np, taint_np
            pk = pod_class_key(i)
            got = feas_memo.get(pk)
            if got is not None:
                return got
            if i in infeasible:
                got = feas_memo[pk] = np.zeros((0,), dtype=np.intp)
                return got
            if fit_np is None:
                uq = np.stack(batch.req_rows)  # (n_classes, R)
                fit_np = np.all(
                    ct.used_q[None, :, :] + uq[:, None, :]
                    <= ct.alloc_q[None, :, :], axis=-1)
                fit_np &= (ct.used_pods + 1 <= ct.alloc_pods)[None, :]
                if "TaintToleration" in filter_names:
                    ut = np.stack(batch.untol_rows)
                    taint_np = (ut.astype(np.int32)
                                @ ct.taint_filter_mat.T.astype(np.int32)) == 0
                else:
                    taint_np = np.ones(
                        (len(batch.untol_rows),
                         ct.taint_filter_mat.shape[0]), dtype=np.bool_)
            feas = fit_np[batch.req_class[i], : ct.n_real] \
                & taint_np[batch.untol_class[i], : ct.n_real]
            rows_i = pod_rows.get(i)
            if rows_i:
                feas = feas.copy()
                for cid in rows_i:
                    feas &= row_store[cid]
            pin = pod_pin.get(i)
            if pin is not None:
                keep = bool(feas[pin])
                feas = np.zeros_like(feas)
                feas[pin] = keep
            got = feas_memo[pk] = np.nonzero(feas)[0]
            return got

        for name, plugin in score_plugins.items():
            if name in DEVICE_SCORE_PLUGINS:
                continue
            w = fwk.score_weights.get(name, 1)
            for i, pi in enumerate(pods):
                if i in unknown_res:
                    continue
                if name in STATIC_SCORE_PLUGINS:
                    if name == "NodeAffinity" and not (
                            (pi.affinity.get("nodeAffinity") or {})
                            .get("preferredDuringSchedulingIgnoredDuringExecution")):
                        continue
                    row, any_nonzero = self._static_score_row(
                        plugin, pi, snapshot, ct)
                    if not any_nonzero:
                        continue
                    raw = {ct.node_names[j]: float(row[j])
                           for j in feasible_idx(i)}
                    plugin.normalize_scores(CycleState(), pi, raw)
                    if raw:
                        srow = np.zeros((ct.n_real,), dtype=np.float32)
                        for nname, sc in raw.items():
                            srow[ct.name_to_idx[nname]] += w * sc
                        pod_parts.setdefault(i, []).append(
                            _intern_score(srow))
                    continue
                # The stateful plugins (_check_supported admits no
                # other), each behind its activity gate.
                if not _SCORE_ACTIVE[name](plugin, pi, snapshot):
                    continue
                if name == "NodeResourceTopologyMatch":
                    # The zone score, host float64 cast into the plane;
                    # not normalized (the plugin has no NormalizeScore).
                    # Score rows are shared per request vector, so each
                    # is weighted and interned once (id-keyed).
                    srow = self._nrt_score_row(
                        self._nrt_state(plugin, snapshot, ct), pi,
                        nrt_memo, i)
                    sid = nrt_parts.get(id(srow))
                    if sid is None:
                        sid = nrt_parts[id(srow)] = _intern_score(
                            (w * srow).astype(np.float32)) \
                            if srow.any() else -1
                    if sid >= 0:
                        pod_parts.setdefault(i, []).append(sid)
                    continue
                # The constraint families: raw rows from the affinity
                # compiler, normalized over the pod's feasible set as the
                # plugin's NormalizeScore does, memoized per (feasibility
                # class, pod signature).
                if name == "PodTopologySpread":
                    constraints = plugin._constraints_for(
                        pi, "ScheduleAnyway")
                    nk = ("pts", pod_class_key(i), pi.namespace,
                          tuple(sorted(pi.labels.items())),
                          repr(constraints), repr(pi.node_selector),
                          repr(pi.affinity.get("nodeAffinity")),
                          repr(pi.tolerations))
                    got = norm_memo.get(nk)
                    if got is None:
                        if compiler is None:
                            compiler = self._affinity_compiler(snapshot, ct)
                        raw_row = compiler.spread_raw_scores(
                            pi, constraints)[: ct.n_real]
                        feas = feasible_idx(i)
                        wnorm = None
                        if feas.size:
                            vals = raw_row[feas]
                            mx, mn = vals.max(), vals.min()
                            if mx > mn:
                                wnorm = w * 100.0 * (mx - vals) / (mx - mn)
                            else:
                                wnorm = np.full_like(vals, w * 100.0)
                        got = norm_memo[nk] = (feas, wnorm, [])
                    got[2].append(i)
                    continue
                # InterPodAffinity: every score is 0 unless the pod has
                # preferred terms or a resident pod weighs back.
                if not self._ipa_score_relevant(pi, snapshot):
                    continue
                nk = ("ipa", pod_class_key(i), pi.namespace,
                      tuple(sorted(pi.labels.items())),
                      repr(pi.preferred_affinity_terms),
                      repr(pi.preferred_anti_affinity_terms))
                got = norm_memo.get(nk)
                if got is None:
                    if compiler is None:
                        compiler = self._affinity_compiler(snapshot, ct)
                    feas = feasible_idx(i)
                    feas_mask = np.zeros((ct.n_pad,), dtype=np.bool_)
                    feas_mask[feas] = True
                    raw_row = compiler.score_row(
                        pi, float(plugin.hard_pod_affinity_weight),
                        feas_mask)[: ct.n_real]
                    wnorm = None
                    if feas.size:
                        vals = raw_row[feas]
                        mx, mn = vals.max(), vals.min()
                        if mx > mn:
                            wnorm = w * 100.0 * (vals - mn) / (mx - mn)
                    got = norm_memo[nk] = (feas, wnorm, [])
                got[2].append(i)

        # Flush the memoized normalized rows: each group's sparse (feas,
        # wnorm) densifies once into an interned part shared by its pods.
        for feas, wnorm, idxs in norm_memo.values():
            if wnorm is None or not idxs:
                continue
            srow = np.zeros((ct.n_real,), dtype=np.float32)
            srow[feas] = wnorm
            sid = _intern_score(srow)
            for i in idxs:
                pod_parts.setdefault(i, []).append(sid)

        # ---- class-dictionary plane build ----------------------------------
        # Pods dedupe into equivalence classes keyed by (request row,
        # toleration row, filter-row ids, ordered score-part ids) —
        # exception pins ride the sparse exc vector. Class 0 is the reserved
        # EMPTY class (padding pods, unknown resources, conflicting pins).
        # Overflowing the cap — or KTPU_CLASS_PLANES=0 — falls back to
        # per-pod planes (C == P, identity index), identical assignments.
        cap = ctx.class_pad
        mask_dirty = bool(pod_rows or pod_pin or infeasible)
        scores_dirty = bool(pod_parts)
        R = len(ct.resources)
        class_reps: list[int] | None = None
        class_parts: list[tuple] = []
        cls_np = exc_np = None
        if cap:
            cls_map: dict[tuple, int] = {}
            class_reps = []
            cls_np = np.zeros((P,), dtype=np.int32)
            exc_np = np.full((P,), -1, dtype=np.int32)
            for i in range(batch.p_real):
                if i in infeasible:
                    continue                                   # class 0
                pin = pod_pin.get(i)
                # A pinned pod's argmax ranges over at most one column, so
                # its score row cannot change its assignment.
                eff_parts = () if pin is not None \
                    else tuple(pod_parts.get(i, ()))
                ckey = (batch.req_class[i], batch.untol_class[i],
                        tuple(pod_rows.get(i, ())), eff_parts)
                c = cls_map.get(ckey)
                if c is None:
                    if len(class_reps) >= cap:
                        class_reps = None
                        break
                    c = cls_map[ckey] = len(class_reps) + 1
                    class_reps.append(i)
                    class_parts.append(eff_parts)
                cls_np[i] = c
                if pin is not None:
                    exc_np[i] = pin

        # The spread scan runs for any chunk whose pods the table gates,
        # or whose pods it counts while a later chunk holds gated pods.
        use_spread = bool(
            sp_contrib is not None
            and (spread_active_idx
                 or (sp_contrib.any()
                     and chunk_idx < ctx.spread_last_gated)))
        gang_onehot, gang_required = self._gang_arrays(pods, fwk, P)
        # The solve-mode policy row: an optimal chunk rounds its plan with
        # the W=1 scan (wave_w 0, as in the reference); a spread chunk is
        # not eligible; a gang chunk wants optimal at any node count.
        mode, fallback = self._tuner.solve_mode(
            batch.p_real, has_gang=gang_onehot is not None,
            spread=use_spread, class_mode=class_reps is not None)
        self.counters["optimal_fallbacks"] += int(fallback)
        self._tuner.observe_chunk()

        if class_reps is not None:
            crows = _class_rows_bucket(len(class_reps))
            n_cls = len(class_reps)
            pack_np = np.zeros(
                (crows, 2 * R + batch.untol_filter.shape[1]
                 + batch.untol_prefer.shape[1]), dtype=np.int32)
            if n_cls:
                ridx = np.asarray(class_reps, dtype=np.intp)
                pack_np[1: n_cls + 1] = np.concatenate(
                    [batch.req_q[ridx], batch.req_nz_q[ridx],
                     batch.untol_filter[ridx].astype(np.int32),
                     batch.untol_prefer[ridx].astype(np.int32)], axis=1)
            if mask_dirty:
                mask_np = np.zeros((crows, N), dtype=np.bool_)
                rowset_memo: dict[tuple, np.ndarray] = {}
                for c, rep in enumerate(class_reps, start=1):
                    rs = tuple(pod_rows.get(rep, ()))
                    row = rowset_memo.get(rs)
                    if row is None:
                        row = np.ones((ct.n_real,), dtype=np.bool_)
                        for cid in rs:
                            row = row & row_store[cid]
                        rowset_memo[rs] = row
                    mask_np[c, : ct.n_real] = row
                dev_mask = self._put(np.packbits(mask_np, axis=1))
            else:
                mkey = ("cls", crows, n_cls, N, ct.n_real)
                dev_mask = self._dev_base_mask.get(mkey)
                if dev_mask is None:
                    mask_np = np.zeros((crows, N), dtype=np.bool_)
                    mask_np[1: n_cls + 1, : ct.n_real] = True
                    dev_mask = self._dev_base_mask[mkey] = self._put(
                        np.packbits(mask_np, axis=1))
            if scores_dirty:
                scores_np = np.zeros((crows, N), dtype=np.float32)
                for c, parts in enumerate(class_parts, start=1):
                    for sid in parts:
                        scores_np[c, : ct.n_real] += score_store[sid]
                dev_scores = self._put(compress_score_wire(scores_np))
            else:
                dev_scores = self._zero_scores(crows, N)
        else:
            # Per-pod fallback (kill switch / class overflow): C == P,
            # identity index.
            cls_np = np.arange(P, dtype=np.int32)
            exc_np = np.full((P,), -1, dtype=np.int32)
            pack_np = np.concatenate(
                [batch.req_q, batch.req_nz_q,
                 batch.untol_filter.astype(np.int32),
                 batch.untol_prefer.astype(np.int32)], axis=1)
            mask_np = np.zeros((P, N), dtype=np.bool_)
            mask_np[: batch.p_real, : ct.n_real] = True
            for i, lst in pod_rows.items():
                for cid in lst:
                    mask_np[i, : ct.n_real] &= row_store[cid]
            for i, pin in pod_pin.items():
                keep = mask_np[i, pin]
                mask_np[i, :] = False
                mask_np[i, pin] = keep
            for i in infeasible:
                mask_np[i, :] = False
            dev_mask = self._put(np.packbits(mask_np, axis=1))
            if scores_dirty:
                scores_np = np.zeros((P, N), dtype=np.float32)
                for i, parts in pod_parts.items():
                    for sid in parts:
                        scores_np[i, : ct.n_real] += score_store[sid]
                dev_scores = self._put(compress_score_wire(scores_np))
            else:
                dev_scores = self._zero_scores(P, N)

        # The reference's order of decisions: K only for class-mode chunks,
        # W unless the KTPU_WAVEFRONT kill switch is off, the block width
        # only with K; a spread chunk with a shortlist keeps the W=1 scan,
        # an optimal chunk drops K and W, and no K means no block width.
        shortlist_k = self._tuner.shortlist_k(P, ct.n_real) \
            if class_reps is not None else 0
        wave_w = self._tuner.wave_width(P) if flags.get("KTPU_WAVEFRONT") \
            else 0
        block_w = self._tuner.block_width(ct.n_pad, ct.n_real, shortlist_k) \
            if shortlist_k else 0
        if use_spread and shortlist_k:
            wave_w = 0
        if mode == "optimal":
            shortlist_k = wave_w = 0
        if not shortlist_k:
            block_w = 0
        return {
            "pods": pods, "batch": batch, "chunk_idx": chunk_idx,
            "spread_used": use_spread,
            "sp_applies": sp_applies, "sp_contrib": sp_contrib,
            "dev_mask": dev_mask, "dev_scores": dev_scores,
            "dev_cls": self._put(cls_np),
            "dev_exc": self._put(exc_np),
            "dev_pack": self._put(pack_np),
            "cls_np": cls_np,
            "host_filter_fail": host_filter_fail,
            "unknown_res": unknown_res, "stateful_pods": stateful_pods,
            "dev_perms": self._perms(pods, batch, P),
            "wave_w": wave_w,
            "shortlist_k": shortlist_k,
            "block_w": block_w,
            "scan_width": shortlist_k + P if shortlist_k else ct.n_real,
            "solve_mode": mode,
            "optimal_fallback": fallback,
            "gang_onehot": gang_onehot, "gang_required": gang_required,
        }

    def _gang_arrays(self, pods: list[PodInfo], fwk: Framework,
                     P: int) -> tuple:
        """Gang membership (Coscheduling): all-or-nothing inside the solve,
        as the reference's `_prep_chunk` builds it. (gang_onehot (P, 16)
        f32, gang_required (16,) f32), or (None, None) when the profile has
        no Coscheduling, its PodGroup informer is not wired, or no pod of
        the chunk is in a gang. The quota is what the gang still NEEDS:
        minMember minus the members already assembled (bound or parked at
        Permit), at most its members in the chunk — a fully assembled
        gang's stragglers place individually, like the Permit path."""
        cosched = next(
            (pl for pl in fwk.plugins if pl.NAME == "Coscheduling"), None)
        if cosched is None or getattr(cosched, "pg_informer", None) is None:
            return None, None
        groups: dict[str, list[int]] = {}
        for i, pi in enumerate(pods):
            gk = cosched.group_key(pi)
            if gk:
                groups.setdefault(gk, []).append(i)
        if not groups:
            return None, None
        gang_onehot = np.zeros((P, _GANG_PAD), dtype=np.float32)
        gang_required = np.zeros((_GANG_PAD,), dtype=np.float32)
        if len(groups) > _GANG_PAD:
            # Overflow gangs lose in-solver all-or-nothing and keep the
            # Permit barrier alone — weaker atomicity under contention;
            # observable, not silent.
            logger.warning(
                "%d gangs in chunk exceed solver capacity %d; %d gangs "
                "degrade to Permit-barrier-only atomicity", len(groups),
                _GANG_PAD, len(groups) - _GANG_PAD)
            if self.metrics is not None:
                self.metrics.backend_degradations.inc(
                    len(groups) - _GANG_PAD, kind="gang_overflow")
        for g, (gk, idxs) in enumerate(groups.items()):
            if g >= _GANG_PAD:
                break  # overflow gangs: Permit barrier only
            pg = cosched._pod_group(gk)
            mm = int(((pg or {}).get("spec") or {}).get("minMember", 1))
            assembled = len(cosched._bound.get(gk) or ()) + \
                len(cosched._waiting.get(gk) or ())
            for i in idxs:
                gang_onehot[i, g] = 1.0
            gang_required[g] = min(max(mm - assembled, 0), len(idxs))
        return gang_onehot, gang_required

    def _zero_scores(self, rows: int, n: int) -> torch.Tensor:
        z = self._dev_zero_scores.get((rows, n))
        if z is None:
            z = self._dev_zero_scores[(rows, n)] = torch.zeros(
                (rows, n), dtype=torch.float16, device=self.device)
        return z

    def _perms(self, pods: list[PodInfo], batch: PodBatch,
               P: int) -> torch.Tensor:
        """Multistart orders: identity first (ties → the queue order), then
        size-desc / size-asc / seeded shuffles, each PRIORITY-BLOCK-STABLE
        (pods move only within runs of equal priority). Padding stays in
        place. Built with numpy from a fixed seed, as the reference does."""
        K = self.multistart
        pr = batch.p_real
        if K > 1 and pr > 1:
            sizes = batch.req_q[:pr].sum(axis=1)
            prios = np.fromiter((p.priority for p in pods), dtype=np.int64,
                                count=pr)
            perms_key = (K, P, pr, sizes.tobytes(), prios.tobytes())
        else:
            perms_key = (K, P)
        dev_perms = self._dev_perms_cache.get(perms_key)
        if dev_perms is not None:
            return dev_perms
        perms = np.tile(np.arange(P, dtype=np.int32), (K, 1))
        if K > 1 and pr > 1:
            blocks = []
            lo = 0
            for hi in range(1, pr + 1):
                if hi == pr or prios[hi] != prios[lo]:
                    blocks.append((lo, hi))
                    lo = hi
            rng = np.random.default_rng(0xC0FFEE + pr)

            def fill(k, order_of):
                for lo, hi in blocks:
                    perms[k, lo:hi] = lo + order_of(lo, hi)
            fill(1, lambda lo, hi: np.argsort(
                -sizes[lo:hi], kind="stable").astype(np.int32))
            if K > 2:
                fill(2, lambda lo, hi: np.argsort(
                    sizes[lo:hi], kind="stable").astype(np.int32))
            for k in range(3, K):
                fill(k, lambda lo, hi: rng.permutation(
                    hi - lo).astype(np.int32))
        dev_perms = self._put(perms)
        if len(self._dev_perms_cache) > 64:
            self._dev_perms_cache.clear()
        self._dev_perms_cache[perms_key] = dev_perms
        return dev_perms

    def _gang_args(self, prep: dict) -> tuple:
        """(gang_onehot, gang_required) device arrays: the chunk's own
        when it has gangs, else one cached zero pair per batch width."""
        if prep["gang_onehot"] is not None:
            return (self._put(prep["gang_onehot"]),
                    self._put(prep["gang_required"]))
        P = prep["batch"].req_q.shape[0]
        z = self._dev_zero_gang.get(P)
        if z is None:
            z = self._dev_zero_gang[P] = (
                torch.zeros((P, _GANG_PAD), dtype=torch.float32,
                            device=self.device),
                torch.zeros((_GANG_PAD,), dtype=torch.float32,
                            device=self.device))
        return z

    def ensure_static(self, ct: ClusterTensors) -> dict:
        """Device-resident node-static arrays (alloc, taints), refreshed
        only when the static fingerprint moves."""
        if self._dev_static_fp != ct._static_fp or \
                self._dev_static.get("alloc_shape") != ct.alloc_q.shape:
            self._dev_static = {
                "alloc_q": self._put(ct.alloc_q),
                "alloc_pods": self._put(ct.alloc_pods),
                "taint_f": self._put(ct.taint_filter_mat),
                "taint_p": self._put(ct.taint_prefer_mat),
                "alloc_shape": ct.alloc_q.shape,
            }
            self._dev_static_fp = ct._static_fp
        return self._dev_static

    def _dispatch_chunk(self, prep: dict, ctx: "_AssignCtx") -> dict:
        """Run the chunk's device pass; the used state chains on device.
        The Sinkhorn knobs are read here, per chunk, as live flags."""
        p, st = ctx.params, self.ensure_static(ctx.ct)
        prep["sink_iters"] = max(1, flags.get("KTPU_SINKHORN_ITERS"))
        sp = ctx.spread
        spread = None
        if prep["spread_used"]:
            spread = (sp["table"], sp["dev_counts"],
                      self._put(prep["sp_applies"]),
                      self._put(prep["sp_contrib"]))
        assign_d, used_pack2, fit0_d, taint_ok_d, dom_counts2 = \
            mask_solve_update(
            st["alloc_q"], self.used.pack, st["alloc_pods"],
            prep["dev_pack"], prep["dev_cls"], prep["dev_exc"],
            st["taint_f"], st["taint_p"], prep["dev_mask"],
            prep["dev_scores"], p["fit_col_w"], p["bal_col_mask"],
            p["shape_u"], p["shape_s"], p["w_fit"], p["w_bal"],
            p["w_taint"], p["taint_filter_on"], prep["dev_perms"],
            *self._gang_args(prep),
            p["strategy"], prep["wave_w"], prep["solve_mode"],
            prep["sink_iters"],
            float(np.float32(flags.get("KTPU_SINKHORN_TEMP"))),
            spread=spread, shortlist_k=prep["shortlist_k"],
            block_w=prep["block_w"], n_real=ctx.ct.n_real,
            p_real=prep["batch"].p_real)
        self.used.advance(used_pack2)
        if spread is not None:
            sp["dev_counts"] = dom_counts2
        prep["assign_d"] = assign_d
        prep["fit0_d"] = fit0_d
        prep["taint_ok_d"] = taint_ok_d
        if assign_d.is_cuda:
            # The assignments' copy to pinned host memory is queued on
            # this (the dispatching) stream now, with an event behind it:
            # the fetch then waits for that event alone, on any thread.
            host = torch.empty(assign_d.shape, dtype=assign_d.dtype,
                               pin_memory=True)
            host.copy_(assign_d, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record()
            prep["assign_host"], prep["assign_ev"] = host, ev
        return prep

    def _finalize_chunk(self, run: dict, assign_np: np.ndarray,
                        ctx: "_AssignCtx") -> None:
        pods, batch = run["pods"], run["batch"]
        assign = assign_np[: batch.p_real]
        # The device pass appends [shortlist fallbacks, wave commits, wave
        # replays, blocks scanned, blocks pruned]; a poisoned chunk reports
        # the padded width, clamped to the real pods here. The block
        # counters count (class, block) pairs, not pods: no clamp.
        nfall = min(int(assign_np[-5]), batch.p_real)
        wave_com = min(int(assign_np[-4]), batch.p_real)
        wave_rep = min(int(assign_np[-3]), batch.p_real)
        blk_scanned = int(assign_np[-2])
        blk_pruned = int(assign_np[-1])
        if run["shortlist_k"]:
            self._tuner.observe_solve(batch.p_real, nfall)
        if run["wave_w"] > 1:
            self._tuner.observe_wave(wave_com, wave_rep)
        c = self.counters
        c["chunks"] += 1
        c["wave_commits"] += wave_com
        c["wave_replays"] += wave_rep
        if run["shortlist_k"]:
            c["shortlist_pods"] += batch.p_real
            c["shortlist_fallbacks"] += nfall
        if run["block_w"]:
            c["blocks_scanned"] += blk_scanned
            c["blocks_pruned"] += blk_pruned
        if run["solve_mode"] == "optimal":
            self.counters["optimal_solves"] += 1
            self.counters["sinkhorn_iterations"] = run["sink_iters"]
        self.counters["spread_chunks"] += int(run["spread_used"])
        m = self.metrics
        if m is not None:
            m.solver_scan_width.set(run["scan_width"])
            m.solver_wave_width.set(max(1, run["wave_w"]))
            if wave_com:
                m.solver_wave_commits.inc(wave_com)
            if wave_rep:
                m.solver_wave_replays.inc(wave_rep)
            if run["shortlist_k"]:
                m.solver_shortlist_pods.inc(batch.p_real)
                if nfall:
                    m.solver_shortlist_fallbacks.inc(nfall)
            # Block accounting: chunks routed with block_w > 0 only; a
            # chunk whose predicate took the full-width pass prunes 0.
            if run["block_w"]:
                if blk_scanned:
                    m.solver_blocks_scanned.inc(blk_scanned)
                if blk_pruned:
                    m.solver_blocks_pruned.inc(blk_pruned)
            if run["solve_mode"] == "optimal":
                m.solver_optimal_solves.inc()
                m.solver_sinkhorn_iterations.set(run["sink_iters"])
            elif run["optimal_fallback"]:
                m.solver_optimal_fallbacks.inc()
            if ctx.ct.prep_shards > 1:
                # Sharded-path solve accounting: one solve spans every
                # shard, so the wall is labelled with the shard COUNT;
                # the cross-shard argmax merges once per pod step.
                m.shard_solve_seconds.inc(run.get("solve_wall_s", 0.0),
                                          shards=str(ctx.ct.prep_shards))
                m.cross_shard_reductions.inc(batch.p_real)

        rejects = self._verify(pods, assign, ctx, run["stateful_pods"])
        self.counters["verify_rejects"] += len(rejects)
        # Fold verify rejections back into the device-chained used state so
        # later dispatches don't see the rejected pods' resources as
        # consumed (chunks already in flight did: conservative only, a
        # pod there may just requeue). Adds commute, so subtracting from
        # the current chained state is exact for every later chunk.
        if rejects:
            r = batch.req_q.shape[1]
            idx = np.array([j for _, j in rejects], dtype=np.int64)
            rows = np.zeros((len(rejects), 2 * r + 1), dtype=np.int32)
            for k, (i, _) in enumerate(rejects):
                rows[k, :r] = batch.req_q[i]
                rows[k, r:2 * r] = batch.req_nz_q[i]
                rows[k, 2 * r] = 1
            self.used.fold_back(idx, rows)
            # Rejected pods that counted in the chained spread domain
            # counts fold out of them too, per constraint they match.
            contrib = run["sp_contrib"]
            if run["spread_used"]:
                node_dom = ctx.spread["node_dom_host"]
                didx, dval = [], []
                for i, j in rejects:
                    doms = node_dom[j]
                    keep = (doms >= 0) & (contrib[i] > 0)
                    didx.extend(doms[keep].tolist())
                    dval.extend((-contrib[i][keep]).tolist())
                if didx:
                    counts = ctx.spread["dev_counts"]
                    counts.index_add_(
                        0, self._put(np.asarray(didx, np.int64)),
                        self._put(np.asarray(dval, np.int32)))

        need_diag = [i for i, pi in enumerate(pods)
                     if ctx.assignments.get(pi.key) is None
                     and pi.key not in ctx.diagnostics]
        if need_diag:
            fit0 = run.get("fit0_np")
            if fit0 is None:
                fit0 = run["fit0_d"].cpu().numpy()
            taint_ok = run.get("taint_ok_np")
            if taint_ok is None:
                taint_ok = run["taint_ok_d"].cpu().numpy()
            self._build_diagnostics(
                need_diag, pods, ctx.ct, batch, fit0, taint_ok,
                run["cls_np"], run["host_filter_fail"],
                ctx.params["filter_names"], ctx.diagnostics,
                run["unknown_res"])

    # -- verification --------------------------------------------------------

    def _verify(self, pods, assign, ctx: "_AssignCtx",
                stateful_pods: set) -> list[tuple[int, int]]:
        """Exact host re-check of every solver placement against a working
        copy of its node that accumulates this assign()'s earlier
        placements: resources by integer arithmetic and host ports against
        the working node's ports; then, in a chunk with stateful pods
        (NodeResourceTopologyMatch, DynamicResources), every placement
        through the framework's PreFilter and Filter against the working
        snapshot `ctx.wsnap` (built once per assign(), patched as new
        working clones appear); otherwise inter-pod affinity (both ways)
        against the pods placed earlier in the same assign() only — the
        batch-start rows cover the snapshot exactly. Spread placements
        need no re-check: the scan counted them. Returns [(chunk index,
        node index)] for rejected placements (the caller folds them out of
        the device state)."""
        snapshot, fwk, ct = ctx.snapshot, ctx.fwk, ctx.ct
        working = ctx.working
        delta = ctx.delta
        delta_has_terms = ctx.delta_has_terms

        def node_for(idx: int):
            name = ct.node_names[idx]
            ni = working.get(name)
            if ni is None:
                ni = working[name] = snapshot.get(name).clone()
                # Patch the shared working snapshot in place (clones
                # mutate in place afterwards, so its entries stay
                # current).
                w = ctx.wsnap
                if w is not None:
                    old = w._by_name.get(name)
                    w.nodes[idx] = ni
                    w._by_name[name] = ni
                    for lst in (w.have_pods_with_affinity,
                                w.have_pods_with_required_anti_affinity):
                        for k, entry in enumerate(lst):
                            if entry is old:
                                lst[k] = ni
                                break
            return ni

        full_check_batch = bool(stateful_pods)
        contention = Status.unschedulable(
            "node(s) exhausted by earlier pods in the batch"
        ).with_plugin("NodeResourcesFit")
        affinity_conflict = Status.unschedulable(
            "node(s) conflicted with pod affinity/anti-affinity of pods "
            "placed earlier in the batch").with_plugin("InterPodAffinity")
        port_conflict = Status.unschedulable(
            "node(s) didn't have free ports for the requested pod ports"
        ).with_plugin("NodePorts")
        rejects: list[tuple[int, int]] = []
        for i, pi in enumerate(pods):
            idx = int(assign[i])
            if idx < 0:
                ctx.assignments[pi.key] = None
                continue
            ni = node_for(idx)
            if insufficient_resources(pi, ni):
                ctx.assignments[pi.key] = None
                ctx.diagnostics[pi.key] = {ni.name: contention}
                rejects.append((i, idx))
                continue
            if pi.host_ports and any(
                    (ip == "0.0.0.0" or uip == "0.0.0.0" or ip == uip)
                    and proto == uproto and port == uport
                    for (ip, proto, port) in pi.host_ports
                    for (uip, uproto, uport) in ni.used_ports):
                ctx.assignments[pi.key] = None
                ctx.diagnostics[pi.key] = {ni.name: port_conflict}
                rejects.append((i, idx))
                continue
            if full_check_batch:
                wsnap = ctx.wsnap
                if wsnap is None:
                    wsnap = ctx.wsnap = Snapshot(
                        [working.get(n.name, n) for n in snapshot.nodes],
                        snapshot.generation)
                state = CycleState()
                st = fwk.run_pre_filter(state, pi, wsnap)
                if st.is_success():
                    st = fwk.run_filters(state, pi, ni)
                if not st.is_success():
                    ctx.assignments[pi.key] = None
                    ctx.diagnostics[pi.key] = {ni.name: st}
                    rejects.append((i, idx))
                    continue
            elif (delta_has_terms or pi.has_affinity_constraints) \
                    and not _delta_affinity_ok(pi, ni, delta, ct,
                                               self._affinity,
                                               ctx.delta_idx):
                ctx.assignments[pi.key] = None
                ctx.diagnostics[pi.key] = {ni.name: affinity_conflict}
                rejects.append((i, idx))
                continue
            ctx.assignments[pi.key] = ni.name
            ni.add_pod(pi)
            # Keep the working snapshot's affinity indexes current
            # (Snapshot() derives them; add_pod bypasses that).
            if ctx.wsnap is not None:
                if pi.has_affinity_constraints and \
                        ni not in ctx.wsnap.have_pods_with_affinity:
                    ctx.wsnap.have_pods_with_affinity.append(ni)
                if pi.has_required_anti_affinity and ni not in \
                        ctx.wsnap.have_pods_with_required_anti_affinity:
                    ctx.wsnap.have_pods_with_required_anti_affinity.append(ni)
            delta.append((pi, ni.labels))
            ctx.delta_idx.add(pi, ni.labels)
            if pi.required_affinity_terms or pi.required_anti_affinity_terms:
                delta_has_terms = True
        ctx.delta_has_terms = delta_has_terms
        return rejects

    # -- explainability ------------------------------------------------------

    def _build_diagnostics(self, idxs, pods, ct, batch, fit0, taint_ok,
                           cls_np, host_filter_fail, filter_names,
                           diagnostics, unknown_res):
        """Per-node, per-plugin failure reasons from the class-level unsat
        planes (each pod reads its class row through cls_np) and the host
        rows the prep recorded — FitError's "0/N nodes are available"."""
        taint_st = Status.unschedulable(
            "node(s) had untolerated taint", resolvable=False
        ).with_plugin("TaintToleration")
        contention = Status.unschedulable(
            "node(s) exhausted by earlier pods in the batch"
        ).with_plugin("NodeResourcesFit")
        host_statuses = {
            name: Status.unschedulable(
                _HOST_REASONS.get(name, "node(s) filtered"),
                resolvable=name not in _UNRESOLVABLE).with_plugin(name)
            for name in host_filter_fail
        }
        n_real = ct.n_real
        names = list(ct.node_names[:n_real])
        names_hash = hash(tuple(names))
        R = ct.alloc_q.shape[1]
        weights = 1 << np.arange(R, dtype=np.int64)
        too_many = (ct.used_pods + 1 > ct.alloc_pods)[:n_real]
        res_status_cache: dict[int, Status] = {}
        taint_on = "TaintToleration" in filter_names
        for i in idxs:
            pi = pods[i]
            if i in unknown_res:
                st = Status.unschedulable(
                    "Insufficient " + ", ".join(
                        r for r in pi.requests if r not in ct.r_index),
                    resolvable=True).with_plugin("NodeResourcesFit")
                dm = DiagMap((n, st) for n in ct.node_names)
                dm.reason_counts = {r: len(ct.node_names)
                                    for r in st.reasons}
                dm.plugins = {st.plugin}
                dm.resolvable = True
                dm.banned_mask = np.zeros((n_real,), dtype=bool)
                dm.banned_nodes_hash = names_hash
                diagnostics[pi.key] = dm
                continue
            statuses = np.empty((n_real,), dtype=object)
            assigned = np.zeros((n_real,), dtype=bool)
            banned = np.zeros((n_real,), dtype=bool)
            agg: list[tuple[Status, int]] = []
            ci = int(cls_np[i])
            if taint_on:
                m = ~taint_ok[ci, :n_real]
                statuses[m] = taint_st
                assigned |= m
                banned |= m
                c = int(m.sum())
                if c:
                    agg.append((taint_st, c))
            for pname, okmap in host_filter_fail.items():
                ok_row = okmap.get(i)
                if ok_row is None:
                    continue
                m = ~ok_row[:n_real] & ~assigned
                statuses[m] = host_statuses[pname]
                assigned |= m
                if host_statuses[pname].code == \
                        UNSCHEDULABLE_AND_UNRESOLVABLE:
                    banned |= m
                c = int(m.sum())
                if c:
                    agg.append((host_statuses[pname], c))
            short = (ct.used_q + batch.req_q[i][None, :]
                     > ct.alloc_q)[:n_real]
            bits = (short @ weights) + (too_many.astype(np.int64) << R)
            bits[assigned] = -1
            for b in np.unique(bits):
                if b < 0:
                    continue
                m = bits == b
                if b == 0:
                    # Feasible at batch start but taken by earlier pods.
                    statuses[m] = contention
                    agg.append((contention, int(m.sum())))
                    continue
                st = res_status_cache.get(int(b))
                if st is None:
                    msgs = [f"Insufficient {ct.resources[r]}"
                            for r in range(R) if b & (1 << r)]
                    if b >> R:
                        msgs = ["Too many pods"] + msgs
                    st = Status.unschedulable(*msgs).with_plugin(
                        "NodeResourcesFit")
                    res_status_cache[int(b)] = st
                statuses[m] = st
                agg.append((st, int(m.sum())))
            dm = DiagMap(zip(names, statuses))
            for st, c in agg:
                for r in st.reasons:
                    dm.reason_counts[r] = dm.reason_counts.get(r, 0) + c
                if st.plugin:
                    dm.plugins.add(st.plugin)
                if st.code != UNSCHEDULABLE_AND_UNRESOLVABLE:
                    dm.resolvable = True
            dm.banned_mask = banned
            dm.banned_nodes_hash = names_hash
            diagnostics[pi.key] = dm


class DiagMap(dict):
    """Per-pod {node: Status} map with FitError's reason counts and the
    plugin set precomputed from the vectorized masks."""

    __slots__ = ("reason_counts", "plugins", "resolvable", "banned_mask",
                 "banned_nodes_hash")

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.reason_counts: dict[str, int] = {}
        self.plugins: set[str] = set()
        #: any node failed with a preemption-resolvable status
        self.resolvable: bool = False
        #: (n_real,) bool — nodes rejected UnschedulableAndUnresolvable
        self.banned_mask = None
        #: hash of the node-name tuple the mask indexes
        self.banned_nodes_hash = 0


class _AssignCtx:
    """Per-assign()-call state: the chunk list, framework params,
    accumulated results, the cross-chunk verify context (working nodes,
    the working snapshot of the full re-check, the delta of accepted
    placements and its affinity index) and the union spread table."""

    __slots__ = ("snapshot", "fwk", "ct", "chunks", "params",
                 "assignments", "diagnostics", "working", "wsnap", "delta",
                 "delta_has_terms", "sel_cache", "delta_idx", "spread",
                 "spread_last_gated", "chunk_seq", "class_pad")


def _cached_matcher(term: dict, owner_ns: str, sel_cache: dict,
                    resolver=None):
    """Compiled (namespace set, Selector) per term object: the delta
    checks are O(batch²) pairs, so per-pair selector parsing would
    dominate. The set may be the ALL_NAMESPACES wildcard; membership goes
    through labels.ns_contains."""
    key = (id(term), owner_ns)
    got = sel_cache.get(key)
    if got is None:
        from kubernetes_tpu_torch.api.labels import from_label_selector
        nses = frozenset(resolve_term_namespaces(term, owner_ns, resolver))
        got = sel_cache[key] = (nses, from_label_selector(
            term.get("labelSelector")))
    return got


def _term_sig(term: dict, owner_ns: str, sel_cache: dict) -> tuple:
    """CONTENT-keyed term signature: pods stamped from one template carry
    equal-but-distinct term dicts, so id()-keyed indexes would grow one
    entry per pod."""
    key = ("sig", id(term), owner_ns)
    sig = sel_cache.get(key)
    if sig is None:
        sig = sel_cache[key] = (
            term.get("topologyKey", ""),
            tuple(sorted(term.get("namespaces") or [owner_ns])),
            repr(term.get("namespaceSelector")),
            repr(term.get("labelSelector")))
    return sig


class _DeltaAffinityIndex:
    """Incremental index over same-assign() placements, answering the
    three delta-affinity questions in O(terms) per query:

    - fwd[sig]: for a queried term, the count of delta pods matching its
      selector, by their node's topology value (and the total);
    - anti[sig]: for required anti-affinity terms CARRIED by delta pods,
      the same counts (symmetry: they forbid the querier).

    add() is O(registered signatures) per accepted pod — one per distinct
    template, not one per pod."""

    __slots__ = ("sel_cache", "fwd", "anti", "resolver")

    def __init__(self, sel_cache: dict, resolver=None):
        self.sel_cache = sel_cache
        self.resolver = resolver
        #: sig -> [nses, sel, tk, {node tk value -> count}, total]
        self.fwd: dict[tuple, list] = {}
        self.anti: dict[tuple, list] = {}

    def register(self, term: dict, owner_ns: str, delta: list) -> list:
        sig = _term_sig(term, owner_ns, self.sel_cache)
        e = self.fwd.get(sig)
        if e is None:
            nses, sel = _cached_matcher(term, owner_ns, self.sel_cache,
                                        self.resolver)
            tk = term.get("topologyKey", "")
            counts: dict = {}
            total = 0
            for d, labels_m in delta:  # back-fill placements so far
                if ns_contains(nses, d.namespace) and sel.matches(d.labels):
                    v = labels_m.get(tk)
                    counts[v] = counts.get(v, 0) + 1
                    total += 1
            e = self.fwd[sig] = [nses, sel, tk, counts, total]
        return e

    def add(self, d, node_labels: Mapping) -> None:
        for e in self.fwd.values():
            nses, sel, tk, counts, _total = e
            if ns_contains(nses, d.namespace) and sel.matches(d.labels):
                v = node_labels.get(tk)
                counts[v] = counts.get(v, 0) + 1
                e[4] += 1
        for term in d.required_anti_affinity_terms:
            sig = _term_sig(term, d.namespace, self.sel_cache)
            e = self.anti.get(sig)
            if e is None:
                nses, sel = _cached_matcher(
                    term, d.namespace, self.sel_cache, self.resolver)
                e = self.anti[sig] = [
                    nses, sel, term.get("topologyKey", ""), {}, 0]
            v = node_labels.get(e[2])
            e[3][v] = e[3].get(v, 0) + 1
            e[4] += 1


def _delta_affinity_ok(pi, ni, delta, ct, compiler,
                       delta_idx: _DeltaAffinityIndex) -> bool:
    """Inter-pod affinity check of `pi` on node `ni` against only the pods
    placed earlier in this assign() (the batch-start rows already cover
    the snapshot exactly), as O(terms) lookups in `delta_idx` — the
    reference's indexed form of `_delta_affinity_ok`."""
    labels_n = ni.labels
    # (1) pi's own anti-affinity vs delta placements.
    for term in pi.required_anti_affinity_terms:
        e = delta_idx.register(term, pi.namespace, delta)
        tv = labels_n.get(e[2])
        if tv is not None and e[3].get(tv):
            return False
    # (2) symmetry: delta pods' anti-affinity vs pi.
    for e in delta_idx.anti.values():
        nses, sel, tk, counts, _total = e
        tv = labels_n.get(tk)
        if tv is not None and counts.get(tv) \
                and ns_contains(nses, pi.namespace) \
                and sel.matches(pi.labels):
            return False
    # (3) pi's required affinity: delta pods can only ADD matches; the one
    # invalidation is the first-pod-in-group escape — once a matching pod
    # exists (placed in this batch), the term must be satisfied in the
    # node's domain for real.
    for term in pi.required_affinity_terms:
        tk = term.get("topologyKey", "")
        tv = labels_n.get(tk)
        if tv is None:
            return False
        e = delta_idx.register(term, pi.namespace, delta)
        if e[3].get(tv):
            continue  # satisfied by a batch sibling in this domain
        if compiler is not None:
            per_node, _, total = compiler.affinity_term_presence(
                term, pi.namespace)
            idx = ct.name_to_idx.get(ni.name)
            if idx is not None and per_node[idx] > 0:
                continue  # satisfied by the snapshot already
            if total == 0 and e[4] == 0:
                continue  # escape still valid: no match anywhere
            return False
        if e[4]:
            return False
    return True
