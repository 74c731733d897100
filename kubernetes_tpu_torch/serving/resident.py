"""Resident device planes: the packed used state stays warm across placements.

Without them every `assign()` uploads the whole (N, 2R+1) int32 used-state
pack (used_q ‖ used_nz_q ‖ used_pods) from the snapshot, and the fast path
would pay the same per lone pod when one pod moved one node. This class
keeps the pack on the device and refreshes it O(changed): the dirty row set
comes straight from the cache's `changed_since` log (never an O(N)
generation walk), the rows are re-quantized from the ClusterTensors arrays,
and only they ship to the device — as a fused scatter inside the fast-path
solve (`solver.solve_one_fresh`) or a standalone scatter for batch assigns
(`parallel/sharded.resident_row_scatter`).

Refresh contract (what invalidates what):

- **row refresh**: a node's generation moved (assume/confirm/forget,
  informer node update) → that row is re-quantized and scattered.
  Identical to a full upload by construction: both read the same ct rows.
- **full rebuild**: the node SET changed (`set_epoch`), the resource
  columns/scales/pad changed, the snapshot carries no epoch handles / the
  changed-log window doesn't reach back (fallback: one O(N) diff), or the
  dirty set exceeds REBUILD_FRACTION of the rows (a contiguous upload
  beats a dense scatter).
- a batch solve's chained state never touches the resident base:
  `TorchBackend._start` seeds its chain from a COPY (the chain is
  corrected in place on a verify rejection), and the next refresh
  re-derives from the cache, where the assumes landed anyway.

The host mirror (`_pack_np` + per-row generations) is updated at refresh()
time; the DEVICE pack catches up when the caller applies the returned delta
(used_pack does it inline; the fast path fuses it into the solve and
`adopt()`s the result). Every device pack this class holds owns its memory
— a CPU tensor made with `torch.from_numpy` would share the mirror's, and
refresh() writes the mirror before the delta is applied. Un-adopted deltas
persist in `_pending` and ride the next refresh — an exception between
refresh and adopt can delay a row, never lose it.

Block-index aggregates: the same dirty-row set additionally maintains
per-block capacity interval planes — (amin_pos, amin, amax) over
allocatable and (umin, umax) over scoring-used, each (B, R) int32 with
B = ceil(n_real / block_w) — recomputed O(changed blocks · block_w) per
refresh and mirrored to the device as one packed (B, 5R) upload, their
minima masked with the block kernels' sentinel (`ops/kernels._BLOCK_BIG`),
so they equal a from-scratch `block_capacity_aggregates`. They are
observability and serving-side reuse state: the batch solve's block
prefilter (`solver.block_bound_prefilter`) derives its aggregates from the
live capacity planes in each device pass, as the reference's does.

Copy of `kubernetes_tpu/serving/resident.py`.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from kubernetes_tpu_torch.ops.kernels import _BLOCK_BIG
from kubernetes_tpu_torch.utils import flags

REBUILD_FRACTION = 0.25


class ResidentPlanes:
    def __init__(self, backend, metrics=None):
        """`metrics`: a metrics/registry.SchedulerMetrics, or None; each
        refresh that did work observes `resident_plane_refresh_seconds`
        and each block refresh `scheduler_tpu_solver_block_refresh_seconds`."""
        self.backend = backend
        self.metrics = metrics
        self._key: tuple | None = None
        self._gen = -1
        self._gens: list | None = None
        self._pack_np: np.ndarray | None = None
        self._dev: torch.Tensor | None = None
        #: dirty rows whose device scatter hasn't been applied yet.
        self._pending: set[int] = set()
        #: observability (also mirrored into the metrics registry).
        self.full_rebuilds = 0
        self.row_refreshes = 0
        #: block-index aggregate planes (see module docstring): host
        #: dict of five (B, R) int32 planes + one packed device mirror.
        self._blocks: dict[str, np.ndarray] | None = None
        self._blocks_dev: torch.Tensor | None = None
        self._block_w = 0
        self._alloc_q: np.ndarray | None = None

    def invalidate(self) -> None:
        self._key = None
        self._dev = None
        self._pending.clear()
        self._blocks = None
        self._blocks_dev = None
        self._alloc_q = None

    # -- refresh ------------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """`arr` on the backend's device, in memory of its own."""
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            self.backend.device, copy=True)

    def _rebuild(self, ct) -> None:
        pack = np.concatenate(
            [ct.used_q, ct.used_nz_q,
             ct.used_pods.astype(np.int32)[:, None]], axis=1)
        self._pack_np = pack
        self._dev = self._upload(pack)
        self._gens = list(ct.node_gens)
        self._gen = ct.generation
        self._pending.clear()
        self.full_rebuilds += 1
        self._rebuild_blocks(ct)

    def refresh(self, ct, snapshot=None):
        """Bring the host mirror up to `ct` and return the device delta:
        None when the device pack is already fresh (full rebuild, or
        nothing changed), else bucket-padded host (rows, vals) the caller
        must apply — via used_pack's inline scatter or the fast path's
        fused solve followed by adopt()."""
        t0 = time.perf_counter()
        key = (ct.set_epoch, ct.n_pad, ct.n_real,
               tuple(ct.resources), tuple(ct.scales))
        out = None
        worked = False
        if self._dev is None or self._key != key or ct.set_epoch < 0:
            self._rebuild(ct)
            self._key = key
            worked = True
        else:
            changed = None
            fn = getattr(snapshot, "changed_since", None) \
                if snapshot is not None else None
            if fn is not None and self._gen >= 0:
                changed = fn(self._gen)
            if changed is None:
                # No changed-log window: one O(N) diff against the
                # mirror's per-row generations.
                changed = [i for i, g in enumerate(ct.node_gens)
                           if self._gens[i] != g]
            if len(changed) + len(self._pending) \
                    > REBUILD_FRACTION * max(ct.n_real, 1):
                self._rebuild(ct)
                worked = True
            else:
                self._gen = ct.generation
                fresh = [i for i in changed
                         if i < ct.n_real and self._gens[i]
                         != ct.node_gens[i]]
                for i in fresh:
                    self._gens[i] = ct.node_gens[i]
                self._pending.update(fresh)
                if self._pending:
                    idxs = np.fromiter(sorted(self._pending), np.int32,
                                       count=len(self._pending))
                    vals = np.concatenate(
                        [ct.used_q[idxs], ct.used_nz_q[idxs],
                         ct.used_pods[idxs].astype(np.int32)[:, None]],
                        axis=1)
                    self._pack_np[idxs] = vals
                    self.row_refreshes += 1
                    out = self._pad_bucket(idxs, vals)
                    self._refresh_blocks(ct, idxs)
                    worked = True
        if worked and self.metrics is not None:
            # No-op refreshes (nothing dirty) deliberately don't count:
            # the counter/histogram describe actual rebuild/scatter
            # work, and diluting them with no-op walls would misstate
            # the refresh cost.
            self.metrics.resident_plane_refreshes.inc()
            self.metrics.resident_plane_refresh.observe(
                time.perf_counter() - t0)
        return out

    @staticmethod
    def _pad_bucket(rows: np.ndarray, vals: np.ndarray):
        """Pad the delta to a power-of-two bucket (repeating the first
        row — the duplicate set is idempotent), as the reference does so
        that one program serves each bucket; the fast path fuses only the
        smallest buckets (fastpath.FUSE_MAX_ROWS)."""
        cap = 1
        while cap < len(rows):
            cap <<= 1
        if cap > len(rows):
            pad = cap - len(rows)
            rows = np.concatenate(
                [rows, np.full((pad,), rows[0], np.int32)])
            vals = np.concatenate(
                [vals, np.repeat(vals[:1], pad, axis=0)])
        return rows, vals

    def adopt(self, dev: torch.Tensor) -> None:
        """Install a device pack that already includes every pending row
        (the fused fast-path solve returns it)."""
        self._dev = dev
        self._pending.clear()

    def apply_delta(self, delta) -> None:
        """Apply a refresh() delta via the standalone out-of-place scatter
        and adopt the result."""
        from kubernetes_tpu_torch.parallel.sharded import resident_row_scatter
        fn = resident_row_scatter(getattr(self.backend, "mesh", None))
        put = self.backend._put
        self.adopt(fn(self._dev, put(delta[0]), put(delta[1])))

    def used_pack(self, ct, snapshot=None) -> torch.Tensor:
        """The refreshed device pack (the batch path's entry point):
        refresh, apply any delta via the standalone scatter, return."""
        delta = self.refresh(ct, snapshot)
        if delta is not None:
            self.apply_delta(delta)
        return self._dev

    # -- block-index aggregates ---------------------------------------------

    @staticmethod
    def _block_width_from_flags() -> int:
        """The maintained block width: 0 (index off) under the
        KTPU_BLOCK_INDEX kill switch, else the KTPU_BLOCK_WIDTH override,
        else the tuner's default width."""
        if not flags.get("KTPU_BLOCK_INDEX"):
            return 0
        override = flags.get("KTPU_BLOCK_WIDTH")
        if override is not None:
            return max(0, int(override))
        from kubernetes_tpu_torch.ops.backend import AdaptiveTuner
        return AdaptiveTuner.BLOCK_WIDTH

    def _rebuild_blocks(self, ct) -> None:
        """Full recompute of the five (B, R) planes over the real rows.

        Called from _rebuild (the node set / columns / pad changed, so
        every block is dirty anyway). Minima fill with _BLOCK_BIG, maxima
        with 0, and amin_pos additionally masks zero-alloc columns.
        """
        bw = self._block_w = self._block_width_from_flags()
        if not bw:
            self._blocks = None
            self._blocks_dev = None
            self._alloc_q = None
            return
        n = ct.n_real
        alloc = np.asarray(ct.alloc_q[:n], dtype=np.int32)
        self._alloc_q = alloc.copy()
        r = alloc.shape[1]
        used_nz = self._pack_np[:n, r:2 * r]
        b = -(-n // bw) if n else 0

        def fold(x, fill):
            pad = b * bw - n
            if pad:
                x = np.concatenate(
                    [x, np.full((pad, r), fill, np.int32)])
            return x.reshape(b, bw, r)

        self._blocks = {
            "amin_pos": fold(np.where(alloc > 0, alloc, _BLOCK_BIG),
                             _BLOCK_BIG).min(axis=1),
            "amin": fold(alloc, _BLOCK_BIG).min(axis=1),
            "amax": fold(alloc, 0).max(axis=1),
            "umin": fold(used_nz, _BLOCK_BIG).min(axis=1),
            "umax": fold(used_nz, 0).max(axis=1),
        } if b else {
            k: np.zeros((0, r), np.int32)
            for k in ("amin_pos", "amin", "amax", "umin", "umax")
        }
        self._upload_blocks()

    def _refresh_blocks(self, ct, idxs: np.ndarray) -> None:
        """Recompute only the blocks containing dirty rows — O(changed
        blocks · block_w). `idxs` are the already-filtered real dirty rows
        (< n_real)."""
        if self._blocks is None or self._block_w <= 0:
            return
        t0 = time.perf_counter()
        bw = self._block_w
        n = self._alloc_q.shape[0]
        r = self._alloc_q.shape[1]
        # allocatable can move too (informer node updates ride the same
        # dirty set) — re-snapshot those rows before aggregating.
        self._alloc_q[idxs] = np.asarray(ct.alloc_q[idxs], dtype=np.int32)
        for blk in np.unique(idxs // bw):
            lo, hi = int(blk) * bw, min((int(blk) + 1) * bw, n)
            alloc = self._alloc_q[lo:hi]
            used_nz = self._pack_np[lo:hi, r:2 * r]
            self._blocks["amin_pos"][blk] = np.where(
                alloc > 0, alloc, _BLOCK_BIG).min(axis=0)
            self._blocks["amin"][blk] = alloc.min(axis=0)
            self._blocks["amax"][blk] = alloc.max(axis=0)
            self._blocks["umin"][blk] = used_nz.min(axis=0)
            self._blocks["umax"][blk] = used_nz.max(axis=0)
        self._upload_blocks()
        if self.metrics is not None:
            self.metrics.solver_block_refresh.observe(
                time.perf_counter() - t0)

    def _upload_blocks(self) -> None:
        """Mirror the host planes to the device as one packed (B, 5R)
        upload (small: one transfer per refresh)."""
        self._blocks_dev = self._upload(np.concatenate(
            [self._blocks[k] for k in
             ("amin_pos", "amin", "amax", "umin", "umax")],
            axis=1).astype(np.int32))

    # -- test/debug hooks ---------------------------------------------------

    def host_mirror(self) -> np.ndarray | None:
        """The host copy of the resident pack (None before first use)."""
        return self._pack_np

    def block_aggregates(self):
        """(block_w, host planes dict, packed device mirror) — None planes
        when the block index is off."""
        return self._block_w, self._blocks, self._blocks_dev
