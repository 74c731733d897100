"""Scheduler cache: in-memory mirror of nodes+pods with assume/confirm/expire
and incremental generation-based snapshots.

Parity target: pkg/scheduler/internal/cache/cache.go (`cacheImpl`:
`AssumePod`, `FinishBinding`, `ForgetPod`, `AddPod`, `RemovePod`,
`AddNode`/`UpdateNode`/`RemoveNode`, `UpdateSnapshot` — generation-numbered
incremental copy; assumed pods expire after a TTL (`durationToExpireAssumedPod`,
default 15 min, 0 = never) unless confirmed by observing the bound pod).

The assume protocol is what lets binding be asynchronous: the cycle writes the
assumed pod into the cache *optimistically* so the next cycle's snapshot sees
its resources as taken; the informer later confirms (AddPod for the bound pod)
or the TTL expires it (bind failed and nobody told us).

Batched-pop deviation: assume() is called for every pod in a solver batch
before any binding starts — intra-batch contention is already resolved inside
the solver, so assumes cannot conflict (SURVEY §3.1 note).

Copy of `kubernetes_tpu/scheduler/cache.py`, whole: the serving fast path
(serving/) and the incremental `ClusterTensors` build read the snapshot
handles it stamps (`set_epoch`, `spec_seq`, `changed_since`).
"""

from __future__ import annotations

import logging
import time
from typing import Mapping

from kubernetes_tpu_torch.scheduler.types import NodeInfo, PodInfo, Snapshot

logger = logging.getLogger(__name__)


class SchedulerCache:
    def __init__(self, assumed_pod_ttl: float = 900.0):
        self.nodes: dict[str, NodeInfo] = {}
        # pod key -> (PodInfo, node_name, assumed, finished_binding, deadline)
        self._pod_states: dict[str, dict] = {}
        self.assumed_pod_ttl = assumed_pod_ttl
        self._generation = 0
        # Snapshot bookkeeping: cached NodeInfo clones by name.
        self._snap_nodes: dict[str, NodeInfo] = {}
        # Incremental-snapshot state (the 200k-preset host-prep fix):
        # event handlers mark DIRTY node names; update_snapshot touches
        # only those instead of walking all N nodes per cycle. The
        # stable snapshot-order list + position map let Snapshot
        # construction be pointer copies, and the (generation, index)
        # changed-log hands ops/tensorize its O(changed) delta.
        self._dirty: set[str] = set()
        self._full = True            # first snapshot / node removal
        self._snap_list: list[NodeInfo] = []
        self._snap_pos: dict[str, int] = {}
        self._aff_names: set[str] = set()
        self._anti_names: set[str] = set()
        self._set_epoch = 0          # bumps when the node set changes
        self._spec_seq = 0           # bumps on any node OBJECT update
        self._changed_log: list[tuple[int, int]] = []
        self._log_floor = 0          # gens ≤ floor are out of the log
        self._last_snap: Snapshot | None = None

    def _bump(self, node: NodeInfo) -> None:
        self._generation += 1
        node.generation = self._generation
        self._dirty.add(node.name)

    # -- nodes -------------------------------------------------------------

    def add_node(self, node: Mapping) -> None:
        name = node["metadata"]["name"]
        ni = self.nodes.get(name)
        if ni is None:
            ni = NodeInfo(node)
            self.nodes[name] = ni
        else:
            ni.set_node(node)
        self._spec_seq += 1  # node OBJECT changed: taints/alloc may move
        self._bump(ni)

    def update_node(self, node: Mapping) -> None:
        self.add_node(node)

    def remove_node(self, name: str) -> None:
        self.nodes.pop(name, None)
        self._snap_nodes.pop(name, None)
        self._generation += 1
        self._spec_seq += 1
        self._full = True  # positions shift: full re-snapshot on deletion

    # -- pods --------------------------------------------------------------

    def assume_pod(self, pi: PodInfo, node_name: str) -> None:
        if pi.key in self._pod_states:
            raise ValueError(f"pod {pi.key} already assumed/added")
        ni = self.nodes.get(node_name)
        if ni is None:
            raise KeyError(f"assume: unknown node {node_name}")
        ni.add_pod(pi)
        self._bump(ni)
        self._pod_states[pi.key] = {
            "pod": pi, "node": node_name, "assumed": True,
            "finished": False, "deadline": None,
        }

    def finish_binding(self, pod_key: str, now: float | None = None) -> None:
        st = self._pod_states.get(pod_key)
        if st is None or not st["assumed"]:
            return
        st["finished"] = True
        if self.assumed_pod_ttl > 0:
            st["deadline"] = (now or time.monotonic()) + self.assumed_pod_ttl

    def forget_pod(self, pod_key: str) -> None:
        """Undo an assume (bind failed)."""
        st = self._pod_states.pop(pod_key, None)
        if st is None:
            return
        ni = self.nodes.get(st["node"])
        if ni is not None:
            ni.remove_pod(pod_key)
            self._bump(ni)

    def add_pod(self, pi: PodInfo) -> None:
        """Informer confirms a bound pod. If it was assumed: confirm (or move
        if the API says a different node than we assumed)."""
        st = self._pod_states.get(pi.key)
        if st is not None and st["assumed"]:
            if st["node"] != pi.node_name:
                logger.warning("pod %s assumed on %s but bound to %s; correcting",
                               pi.key, st["node"], pi.node_name)
                self.forget_pod(pi.key)
                self._add_confirmed(pi)
            else:
                st["assumed"] = False
                st["deadline"] = None
                st["pod"] = pi
            return
        if st is not None:
            return  # duplicate add
        self._add_confirmed(pi)

    def _add_confirmed(self, pi: PodInfo) -> None:
        ni = self.nodes.get(pi.node_name)
        if ni is None:
            # Pod bound to a node we haven't seen yet: create a placeholder
            # (the reference tolerates this ordering with an imaginary node).
            ni = NodeInfo()
            ni.name = pi.node_name
            self.nodes[pi.node_name] = ni
        ni.add_pod(pi)
        self._bump(ni)
        self._pod_states[pi.key] = {
            "pod": pi, "node": pi.node_name, "assumed": False,
            "finished": True, "deadline": None,
        }

    def update_pod(self, pi: PodInfo) -> None:
        st = self._pod_states.get(pi.key)
        if st is None:
            if pi.node_name:
                self.add_pod(pi)
            return
        ni = self.nodes.get(st["node"])
        if ni is not None:
            ni.remove_pod(pi.key)
            self._bump(ni)
        del self._pod_states[pi.key]
        if pi.node_name:
            self.add_pod(pi)

    def remove_pod(self, pod_key: str) -> None:
        st = self._pod_states.pop(pod_key, None)
        if st is None:
            return
        ni = self.nodes.get(st["node"])
        if ni is not None:
            ni.remove_pod(pod_key)
            self._bump(ni)

    def is_assumed(self, pod_key: str) -> bool:
        st = self._pod_states.get(pod_key)
        return bool(st and st["assumed"])

    def cleanup_expired(self, now: float | None = None) -> list[str]:
        """Expire assumed-and-finished pods past their TTL
        (cleanupAssumedPods, run periodically)."""
        now = now or time.monotonic()
        expired = [
            k for k, st in self._pod_states.items()
            if st["assumed"] and st["finished"]
            and st["deadline"] is not None and st["deadline"] <= now
        ]
        for k in expired:
            logger.warning("assumed pod %s expired without confirmation", k)
            self.forget_pod(k)
        return expired

    # -- snapshot ----------------------------------------------------------

    def _clone_into_snap(self, name: str, ni: NodeInfo) -> None:
        clone = ni.clone()
        self._snap_nodes[name] = clone
        pos = self._snap_pos.get(name)
        if pos is None:
            pos = self._snap_pos[name] = len(self._snap_list)
            self._snap_list.append(clone)
            self._set_epoch += 1  # node set grew: tensors re-key
        else:
            self._snap_list[pos] = clone
            self._changed_log.append((clone.generation, pos))
        if clone.pods_with_affinity:
            self._aff_names.add(name)
        else:
            self._aff_names.discard(name)
        if clone.pods_with_required_anti_affinity:
            self._anti_names.add(name)
        else:
            self._anti_names.discard(name)

    def update_snapshot(self) -> Snapshot:
        """Incremental snapshot off the event stream: only DIRTY nodes
        (marked by the informer/assume handlers' `_bump`) are re-cloned —
        O(changed) per cycle, not UpdateSnapshot's O(N) generation walk,
        which at the 200k preset cost more than the scheduling work it
        fed. Node removals fall back to one full rebuild (positions
        shift). The returned Snapshot carries the incremental host-prep
        handles ops/tensorize consumes (set_epoch / spec_seq /
        changed_since)."""
        if not self._full and not self._dirty \
                and self._last_snap is not None:
            # Nothing moved since the last snapshot (generation can only
            # advance through _bump/remove_node, which set dirty/_full):
            # hand back the SAME immutable-by-convention snapshot — the
            # scheduler re-snapshots ~10× per cycle and the no-op calls
            # must not pay two O(N) copies each at 200k nodes.
            return self._last_snap
        self._refresh_clones()
        snap = self._make_snapshot(self._snap_list.copy(),
                                   dict(self._snap_nodes))
        self._last_snap = snap
        return snap

    def light_snapshot(self) -> Snapshot:
        """ZERO-COPY snapshot for the serving fast path: same clone
        maintenance as update_snapshot, but the returned Snapshot WRAPS
        the cache's live list/dict instead of copying them — the two
        O(N) copies were most of the fast path's host wall at 5k nodes,
        paid per lone-pod placement for a one-row change.

        Contract: consume SYNCHRONOUSLY and drop before the next cache
        mutation — any assume/informer event replaces entries beneath
        it (update_snapshot's copies exist precisely for callers that
        hold snapshots across mutations, like the batch pipeline's
        chunked verify). Never cached as _last_snap for the same
        reason."""
        if self._full or self._dirty:
            # This maintenance clears the dirty set, but _last_snap's
            # COPIED lists still hold the pre-mutation clones — without
            # this invalidation the next update_snapshot()'s clean-path
            # guard would hand that stale snapshot back.
            self._last_snap = None
        self._refresh_clones()
        return self._make_snapshot(self._snap_list, self._snap_nodes)

    def _refresh_clones(self) -> None:
        """Shared maintenance: re-clone dirty/removed nodes into the
        stable snapshot list (see update_snapshot)."""
        if self._full:
            self._snap_nodes = {}
            self._snap_list = []
            self._snap_pos = {}
            self._aff_names = set()
            self._anti_names = set()
            self._changed_log = []
            self._log_floor = self._generation
            self._set_epoch += 1
            for name, ni in self.nodes.items():
                self._clone_into_snap(name, ni)
            self._full = False
            self._dirty.clear()
        elif self._dirty:
            for name in self._dirty:
                ni = self.nodes.get(name)
                if ni is None:
                    continue  # removal already forced _full
                cached = self._snap_nodes.get(name)
                if cached is None or cached.generation != ni.generation:
                    self._clone_into_snap(name, ni)
            self._dirty.clear()
            # Bound the log: once it outgrows the node set several times
            # over, one full tensor re-scan is cheaper than carrying it.
            if len(self._changed_log) > 4 * len(self._snap_list) + 65536:
                self._changed_log = []
                self._log_floor = self._generation

    def _make_snapshot(self, nodes: list, by_name: dict) -> Snapshot:
        # Affinity lists in snapshot-position order (deterministic — the
        # unsharded and sharded paths must build identical tables).
        pos = self._snap_pos.get
        snap = Snapshot(nodes, self._generation,
                        by_name=by_name,
                        have_affinity=[self._snap_nodes[n] for n in
                                       sorted(self._aff_names, key=pos)],
                        have_anti_affinity=[self._snap_nodes[n] for n in
                                            sorted(self._anti_names,
                                                   key=pos)])
        snap.set_epoch = self._set_epoch
        snap.spec_seq = self._spec_seq
        log, log_len, floor = self._changed_log, len(self._changed_log), \
            self._log_floor

        def changed_since(gen: int, _log=log, _n=log_len, _floor=floor):
            """Snapshot-order indices changed after `gen`; None when the
            window doesn't reach back that far (caller full-scans).
            Entries are appended per update_snapshot batch, and every
            batch's generations exceed the previous snapshot's, so a
            back-scan terminates exactly at the boundary."""
            if gen < _floor:
                return None
            out = set()
            i = _n - 1
            while i >= 0 and _log[i][0] > gen:
                out.add(_log[i][1])
                i -= 1
            return out

        snap.changed_since = changed_since
        return snap

    def pod_count(self) -> int:
        return len(self._pod_states)
