"""Kubelet-local device allocation ledger + checkpoint.

Parity target: pkg/kubelet/cm/devicemanager/manager.go (`Allocate`,
`podDevices`, `writeCheckpoint`) + pkg/kubelet/checkpointmanager/
(SURVEY §2.5 resource managers, §5.4 checkpoint/resume): the node agent
records which devices each pod holds and persists the record locally so
a restarted agent never double-allocates devices that survived it.

TPU-first divergence: devices here are DRA ResourceSlice entries (the
only device model this framework ships); the extended-resource counting
path needs no per-device identity, so only claims reach the ledger.

The checkpoint is one JSON document written atomically (tmp + fsync +
rename — the checkpointmanager's atomic-writer contract on one file).

Copy of `kubernetes_tpu/agent/ledger.py`.
"""

from __future__ import annotations

import json
import logging
import os

logger = logging.getLogger(__name__)

_VERSION = 1


class DeviceLedger:
    """pod key -> claim name -> [device names] with file checkpointing."""

    def __init__(self, path: str, node_name: str):
        self.path = path
        self.node_name = node_name
        self._alloc: dict[str, dict[str, list[str]]] = {}

    # -- checkpoint --------------------------------------------------------

    def load(self) -> None:
        """Restore state from the checkpoint; a missing file is first
        boot, a corrupt one is discarded loudly (the reference rebuilds
        from the runtime in that case — we rebuild from the apiserver
        via reconcile())."""
        try:
            with open(self.path) as f:
                doc = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, json.JSONDecodeError):
            logger.exception(
                "device checkpoint %s unreadable; starting empty "
                "(reconcile() will rebuild from claim status)", self.path)
            return
        if doc.get("node") not in (None, self.node_name):
            logger.warning(
                "device checkpoint %s belongs to node %r, not %r; ignoring",
                self.path, doc.get("node"), self.node_name)
            return
        self._alloc = {
            pod: {c: list(devs) for c, devs in claims.items()}
            for pod, claims in (doc.get("allocations") or {}).items()}

    def _save(self) -> None:
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump({"version": _VERSION, "node": self.node_name,
                       "allocations": self._alloc}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    # -- allocation --------------------------------------------------------

    def in_use(self) -> set[str]:
        return {d for claims in self._alloc.values()
                for devs in claims.values() for d in devs}

    def get(self, pod_key: str) -> dict[str, list[str]]:
        return {c: list(d) for c, d in self._alloc.get(pod_key, {}).items()}

    def allocate(self, pod_key: str, claim_name: str,
                 devices: list[str]) -> None:
        """Idempotent: re-syncing a pod re-records the same devices."""
        cur = self._alloc.setdefault(pod_key, {})
        if cur.get(claim_name) == devices:
            return
        taken = self.in_use() - set(cur.get(claim_name) or [])
        clash = taken & set(devices)
        if clash:
            # Double-allocation would corrupt the node's device state —
            # refuse; the claim's scheduler-side allocation is the source
            # of truth and the conflict means OUR ledger is stale.
            raise ValueError(
                f"devices {sorted(clash)} already allocated on this node")
        cur[claim_name] = list(devices)
        self._save()

    def release(self, pod_key: str) -> list[str]:
        claims = self._alloc.pop(pod_key, None)
        if not claims:
            return []
        self._save()
        return sorted({d for devs in claims.values() for d in devs})

    def reconcile(self, live_pod_keys: set[str]) -> list[str]:
        """Drop allocations for pods that no longer exist on this node
        (restart recovery: the checkpoint may outlive its pods)."""
        gone = [k for k in self._alloc if k not in live_pod_keys]
        for k in gone:
            self._alloc.pop(k, None)
        if gone:
            self._save()
        return gone
