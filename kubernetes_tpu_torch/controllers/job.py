"""Job controller: run-to-completion workloads.

Parity target: pkg/controller/job/job_controller.go (`Controller.syncJob`,
`manageJob`): parallelism/completions accounting, NonIndexed + Indexed
completion modes, backoffLimit → Failed condition, activeDeadlineSeconds,
Complete condition + completionTime. SURVEY §2.4 calls Job "the
gang-adjacent batch workload" — on TPU clusters it is the shape most
training launches take, so Indexed mode (stable per-replica identity) is
first-class here.

Copy of `kubernetes_tpu/controllers/job.py`. The status write goes
through `base.status_writer`: skipped when it would change nothing.
"""

from __future__ import annotations

import logging
import time

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, now_iso, uid_of
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller, status_writer
from kubernetes_tpu_torch.controllers.replicaset import owner_ref, _controller_of
from kubernetes_tpu_torch.store.mvcc import NotFound, StoreError

logger = logging.getLogger(__name__)

#: job_controller.go DefaultJobApiBackoffLimit.
DEFAULT_BACKOFF_LIMIT = 6


def make_job(name: str, *, parallelism: int = 1, completions: int | None = None,
             template: dict | None = None, namespace: str = "default",
             completion_mode: str = "NonIndexed",
             backoff_limit: int = DEFAULT_BACKOFF_LIMIT,
             active_deadline_seconds: float | None = None) -> dict:
    spec = {
        "parallelism": parallelism,
        "template": template or {"spec": {"containers": [
            {"name": "main", "image": "app"}]}},
        "completionMode": completion_mode,
        "backoffLimit": backoff_limit,
    }
    if completions is not None:
        spec["completions"] = completions
    if active_deadline_seconds is not None:
        spec["activeDeadlineSeconds"] = active_deadline_seconds
    return new_object("Job", name, namespace, spec=spec, status={})


def _phase(pod: dict) -> str:
    return (pod.get("status") or {}).get("phase", "Pending")


class JobController(Controller):
    NAME = "job"
    WORKERS = 4
    RESYNC_PERIOD = 5.0

    def setup(self, factory: InformerFactory) -> None:
        self.job_informer = factory.informer("jobs")
        self.pod_informer = factory.informer("pods")
        self.watch_resource(factory, "jobs")
        self.watch_owned_pods(factory, "Job")

    async def resync_keys(self):
        return [namespaced_name(j) for j in self.job_informer.indexer.list()]

    def _owned_pods(self, job: dict) -> list[dict]:
        ns = job["metadata"].get("namespace", "default")
        juid = uid_of(job)
        out = []
        for pod in self.pod_informer.indexer.list():
            if pod["metadata"].get("namespace", "default") != ns:
                continue
            ref = _controller_of(pod)
            if ref is None or ref.get("kind") != "Job" \
                    or ref.get("name") != job["metadata"]["name"]:
                continue
            if ref.get("uid") and juid and ref["uid"] != juid:
                continue
            out.append(pod)
        return out

    @staticmethod
    def _finished(job: dict) -> bool:
        return any(c.get("type") in ("Complete", "Failed")
                   and c.get("status") == "True"
                   for c in (job.get("status") or {}).get("conditions") or [])

    async def sync(self, key: str) -> None:
        job = self.job_informer.indexer.get(key)
        if job is None or self._finished(job):
            return
        spec = job.get("spec") or {}
        parallelism = int(spec.get("parallelism", 1))
        completions = spec.get("completions")
        indexed = spec.get("completionMode") == "Indexed"
        if indexed and completions is None:
            completions = parallelism  # validation requires it; be lenient
        backoff_limit = int(spec.get("backoffLimit", DEFAULT_BACKOFF_LIMIT))
        ns = job["metadata"].get("namespace", "default")
        name = job["metadata"]["name"]

        pods = self._owned_pods(job)
        active = [p for p in pods if _phase(p) not in ("Succeeded", "Failed")
                  and not p["metadata"].get("deletionTimestamp")]

        # CUMULATIVE terminal accounting (job_controller.go with the
        # JobTrackingWithFinalizers semantics): live terminal pods are
        # counted into status ONCE, keyed by uid — so eviction/GC deleting a
        # finished pod cannot regress succeeded/failed or re-run completed
        # indexes. The counted-uid sets are bounded by total pod churn of
        # one job (status-internal analog of uncountedTerminatedPods).
        status = job.get("status") or {}
        counted = set(status.get("countedTerminatedUIDs") or [])
        n_succeeded = int(status.get("succeeded", 0))
        n_failed = int(status.get("failed", 0))
        completed_idx = set(status.get("completedIndexes") or [])
        new_uids: list[str] = []
        for p in pods:
            phase = _phase(p)
            if phase not in ("Succeeded", "Failed"):
                continue
            uid = uid_of(p) or namespaced_name(p)
            if uid in counted:
                continue
            new_uids.append(uid)
            if phase == "Succeeded":
                idx = (p["metadata"].get("annotations") or {}).get(
                    "batch.kubernetes.io/job-completion-index")
                if indexed:
                    if idx is not None and idx not in completed_idx:
                        completed_idx.add(idx)
                        n_succeeded += 1
                else:
                    n_succeeded += 1
            else:
                n_failed += 1

        # Terminal transitions first (syncJob ordering).
        deadline = spec.get("activeDeadlineSeconds")
        start = status.get("startTime")
        past_deadline = False
        if deadline is not None and start is not None:
            past_deadline = time.time() - _parse_ts(start) > float(deadline)
        if n_failed > backoff_limit or past_deadline:
            for p in active:
                try:
                    await self.store.delete("pods", namespaced_name(p))
                except NotFound:
                    pass
            reason = "DeadlineExceeded" if past_deadline else \
                "BackoffLimitExceeded"
            await self._update_status(
                key, active=0, succeeded=n_succeeded, failed=n_failed,
                new_uids=new_uids, completed_idx=completed_idx,
                condition=("Failed", reason))
            return
        complete = (completions is not None and n_succeeded >= completions) \
            or (completions is None and n_succeeded > 0 and not active)
        if complete:
            await self._update_status(
                key, active=0, succeeded=n_succeeded, failed=n_failed,
                new_uids=new_uids, completed_idx=completed_idx,
                condition=("Complete", "Completed"))
            return

        # manageJob: create up to parallelism active pods, bounded by
        # remaining completions.
        want_active = parallelism
        if completions is not None:
            want_active = min(parallelism, completions - n_succeeded)
        diff = want_active - len(active)
        n_active = len(active)
        if diff > 0:
            if indexed:
                have_idx = {(p["metadata"].get("annotations") or {})
                            .get("batch.kubernetes.io/job-completion-index")
                            for p in active} | completed_idx
                missing = [i for i in range(int(completions))
                           if str(i) not in have_idx][:diff]
                for i in missing:
                    await self._create_pod(job, ns, name, index=i)
                n_active += len(missing)
            else:
                for _ in range(diff):
                    await self._create_pod(job, ns, name)
                n_active += diff
        elif diff < 0:
            for p in active[:(-diff)]:
                try:
                    await self.store.delete("pods", namespaced_name(p))
                except NotFound:
                    pass
            n_active += diff
        await self._update_status(
            key, active=n_active, succeeded=n_succeeded, failed=n_failed,
            new_uids=new_uids, completed_idx=completed_idx, condition=None,
            set_start=start is None)

    async def _create_pod(self, job: dict, ns: str, name: str,
                          index: int | None = None) -> None:
        template = (job.get("spec") or {}).get("template") or {}
        meta = dict(template.get("metadata") or {})
        labels = dict(meta.get("labels") or {})
        labels.setdefault("job-name", name)
        pod_name = f"{name}-{index}" if index is not None \
            else f"{name}-{self._suffix()}"
        annotations = dict(meta.get("annotations") or {})
        if index is not None:
            annotations["batch.kubernetes.io/job-completion-index"] = str(index)
            labels["batch.kubernetes.io/job-completion-index"] = str(index)
        pod = {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {
                "name": pod_name, "namespace": ns, "labels": labels,
                "annotations": annotations,
                "ownerReferences": [owner_ref(job)],
            },
            "spec": dict(template.get("spec") or {}),
            "status": {"phase": "Pending"},
        }
        if not pod["spec"].get("containers"):
            pod["spec"]["containers"] = [{"name": "main", "image": "app"}]
        pod["spec"].setdefault("restartPolicy", "Never")
        try:
            await self.store.create("pods", pod)
        except StoreError as e:
            logger.warning("job %s/%s: create pod failed: %s", ns, name, e)

    async def _update_status(self, key: str, *, active: int, succeeded: int,
                             failed: int, new_uids: list[str],
                             completed_idx: set[str],
                             condition: tuple[str, str] | None,
                             set_start: bool = False) -> None:
        def mutate(obj):
            st = obj.setdefault("status", {})
            st["active"] = active
            # Counters only move forward (cumulative semantics survive a
            # racing stale sync).
            st["succeeded"] = max(succeeded, int(st.get("succeeded", 0)))
            st["failed"] = max(failed, int(st.get("failed", 0)))
            if new_uids:
                st["countedTerminatedUIDs"] = sorted(
                    set(st.get("countedTerminatedUIDs") or []) | set(new_uids))
            if completed_idx:
                st["completedIndexes"] = sorted(
                    set(st.get("completedIndexes") or []) | completed_idx)
            if set_start and not st.get("startTime"):
                st["startTime"] = now_iso()
            if condition is not None:
                ctype, reason = condition
                conds = st.setdefault("conditions", [])
                if not any(c.get("type") == ctype for c in conds):
                    conds.append({"type": ctype, "status": "True",
                                  "reason": reason,
                                  "lastTransitionTime": now_iso()})
                if ctype == "Complete":
                    st["completionTime"] = now_iso()
                st["active"] = 0
            return obj
        try:
            await self.store.guaranteed_update("jobs", key,
                                              status_writer(mutate))
        except NotFound:
            pass

    _seq = 0

    @classmethod
    def _suffix(cls) -> str:
        cls._seq += 1
        return f"{cls._seq:05d}"


def _parse_ts(ts: str) -> float:
    from datetime import datetime
    try:
        return datetime.fromisoformat(ts.replace("Z", "+00:00")).timestamp()
    except ValueError:
        return time.time()
