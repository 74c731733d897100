"""CronJob controller: scheduled Job spawning.

Parity target: pkg/controller/cronjob/cronjob_controllerv2.go
(`syncCronJob`): compute the most recent schedule time since
status.lastScheduleTime, honor startingDeadlineSeconds, apply
concurrencyPolicy (Allow | Forbid | Replace), stamp Jobs named
`<cronjob>-<scheduled-unix-minute>` with ownerReferences, and trim
finished Jobs to the success/failure history limits.

The cron expression parser supports the standard five fields
(minute hour day-of-month month day-of-week) with `*`, lists, ranges
and `*/step` — the subset the reference's robfig/cron usage relies on.

Copy of `kubernetes_tpu/controllers/cronjob.py`.
"""

from __future__ import annotations

import logging
import time as _time
from datetime import datetime, timedelta, timezone

from kubernetes_tpu_torch.api.meta import namespaced_name, new_object, uid_of
from kubernetes_tpu_torch.client import InformerFactory
from kubernetes_tpu_torch.controllers.base import Controller
from kubernetes_tpu_torch.controllers.replicaset import _controller_of
from kubernetes_tpu_torch.store.mvcc import AlreadyExists, NotFound, StoreError

logger = logging.getLogger(__name__)


def make_cronjob(name: str, schedule: str, *, namespace: str = "default",
                 job_template: dict | None = None,
                 concurrency_policy: str = "Allow",
                 starting_deadline_seconds: float | None = None,
                 suspend: bool = False,
                 successful_jobs_history_limit: int = 3,
                 failed_jobs_history_limit: int = 1) -> dict:
    spec = {
        "schedule": schedule,
        "concurrencyPolicy": concurrency_policy,
        "suspend": suspend,
        "jobTemplate": job_template or {"spec": {
            "template": {"spec": {"containers": [
                {"name": "main", "image": "app"}]}}}},
        "successfulJobsHistoryLimit": successful_jobs_history_limit,
        "failedJobsHistoryLimit": failed_jobs_history_limit,
    }
    if starting_deadline_seconds is not None:
        spec["startingDeadlineSeconds"] = starting_deadline_seconds
    return new_object("CronJob", name, namespace, spec=spec, status={})


# -- cron expression math ---------------------------------------------------


def _parse_field(field: str, lo: int, hi: int) -> set[int]:
    out: set[int] = set()
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
        if part in ("*", ""):
            start, end = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            start, end = int(a), int(b)
        else:
            start = end = int(part)
        if not (lo <= start <= hi and lo <= end <= hi and step >= 1):
            raise ValueError(f"cron field out of range: {field!r}")
        out.update(range(start, end + 1, step))
    return out


class CronSchedule:
    """Compiled five-field cron expression."""

    def __init__(self, spec: str):
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"cron spec needs 5 fields: {spec!r}")
        self.minutes = _parse_field(fields[0], 0, 59)
        self.hours = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.months = _parse_field(fields[3], 1, 12)
        # cron dow: 0 and 7 are both Sunday; python weekday(): Mon=0.
        dow = _parse_field(fields[4], 0, 7)
        self.dow = {(d % 7) for d in dow}
        # robfig/cron star semantics: any field BEGINNING with '*'
        # (including "*/n") carries the star bit — dom AND dow then,
        # vixie OR only when both are restricted lists.
        self.dom_star = fields[2].startswith("*")
        self.dow_star = fields[4].startswith("*")

    def _day_matches(self, t: datetime) -> bool:
        dom_ok = t.day in self.dom
        dow_ok = ((t.weekday() + 1) % 7) in self.dow  # cron Sun=0
        if self.dom_star and self.dow_star:
            return True
        if self.dom_star:
            return dow_ok
        if self.dow_star:
            return dom_ok
        return dom_ok or dow_ok  # vixie-cron OR semantics

    def next_after(self, after: datetime) -> datetime:
        """First matching minute strictly after `after` (UTC); raises
        ValueError for valid-but-never-firing specs (e.g. Feb 30)."""
        t = after.replace(second=0, microsecond=0) + timedelta(minutes=1)
        # Horizon-bounded walk (not iteration-bounded): the hierarchical
        # jumps advance at least a month/day/hour per miss, so scanning
        # five years of a never-firing spec is a few thousand steps, not
        # a multi-second minute-by-minute grind.
        horizon = t + timedelta(days=366 * 5)
        while t <= horizon:
            if t.month not in self.months:
                # jump to the 1st of the next month
                if t.month == 12:
                    t = t.replace(year=t.year + 1, month=1, day=1,
                                  hour=0, minute=0)
                else:
                    t = t.replace(month=t.month + 1, day=1,
                                  hour=0, minute=0)
                continue
            if not self._day_matches(t):
                t = t.replace(hour=0, minute=0) + timedelta(days=1)
                continue
            if t.hour not in self.hours:
                t = t.replace(minute=0) + timedelta(hours=1)
                continue
            if t.minute not in self.minutes:
                t += timedelta(minutes=1)
                continue
            return t
        raise ValueError("cron schedule never fires")


def _parse_time(s: str | None) -> datetime | None:
    if not s:
        return None
    return datetime.fromisoformat(s.replace("Z", "+00:00"))


def _fmt_time(t: datetime) -> str:
    return t.astimezone(timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


class CronJobController(Controller):
    NAME = "cronjob"
    WORKERS = 2
    RESYNC_PERIOD = 1.0

    def __init__(self, store, *, now=None):
        super().__init__(store)
        #: injectable clock (tests drive schedules without waiting).
        self.now = now or (lambda: datetime.fromtimestamp(
            _time.time(), tz=timezone.utc))

    def setup(self, factory: InformerFactory) -> None:
        self.cron_informer = factory.informer("cronjobs")
        self.job_informer = factory.informer("jobs")
        self.watch_resource(factory, "cronjobs")
        self.watch_owned(factory, "jobs", "CronJob")

    async def resync_keys(self):
        return [namespaced_name(c)
                for c in self.cron_informer.indexer.list()]

    def _owned_jobs(self, cron: dict) -> list[dict]:
        ns = cron["metadata"].get("namespace", "default")
        cuid = uid_of(cron)
        out = []
        for job in self.job_informer.indexer.list():
            if job["metadata"].get("namespace", "default") != ns:
                continue
            ref = _controller_of(job)
            if ref is None or ref.get("kind") != "CronJob" \
                    or ref.get("name") != cron["metadata"]["name"]:
                continue
            if ref.get("uid") and cuid and ref["uid"] != cuid:
                continue
            out.append(job)
        return out

    @staticmethod
    def _job_finished(job: dict) -> str | None:
        for c in (job.get("status") or {}).get("conditions") or []:
            if c.get("status") == "True" and \
                    c.get("type") in ("Complete", "Failed"):
                return c["type"]
        return None

    async def sync(self, key: str) -> None:
        cron = self.cron_informer.indexer.get(key)
        if cron is None:
            return
        spec = cron.get("spec") or {}
        if spec.get("suspend"):
            return
        try:
            sched = CronSchedule(spec.get("schedule", ""))
        except ValueError as e:
            logger.warning("cronjob %s: bad schedule: %s", key, e)
            return
        return await self._sync_scheduled(key, cron, spec, sched)

    async def _sync_scheduled(self, key, cron, spec, sched) -> None:
        now = self.now()
        created = cron["metadata"].get("creationTimestamp")
        last = _parse_time((cron.get("status") or {})
                           .get("lastScheduleTime")) \
            or _parse_time(created) or now
        if last > now:
            # Clock skew (or an injected test clock behind the apiserver's
            # stamp): a future baseline would postpone the first run
            # indefinitely.
            last = now
        try:
            due = sched.next_after(last)
            if due > now:
                await self._trim_history(cron)
                return
            # Most recent missed time wins (the reference warns past 100
            # misses; we just take the latest).
            while True:
                nxt = sched.next_after(due)
                if nxt > now:
                    break
                due = nxt
        except ValueError as e:
            # Valid-looking spec that never fires (e.g. "0 0 30 2 *"):
            # park it, don't hot-requeue.
            logger.warning("cronjob %s: schedule never fires: %s", key, e)
            return
        deadline = spec.get("startingDeadlineSeconds")
        if deadline is not None and \
                (now - due).total_seconds() > float(deadline):
            await self._record_schedule(key, due)  # too late: skip run
            return
        active = [j for j in self._owned_jobs(cron)
                  if self._job_finished(j) is None]
        policy = spec.get("concurrencyPolicy", "Allow")
        if active and policy == "Forbid":
            # Do NOT record the skipped time: the run stays due and
            # catches up when the active job finishes (the reference
            # leaves LastScheduleTime unset in this branch).
            return
        if active and policy == "Replace":
            for j in active:
                try:
                    await self.store.delete("jobs", namespaced_name(j))
                except StoreError:
                    pass
        await self._spawn_job(cron, due)
        await self._record_schedule(key, due)
        await self._trim_history(cron)

    async def _spawn_job(self, cron: dict, due: datetime) -> None:
        ns = cron["metadata"].get("namespace", "default")
        name = f"{cron['metadata']['name']}-{int(due.timestamp()) // 60}"
        tmpl = (cron.get("spec") or {}).get("jobTemplate") or {}
        job = new_object("Job", name, ns,
                         spec=dict(tmpl.get("spec") or {}), status={})
        job["metadata"]["ownerReferences"] = [{
            "apiVersion": "batch/v1", "kind": "CronJob",
            "name": cron["metadata"]["name"], "uid": uid_of(cron),
            "controller": True}]
        job["metadata"]["annotations"] = {
            "batch.kubernetes.io/cronjob-scheduled-timestamp":
                _fmt_time(due)}
        try:
            await self.store.create("jobs", job, return_copy=False)
        except AlreadyExists:
            pass  # deterministic name: this tick already ran

    async def _record_schedule(self, key: str, due: datetime) -> None:
        def set_last(obj):
            status = obj.setdefault("status", {})
            if status.get("lastScheduleTime") == _fmt_time(due):
                return None
            status["lastScheduleTime"] = _fmt_time(due)
            return obj
        try:
            await self.store.guaranteed_update(
                "cronjobs", key, set_last, return_copy=False)
        except NotFound:
            pass

    async def _trim_history(self, cron: dict) -> None:
        spec = cron.get("spec") or {}
        limits = {"Complete": int(spec.get(
            "successfulJobsHistoryLimit", 3)),
            "Failed": int(spec.get("failedJobsHistoryLimit", 1))}
        by_outcome: dict[str, list[dict]] = {"Complete": [], "Failed": []}
        for j in self._owned_jobs(cron):
            outcome = self._job_finished(j)
            if outcome:
                by_outcome[outcome].append(j)
        for outcome, jobs in by_outcome.items():
            jobs.sort(key=lambda j: j["metadata"]
                      .get("creationTimestamp", ""))
            excess = len(jobs) - limits[outcome]
            for j in jobs[:max(0, excess)]:
                try:
                    await self.store.delete("jobs", namespaced_name(j))
                except StoreError:
                    pass
