"""scheduler_perf harness (SURVEY §3.5), in process."""

from kubernetes_tpu_torch.perf.scheduler_perf import (
    PerfRunner, WorkloadResult, run_suite)

__all__ = ["PerfRunner", "WorkloadResult", "run_suite"]
