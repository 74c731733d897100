"""ChurnDay: open-loop sustained-churn scenario battery (ROADMAP #2).

Every drain family measures a bulk drain of pre-created pods; production
control planes live in steady state — trickling arrivals, rollouts, node
deaths and preemption colliding mid-wave (SURVEY §3.1). This package is
the measurement subsystem for that regime:

- arrivals.py  — seeded open-loop arrival processes (Poisson/burst/ramp):
  pods are enqueued at a target rate regardless of completion, so
  saturation shows up as queue growth, not a slower clock.
- faults.py    — deterministic fault scheduler: timeline events injected
  mid-wave (node death via agent kill + lease expiry, drain/cordon,
  rollout waves, gang arrivals) with time-to-recovery measured.
- driver.py    — the open-loop driver + the rate-sweep harness that
  walks arrival rate to find the knee, reporting exact p50/p99/p999
  attempt latency (r11's WindowedLatencyRecorder) as the headline.

Port of `kubernetes_tpu/perf/churn/` (its departures are in faults.py).
"""

from kubernetes_tpu_torch.perf.churn.arrivals import (
    ArrivalProcess,
    BurstArrivals,
    PoissonArrivals,
    RampArrivals,
    make_arrival_process,
)
from kubernetes_tpu_torch.perf.churn.driver import (
    ChurnDriver,
    find_knee,
    is_saturated,
    run_rate_sweep,
)
from kubernetes_tpu_torch.perf.churn.faults import (
    FaultEvent,
    FaultInjector,
    build_fault_timeline,
)

__all__ = [
    "ArrivalProcess", "PoissonArrivals", "BurstArrivals", "RampArrivals",
    "make_arrival_process", "ChurnDriver", "find_knee", "is_saturated",
    "run_rate_sweep",
    "FaultEvent", "FaultInjector", "build_fault_timeline",
]
