"""The online serving tier's device side: single-pod latency as a path.

The batch cycle is worst at production's most common shape — a trickle of
lone pods that each want a placement in about a millisecond. Counterpart
of `kubernetes_tpu/serving/`, with three of its layers:

- **Resident device planes** (resident.py): the (N, 2R+1) packed used
  state stays warm on the device across placements and is refreshed by
  scattering only the rows the cache's dirty set re-quantized
  (`SchedulerCache` snapshots' `changed_since`), instead of a full upload
  per assign().
- **Pinned single-pod fast path** (fastpath.py + ops/solver.solve_one): a
  fixed-shape C=1 solve against the resident planes — mask → score →
  argmax, no chunk machinery — identical to the batch path's first scan
  step by construction.
- **Adaptive admission window** (admission.py): dispatch immediately when
  arrivals are a trickle, hold the queue open a few ms to coalesce a batch
  under backlog; pure host policy over the tuner's rows
  (`AdaptiveTuner.admission_window`).

Driving a lone pod (on the CPU pass `device="cpu"` to the backend):

    cache = SchedulerCache(); cache.add_node(...)
    backend = TorchBackend()
    fast = SinglePodFastPath(backend, ResidentPlanes(backend))
    node = fast.try_schedule(pi, cache.light_snapshot(), fwk)
    if node is not None:
        cache.assume_pod(pi, node)

The **serving tier** (loop.py, `ServingTier`) wires these into the
scheduler's dispatch loop: `Scheduler.run` delegates each pop to
`schedule_next`, which routes small dispatches pod by pod through the fast
path and the rest to the batch pipeline. `maybe_attach_serving` attaches
it at run()-loop entry when a batched backend is present.

`KTPU_SERVING=0` is the kill switch: the scheduler's run loop degrades
STRUCTURALLY to the pre-serving shape (plain schedule_batch, full
used-state uploads, lone pods on the host path).
"""

from kubernetes_tpu_torch.serving.admission import AdmissionWindow
from kubernetes_tpu_torch.serving.fastpath import SinglePodFastPath
from kubernetes_tpu_torch.serving.loop import ServingTier
from kubernetes_tpu_torch.serving.resident import ResidentPlanes
from kubernetes_tpu_torch.utils import flags

__all__ = [
    "AdmissionWindow",
    "ResidentPlanes",
    "ServingTier",
    "SinglePodFastPath",
    "serving_enabled",
    "maybe_attach_serving",
]


def serving_enabled() -> bool:
    """KTPU_SERVING kill switch; default ON (the serving tier is the
    flagless production shape, like the class planes)."""
    return flags.get("KTPU_SERVING")


def maybe_attach_serving(sched) -> "ServingTier | None":
    """Build (once) and return the scheduler's serving tier, or None when
    the kill switch is set / no batched backend is attached. Called at
    run()-loop entry so tests can flip KTPU_SERVING between runs."""
    if not serving_enabled() or sched.backend is None:
        if sched.serving is not None:
            # Kill switch flipped between runs: detach so the backend's
            # _start returns to full used-state uploads.
            if sched.backend is not None:
                sched.backend.resident = None
            sched.serving = None
        return None
    if sched.serving is None:
        sched.serving = ServingTier(sched)
    return sched.serving
