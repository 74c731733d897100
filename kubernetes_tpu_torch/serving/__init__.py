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

The `ServingTier` loop that routes popped pods between this path and the
batch path waits for the slice that ports the scheduler's run loop and
queue.
"""

from kubernetes_tpu_torch.serving.admission import AdmissionWindow
from kubernetes_tpu_torch.serving.fastpath import SinglePodFastPath
from kubernetes_tpu_torch.serving.resident import ResidentPlanes

__all__ = ["AdmissionWindow", "ResidentPlanes", "SinglePodFastPath"]
