"""The accepted per-layer readers read only their own inputs: a record whose
`layer` also carries the port's layer clocks and pod-stage samples (the
keys a harness that snapshots them at its marks would add) reads the
same, metric for metric."""

import copy

from schedbench import harness

CLOCK_KEYS = {
    "record_s": 1.5, "fanout_s": 0.6, "events": 140000, "apply_s": 4.0,
    "snapshot_s": 0.2, "assume_s": 1.1, "bind_s": 5.2, "bound": 40000,
    "drain_s": 0.9, "watch_s": 0.4,
    "informer_lag_s": [0.01 * i for i in range(100)],
    "queue_wait_s": [0.02 * i for i in range(100)],
}


def _record() -> harness.RunRecord:
    return harness.RunRecord(
        seconds=51.0,
        layer={"seconds": 29.5, "created": 40000, "create_s": 2.9,
               "dispatched": 40000, "dispatches": 20,
               "latencies_s": [0.001 * i for i in range(40000)],
               "assign_s": 2.1, "device_s": 0.35},
        trace={"busy_s": 0.045, "window_s": 3.6,
               "wave_solve_device_s": 0.04, "wave_solve_kernels": 2,
               "breakdown": {"device_ops": [], "idle_gaps": []}},
        extra={"traced_launches": [(1024, 5120, 2, 2, 4, 2, 4000)] * 2})


def test_accepted_readers_ignore_the_layer_clock_keys():
    names = [m["name"] for m in harness.load_benchmark()["per_layer"]]
    plain = harness.per_layer(_record(), names)
    assert sorted(plain) == sorted(names)
    rec = _record()
    rec.layer.update(copy.deepcopy(CLOCK_KEYS))
    assert harness.per_layer(rec, names) == plain
