"""Milliseconds of `TorchBackend.timings["device_s"]` (the dispatch of each
chunk's device pass and the wait for its result) per 1,000 pods handed to
the backend, over the window's part the per-layer numbers are taken from
(`RunRecord.layer`)."""


def read(rec):
    lay = rec.layer
    if not lay.get("dispatched") or "device_s" not in lay:
        return None
    return 1e3 * lay["device_s"] / (lay["dispatched"] / 1e3)
