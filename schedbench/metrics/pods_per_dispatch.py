"""Pods handed to the backend per dispatch, counted by the benchmark's
wrapper around the backend object over the dispatches that began in the
window's part the per-layer numbers are taken from (`RunRecord.layer`)."""


def read(rec):
    lay = rec.layer
    if not lay.get("dispatches"):
        return None
    return lay["dispatched"] / lay["dispatches"]
