"""Host microseconds per pod in the benchmark's own create calls (the
store and its watch fan-out on the create path), over the window's part
the per-layer numbers are taken from (`RunRecord.layer`)."""


def read(rec):
    lay = rec.layer
    if not lay.get("created"):
        return None
    return 1e6 * lay["create_s"] / lay["created"]
