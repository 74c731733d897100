"""The backend's share of the wall: the change of
`TorchBackend.timings["assign_s"]` over the seconds of the window's part
the per-layer numbers are taken from (`RunRecord.layer`), in %."""


def read(rec):
    lay = rec.layer
    if "assign_s" not in lay or lay.get("seconds", 0) <= 0:
        return None
    return 100.0 * lay["assign_s"] / lay["seconds"]
