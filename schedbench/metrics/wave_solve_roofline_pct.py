"""`wave_solve`'s share of its roofline in the traced slice: the least time
of the slice's launches (`bounds.wave_bound_ms`, the work counted from each
chunk's inputs by the reference's walk) over the device time of the
slice's `wave_solve` kernels, in %. The slice begins with a dispatch and
chunks launch in order, one launch each, so its k kernels are the first k
launches of the traced dispatches. Nothing to read where the slice
launched none."""
from schedbench.bounds import wave_bound_ms


def read(rec):
    tr = rec.trace
    if not tr or not tr["wave_solve_kernels"] or tr["wave_solve_device_s"] <= 0:
        return None
    launches = rec.extra.get("traced_launches") or []
    if not launches:
        return None
    launches = launches[: tr["wave_solve_kernels"]]
    bound_ms = sum(wave_bound_ms(*args)[0] for args in launches)
    return 100.0 * bound_ms * 1e-3 / tr["wave_solve_device_s"]
