"""The card's idle share of the traced slice: 100 (1 - busy / wall), busy
being the union of its kernel and copy intervals in the profiler's trace."""


def read(rec):
    if not rec.trace or rec.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.trace["busy_s"] / rec.trace["window_s"])
