"""99th percentile of create-to-bind over the pods created in the window's
part the per-layer numbers are taken from (`RunRecord.layer`; an unbound
pod counts the window's remaining time): how long a burst waits, where
the card idles and the loop sets the wait."""
from schedbench.harness import percentile


def read(rec):
    lat = rec.layer.get("latencies_s")
    if not lat:
        return None
    return 1e3 * percentile(lat, 99)
