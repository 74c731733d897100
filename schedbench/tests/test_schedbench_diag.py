"""The layer diagnostic (`schedbench/diag_layers.py`) on a small cell on
the CPU: it reads the port's clocks at the harness's marks, gives each
whole round's clocks and the figures over the layer part, leaves the run's
result as `schedbench.run` gives it, and undoes its wrapping."""

import pytest

from schedbench import diag_layers, harness, run
from schedbench.tests.small import basic_spec


def test_the_diagnostic_reads_the_clocks_over_the_part(monkeypatch):
    spec = basic_spec()
    spec["traffic"]["trace_tail_s"] = 1.0
    originals = (harness.Mark, harness._layer, harness.summarize,
                 harness.BindWatch._consume)
    with monkeypatch.context() as m:
        diag_layers.install(m.setattr)
        out, _rows = run.execute(spec, 2 ** 31 + 11, 4.0, False,
                                 device="cpu")
        got = diag_layers.diag()
    assert (harness.Mark, harness._layer, harness.summarize,
            harness.BindWatch._consume) == originals
    assert out["correct"] is True, out["compared"]
    part = got["part"]
    assert part["wall_s"] > 0 and part["events"] > 0
    assert part["bound"] > 0 and part["bind_cycle_us"] > 0
    assert part["store_event_us"] > 0
    assert part["wait_samples"] >= part["bound"] > 0
    assert part["lag_samples"] > 0
    assert 0 < part["ingest_s"] <= part["record_s"]
    assert part["watch_s"] > 0
    assert part["host_unnamed_pct"] < 100
    assert sum(part["share_pct"][k] for k in (
        "create_s", "assign_s", *diag_layers.NAMED)) \
        == pytest.approx(100 - part["host_unnamed_pct"])
    assert got["rounds"] and all(r["wall_s"] > 0 for r in got["rounds"])
