"""The cell on the card at its full size, with a short window: the run is
correct and the control fails its check. Run on a machine with
a card: `python -m pytest -m cuda schedbench/tests`."""

import pytest

from schedbench import check, harness
from schedbench.control import readings


@pytest.mark.cuda
@pytest.mark.parametrize("cell,control", [
    ("basic-5000n-burst", "control_ties_high")])
def test_cell_is_correct_and_its_control_is_not(cuda_device, cell, control):
    spec = harness.cell_spec(harness.load_benchmark(), cell)
    r = readings(spec, 2 ** 31 + 977, 6.0, device=cuda_device)
    lim = check.LIMITS["misplaced_per_kpod"]
    assert r["program"]["judged"] > 0
    for k, v in r["program"].items():
        if k in check.LIMITS:
            assert v <= check.LIMITS[k], (k, v)
    assert r[control]["misplaced_per_kpod"] > lim
