"""The check's control, at a size a test run holds: the plain reference put
in the program's place with ties to the highest node index fails the
basic cell's check while the program passes it; in bfloat16 it places
every pod where the program does (see PERF.md: the plan's node states lie
e^50 apart and its ties are exact in any precision)."""

from schedbench import check
from schedbench.control import readings
from schedbench.tests.small import basic_spec


def test_tie_control_fails_the_basic_cell():
    r = readings(basic_spec(), 2 ** 31 + 103, 3.0, device="cpu")
    lim = check.LIMITS["misplaced_per_kpod"]
    assert r["program"]["judged"] > 0
    assert r["program"]["misplaced_per_kpod"] <= lim
    assert r["control_ties_high"]["misplaced_per_kpod"] > lim


def test_bfloat16_places_the_basic_cell_as_float64_does():
    r = readings(basic_spec(), 2 ** 31 + 101, 2.0, device="cpu")
    assert r["program"]["judged"] > 0
    assert r["control_bfloat16"]["misplaced"] == 0
