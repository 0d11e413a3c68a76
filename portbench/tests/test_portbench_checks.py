"""The correctness check fails where it must: the control (the reference
at TF32 in the program's place), each planted fault that a cell's request
form can have (`portbench/faults.py`), and a comparison that never ran,
each through a whole run of a tiny cell on the CPU, the harness's look
for a chip skipped.  On the CPU the program runs its plain twins; the
same faults are read on the card at the cells' own sizes by
`python3 -m portbench.calibrate`."""

import pytest

from portbench import faults, run, traffic
from portbench.tests.helpers import ROOT, TINY, tiny_run

QUIET = dict(log=lambda *a, **k: None)
CELLS = sorted(TINY)


def _form(cell):
    bench = run.load_bench(ROOT)
    return traffic.load_mix(run.cell_spec(bench, cell)[0]["traffic"])["request"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    line = tiny_run(cell, **QUIET)
    assert line["correct"], line["checks"]
    assert line["checks"]["uncompared"]["value"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    line = tiny_run(cell, control=True, **QUIET)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in faults.of_form(_form(c))])
def test_faults_are_not_correct(cell, fault):
    with faults.FAULTS[fault][0]():
        line = tiny_run(cell, **QUIET)
    assert not line["correct"], line["checks"]


def test_a_number_not_computed_fails():
    assert run.check(None, 0) == ({"value": None, "at_most": 0}, False)
    assert run.check(float("inf"), 1.0)[1] is False
    assert run.check(0.0, 0)[1] and run.check(7, {"at_least": 6})[1]
    assert not run.check(5, {"at_least": 6})[1]
    assert not run.check(None, {"at_least": 6})[1]


def test_a_short_window_is_not_correct():
    """Fewer requests in the window than the sample asks for: the check
    counts the missing ones as not compared."""
    line = tiny_run("surf_demo.pairs", seconds=0.0, **QUIET)
    assert line["checks"]["uncompared"]["value"] > 0
    assert not line["correct"]
