"""The rotated cell, `surf_rot.roll32`, through whole runs at a tiny size
on the CPU (the program runs its plain twins): a sound run is correct,
the control (the rotated reference at TF32 in the program's place) is
not, and the rolled scene refuses a camera path that leaves the
texture."""

import pytest
import torch

from portbench import run
from portbench.scenes import plane_roll, render
from portbench.tests.helpers import ROOT, TINY_SURF

CELL = "surf_rot.roll32"
TINY = dict(TINY_SURF, mix=dict(TINY_SURF["mix"], frames=3))
QUIET = dict(log=lambda *a, **k: None)


def _run(**kw):
    return run.run(CELL, 11, kw.pop("seconds", 2.0), False, device="cpu",
                   root=ROOT, overrides=TINY, **kw)


def test_sound_run_is_correct():
    line = _run(**QUIET)
    assert line["correct"], line["checks"]
    checks = line["checks"]
    assert checks["uncompared"]["value"] == 0
    assert {"ori_gap", "ori_ties", "desc_gap"} <= set(checks)


def test_control_is_not_correct():
    line = _run(control=True, **QUIET)
    assert not line["correct"], line["checks"]


def test_the_scene_stays_on_the_texture():
    tex = torch.zeros((1, render.T, render.T), dtype=torch.float64)
    frames = plane_roll.render_rolled(tex, 96, 128, 32, 0.01, 20.0)
    assert frames.shape == (1, 32, 96, 128)
    with pytest.raises(ValueError, match="leaves the texture"):
        plane_roll.render_rolled(tex, 96, 128, 32, 0.05, 20.0)
