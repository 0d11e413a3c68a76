"""The doubled batch frontend on the CPU: `detect_and_compute_batch` with
doubled=True runs the stacked pipeline over the (B, 2H, 2W) stack of the
upsampled frames' integral images, and on every valid slot equals the
port's single-frame doubled path bit for bit; the port against the
benchmark's plain reference (`portbench/reference/surfref`) within the
`surf_dbl.batch32` cell's limits; and the cell's work counts
(`portbench/rooflines/*_doubled.py`) against a count over the port's own
doubled geometry.

Frames: 3 frames of 240x320 from the cell's renderer
(`portbench/scenes/plane.py`), drawn from a fixed seed; the cell's SURF
settings with max_pts and candidates_per_octave at 1024.
"""

import json

import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, sample_frame
from cuda_surf_tpu_torch.ops.integral import integral_image
from portbench.forms import Outputs, batch
from portbench.reference.judge import Judge
from portbench.rooflines import (describe_doubled, detect_doubled,
                                 integral_doubled)
from portbench.scenes import plane
from portbench.tests.helpers import ROOT
from torch_parity import one_torch_thread  # noqa: F401

KW = dict(noctaves=4, thresh=4.0, upright=True, extended=False,
          doubled=True, max_pts=1024, candidates_per_octave=1024)
B, H, W = 3, 240, 320


@pytest.fixture(scope="module")
def run():
    gen = torch.Generator()
    gen.manual_seed(22)
    mix = {"pool": 1, "frames": B, "motion": 0.01, "sample": 1}
    inputs = plane.make_inputs(mix, {"h": H, "w": W}, gen, "cpu")
    surf = cst.Surf(cst.SurfConfig(**KW), device="cpu")
    return inputs, surf, surf.detect_and_compute_batch(inputs.frames[0])


def _bits(a):
    return a.view(torch.int32) if a.is_floating_point() else a


def test_stacked_doubled_batch_equals_the_single_frame_path(run):
    """Every valid slot's keypoint and descriptor are the single-frame
    doubled path's bit for bit; padding slots are zero."""
    inputs, surf, (kb, db) = run
    assert db.shape == (B, 1024, 64)
    for b in range(B):
        k1, d1 = surf.detect_and_compute(inputs.frames[0, b])
        v = kb.valid[b]
        assert torch.equal(k1.valid, v) and int(k1.count) == int(kb.count[b])
        assert int(kb.count[b]) > 100
        for f in ("x", "y", "scale", "strength", "laplace", "octave"):
            assert torch.equal(_bits(getattr(k1, f)[v]),
                               _bits(getattr(kb, f)[b][v])), f
            assert not getattr(kb, f)[b][~v].any(), f
        assert torch.equal(_bits(d1[v]), _bits(db[b][v]))
        assert not db[b][~v].any()


def test_port_agrees_with_the_reference(run):
    """The port's CPU path (the twins) against the plain reference, judged
    by the batch form within the `surf_dbl.batch32` cell's limits."""
    inputs, surf, (kb, db) = run
    limits = json.loads((ROOT / "portbench" / "limits"
                         / "surf_dbl.batch32.json").read_text())
    j = Judge({"surf": KW}, inputs, torch.device("cpu"), batch, limits)
    sub = lambda t, sl: type(t)(*[f[sl] for f in t])
    m = surf.match(sub(kb, slice(0, B - 1)), db[:-1], sub(kb, slice(1, B)),
                   db[1:])
    acc = j.numbers({0: Outputs([kb], [db], [m])})
    assert set(limits) <= set(acc), acc
    for k, lim in limits.items():
        assert acc[k] <= lim, (k, acc[k], lim)


def test_work_counts_follow_the_ports_doubled_geometry(run):
    """G's bytes are the frames' and the (2H, 2W) integral images'; A's
    response grids and layers are SurfConfig's doubled octave shapes and
    schedule; B's live samples are those that the port's own doubled
    sample frame keeps, counted keypoint by keypoint."""
    inputs, surf, (kb, _) = run
    cfg = surf.cfg
    frames = inputs.frames[0]
    ii = integral_image(frames, True)
    assert integral_doubled.work(B, H, W) == (
        float(frames.numel() + 4 * ii.numel()), 0.0)

    sched, shapes = cfg.hessian_schedule(H, W), cfg.octave_shapes(H, W)
    responses = sum(len(o.scales) * r * c for o, (r, c) in zip(sched, shapes))
    assert detect_doubled.work(KW, H, W) == (
        4.0 * ii[0].numel(), float(detect_doubled.OPS_PER_RESPONSE
                                   * responses))
    with pytest.raises(ValueError):
        detect_doubled.work(dict(KW, doubled=False), H, W)

    for b in range(B):
        v = kb.valid[b]
        x, y, s = kb.x[b][v], kb.y[b][v], kb.scale[b][v]
        geom = desc_geometry(cfg, x, y, s, torch.zeros_like(x))
        ok = sample_frame(cfg, 2 * H, 2 * W, *geom,
                          torch.ones_like(v[v]))[2]
        assert describe_doubled.live_samples(x, y, s, H, W) == int(ok.sum())
        n = int(v.sum())
        nbytes, ops = describe_doubled.work(type(kb)(*[f[b] for f in kb]),
                                            H, W)
        assert (nbytes, ops) == (268.0 * n, 51.0 * int(ok.sum()))
