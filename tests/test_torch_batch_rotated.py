"""The rotated batch frontend on the CPU: `detect_and_compute_batch` with
upright=False runs the stacked pipeline (kernel D's twin once over the
(B, ih, iw) stack of integral images, then the stacked describe), and on
every valid slot equals the port's single-frame path bit for bit; the
twin's frame index; and the port against the benchmark's rotated
reference (`portbench/reference/surfref/rotated.py`) within the rotated
cell's limits.

Frames: 3 frames of 240x320 from the `surf_rot.roll32` cell's renderer
(`portbench/scenes/plane_roll.py`), the textured plane turning 20 degrees
a frame, drawn from a fixed seed; the cell's SURF settings with max_pts
and candidates_per_octave at 512 (~155 keypoints a frame).
"""

import json

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import assign_orientations_plain
from portbench.forms import Outputs, batch_rot
from portbench.reference import surfref
from portbench.reference.surfref import rotated
from portbench.reference.judge import Judge
from portbench.reference.surfref.ops.orientation import orientations
from portbench.scenes import plane, plane_roll, render
from portbench.tests.helpers import ROOT
from torch_parity import emulate_kernel_d, one_torch_thread  # noqa: F401

KW = dict(noctaves=4, thresh=4.0, upright=False, extended=False,
          doubled=False, max_pts=512, candidates_per_octave=512)
B = 3


@pytest.fixture(scope="module")
def batch():
    gen = torch.Generator()
    gen.manual_seed(19)
    grids = render.draw_grids(gen, render.PLANE_CELLS, 1, "cpu")
    tex = plane_roll.exposed_texture(grids) * 255.0
    frames = plane_roll.render_rolled(tex, 240, 320, B, 0.01, 20.0)
    surf = cst.Surf(cst.SurfConfig(**KW), device="cpu")
    return frames, surf, surf.detect_and_compute_batch(frames[0])


def _bits(a):
    return a.view(torch.int32) if a.is_floating_point() else a


def test_stacked_rotated_batch_equals_the_single_frame_path(batch):
    """Every valid slot's keypoint, orientation and descriptor are the
    single-frame path's bit for bit; padding slots are zero."""
    frames, surf, (kb, db) = batch
    assert db.shape == (B, 512, 64) and kb.ori.shape == (B, 512)
    for b in range(B):
        k1, d1 = surf.detect_and_compute(frames[0, b])
        v = kb.valid[b]
        assert torch.equal(k1.valid, v) and int(k1.count) == int(kb.count[b])
        assert int(kb.count[b]) > 100
        for f in ("x", "y", "scale", "strength", "laplace", "ori", "octave"):
            assert torch.equal(_bits(getattr(k1, f)[v]),
                               _bits(getattr(kb, f)[b][v])), f
            assert not getattr(kb, f)[b][~v].any(), f
        assert torch.equal(_bits(d1[v]), _bits(db[b][v]))
        assert not db[b][~v].any()
    assert kb.ori[kb.valid].abs().max() > 1.0


def test_twin_with_a_frame_index_equals_it_frame_by_frame(batch):
    """`assign_orientations_plain(..., frame=)` over the stack gives each
    keypoint the angle it gets on its frame alone; a slot whose frame lies
    outside the stack gets 0."""
    frames, surf, (kb, _) = batch
    cfg = surf.cfg
    ii = integral_image(frames[0])
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32).repeat_interleave(512)
    got = assign_orientations_plain(ii, cfg, flat(kb.x), flat(kb.y),
                                    flat(kb.scale), flat(kb.valid), frame)
    for b in range(B):
        own = assign_orientations_plain(ii[b], cfg, kb.x[b], kb.y[b],
                                        kb.scale[b], kb.valid[b])
        assert torch.equal(_bits(got[b * 512:(b + 1) * 512]), _bits(own))
    bad = frame.clone()
    bad[:512] = B
    off = assign_orientations_plain(ii, cfg, flat(kb.x), flat(kb.y),
                                    flat(kb.scale), flat(kb.valid), bad)
    assert not off[:512].any()
    assert torch.equal(_bits(off[512:]), _bits(got[512:]))


def test_reference_orientation_walks_kernel_d_bit_for_bit(batch):
    """The benchmark's plain orientation sums in kernel D's order (the
    samples in grid index order, the windows' bins in order): on frame 1
    its angles equal kernel D's numpy walk (`emulate_kernel_d`) bit for
    bit, and on the stack with a frame index its own per-frame angles."""
    frames, _, (kb, _) = batch
    ii = integral_image(frames[0])
    v = kb.valid[1]
    emu = emulate_kernel_d(ii[1], kb.x[1], kb.y[1], kb.scale[1], v)[0]
    ref, gap, top2 = orientations(ii[1], kb.x[1], kb.y[1], kb.scale[1], v)
    np.testing.assert_array_equal(ref.numpy().view(np.int32),
                                  emu.view(np.int32))
    assert torch.isinf(gap[~v]).all() and (gap[v] >= 0).all()
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32).repeat_interleave(512)
    stacked = orientations(ii, flat(kb.x), flat(kb.y), flat(kb.scale),
                           flat(kb.valid), frame)[0]
    assert torch.equal(_bits(stacked[512:1024]), _bits(ref))


def test_port_agrees_with_the_rotated_reference(batch):
    """The port's CPU path (the twins) against the rotated reference,
    judged by the `surf_rot.roll32` cell's own form within its limits:
    detection exact, angles within `ori_gap`, descriptors and matches of
    the keypoints no near tie or ring edge exempts within theirs."""
    frames, surf, (kb, db) = batch
    limits = json.loads((ROOT / "portbench" / "limits"
                         / "surf_rot.roll32.json").read_text())
    mix = {"pool": 1, "frames": B, "sample": 1}
    j = Judge({"surf": KW}, plane.PlaneInputs(mix, frames),
              torch.device("cpu"), batch_rot, limits)
    sub = lambda t, sl: type(t)(*[f[sl] for f in t])
    m = surf.match(sub(kb, slice(0, B - 1)), db[:-1], sub(kb, slice(1, B)),
                   db[1:])
    acc = j.numbers({0: Outputs([kb], [db], [m])})
    assert set(limits) <= set(acc), acc
    for k, lim in limits.items():
        assert acc[k] <= lim, (k, acc[k], lim)
    assert 0 < acc["ori_gap"] and acc["ori_ties"] < 10


def test_rotated_reference_batch_is_its_single_frame_path(batch):
    """The reference's batch path (the upright batch detection, then one
    orientation and one describe over the stack) gives each valid slot
    what its single-frame path gives, and the control's `Requests` serve
    through it."""
    frames, _, _ = batch
    cfg = surfref.SurfConfig(**KW)
    req = batch_rot.Requests(surfref, {"surf": KW},
                             plane.PlaneInputs({"frames": B}, frames), "cpu")
    out = req(0)
    kr, dr = out.kps[0], out.descs[0]
    for b in range(B):
        k1, d1 = rotated.detect_and_compute(frames[0, b], cfg)
        v = kr.valid[b]
        assert torch.equal(k1.valid, v)
        for f in ("x", "y", "scale", "ori"):
            assert torch.equal(_bits(getattr(k1, f)[v]),
                               _bits(getattr(kr, f)[b][v])), f
        assert torch.equal(_bits(d1[v]), _bits(dr[b][v]))
    assert out.matches[0].index.shape == (B - 1, 512)
