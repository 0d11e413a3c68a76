"""Kernel D over a stack of frames, and the rotated batch frontend, on the
card.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Kernel D with a frame index gives each keypoint of a (B, ih, iw) stack
the angle the single-frame launch gives it on its frame, bit for bit;
against the twin, angles within 1e-4 rad wherever the top-two window gap
is >= 1e-5 relative, one of the two top windows below that
(`torch_parity.check_orientations`); against the benchmark's plain
reference (`portbench/reference/surfref/ops/orientation.py`), which sums
in the kernel's order, bit for bit.  The rotated batch orients and
describes all its slots in one launch each, and equals the single-frame
path on every valid slot.
"""

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import _build
from cuda_surf_tpu_torch.config import ROTATED_CONFIG
from cuda_surf_tpu_torch.io import main_batch
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orientation_windows)
from portbench.reference.surfref.ops.orientation import orientations
from torch_parity import check_orientations, cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

B = 8


@pytest.fixture(scope="module")
def stack():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    frames = torch.as_tensor(main_batch(B)).cuda()
    cfg = cst.SurfConfig(**ROTATED_CONFIG)
    kb, _ = cst.frontend.detect_and_compute_batch(frames, cfg,
                                                  compute_descriptors=False)
    return frames, cfg, integral_image(frames), kb


def _bits(a):
    return a.view(torch.int32) if a.is_floating_point() else a


def test_kernel_d_on_a_stack_equals_each_frame_and_the_twin(stack):
    """One launch over the 8 stacked 1280x960 frames' 32768 slots: each
    frame's angles those of the single-frame launch bit for bit, within
    the twin's tolerance, and the plain reference's bit for bit; a slot
    whose frame lies outside the stack gets 0; two launches agree."""
    frames, cfg, ii, kb = stack
    P = kb.x.shape[1]
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=ii.device).repeat_interleave(P)
    args = (flat(kb.x), flat(kb.y), flat(kb.scale), flat(kb.valid))
    before = _build.launch_counts["surf_orient"]
    got = assign_orientations(ii, cfg, *args, frame=frame)
    again = assign_orientations(ii, cfg, *args, frame=frame)
    torch.cuda.synchronize()
    assert _build.launch_counts["surf_orient"] == before + 2
    assert torch.equal(_bits(got), _bits(again))
    ref = orientations(ii, *args, frame)[0]
    assert torch.equal(_bits(got), _bits(ref))
    for f in range(B):
        sl = slice(f * P, (f + 1) * P)
        own = assign_orientations(ii[f], cfg, kb.x[f], kb.y[f], kb.scale[f],
                                  kb.valid[f])
        assert torch.equal(_bits(got[sl]), _bits(own)), f
        ws, wa = orientation_windows(ii[f], kb.x[f], kb.y[f], kb.scale[f],
                                     kb.valid[f])
        check_orientations(assign_orientations_plain(
            ii[f], cfg, kb.x[f], kb.y[f], kb.scale[f], kb.valid[f]),
            got[sl], ws, wa, kb.valid[f].cpu().numpy())
    bad = frame.clone()
    bad[:P] = B
    bad[P:2 * P] = -1
    off = assign_orientations(ii, cfg, *args, frame=bad)
    assert not off[:2 * P].any()
    assert torch.equal(_bits(off[2 * P:]), _bits(got[2 * P:]))
    assert int(kb.valid.sum()) > 15000


def test_rotated_batch_launches_d_and_b_once(stack):
    """A rotated batch of 8 launches kernel D once and the stacked kernel
    B once, and no single-frame D or B."""
    frames, cfg, _, _ = stack
    names = ("surf_orient", "surf_describe_stacked", "surf_describe",
             "surf_pyramid", "surf_integral", "surf_extrema")
    before = {n: _build.launch_counts[n] for n in names}
    cst.frontend.detect_and_compute_batch(frames, cfg)
    torch.cuda.synchronize()
    got = {n: _build.launch_counts[n] - before[n] for n in names}
    assert got == {"surf_orient": 1, "surf_describe_stacked": 1,
                   "surf_describe": 0, "surf_pyramid": 1, "surf_integral": 1,
                   "surf_extrema": 1}


def test_rotated_batch_equals_the_single_frame_path(stack):
    """Every valid slot's keypoint, orientation and descriptor are those
    of the single-frame path on the card, bit for bit; padding slots are
    zero."""
    frames, cfg, _, _ = stack
    kb, db = cst.frontend.detect_and_compute_batch(frames, cfg)
    for f in range(B):
        k1, d1 = cst.frontend.detect_and_compute(frames[f], cfg)
        v = kb.valid[f]
        assert torch.equal(k1.valid, v)
        for name in ("x", "y", "scale", "strength", "laplace", "ori",
                     "octave"):
            assert torch.equal(_bits(getattr(k1, name)[v]),
                               _bits(getattr(kb, name)[f][v])), (f, name)
            assert not getattr(kb, name)[f][~v].any(), (f, name)
        assert torch.equal(_bits(d1[v]), _bits(db[f][v])), f
        assert not db[f][~v].any()
    assert float(kb.ori[kb.valid].abs().max()) > 1.0
    assert np.isfinite(db.cpu().numpy()).all()


@pytest.mark.parametrize("mode", [dict(upright=True), dict(),
                                  dict(extended=True), dict(doubled=True),
                                  dict(upright=True, doubled=True)],
                         ids=["upright", "rotated", "extended", "doubled",
                              "doubled_upright"])
def test_surf_batch_replays_its_graph(stack, mode):
    """`Surf.detect_and_compute_batch` runs eagerly at a shape's first
    call and from its second runs kernel G and replays a CUDA graph of the
    rest: every call equals the eager pipeline on its own frames bit for
    bit, a replaying call launches kernel G alone through an entry point
    (doubled: its doubled one), and a later call leaves an earlier call's
    tensors as they were."""
    frames = stack[0][:4]
    other = frames.flip(0)
    cfg = cst.SurfConfig(**dict(ROTATED_CONFIG, **mode))
    want = [cst.frontend.detect_and_compute_batch(f, cfg)
            for f in (frames, other)]
    surf = cst.Surf(cfg, device="cuda")
    first = surf.detect_and_compute_batch(frames)
    second = surf.detect_and_compute_batch(other)
    before = _build.launch_counts.copy()
    third = surf.detect_and_compute_batch(frames)
    torch.cuda.synchronize()
    g = "surf_integral_doubled" if cfg.doubled else "surf_integral"
    assert _build.launch_counts - before == {g: 1}
    for (kp, d), (kw, dw) in ((first, want[0]), (second, want[1]),
                              (third, want[0])):
        for a, b in zip(kp, kw):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(_bits(d), _bits(dw))
    assert int(second[0].count.sum()) > 1000
