"""Kernel F (csrc/extrema.cu), the compaction and subpixel walk of
`ops.extrema.detect`, against its plain twin `_detect_plain`, both on the
card and on the same layers and masks of kernel A.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Every output field and both counts equal the twin's bit for bit (float
fields compared as their int32 bits, so NaN payloads count too): on a
1280x960 frame of the main configuration, a 640x480 frame of the VO
configuration and a doubled frame; on a stack of 8 frames, where each
frame's keypoints also equal the frame's own call; on dense random masks
that overflow both the capacity and the max(cap // 8, 64) walker set; and
on a frame with no candidate.  One call is one count of `surf_extrema`
on `_build.launch_counts`, one call of the kernel library and no host
synchronisation.
"""

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import _build
from cuda_surf_tpu_torch.config import DOUBLED_CONFIG, MAIN_CONFIG, VO_CONFIG
from cuda_surf_tpu_torch.io import main_batch, render_plane_sequence
from cuda_surf_tpu_torch.ops.extrema import (_cell_windows, _detect_plain,
                                             detect)
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

FIELDS = ("valid", "nx", "ny", "ns", "strength", "octave", "frame", "count",
          "walkers")


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _assert_equal(got, want, what):
    for k in FIELDS:
        a, b = _bits(got[k]), _bits(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, (what, k)
        bad = (a != b).nonzero()
        assert bad.numel() == 0, (what, k, bad[:8].flatten().tolist(),
                                  a.flatten()[bad[:8].flatten()].tolist(),
                                  b.flatten()[bad[:8].flatten()].tolist())


def _pyramid(frames, cfg, dev):
    """Kernel A's layers and masks of a (H, W) frame or a (B, H, W) stack."""
    img = torch.as_tensor(frames, device=dev)
    h, w = img.shape[-2:]
    pyr, masks = fused_pyramid(integral_image(img, cfg.doubled), cfg, h, w)
    return pyr, masks, cfg.hessian_schedule(h, w)


def _both(pyr, masks, scheds, cfg, what, **kw):
    got = detect(pyr, scheds, cfg, masks, **kw)
    want = _detect_plain(pyr, scheds, cfg, masks, **kw)
    _assert_equal(got, want, what)
    return got


@pytest.mark.parametrize("name", ["main", "vo", "doubled"])
def test_kernel_f_equals_twin_on_a_frame(cuda_device, name):
    """The main configuration on a 1280x960 frame, the VO configuration on
    a 640x480 frame, the doubled main configuration on a 1280x960 frame."""
    if name == "vo":
        frame = render_plane_sequence(1, 480, 640, seed=5)[0][0]
        cfg = cst.SurfConfig(**VO_CONFIG)
    else:
        frame = main_batch(1)[0]
        cfg = cst.SurfConfig(**(DOUBLED_CONFIG if name == "doubled"
                                else MAIN_CONFIG))
    out = _both(*_pyramid(frame, cfg, cuda_device), cfg, name)
    assert 100 < int(out["count"]) < cfg.max_candidates
    assert int(out["valid"].sum()) > 100


def test_kernel_f_on_a_stack_equals_the_frames_one_by_one(cuda_device):
    """Eight stacked frames: the union equals the twin bit for bit, and
    each frame's keypoints, in order, equal its own single-frame call's."""
    cfg = cst.SurfConfig(**MAIN_CONFIG)
    frames = main_batch(8)
    stack = _both(*_pyramid(frames, cfg, cuda_device), cfg, "stack",
                  nframes=8)
    assert set(stack["frame"][stack["valid"]].tolist()) == set(range(8))
    for f in range(8):
        pyr, masks, scheds = _pyramid(frames[f], cfg, cuda_device)
        one = detect(pyr, scheds, cfg, masks)
        mine = stack["valid"] & (stack["frame"] == f)
        for k in ("nx", "ny", "ns", "strength", "octave"):
            assert torch.equal(_bits(stack[k][mine]),
                               _bits(one[k][one["valid"]])), (f, k)


def test_kernel_f_overflows_cap_and_walkers_like_the_twin(cuda_device):
    """Dense random masks inside the cell windows: the candidates overflow
    the capacity (truncation in index order; on a stack of two, inside
    frame 1) and the step-1 movers overflow the max(cap // 8, 64) walker
    set, whose overflow keeps its first fit."""
    cfg = cst.SurfConfig(**MAIN_CONFIG)
    for nframes in (1, 2):
        frames = render_plane_sequence(nframes, 480, 640, seed=9)[0]
        pyr, _, scheds = _pyramid(frames if nframes > 1 else frames[0], cfg,
                                  cuda_device)
        rng = np.random.default_rng(nframes)
        density = 0.3 if nframes == 1 else 0.004
        masks = []
        for o, p in enumerate(pyr):
            row_ok, col_ok = _cell_windows(scheds[o], *p.shape[-3:])
            m = row_ok & col_ok & (rng.random(tuple(p.shape)) < density)
            masks.append(torch.as_tensor(m, device=cuda_device))
        last = int(sum(m[-1].sum() for m in masks)) if nframes > 1 else 0
        n = int(sum(m.sum() for m in masks))
        cap = 512 if nframes == 1 else (n - last // 2) // nframes
        out = _both(pyr, masks, scheds, cfg, f"dense x{nframes}", cap=cap,
                    nframes=nframes)
        assert int(out["count"]) == cap * nframes < n
        assert int(out["walkers"]) > max(cap * nframes // 8, 64)
        if nframes > 1:   # the cut falls inside the last frame
            assert int(out["frame"][cap * nframes - 1]) == nframes - 1


def test_kernel_f_empty_frame_launches_and_refusals(cuda_device):
    """No candidate: every slot empty, as the twin's.  One call: one count
    of `surf_extrema` on `_build.launch_counts`, one call of the kernel
    library (its three launches) and no host synchronisation.  Mixed devices, wrong types and
    shapes raise."""
    cfg = cst.SurfConfig(**VO_CONFIG)
    frame = render_plane_sequence(1, 480, 640, seed=5)[0][0]
    pyr, masks, scheds = _pyramid(frame, cfg, cuda_device)
    empty = [torch.zeros_like(m) for m in masks]
    out = _both(pyr, empty, scheds, cfg, "empty")
    assert int(out["count"]) == 0 and int(out["walkers"]) == 0
    assert not out["valid"].any()

    detect(pyr, scheds, cfg, masks)    # the plan is built and copied once
    torch.cuda.synchronize()
    before = _build.launch_counts["surf_extrema"]
    with _build.record_launches() as rec:
        torch.cuda.set_sync_debug_mode("error")
        try:
            detect(pyr, scheds, cfg, masks)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _build.launch_counts["surf_extrema"] == before + 1
    assert [name for name, *_ in rec] == ["surf_extrema"]

    bad = [
        ([p.cpu() if o == 1 else p for o, p in enumerate(pyr)], masks, {}),
        (pyr, [m.cpu() for m in masks], {}),
        ([p.double() for p in pyr], masks, {}),
        (pyr, [m.to(torch.uint8) for m in masks], {}),
        (pyr, [m[:, 1:] for m in masks], {}),
        (pyr, masks, {"nframes": 2}),
        ([p.transpose(-1, -2).contiguous().transpose(-1, -2) for p in pyr],
         masks, {}),
        (pyr[:2], masks[:2], {}),
    ]
    for p, m, kw in bad:
        with pytest.raises(ValueError):
            detect(p, scheds, cfg, m, **kw)
    with pytest.raises(ValueError):
        detect(pyr, scheds, cfg, masks, cap=0)
    assert _build.launch_counts["surf_extrema"] == before + 1
