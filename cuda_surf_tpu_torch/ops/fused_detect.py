"""Kernel A's wrapper: per-octave response layers + NMS candidate mask
(port of cuda_surf_tpu/ops/fused_detect.py).

On a CUDA tensor `fused_octave` launches kernel A (csrc/detect.cu); on
a CPU tensor `fused_pyramid` takes the plain twins,
`hessian.response_pyramid` and `extrema._candidate_mask`.  Any other
device raises.  The kernel reads its box-sum corners straight from the
int32 integral image, so no phase planes are built.

Layer geometry (`octave_plan`): layer `li` of octave `o` holds, at grid
position (R, C) inside its embed rectangle, the determinant read from
integral-image entries (d*R + dy, d*C + dx), d being the octave's
sampling delta.  For the two seed layers of octaves > 0 the offsets are
the previous octave's scale geometry and the rectangle is the part of
the previous octave's nonzero region that 2x decimation keeps: the
decimated value at R is the previous layer's value at 2R, which read
(d/2)*2R + dy, the same integral-image entry.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _build
from ..config import SurfConfig, ScaleParams
from .extrema import _candidate_mask, nms_windows
from .hessian import RR, response_pyramid


def _corner_offsets(sp: ScaleParams):
    """(dy, dx) of every integral-image corner the layer's box filters read
    (getSum corners of the dxx, dyy and dxy boxes)."""
    m, x2, x3, x4 = sp.mask_size, sp.x2, sp.x3, sp.x4
    boxes = [(m + x2, x3, -m - x2, -x3), (x2, x3, -x2, -x3),
             (x3, m + x2, -x3, -m - x2), (x3, x2, -x3, -x2),
             (x4, 0, 0, -x4), (0, x4, -x4, 0), (x4, x4, 0, 0),
             (0, 0, -x4, -x4)]
    out = []
    for x1, y1, xx2, y2 in boxes:
        out += [(y1 + 1, x1 + 1), (y2, xx2), (y2, x1 + 1), (y1 + 1, xx2)]
    return out


def octave_plan(cfg: SurfConfig, scheds, shapes, o: int, ih: int, iw: int):
    """Static geometry of octave o's kernel A launches."""
    sched = scheds[o]
    oh, ow = shapes[o]
    d = sched.scales[0].delta
    ms = cfg.max_scale
    layers = []  # (r0, r1, c0, c1, ScaleParams)
    if o > 0:
        prev = scheds[o - 1]
        poh, pow_ = shapes[o - 1]
        for li in (ms - 3, ms - 1):
            sp = prev.scales[li - prev.init_scale]
            b1 = sp.border1
            # previous layer is nonzero on [b1, prev_dim - b1); decimated
            # position y maps to 2y
            r_lo, r_hi = -(-b1 // 2), min((poh - b1 + 1) // 2, oh)
            c_lo, c_hi = -(-b1 // 2), min((pow_ - b1 + 1) // 2, ow)
            layers.append((r_lo, max(r_hi, r_lo), c_lo, max(c_hi, c_lo), sp))
    for sp in sched.scales:
        b1 = sp.border1
        r_hi, c_hi = max(oh - b1, b1), max(ow - b1, b1)
        layers.append((b1, r_hi, b1, c_hi, sp))
    if len(layers) != ms:
        raise ValueError(f"octave {o}: {len(layers)} layers, expected {ms}")

    geom = np.zeros((ms, 8), np.int32)
    norm = np.zeros((ms,), np.float32)
    for li, (r0, r1, c0, c1, sp) in enumerate(layers):
        geom[li] = (r0, r1, c0, c1, sp.mask_size, sp.x2, sp.x3, sp.x4)
        norm[li] = np.float32(sp.norm)
        if r1 > r0 and c1 > c0:
            offs = _corner_offsets(sp)
            dys = [dy for dy, _ in offs]
            dxs = [dx for _, dx in offs]
            if (d * r0 + min(dys) < 0 or d * (r1 - 1) + max(dys) > ih - 1
                    or d * c0 + min(dxs) < 0
                    or d * (c1 - 1) + max(dxs) > iw - 1):
                raise ValueError(f"octave {o} layer {li} reads outside the "
                                 "integral image")

    win = np.zeros((ms, 4), np.int32)
    for s, w in nms_windows(sched.maximum_borders(), ms, oh, ow).items():
        win[s] = w
    return dict(d=d, oh=oh, ow=ow, ms=ms, geom=geom, norm=norm, win=win)


def fused_octave(ii: torch.Tensor, plan: dict, cfg: SurfConfig):
    """Kernel A on one octave: int32 integral image (CUDA) ->
    (layers (ms, oh, ow) f32, mask (ms, oh, ow) bool)."""
    _build.require_cuda(ii, "ii", torch.int32)
    ms, oh, ow = plan["ms"], plan["oh"], plan["ow"]
    layers = torch.empty((ms, oh, ow), dtype=torch.float32, device=ii.device)
    mask = torch.empty((ms, oh, ow), dtype=torch.bool, device=ii.device)
    pre_t = float(np.float32(0.8) * np.float32(cfg.thresh))
    with torch.cuda.device(ii.device):
        st = _build.stream(ii.device)
        _build.launch(
            "surf_octave_layers", _build.ptr(ii), ii.shape[1],
            _build.ptr(layers), ms, oh, ow, plan["d"], RR,
            plan["geom"].ctypes.data, plan["norm"].ctypes.data, st)
        _build.launch(
            "surf_octave_mask", _build.ptr(layers), _build.ptr(mask), ms, oh,
            ow, pre_t, plan["win"].ctypes.data, st)
    fused_octave.launches += 1
    return layers, mask


fused_octave.launches = 0


def fused_pyramid(ii: torch.Tensor, cfg: SurfConfig, h: int, w: int):
    """-> (pyr, masks): per-octave response layers and NMS candidate masks.
    CUDA: kernel A, one call per octave.  CPU: the plain twins."""
    scheds = cfg.hessian_schedule(h, w)
    if ii.device.type == "cpu":
        pyr = response_pyramid(ii, cfg, h, w)
        return pyr, [_candidate_mask(p, s, cfg) for p, s in zip(pyr, scheds)]
    if ii.device.type != "cuda":
        raise ValueError(f"fused_pyramid: unsupported device {ii.device}")
    shapes = cfg.octave_shapes(h, w)
    ih, iw = ii.shape
    pyr, masks = [], []
    for o in range(cfg.noctaves):
        layers, mask = fused_octave(
            ii, octave_plan(cfg, scheds, shapes, o, ih, iw), cfg)
        pyr.append(layers)
        masks.append(mask)
    return pyr, masks
