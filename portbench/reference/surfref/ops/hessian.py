"""Box-filter Hessian determinant response pyramid (port of
cuda_surf_tpu/ops/hessian.py): the plain twin of kernel A's layers.

Every box-sum corner is a strided slice of the integral image (stride =
the scale's sampling delta), so a response layer is an elementwise
expression over 32 slices.  Scales 0-1 of octaves > 0 are seeded by 2x
decimation of the previous octave (halfImage, surfd.cu:321-331).  The
expression tree and its evaluation order are the JAX package's, op by
op, so a kernel that keeps the same order without FMA contraction
reproduces these layers bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SurfConfig, ScaleParams

# (1/255)^2 rounded as the JAX package rounds it: f32(r) * f32(r)
RR = float(np.float32(0.003921568627) * np.float32(0.003921568627))


def response_pyramid(ii: torch.Tensor, cfg: SurfConfig, h: int, w: int):
    """-> list over octaves of (max_scale, Ho, Wo) float32 response maps.

    Out-of-border entries are zero, matching the reference's steady-state
    zeroed omem buffer (surf.cpp:347-348).
    """
    shapes = cfg.octave_shapes(h, w)
    sched = cfg.hessian_schedule(h, w)
    pyr = []
    for o in range(cfg.noctaves):
        oh, ow = shapes[o]
        layers = []
        if o > 0:
            prev = pyr[o - 1]
            layers.append(prev[cfg.max_scale - 3, : 2 * oh : 2, : 2 * ow : 2])
            layers.append(prev[cfg.max_scale - 1, : 2 * oh : 2, : 2 * ow : 2])
        for sp in sched[o].scales:
            layers.append(_response_layer(ii, sp, oh, ow))
        pyr.append(torch.stack(layers))
    return pyr


def _response_layer(ii: torch.Tensor, sp: ScaleParams, oh: int, ow: int):
    """One scale's response map: det at output (R, C) reads the integral
    image at (d*R + dy, d*C + dx) for the box-filter corner offsets."""
    b1, d = sp.border1, sp.delta
    ny, nx = oh - 2 * b1, ow - 2 * b1
    out = torch.zeros((oh, ow), dtype=torch.float32, device=ii.device)
    if ny <= 0 or nx <= 0:
        return out

    def corner(dy: int, dx: int):
        y0, x0 = d * b1 + dy, d * b1 + dx
        return ii[y0: y0 + d * (ny - 1) + 1: d, x0: x0 + d * (nx - 1) + 1: d]

    def sbox(x1: int, y1: int, x2: int, y2: int):
        # getSum with static offsets relative to the grid centre
        return (corner(y1 + 1, x1 + 1) + corner(y2, x2)
                - corner(y2, x1 + 1) - corner(y1 + 1, x2))

    m, x2, x3, x4 = sp.mask_size, sp.x2, sp.x3, sp.x4
    dxx = (sbox(m + x2, x3, -m - x2, -x3) - 3 * sbox(x2, x3, -x2, -x3)
           ).to(torch.float32)
    dyy = (sbox(x3, m + x2, -x3, -m - x2) - 3 * sbox(x3, x2, -x3, -x2)
           ).to(torch.float32)
    dxy = 0.6 * (sbox(x4, 0, 0, -x4) + sbox(0, x4, -x4, 0)
                 - sbox(x4, x4, 0, 0) - sbox(0, 0, -x4, -x4)
                 ).to(torch.float32)
    det = RR * (dxx * dyy - dxy * dxy) * float(np.float32(sp.norm))
    out[b1:oh - b1, b1:ow - b1] = det
    return out


def fused_pyramid(ii: torch.Tensor, cfg: SurfConfig, h: int, w: int):
    """-> (pyr, masks): per-octave response layers and NMS candidate masks
    of the (ih, iw) integral image, or (B, ...) of a (B, ih, iw) stack:
    kernel A's plain twin, frame by frame, on any device."""
    from .extrema import _candidate_mask   # it imports this module's peers
    scheds = cfg.hessian_schedule(h, w)
    frames = []
    for frame in (ii if ii.ndim == 3 else ii[None]):
        pyr = response_pyramid(frame, cfg, h, w)
        frames.append((pyr, [_candidate_mask(p, s, cfg)
                             for p, s in zip(pyr, scheds)]))
    if ii.ndim == 2:
        return frames[0]
    return tuple([torch.stack([fr[part][o] for fr in frames])
                  for o in range(cfg.noctaves)] for part in (0, 1))
