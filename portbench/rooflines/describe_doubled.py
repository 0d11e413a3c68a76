"""Kernel B's work in doubled mode (`surf_describe*`, csrc/describe.cu's
`describe_kernel`): the upright 64-d descriptor rows of a frame's
keypoints, sampled on the integral image of the frame upsampled 2x.

`rooflines/describe.py`'s count with the doubled sample frame (the
port's desc_geometry in doubled mode, frozen here): each keypoint's x and
y doubled, its window 3.3 x scale in place of 1.65 x scale, and the
(2h, 2w) integral image's borders.  Operations: 51 a live sample.  Bytes:
each valid keypoint's x, y and scale read once (12) and its row written
once (4 x 64); the integral image's reads are not counted.  So both
counts are lower bounds.
"""

from __future__ import annotations

import torch

from portbench.rooflines.describe import (CHUNK, MAG, OPS_PER_LIVE_SAMPLE,
                                          WSZ)

KERNEL = "describe"
WORK_PER_SCALE = 3.3


def live_samples(x, y, scale, h: int, w: int) -> int:
    """Live samples of the keypoints (x, y, scale), 1-d float32 tensors of
    the valid keypoints of one frame of h x w, in the frame's pixels."""
    ih, iw = 2 * h, 2 * w
    total = 0
    for k0 in range(0, x.shape[0], CHUNK):
        xs, ys, ss = (a[k0:k0 + CHUNK].float() for a in (x, y, scale))
        xs, ys = 2 * xs, 2 * ys
        work = WORK_PER_SCALE * ss
        step = torch.clamp(torch.round(work * 0.5), min=1)
        ix, iy = torch.round(xs), torch.round(ys)
        fracc, fracr = xs - ix, ys - iy
        spacing = work * MAG
        iscale = torch.trunc(work)
        irad = torch.round(spacing * ((WSZ + 1) * 0.5) / step)
        R = int(irad.max()) if irad.numel() else 0
        g = torch.arange(-R, R + 1, device=xs.device, dtype=torch.float32)
        gi, gj = g.repeat_interleave(2 * R + 1)[None], g.repeat(2 * R + 1)[None]
        col = lambda a: a[:, None]
        inwin = (gi.abs() <= col(irad)) & (gj.abs() <= col(irad))
        rpos = (col(step) * gi - col(fracr)) / col(spacing)
        cpos = (col(step) * gj - col(fracc)) / col(spacing)
        rx, cx = rpos + (WSZ * 0.5 - 0.5), cpos + (WSZ * 0.5 - 0.5)
        ok = inwin & (rx > -1) & (rx < WSZ) & (cx > -1) & (cx < WSZ)
        r = col(iy) + gi * col(step)
        c = col(ix) + gj * col(step)
        s = col(iscale)
        ok &= (r >= 1 + s) & (r < ih - 1 - s) & (c >= 1 + s) & (c < iw - 1 - s)
        total += int(ok.sum())
    return total


def work(kps, h: int, w: int) -> tuple[float, float]:
    """-> (bytes, operations) of one frame's Keypoints (fields (N,))."""
    v = kps.valid
    n = int(v.sum())
    live = live_samples(kps.x[v], kps.y[v], kps.scale[v], h, w)
    return 12.0 * n + 4.0 * 64 * n, float(OPS_PER_LIVE_SAMPLE * live)
