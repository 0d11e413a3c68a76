"""Kernel B's work in its rotated 64-d form (`surf_describe*`,
csrc/describe.cu's `describe_kernel<false, 4>`): the descriptor rows of a
frame's keypoints, each in its window turned by the keypoint's angle.

The live samples of each keypoint come from its position, scale and angle
alone, by this file's frozen copy of the rotated sample-frame arithmetic
(desc_geometry and sample_frame of the port, as they stood when the
benchmark counted them): inside the keypoint's own window, whose radius
is 1.4 times the upright one's so that the turned 4 x 4 cells fit in it,
within reach of the cells once turned, and inside the integral image's
borders.
Operations: 63 a live sample: the upright count's 51
(`rooflines/describe.py`), plus the sample's position turned into the
keypoint's frame 6 and its two responses turned 6.  Samples outside the
window are not counted: a kernel need not visit them.
Bytes: each valid keypoint's x, y, scale and angle read once (16) and its
unnormalised row written once (4 x 64).  The integral image's reads are
not counted.  So both counts are lower bounds.
"""

from __future__ import annotations

import torch

KERNEL = "describe_kernel<false"
OPS_PER_LIVE_SAMPLE = 63
WSZ, MAG, RADIUS_FACTOR = 4, 3, 1.4
CHUNK = 256


def live_samples(x, y, scale, ori, h: int, w: int) -> int:
    """Live samples of the keypoints (x, y, scale, ori), 1-d float32
    tensors of the valid keypoints of one frame of h x w."""
    ih, iw = h + 1, w + 1
    total = 0
    for k0 in range(0, x.shape[0], CHUNK):
        xs, ys, ss, os_ = (a[k0:k0 + CHUNK].float()
                           for a in (x, y, scale, ori))
        work = 1.65 * ss
        step = torch.clamp(torch.round(work * 0.5), min=1)
        ix, iy = torch.round(xs), torch.round(ys)
        fracx, fracy = xs - ix, ys - iy
        spacing = work * MAG
        iscale = torch.trunc(work)
        irad = torch.round(RADIUS_FACTOR * spacing * ((WSZ + 1) * 0.5) / step)
        sn, cs = torch.sin(os_), torch.cos(os_)
        col = lambda a: a[:, None]
        fracr = col(cs * fracy + sn * fracx)
        fracc = col(-sn * fracy + cs * fracx)
        R = int(irad.max()) if irad.numel() else 0
        g = torch.arange(-R, R + 1, device=xs.device, dtype=torch.float32)
        gi, gj = g.repeat_interleave(2 * R + 1)[None], g.repeat(2 * R + 1)[None]
        inwin = (gi.abs() <= col(irad)) & (gj.abs() <= col(irad))
        ti = col(cs) * gi + col(sn) * gj
        tj = -col(sn) * gi + col(cs) * gj
        rpos = (col(step) * ti - fracr) / col(spacing)
        cpos = (col(step) * tj - fracc) / col(spacing)
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
    live = live_samples(kps.x[v], kps.y[v], kps.scale[v], kps.ori[v], h, w)
    return 16.0 * n + 4.0 * 64 * n, float(OPS_PER_LIVE_SAMPLE * live)
