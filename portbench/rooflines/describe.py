"""Kernel B's work (`surf_describe*`, csrc/describe.cu's
`describe_kernel`, and `describe_step_kernel` when routed): the upright
64-d descriptor rows of a frame's keypoints.

The live samples of each keypoint, those that count towards its
descriptor, come from its position and scale alone, by this file's frozen
copy of the upright sample-frame arithmetic (desc_geometry and
sample_frame of the port, as it stood when the benchmark was written):
inside the keypoint's own window, within reach of the 4 x 4 cells, and
inside the integral image's borders.
Operations: 51 a live sample (the Gaussian weight 5, two Haar wavelets of
two box sums each 14, scaling 4, the bilinear cell weights 4, the signed
sums into 4 cells 24).  Samples outside the window are not counted: a
kernel need not visit them.
Bytes: each valid keypoint's x, y and scale read once (12) and its
unnormalised row written once (4 x 64).  The integral image's reads are
not counted: what a window covers depends on the kernel's tiling.  So
both counts are lower bounds.
"""

from __future__ import annotations

import torch

KERNEL = "describe"
OPS_PER_LIVE_SAMPLE = 51
WSZ, MAG = 4, 3          # desc_wsz, 12 // desc_wsz
CHUNK = 512


def _round_even(a):
    return torch.round(a)            # half to even, as CUDA's __float2int_rn


def live_samples(x, y, scale, h: int, w: int) -> int:
    """Live samples of the keypoints (x, y, scale), 1-d float32 tensors of
    the valid keypoints of one frame of h x w."""
    ih, iw = h + 1, w + 1
    total = 0
    for k0 in range(0, x.shape[0], CHUNK):
        xs, ys, ss = (a[k0:k0 + CHUNK].float() for a in (x, y, scale))
        work = 1.65 * ss
        step = torch.clamp(_round_even(work * 0.5), min=1)
        ix, iy = _round_even(xs), _round_even(ys)
        fracc, fracr = xs - ix, ys - iy
        spacing = work * MAG
        iscale = torch.trunc(work)
        irad = _round_even(spacing * ((WSZ + 1) * 0.5) / step)
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
