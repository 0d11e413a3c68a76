"""Kernel D's work (`surf_orient`, csrc/orient.cu's `orient_kernel`): the
orientation of each valid keypoint of a frame.

The live samples of each keypoint, those that count towards its
orientation, come from its position and scale alone, by this file's
frozen copy of the disc's arithmetic (orient_geometry and disc_samples of
the port, as they stood when the benchmark counted them): the 253 points
of the 19 x 19 grid with dy^2 + dx^2 < 81.5, at step trunc(scale + 0.8)
about (round(x), round(y)), whose Haar wavelets of half side
trunc(2 scale + 1.6) lie inside the integral image (on a doubled frame
the 2x upsampled one's, with x, y and scale doubled first).
Operations: 53 a live sample (two Haar wavelets of two box sums each 14,
the magnitude 8, the polynomial atan2 20, the bin and the Gaussian weight
6, the histogram's sums 5), and 72 x 36 a keypoint for its windows (11
whole bins and two fractional edges, weight and angle sums, each window).
A sample whose response is zero is counted: only the image tells it.
Bytes: each valid keypoint's x, y and scale read once (12) and its angle
written once (4).  The integral image's reads are not counted: what the
discs cover depends on the keypoints, and a kernel may share them.  So
both counts are lower bounds.
"""

from __future__ import annotations

import torch

KERNEL = "orient_kernel"
OPS_PER_LIVE_SAMPLE = 53
OPS_PER_KEYPOINT = 72 * 36
RADIUS, RADIUS_SQ = 9, 81.5
CHUNK = 4096


def live_samples(x, y, scale, h: int, w: int, doubled: bool = False) -> int:
    """Live disc samples of the keypoints (x, y, scale), 1-d float32
    tensors of the valid keypoints of one frame of h x w."""
    ih, iw = (2 * h, 2 * w) if doubled else (h + 1, w + 1)
    if doubled:
        x, y, scale = 2 * x, 2 * y, 2 * scale
    g = torch.arange(-RADIUS, RADIUS + 1, device=x.device)
    dy, dx = g.repeat_interleave(g.numel()), g.repeat(g.numel())
    disc = dy * dy + dx * dx < RADIUS_SQ
    dy, dx = dy[disc][None], dx[disc][None]
    total = 0
    for k0 in range(0, x.shape[0], CHUNK):
        xs, ys, ss = (a[k0:k0 + CHUNK].float()[:, None]
                      for a in (x, y, scale))
        s = torch.trunc(2 * ss + 1.6)
        step = torch.trunc(ss + 0.8)
        xx = torch.round(xs) + dx * step
        yy = torch.round(ys) + dy * step
        ok = (yy + s + 2 < ih) & (yy - s > -1) & (xx + s + 2 < iw) \
            & (xx - s > -1)
        total += int(ok.sum())
    return total


def work(kps, h: int, w: int, doubled: bool = False) -> tuple[float, float]:
    """-> (bytes, operations) of one frame's Keypoints (fields (N,))."""
    v = kps.valid
    n = int(v.sum())
    live = live_samples(kps.x[v], kps.y[v], kps.scale[v], h, w, doubled)
    return 16.0 * n, float(OPS_PER_LIVE_SAMPLE * live + OPS_PER_KEYPOINT * n)
