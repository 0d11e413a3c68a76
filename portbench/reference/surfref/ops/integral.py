"""Integral image and box sums (port of cuda_surf_tpu/ops/integral.py).

The GPU has fast prefix sums, so the integral image is a plain int32
`cumsum`; the JAX package's triangular MXU scans and phase planes are a
TPU workaround and are not ported.  Doubled mode upsamples the frame 2x
before the sums.
"""

from __future__ import annotations

import torch


def integral_image(img: torch.Tensor, doubled: bool = False) -> torch.Tensor:
    """uint8 (H, W) -> int32 (H+1, W+1) zero-padded integral image:
    I[y, x] = sum(img[:y, :x]) (integralRow's (+1,+1) write offset,
    surfd.cu:135-138).  With `doubled` the source is first upsampled 2x
    bilinearly onto the (2H-1, 2W-1) grid, rounding half to even
    (integralDoubleRow0U2, surfd.cu:186-205), so the result is (2H, 2W).
    Exact: the averages are multiples of 1/4 below 2^10, and 255*2H*2W
    stays below 2^31 for any frame the frontend takes."""
    src = img.to(torch.int32)
    if doubled:
        h, w = src.shape
        rn = lambda a, f: torch.round(a.to(torch.float32) * f).to(torch.int32)
        up = torch.zeros((2 * h - 1, 2 * w - 1), dtype=torch.int32,
                         device=img.device)
        up[0::2, 0::2] = src
        up[0::2, 1::2] = rn(src[:, :-1] + src[:, 1:], 0.5)
        up[1::2, 0::2] = rn(src[:-1, :] + src[1:, :], 0.5)
        up[1::2, 1::2] = rn(src[:-1, :-1] + src[:-1, 1:] + src[1:, :-1]
                            + src[1:, 1:], 0.25)
        src = up
    h, w = src.shape
    ii = torch.zeros((h + 1, w + 1), dtype=torch.int32, device=img.device)
    # dtype=int32 explicitly: torch's integer cumsum promotes to int64
    ii[1:, 1:] = torch.cumsum(torch.cumsum(src, 0, dtype=torch.int32), 1,
                              dtype=torch.int32)
    return ii


def box_sum(ii: torch.Tensor, x1, y1, x2, y2):
    """Inclusive rectangle sum over cols [x2..x1], rows [y2..y1]
    (getSum, surfd.cu:334-343).  Index args are int tensors (gather form)."""
    return ii[y1 + 1, x1 + 1] + ii[y2, x2] - ii[y2, x1 + 1] - ii[y1 + 1, x2]


def wavelet_dy(ii, x, y, size):
    """Haar wavelet dy response (getWavelet1, surfd.cu:1171-1175)."""
    return (box_sum(ii, x + size, y, x - size, y - size)
            - box_sum(ii, x + size, y + size, x - size, y))


def wavelet_dx(ii, x, y, size):
    """Haar wavelet dx response (getWavelet2, surfd.cu:1178-1182)."""
    return (box_sum(ii, x + size, y + size, x, y - size)
            - box_sum(ii, x, y + size, x - size, y - size))
