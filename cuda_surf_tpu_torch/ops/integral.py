"""Integral image and box sums (port of cuda_surf_tpu/ops/integral.py).

`integral_image` launches kernel G (csrc/integral.cu: three launches over
a frame or a whole (B, H, W) stack, no host sync) on a CUDA tensor and
runs the plain twin `_integral_plain`, two int32 `cumsum`s, on a CPU one;
any other device raises.  The JAX package's triangular MXU scans and
phase planes are a TPU workaround and are not ported.  Doubled mode sums
the frame upsampled 2x: kernel G's doubled entry point makes each
upsampled value inside its passes; the twin upsamples first (`_upsample`).
"""

from __future__ import annotations

import torch

from .. import _build

# kernel G's blocks a SM that `band_rows` aims for, and its shortest band
BLOCKS_PER_SM = 8
MIN_BAND_ROWS = 8


def integral_image(img: torch.Tensor, doubled: bool = False,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """uint8 (H, W) -> int32 (H+1, W+1) zero-padded integral image:
    I[y, x] = sum(img[:y, :x]) (integralRow's (+1,+1) write offset,
    surfd.cu:135-138); a (B, H, W) stack -> (B, H+1, W+1), frame by frame.
    With `doubled` the source is first upsampled 2x bilinearly onto the
    (2H-1, 2W-1) grid, rounding half to even (integralDoubleRow0U2,
    surfd.cu:186-205), so the result is (2H, 2W).  Exact: the averages are
    multiples of 1/4 below 2^10, and 255*2H*2W stays below 2^31 for any
    frame the frontend takes.

    CUDA: kernel G, one library call of at most three launches whatever B
    (`surf_integral`, or `surf_integral_doubled` with `doubled`); the
    tensor must be a contiguous uint8 (H, W) or (B, H, W); `out`, a
    contiguous int32 tensor of the result's shape, is written in place of
    a new one.  CPU: the twin `_integral_plain`."""
    dev = img.device
    if dev.type == "cpu":
        res = _integral_plain(img, doubled)
        return res if out is None else out.copy_(res)
    if dev.type != "cuda":
        raise ValueError(f"integral_image: unsupported device {dev}")
    _build.require_cuda(img, "integral_image: img", torch.uint8)
    if img.ndim not in (2, 3) or 0 in img.shape:
        raise ValueError(f"integral_image: expected a (H, W) frame or a "
                         f"(B, H, W) stack, got {tuple(img.shape)}")
    B, h, w = img.shape if img.ndim == 3 else (1, *img.shape)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if out is not None and out.ndim == 2:
        out = out[None]
    gh = 2 * h - 1 if doubled else h        # the rows the sums run over
    out = _integral_cuda(img, band_rows(B, gh, sms), out, doubled)
    return out if img.ndim == 3 else out[0]


def band_rows(nframes: int, h: int, sms: int) -> int:
    """Kernel G's rows a band: as long as lets nframes x bands fill the
    card with BLOCKS_PER_SM blocks a SM, and at least MIN_BAND_ROWS."""
    want = BLOCKS_PER_SM * sms
    return max(MIN_BAND_ROWS, -(-nframes * h // want))


def _integral_cuda(src: torch.Tensor, rows: int,
                   out: torch.Tensor | None = None,
                   doubled: bool = False) -> torch.Tensor:
    """Kernel G on a contiguous uint8 (H, W) or (B, H, W) CUDA tensor at
    bands of `rows` rows -> int32 (B, H+1, W+1), in `out` if given; with
    `doubled`, over the (2H-1, 2W-1) grid of the upsampled frames ->
    (B, 2H, 2W)."""
    B, h, w = src.shape if src.ndim == 3 else (1, *src.shape)
    gh, gw = (2 * h - 1, 2 * w - 1) if doubled else (h, w)
    if gw > 16 * 1024 or B > 65535:
        raise ValueError(f"integral_image: {B} frames of width {w}; kernel "
                         "G takes at most 65535 frames and sums rows of at "
                         "most 16384")
    dev = src.device
    shape = (B, gh + 1, gw + 1)
    if out is None:
        out = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        _build.require_cuda(out, "integral_image: out", torch.int32)
        if tuple(out.shape) != shape or out.device != dev:
            raise ValueError(f"integral_image: out is {tuple(out.shape)} on "
                             f"{out.device}, expected {shape} on {dev}")
    nbands = -(-gh // rows)    # one band needs no scratch: a null pointer
    scratch = torch.empty(B * nbands * (-(-gw // 16) * 16) if nbands > 1
                          else 0, dtype=torch.int32, device=dev)
    # one load of 16 source bytes a row, or of 8 under 16 doubled columns
    load = 8 if doubled else 16
    vec = w % load == 0 and src.data_ptr() % load == 0
    with torch.cuda.device(dev):
        _build.launch("surf_integral_doubled" if doubled else "surf_integral",
                      _build.ptr(src), B, h, w, rows, int(vec),
                      _build.ptr(scratch), _build.ptr(out),
                      _build.stream(dev))
    return out


def _upsample(src: torch.Tensor) -> torch.Tensor:
    """int32 (..., h, w) -> (..., 2h-1, 2w-1): the frames upsampled 2x
    bilinearly, rounding half to even (integralDoubleRow0U2); the twin's
    part of what kernel G's doubled passes make in place."""
    *lead, h, w = src.shape
    rn = lambda a, f: torch.round(a.to(torch.float32) * f).to(torch.int32)
    up = torch.zeros((*lead, 2 * h - 1, 2 * w - 1), dtype=torch.int32,
                     device=src.device)
    up[..., 0::2, 0::2] = src
    up[..., 0::2, 1::2] = rn(src[..., :, :-1] + src[..., :, 1:], 0.5)
    up[..., 1::2, 0::2] = rn(src[..., :-1, :] + src[..., 1:, :], 0.5)
    up[..., 1::2, 1::2] = rn(src[..., :-1, :-1] + src[..., :-1, 1:]
                             + src[..., 1:, :-1] + src[..., 1:, 1:], 0.25)
    return up


def _integral_plain(img: torch.Tensor, doubled: bool = False) -> torch.Tensor:
    """The twin of kernel G: `integral_image` in eager torch, on a
    (..., H, W) tensor of any integer type."""
    src = img.to(torch.int32)
    if doubled:
        src = _upsample(src)
    *lead, h, w = src.shape
    ii = torch.zeros((*lead, h + 1, w + 1), dtype=torch.int32,
                     device=img.device)
    # dtype=int32 explicitly: torch's integer cumsum promotes to int64
    ii[..., 1:, 1:] = torch.cumsum(torch.cumsum(src, -2, dtype=torch.int32),
                                   -1, dtype=torch.int32)
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
