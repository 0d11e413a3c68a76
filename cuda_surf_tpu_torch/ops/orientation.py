"""Haar-wavelet orientation assignment (port of
cuda_surf_tpu/ops/orientation.py).

Re-derivation of assignOrientationApprox (surfd.cu:1711-1960): each
keypoint samples Haar dx/dy on the 19x19 disc of radius ORADIUS steps,
bins the sample angles into 72 histograms (count, angle, Gaussian-weighted
magnitude, angle x magnitude), slides a pi/3 window with fractional edges
over them and returns the mean angle of the first window with the largest
weighted magnitude.

`assign_orientations` launches kernel D (csrc/orient.cu) on a CUDA tensor,
on the keypoints' x, y, scale and valid as they are (the kernel takes the
disc's geometry from them itself), and runs the plain twin
`assign_orientations_plain` on a CPU tensor; any other device raises.
The twin follows the JAX package's gather path:
one-hot segment sums per chunk of keypoints, the +/-2pi wrapped copies of
the angle-mass histogram, and the 11-bin window sums as full-fp32
matmuls (the package turns TF32 off).  Invalid slots get 0.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import _build
from ..config import (HWN, NBIN, ORADIUS, ORADIUS_SQ, SEP_ANGLE, WINDOW,
                      SurfConfig, bin_centers, lut1)
from .integral import wavelet_dx, wavelet_dy

# float32 constants as Python floats that float32 represents exactly, so
# that a tensor op with one of them rounds nothing but its own result
_f32 = lambda v: float(np.float32(v))
_PI = _f32(math.pi)
_HALF_PI = _f32(math.pi / 2)
_2PI = _f32(2 * math.pi)
_SEP = _f32(SEP_ANGLE)
_INV255 = _f32(0.003921568627)
_C0, _C1, _C2 = _f32(-0.0464964749), _f32(0.15931422), _f32(0.327622764)

# keypoints per chunk of the twin's histogram stage: bounds its
# (chunk, 361, 72) one-hot
CHUNK = 512


def fast_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Polynomial atan2 approximation (dFastAtan2, surfd.cu:114-126).
    (0, 0) gives 0/0 = nan: callers mask it."""
    absx, absy = x.abs(), y.abs()
    a = torch.minimum(absx, absy) / torch.maximum(absx, absy)
    s = a * a
    r = ((_C0 * s + _C1) * s - _C2) * s * a + a
    r = torch.where(absy > absx, _HALF_PI - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def orient_geometry(x, y, scale, doubled: bool = False):
    """-> (cx, cy, step, pixsi) int32: the disc's centre, its sample
    spacing trunc(scale + 0.8) and the Haar size trunc(2 scale + 1.6).
    In doubled mode the integral image is the 2x upsampled frame's, so x,
    y and scale double first (orientation.py:56-57 of the JAX package)."""
    if doubled:
        x, y, scale = 2 * x, 2 * y, 2 * scale
    pixsi = torch.trunc(2 * scale + _f32(1.6)).to(torch.int32)
    step = torch.trunc(scale + _f32(0.8)).to(torch.int32)
    return (torch.round(x).to(torch.int32), torch.round(y).to(torch.int32),
            step, pixsi)


def _band(offsets, n_in) -> np.ndarray:
    """(n_in, NBIN) 0/1 matrix summing inputs (b + j) for j in offsets
    into output b, inputs taken modulo n_in."""
    w = np.zeros((n_in, NBIN), np.float32)
    idx = np.arange(NBIN)
    for j in offsets:
        w[(idx + j) % n_in, idx] = 1.0
    return w


@functools.lru_cache(maxsize=None)
def tables(device: torch.device) -> dict:
    """The constant tables of the orientation stage, float32 on `device`
    (made once per device, read only): the 83-entry Gaussian LUT, the 72
    bin centres, the per-window bases of the fractional left and right
    edges (orientation.py:155-179 of the JAX package, same numpy
    expressions), the 0/1 band matrices of the 11-bin window sums, and
    the first four packed for kernel D."""
    bins = np.asarray(bin_centers(), np.float32)
    half_w = np.float32(WINDOW / 2)
    idx = np.arange(NBIN)
    kl = idx - HWN
    k1 = (np.where(kl < 0, kl + NBIN, kl) + 1) % NBIN
    base_l = np.where(
        kl < 0,
        bins[k1] + half_w
        - np.where(bins[k1] < 0, 0.0, 2 * math.pi).astype(np.float32),
        bins[np.clip(kl + 1, 0, NBIN - 1)] + half_w)
    kr = idx + HWN
    krw = np.where(kr >= NBIN, kr - NBIN, kr)
    base_r = np.where(kr >= NBIN, -2 * math.pi - bins[krw],
                      -bins[krw]).astype(np.float32) + half_w
    js = range(-HWN + 1, HWN)                       # the 11 whole bins
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    tab = dict(lut=t(lut1()), bins=t(bins), base_l=t(base_l),
               base_r=t(base_r),
               wa=t(_band([j + HWN for j in js], NBIN + 2 * HWN)),
               ws=t(_band(js, NBIN)))
    tab["packed"] = torch.cat([tab[k] for k in ("lut", "bins", "base_l",
                                                "base_r")]).contiguous()
    return tab


def _sample_grid(device):
    g = torch.arange(-ORADIUS, ORADIUS + 1, dtype=torch.int32, device=device)
    n = 2 * ORADIUS + 1
    y1, x1 = g.repeat_interleave(n), g.repeat(n)       # (361,)
    return y1, x1, y1 * y1 + x1 * x1


def disc_positions() -> np.ndarray:
    """Indices (dy + 9) * 19 + (dx + 9) of the 253 grid positions inside
    the disc, increasing: kernel D's table DISC_Q."""
    g = np.arange(-ORADIUS, ORADIUS + 1)
    return np.flatnonzero((g[:, None] ** 2 + g[None, :] ** 2).ravel()
                          < ORADIUS_SQ)


def disc_samples(ii, lut, cx, cy, step, pixsi, valid):
    """-> (ok, bin, angle, psum), each (k, 361): per sample of the 19x19
    grid, in index order, whether it counts (inside the disc and the frame,
    nonzero gradient, valid keypoint), its histogram bin, its angle and
    its Gaussian-weighted magnitude; angle is 0 where not ok."""
    ih, iw = ii.shape
    y1, x1, distsq = _sample_grid(ii.device)
    col = lambda a: a[:, None]
    xx = col(cx) + x1 * col(step)
    yy = col(cy) + y1 * col(step)
    s = col(pixsi)
    ok = ((yy + s + 2 < ih) & (yy - s > -1) & (xx + s + 2 < iw)
          & (xx - s > -1) & (distsq < ORADIUS_SQ) & col(valid))
    # read only where ok (there every corner is in range); a masked
    # sample reads the harmless (1, 1, size 0) wavelet instead
    xr = torch.where(ok, xx, 1).long()
    yr = torch.where(ok, yy, 1).long()
    sr = torch.where(ok, s, 0).long()
    dx = wavelet_dx(ii, xr, yr, sr).to(torch.float32) * _INV255
    dy = wavelet_dy(ii, xr, yr, sr).to(torch.float32) * _INV255
    mag = torch.sqrt(dx * dx + dy * dy)
    ok &= mag > 0
    # fast_atan2(0, 0) is nan, and nan * 0 stays nan: mask by where
    angle = torch.where(ok, fast_atan2(dy, dx), 0.0)
    hid = torch.remainder(torch.trunc((angle + _PI) / _SEP).to(torch.int64),
                          NBIN)
    psum = lut[torch.clamp(distsq, max=lut.shape[0] - 1).long()] * mag
    return ok, hid, angle, psum


def _histogram_chunk(ii, lut, cx, cy, step, pixsi, valid):
    """-> (k, NBIN, 4) per-bin sums [count, angle, psum, angle*psum] for a
    chunk of keypoints (the JAX gather path's `one`, batched)."""
    ok, hid, angle, psum = disc_samples(ii, lut, cx, cy, step, pixsi, valid)
    onehot = (torch.where(ok, hid, NBIN)[..., None]
              == torch.arange(NBIN, device=ii.device)).to(torch.float32)
    vals = torch.stack([torch.ones_like(psum), angle, psum, angle * psum], -1)
    vals = torch.where(ok[..., None], vals, 0.0)
    return torch.bmm(onehot.transpose(1, 2), vals)        # (k, NBIN, 4)


def window_sums(sums: torch.Tensor, tab: dict):
    """The pi/3 sliding window over the per-bin sums (K, NBIN, 4) ->
    (win_sums, win_asums), each (K, NBIN): window w's weighted magnitude
    and weighted angle sum, with the fractional left and right edges."""
    hist, angsum, part_sums, angpsum = sums.unbind(-1)
    avg = torch.where(hist > 0, angsum / torch.clamp(hist, min=1.0),
                      tab["bins"][None, :])
    # part_angle_sums with wrapped copies (surfd.cu:1798-1806): slot b+HWN
    # holds bin b; low slots hold bins 66..71 shifted by -2pi, high slots
    # bins 0..5 shifted by +2pi
    pas = torch.cat([angpsum[:, NBIN - HWN:] - _2PI * part_sums[:, NBIN - HWN:],
                     angpsum,
                     angpsum[:, :HWN] + _2PI * part_sums[:, :HWN]], 1)
    win_asums = torch.matmul(pas, tab["wa"])
    win_sums = torch.matmul(part_sums, tab["ws"])
    # left edge j = -HWN: bin (w - HWN) % NBIN, wrapped slot w
    ratio_l = (tab["base_l"][None, :] - avg) / _SEP
    win_sums = win_sums + ratio_l * torch.roll(part_sums, HWN, dims=1)
    win_asums = win_asums + ratio_l * pas[:, :NBIN]
    # right edge j = +HWN: bin (w + HWN) % NBIN, wrapped slot w + 2 HWN
    ratio_r = (avg + tab["base_r"][None, :]) / _SEP
    win_sums = win_sums + ratio_r * torch.roll(part_sums, -HWN, dims=1)
    win_asums = win_asums + ratio_r * pas[:, 2 * HWN:]
    return win_sums, win_asums


def orientation_windows(ii: torch.Tensor, x, y, scale, valid,
                        doubled: bool = False):
    """-> (win_sums, win_asums), each (K, NBIN), of the plain twin."""
    tab = tables(ii.device)
    geom = orient_geometry(x, y, scale, doubled) + (valid,)
    K = x.shape[0]
    parts = [_histogram_chunk(ii, tab["lut"], *[a[k0:k0 + CHUNK] for a in geom])
             for k0 in range(0, K, CHUNK)]
    sums = (torch.cat(parts) if parts else
            torch.zeros((0, NBIN, 4), dtype=torch.float32, device=ii.device))
    return window_sums(sums, tab)


def top2_windows(win_sums: torch.Tensor, win_asums: torch.Tensor):
    """The two windows with the largest weighted magnitude, per keypoint
    -> (gap, angles): gap (K,) = (best - second) / |best|, below ~1e-5 a
    different summation order may pick the other window; angles (K, 2)
    are the two windows' mean angles, the answers either pick gives."""
    top = torch.topk(win_sums, 2, dim=1)
    best = top.values
    gap = (best[:, 0] - best[:, 1]) / torch.clamp(best[:, 0].abs(), min=1e-30)
    return gap, torch.gather(win_asums, 1, top.indices) / best


def assign_orientations_plain(ii: torch.Tensor, cfg: SurfConfig, x, y, scale,
                              valid) -> torch.Tensor:
    """Kernel D's plain twin -> (K,) float32 angles, 0 on invalid slots."""
    win_sums, win_asums = orientation_windows(ii, x, y, scale, valid,
                                              cfg.doubled)
    sel = torch.argmax(win_sums, dim=1, keepdim=True)  # first maximum
    ori = (torch.gather(win_asums, 1, sel) / torch.gather(win_sums, 1, sel))
    return torch.where(valid, ori[:, 0], 0.0)


def assign_orientations(ii: torch.Tensor, cfg: SurfConfig, x, y, scale,
                        valid) -> torch.Tensor:
    """(K,) keypoints -> (K,) float32 orientations in radians, 0 on
    invalid slots.  Kernel D on a CUDA tensor, the twin on a CPU one."""
    if ii.device.type == "cpu":
        return assign_orientations_plain(ii, cfg, x, y, scale, valid)
    if ii.device.type != "cuda":
        raise ValueError(f"assign_orientations: unsupported device "
                         f"{ii.device}")
    _build.require_cuda(ii, "ii", torch.int32)
    K = x.shape[0]
    x, y, scale = x.contiguous(), y.contiguous(), scale.contiguous()
    valid = valid.to(torch.bool).contiguous()
    for name, t in (("x", x), ("y", y), ("scale", scale)):
        _build.require_cuda(t, name, torch.float32)
    _build.require_cuda(valid, "valid", torch.bool)
    if not x.shape == y.shape == scale.shape == valid.shape == (K,):
        raise ValueError("assign_orientations: x, y, scale and valid must "
                         "all be (K,)")
    ftab = tables(ii.device)["packed"]
    out = torch.empty((K,), dtype=torch.float32, device=ii.device)
    ih, iw = ii.shape
    with torch.cuda.device(ii.device):
        _build.launch("surf_orient", _build.ptr(ii), ih, iw, _build.ptr(x),
                      _build.ptr(y), _build.ptr(scale), _build.ptr(valid),
                      int(cfg.doubled), _build.ptr(ftab), K, _build.ptr(out),
                      _build.stream(ii.device))
    assign_orientations.launches += 1
    return out


assign_orientations.launches = 0
