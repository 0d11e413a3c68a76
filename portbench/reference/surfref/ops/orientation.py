"""Orientation assignment, plain PyTorch: the reference that decides the
rotated cells' `correct`.

Bay, Ess, Tuytelaars, Van Gool, "Speeded-Up Robust Features (SURF)", CVIU
110(3), 2008, sec. 4.1: Haar wavelet responses in x and y, of side 4s,
at the sample points of a circle of radius 6s around the keypoint, at
step s (s the keypoint's scale), weighted by a Gaussian centred on it;
a sliding window of pi/3 sums the weighted responses, and the window of
the longest sum gives the orientation.

Written at the contract of the reference CUDA SURF that the program
ports (assignOrientationApprox, surfd.cu:1711-1960, and its tables,
surf.cpp:85-89 and 360-364), which departs from the paper here:

- the disc is the 253 points (dy, dx) of the 19 x 19 grid with
  dy^2 + dx^2 < 81.5, at step trunc(s + 0.8) px about (round(x),
  round(y)): a radius of about 9 s, not 6 s;
- the wavelets' half side is trunc(2 s + 1.6) px (a side of about 4 s,
  as in the paper); a sample counts only where its whole wavelet lies
  inside the frame, and only with a nonzero response;
- the Gaussian is exp(-(d^2 + 0.5) / 12.5) of the grid distance d^2 in
  steps (sigma 2.5 steps), the response is scaled by 1/255, and the
  sample's weight is that Gaussian times the response's magnitude;
- a sample's angle is the reference's polynomial atan2 (dFastAtan2,
  surfd.cu:114-126), not the exact one;
- the window slides in 72 steps of 5 degrees over a 72-bin histogram of
  the samples' angles: window w's weight is the sum of the weights of
  bins w-5 .. w+5, plus the fractions ((base_l[w] - avg[w]) / 5 deg and
  (avg[w] + base_r[w]) / 5 deg, avg[w] the mean angle of bin w's
  samples, or its lower edge if it has none) of bins w-6 and w+6;
- a window's angle is the weighted mean of its samples' angles (their
  angle x weight sums, turned by 2 pi at the ends of the range), not the
  angle of the summed response vector;
- the first window of the largest weight wins, and the keypoint's angle
  is its weighted mean angle.

Every sum runs in the order of the samples' grid index, each addition
and product rounded to float32 on its own (no fused multiply-add), and
every division is a true float32 division: a sum in another order moves
an angle by float32 rounding, and where the two heaviest windows weigh
within that rounding of each other it may pick the other one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import HWN, NBIN, ORADIUS, ORADIUS_SQ, SEP_ANGLE, WINDOW
from ..config import bin_centers, lut1
from .integral import wavelet_dx, wavelet_dy

_f32 = lambda v: float(np.float32(v))
_PI = _f32(math.pi)
_HALF_PI = _f32(math.pi / 2)
_2PI = _f32(2 * math.pi)
_INV255 = _f32(0.003921568627)
_C0, _C1, _C2 = _f32(-0.0464964749), _f32(0.15931422), _f32(0.327622764)
CHUNK = 8192     # keypoints at a time: bounds the (chunk, 253) samples


def _disc():
    """(dy, dx, dy^2 + dx^2) of the 253 disc points, in grid index order."""
    g = np.arange(-ORADIUS, ORADIUS + 1)
    dy, dx = np.repeat(g, g.size), np.tile(g, g.size)
    d2 = dy * dy + dx * dx
    keep = d2 < ORADIUS_SQ
    return dy[keep], dx[keep], d2[keep]


def _edges(dev):
    """The window edges of the reference's tables, float32: base_l[w] is
    bin (w - 5)'s lower edge plus half the window, less 2 pi where w - 5
    wraps below bin 0; base_r[w] is half the window less bin (w + 6)'s
    lower edge, less 2 pi more where w + 6 wraps past bin 71."""
    bins = np.asarray(bin_centers(), np.float32)
    half = np.float32(WINDOW / 2)
    two_pi = np.float32(2 * math.pi)
    w = np.arange(NBIN)
    lo = bins[(w - HWN + 1) % NBIN] + half
    base_l = np.where(w - HWN + 1 < 0, lo - two_pi, lo).astype(np.float32)
    hi = bins[(w + HWN) % NBIN]
    base_r = (np.where(w + HWN >= NBIN, -two_pi - hi, -hi).astype(np.float32)
              + half)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    return t(bins), t(base_l), t(base_r)


def fast_atan2(y, x):
    """dFastAtan2 (surfd.cu:114-126); (0, 0) gives nan, which callers
    mask."""
    absx, absy = x.abs(), y.abs()
    a = torch.div(torch.minimum(absx, absy), torch.maximum(absx, absy))
    s = a * a
    r = ((_C0 * s + _C1) * s - _C2) * s * a + a
    r = torch.where(absy > absx, _HALF_PI - r, r)
    r = torch.where(x < 0, _PI - r, r)
    return torch.where(y < 0, -r, r)


def _samples(ii, ih, iw, x, y, scale, valid, base):
    """-> (ok, bin, angle, weight), each (k, 253): whether a disc point
    counts, its histogram bin, its angle and its weighted magnitude."""
    dev = x.device
    dy, dx, d2 = (torch.as_tensor(a, dtype=torch.int32, device=dev)
                  for a in _disc())
    s = torch.trunc(2 * scale + _f32(1.6)).to(torch.int32)[:, None]
    step = torch.trunc(scale + _f32(0.8)).to(torch.int32)[:, None]
    xx = torch.round(x).to(torch.int32)[:, None] + dx * step
    yy = torch.round(y).to(torch.int32)[:, None] + dy * step
    ok = ((yy + s + 2 < ih) & (yy - s > -1) & (xx + s + 2 < iw)
          & (xx - s > -1) & valid[:, None])
    xr = torch.where(ok, xx, 1).long()
    yr = torch.where(ok, yy, 1).long() + base[:, None]
    sr = torch.where(ok, s, 0).long()
    rx = wavelet_dx(ii, xr, yr, sr).to(torch.float32) * _INV255
    ry = wavelet_dy(ii, xr, yr, sr).to(torch.float32) * _INV255
    mag = torch.sqrt(rx * rx + ry * ry)
    ok &= mag > 0
    angle = torch.where(ok, fast_atan2(ry, rx), 0.0)
    sep = torch.full_like(angle, _f32(SEP_ANGLE))
    hbin = torch.remainder(torch.trunc(torch.div(angle + _PI, sep)).long(),
                           NBIN)
    lut = torch.tensor(lut1(), dtype=torch.float32, device=dev)
    return ok, hbin, angle, lut[d2.long()] * mag


def _windows(ii, ih, iw, x, y, scale, valid, base):
    """-> (weight, angle sum), each (k, NBIN): every window's."""
    ok, hbin, angle, wt = _samples(ii, ih, iw, x, y, scale, valid, base)
    k, dev = x.shape[0], x.device
    ids = torch.arange(NBIN, device=dev)
    zero = torch.zeros((k, NBIN), dtype=torch.float32, device=dev)
    n, asum, part, apsum = zero.clone(), zero.clone(), zero.clone(), zero
    awt = angle * wt
    for t in range(ok.shape[1]):      # the histogram, sample by sample
        hit = ok[:, t, None] & (hbin[:, t, None] == ids)
        at = lambda v: torch.where(hit, v[:, t, None], 0.0)
        n = n + hit.to(torch.float32)
        asum = asum + at(angle)
        part = part + at(wt)
        apsum = apsum + at(awt)
    bins, base_l, base_r = _edges(dev)
    avg = torch.where(n > 0, torch.div(asum, torch.clamp(n, min=1.0)), bins)
    # the angle x weight sums with the ends turned: slot j + 6 holds bin j,
    # slots 0-5 bins 66-71 less 2 pi, slots 78-83 bins 0-5 plus 2 pi
    pas = torch.cat([apsum[:, NBIN - HWN:] - _2PI * part[:, NBIN - HWN:],
                     apsum, apsum[:, :HWN] + _2PI * part[:, :HWN]], 1)
    ws, was = zero, zero
    for j in range(-HWN + 1, HWN):     # the 11 whole bins, in order
        ws = ws + torch.roll(part, -j, 1)
        was = was + pas[:, HWN + j:HWN + j + NBIN]
    sep = torch.full_like(avg, _f32(SEP_ANGLE))
    left = torch.div(base_l - avg, sep)
    ws = ws + left * torch.roll(part, HWN, 1)
    was = was + left * pas[:, :NBIN]
    right = torch.div(avg + base_r, sep)
    ws = ws + right * torch.roll(part, -HWN, 1)
    was = was + right * pas[:, 2 * HWN:]
    return ws, was


def orientations(ii: torch.Tensor, x, y, scale, valid, frame=None):
    """Keypoints (K,) on an (ih, iw) integral image, or with `frame` (K,)
    on a (B, ih, iw) stack -> (angle, gap, top2), each float32: the angle
    in radians (0 where invalid); the relative gap (best - second) /
    |best| between the two heaviest windows, below which another
    summation order may pick the second; and the two windows' angles
    (K, 2).  Undoubled frames only."""
    ih, iw = ii.shape[-2:]
    K, dev = x.shape[0], x.device
    if frame is None:
        base = torch.zeros((K,), dtype=torch.int64, device=dev)
    else:
        valid = valid & (frame >= 0) & (frame < ii.shape[0])
        base = torch.clamp(frame, 0, ii.shape[0] - 1).long() * ih
    rows = ii.reshape(-1, iw)
    angle = torch.zeros((K,), dtype=torch.float32, device=dev)
    gap = torch.full((K,), float("inf"), dtype=torch.float32, device=dev)
    top2 = torch.zeros((K, 2), dtype=torch.float32, device=dev)
    live = torch.nonzero(valid)[:, 0]
    for k0 in range(0, live.shape[0], CHUNK):
        sel = live[k0:k0 + CHUNK]
        ws, was = _windows(rows, ih, iw, x[sel], y[sel], scale[sel],
                           valid[sel], base[sel])
        first = torch.argmax(ws, 1, keepdim=True)   # the first maximum
        angle[sel] = torch.div(was.gather(1, first),
                               ws.gather(1, first))[:, 0]
        top = torch.topk(ws, 2, dim=1)
        best = top.values
        gap[sel] = torch.div(best[:, 0] - best[:, 1],
                             torch.clamp(best[:, 0].abs(), min=1e-30))
        top2[sel] = torch.div(was.gather(1, top.indices), best)
    return angle, gap, top2
