"""SURF descriptors, 64-d or extended 128-d, upright or rotated (port of
cuda_surf_tpu/ops/descriptor.py).

Re-derivation of describeURWithoutNormalization /
describeApproxWithoutNormalization + placeInIndex + normalize
(surfd.cu:1288-1317, 1566-1615, 2391-2444, 1199-1271, 2447-2493).
`describe` computes each keypoint's sampling geometry, gets the
unnormalised rows from `describe_plain` and L2-normalises them.
`_describe_chunk` is kernel B's plain twin: the gather formulation of the
JAX package's `_describe_chunk`, with the bilinear binning as a one-hot
contraction.  With a per-keypoint `frame` index the integral image is a
(B, ih, iw) stack of B frames': every keypoint reads its own frame only,
and its border tests are frame-local.

Rounding: `torch.round` is half-to-even, as `jnp.round` is.
"""

from __future__ import annotations

import torch

from ..config import SurfConfig
from .integral import wavelet_dx, wavelet_dy


def desc_geometry(cfg: SurfConfig, x, y, scale, ori):
    """Per-keypoint sampling geometry (describeUR*, surfd.cu:1373-1387;
    rotated x1.4 at surfd.cu:2428) -> (ix, iy, step, iscale, iradius,
    fracr, fracc, spacing, sine, cose).  Upright, `ori` is ignored and
    sine and cose are None: the sample frame is the image frame.  In
    doubled mode the integral image is the 2x upsampled frame's, so x and
    y double and the window is 3.3 scale (describe, descriptor.py:58-62 of
    the JAX package)."""
    if cfg.doubled:
        x, y = 2 * x, 2 * y
        work = 3.3 * scale
    else:
        work = 1.65 * scale
    step = torch.clamp(torch.round(work * 0.5).to(torch.int32), min=1)
    ix = torch.round(x).to(torch.int32)
    iy = torch.round(y).to(torch.int32)
    fracx = x - ix.to(torch.float32)
    fracy = y - iy.to(torch.float32)
    spacing = work * float(cfg.mag_factor)
    iscale = torch.trunc(work).to(torch.int32)
    radf = 1.0 if cfg.upright else 1.4
    iradius = torch.round(radf * spacing * float((cfg.desc_wsz + 1) * 0.5)
                          / step.to(torch.float32)).to(torch.int32)
    if cfg.upright:
        return ix, iy, step, iscale, iradius, fracy, fracx, spacing, None, None
    sine, cose = torch.sin(ori), torch.cos(ori)
    fracr = cose * fracy + sine * fracx
    fracc = -sine * fracy + cose * fracx
    return ix, iy, step, iscale, iradius, fracr, fracc, spacing, sine, cose


def describe(ii: torch.Tensor, cfg: SurfConfig, x, y, scale, ori, valid,
             frame=None):
    """-> (K, nfeatures) float32 L2-normalised descriptors; `ori` (K,)
    in radians, ignored when upright.  `frame` (K,) int32: `ii` is a
    (B, ih, iw) stack and keypoint k lies in frame `frame[k]`, its x and y
    frame-local."""
    rows = describe_plain(ii, cfg, *desc_geometry(cfg, x, y, scale, ori),
                          valid, frame=frame)
    return l2_normalize(rows)


def sample_frame(cfg: SurfConfig, ih, iw, ix, iy, step, iscale, iradius,
                 fracr, fracc, spacing, sine, cose, valid):
    """The static (2R+1)^2 sample grid of k keypoints in their sample
    frames -> (rpos, cpos, ok, r, c), each (k, S): the sample's position
    in units of the spacing (turned by the orientation unless upright),
    whether it counts (in the keypoint's own window, in the 4x4 cells'
    reach and inside the image), and its image row and column."""
    wsz = cfg.desc_wsz
    n, R = cfg.desc_grid, cfg.max_iradius
    g = torch.arange(n, dtype=torch.int32, device=ix.device) - R
    i_ = g.repeat_interleave(n)[None]      # (1, S)
    j_ = g.repeat(n)[None]
    col = lambda a: a[:, None]             # (k, 1)

    inwin = ((i_.abs() <= col(iradius)) & (j_.abs() <= col(iradius))
             & col(valid))
    stepf = col(step.to(torch.float32))
    fi, fj = i_.to(torch.float32), j_.to(torch.float32)
    if cfg.upright:
        ti, tj = fi, fj
    else:
        sn, cs = col(sine), col(cose)
        ti, tj = cs * fi + sn * fj, -sn * fi + cs * fj
    rpos = (stepf * ti - col(fracr)) / col(spacing)
    cpos = (stepf * tj - col(fracc)) / col(spacing)
    rx = rpos + (wsz * 0.5 - 0.5)
    cx = cpos + (wsz * 0.5 - 0.5)
    ok = inwin & (rx > -1) & (rx < wsz) & (cx > -1) & (cx < wsz)
    r = col(iy) + i_ * col(step)
    c = col(ix) + j_ * col(step)
    s = col(iscale)
    ok &= (r >= 1 + s) & (r < ih - 1 - s) & (c >= 1 + s) & (c < iw - 1 - s)
    return rpos, cpos, ok, r, c


def _describe_chunk(ii, cfg: SurfConfig, ih, iw, ix, iy, step, iscale,
                    iradius, fracr, fracc, spacing, sine, cose, valid,
                    base=None):
    """Kernel B's plain twin on a chunk of k keypoints -> (k, nfeatures)
    unnormalised rows.  Samples the static (2R+1)^2 grid and masks it to
    each keypoint's own window, as the JAX package does.  `ii` is
    (rows, iw); `base` (k,) is the row at which each keypoint's (ih, iw)
    frame starts in it: the border tests use the frame-local row, the
    reads the row plus `base`."""
    wsz = cfg.desc_wsz
    dev = ii.device
    rpos, cpos, ok, r, c = sample_frame(cfg, ih, iw, ix, iy, step, iscale,
                                        iradius, fracr, fracc, spacing, sine,
                                        cose, valid)
    rx = rpos + (wsz * 0.5 - 0.5)
    cx = cpos + (wsz * 0.5 - 0.5)
    s = iscale[:, None]
    widx = torch.trunc(rpos * rpos + cpos * cpos)
    # lookup2[n] = exp(-(n+.5)/8) (surf.cpp:366-370)
    weight = torch.exp(-(torch.clamp(widx, 0, 39) + 0.5) * 0.125)
    rc = torch.clamp(r, s, ih - s - 2).long()
    if base is not None:
        rc = rc + base[:, None].long()
    cc = torch.clamp(c, s, iw - s - 2).long()
    sl = s.long()
    dxx = weight * wavelet_dx(ii, cc, rc, sl).to(torch.float32) * 0.003921568627
    dyy = weight * wavelet_dy(ii, cc, rc, sl).to(torch.float32) * 0.003921568627
    if cfg.upright:
        dx, dy = dxx, dyy
    else:   # the responses turned into the keypoint's frame
        sn, cs = sine[:, None], cose[:, None]
        dx = cs * dxx + sn * dyy
        dy = sn * dxx - cs * dyy

    # placeInIndex as a one-hot contraction; masked samples (whose
    # geometry may be inf/nan for invalid slots) contribute exact zeros
    rx = torch.where(ok, rx, 0.0)
    cx = torch.where(ok, cx, 0.0)
    ri, ci = torch.floor(rx), torch.floor(cx)
    rfrac, cfrac = rx - ri, cx - ci
    cells = torch.arange(wsz, device=dev)

    def axis_w(i0, frac):
        i0 = i0.long()[..., None]
        return ((i0 == cells) * (1 - frac)[..., None]
                + ((i0 + 1) == cells) * frac[..., None])   # (k, S, wsz)

    rw = torch.where(ok[..., None], axis_w(ri, rfrac), 0.0)
    cw = axis_w(ci, cfrac)
    dx = torch.where(ok, dx, 0.0)
    dy = torch.where(ok, dy, 0.0)
    zero = torch.zeros_like(dx)
    split = lambda neg, v: [torch.where(neg, v, zero), torch.where(neg, zero, v)]
    if not cfg.extended:
        ov = split(dx < 0, dx) + split(dy < 0, dy)
    else:   # split by the signs of the unturned responses
        neg_y, neg_x = dyy < 0, dxx < 0
        ov = (split(neg_y, dx) + split(neg_y, dx.abs())
              + split(neg_x, dy) + split(neg_x, dy.abs()))
    ov = torch.stack(ov, -1)                                 # (k, S, osz)
    co = (cw[..., :, None] * ov[..., None, :]).flatten(2)    # (k, S, wsz*osz)
    desc = torch.einsum("ksr,ksx->krx", rw, co)              # (k, wsz, wsz*osz)
    return desc.reshape(desc.shape[0], -1)


# keypoints per chunk of the twin: bounds its (chunk, (2R+1)^2, wsz*osz)
# samples
CHUNK = 256


def describe_plain(ii: torch.Tensor, cfg: SurfConfig, ix, iy, step, iscale,
                   iradius, fracr, fracc, spacing, sine, cose, valid,
                   frame=None):
    """Kernel B's plain twin over all keypoints, in chunks of CHUNK.
    With `frame` (K,), `ii` is a (B, ih, iw) stack of frames."""
    ih, iw = ii.shape[-2:]
    base = None
    if frame is not None:
        ii = ii.reshape(-1, iw)
        # a slot's frame outside [0, B) is never read: masked, and clamped
        base = torch.clamp(frame, 0, ii.shape[0] // ih - 1) * ih
        valid = valid & (frame >= 0) & (frame < ii.shape[0] // ih)
    args = (ix, iy, step, iscale, iradius, fracr, fracc, spacing, sine, cose,
            valid, base)
    parts = [_describe_chunk(ii, cfg, ih, iw,
                             *[None if a is None else a[k0:k0 + CHUNK]
                               for a in args])
             for k0 in range(0, ix.shape[0], CHUNK)]
    if not parts:
        return torch.zeros((0, cfg.nfeatures), dtype=torch.float32,
                           device=ii.device)
    return torch.cat(parts)


def l2_normalize(desc: torch.Tensor) -> torch.Tensor:
    """Per-descriptor L2 normalisation (normalize, surfd.cu:2447-2493)."""
    nrm = torch.sqrt(torch.sum(desc * desc, dim=-1, keepdim=True))
    return desc / torch.clamp(nrm, min=1e-30)
