"""SURF frontend pipeline (port of cuda_surf_tpu/frontend.py): one frame
per call, or a batch of frames per call for throughput.

Mirror of Surfor::detectAndCompute (surf.cpp:205-355): integral image ->
kernel A (response layers + NMS masks of all octaves) -> compaction and
subpixel walk -> makePoint -> kernel D (orientation, unless upright) ->
kernel B (descriptor rows) -> L2 normalise.  Matching runs kernel C.
PyTorch runs eagerly, so there is nothing to compile; the kernels are
built at their first launch.

The eager glue between the kernels is launch-bound: the compaction and
walk of one frame are about a thousand small launches.
`detect_and_compute_batch` runs those stages once over the union of B
frames' candidates, so a batch pays them once and not B times.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SurfConfig
from .types import Keypoints, Matches, compact
from .ops.integral import integral_image
from .ops.extrema import detect
from .ops.fused_detect import fused_pyramid
from .ops.descriptor import describe
from .ops.matcher import match_keypoints
from .ops.orientation import assign_orientations


def _make_keypoints(ii, cand, cfg: SurfConfig):
    """Compaction + makePoint (surfd.cu:1001-1022): scale octave-space
    coords to image space, Laplacian sign on the integral image.

    With `ii` a (B, ih, iw) stack of B frames' integral images, `cand`
    holds the union of their candidates with their `frame` ids, and ONE
    compaction and ONE Laplacian gather serve all frames; the frame ids
    come back as a ninth value.  The Laplacian corners wrap
    and clamp frame-locally.  The union's capacity is B * max_pts: a
    frame with more than max_pts valid keypoints truncates as the
    single-frame path does, but its overflow can also displace later
    frames' slots when the union's total exceeds the capacity."""
    stacked = ii.ndim == 3
    extra = (cand["frame"],) if stacked else ()
    count, valid, nx, ny, ns, strength, octave, *fid = compact(
        cand["valid"], cfg.max_pts * (ii.shape[0] if stacked else 1),
        cand["nx"], cand["ny"], cand["ns"], cand["strength"], cand["octave"],
        *extra)

    td = float(cfg.sampling * cfg.divisor)
    x = nx * td
    y = ny * td
    scale = 1.2 * ns * float(cfg.divisor)
    temp = torch.trunc(3.0 * ns + 0.5).to(torch.int32)
    cx = torch.trunc(nx * float(cfg.sampling) + 0.5).to(torch.int32)
    cy = torch.trunc(ny * float(cfg.sampling) + 0.5).to(torch.int32)
    x2 = torch.div(temp, 2, rounding_mode="floor")
    x3 = 2 * x2

    ih, iw = ii.shape[-2:]

    def box_corners(x1, y1, x2_, y2_):
        # getSum corners (surfd.cu:334-343): +(y1+1,x1+1) +(y2,x2)
        # -(y2,x1+1) -(y1+1,x2)
        return [(x1 + 1, y1 + 1), (x2_, y2_), (x1 + 1, y2_), (x2_, y1 + 1)]

    boxes = (box_corners(cx + temp + x2, cy + x3, cx - temp - x2, cy - x3)
             + box_corners(cx + x2, cy + x3, cx - x2, cy - x3)
             + box_corners(cx + x3, cy + temp + x2, cx - x3, cy - temp - x2)
             + box_corners(cx + x3, cy + x2, cx - x3, cy - x2))
    xx = torch.stack([bx for bx, _ in boxes])               # (16, K)
    yy = torch.stack([by for _, by in boxes])
    # the JAX package's advanced-indexing semantics, made explicit:
    # negative indices wrap once, then clamp to the valid range
    xx = torch.clamp(torch.where(xx < 0, xx + iw, xx), 0, iw - 1)
    yy = torch.clamp(torch.where(yy < 0, yy + ih, yy), 0, ih - 1)
    flat = (yy * iw + xx).long()
    if fid:     # the frame's offset, after the frame-local clamp
        flat = flat + fid[0].long() * (ih * iw)
    vals = ii.reshape(-1)[flat]                             # one gather
    b = vals[0::4] + vals[1::4] - vals[2::4] - vals[3::4]   # (4, K)
    lxx = b[0] - 3 * b[1]
    lyy = b[2] - 3 * b[3]
    laplace = torch.where(lxx + lyy > 0, 1, -1).to(torch.int32)
    return (count, valid, x, y, scale, strength, laplace, octave, *fid)


def detect_and_compute(image: torch.Tensor, cfg: SurfConfig,
                       compute_descriptors: bool = True):
    """uint8 (H, W) tensor -> (Keypoints, (max_pts, nfeatures)
    descriptors), on the image's device."""
    h, w = image.shape
    ii = integral_image(image, cfg.doubled)
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr, cfg.hessian_schedule(h, w), cfg, cand_masks=masks)
    count, valid, x, y, scale, strength, laplace, octave = \
        _make_keypoints(ii, cand, cfg)
    ori = torch.zeros_like(x)
    if compute_descriptors and not cfg.upright:
        ori = assign_orientations(ii, cfg, x, y, scale, valid)  # 0 if invalid
    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=ori, octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, torch.zeros((cfg.max_pts, cfg.nfeatures),
                                dtype=torch.float32, device=image.device)
    desc = describe(ii, cfg, x, y, scale, ori, valid)
    desc = torch.where(valid[:, None], desc, 0.0)
    return kps, desc


def _spread_frames(valid_u, fid, fields, B: int, max_pts: int):
    """The union's keypoints -> the (B, max_pts) layout.  The union is
    frame-major and stable, so frame b's keypoints are a contiguous run of
    it: one gather per field moves each run to its row, and the padding
    slots are zero.  -> (count (B,), valid (B, max_pts), *fields)."""
    dev = valid_u.device
    fr = torch.arange(B, dtype=torch.int32, device=dev)
    inframe = (fid[None, :] == fr[:, None]) & valid_u[None, :]
    count = inframe.sum(1, dtype=torch.int32)
    starts = torch.cumsum(count, 0, dtype=torch.int32) - count
    jj = torch.arange(max_pts, dtype=torch.int32, device=dev)
    valid = jj[None, :] < count[:, None]
    idx = torch.where(valid, torch.clamp(starts[:, None] + jj[None, :],
                                         max=B * max_pts - 1), 0).long()
    return (count, valid,
            *(torch.where(valid, a[idx], torch.zeros((), dtype=a.dtype,
                                                     device=dev))
              for a in fields))


def detect_and_compute_batch(images: torch.Tensor, cfg: SurfConfig,
                             compute_descriptors: bool = True):
    """uint8 (B, H, W) tensor -> (Keypoints with (B, max_pts) fields and a
    (B,) count, (B, max_pts, nfeatures) descriptors), on the images'
    device: the throughput form of the pipeline.

    Kernel A runs once on the (B, ih, iw) stack of integral images.  The
    compaction, the subpixel walk and makePoint run ONCE over the union of
    the B frames' candidates; the union is frame-major and stable, so each
    frame's keypoints are a contiguous run, which one gather spreads to the
    (B, max_pts) layout with zero-filled padding slots (the single-frame
    path leaves makePoint of zeroed coordinates there).  Then ONE launch of
    kernel B describes all B * max_pts slots over the (B, ih, iw) stack of
    integral images, each keypoint reading its own frame.

    Rotated mode (upright=False) maps the single-frame path over the
    frames and stacks the results, as the JAX package does.
    """
    B, h, w = images.shape
    if not cfg.upright and compute_descriptors:
        kps, descs = zip(*[detect_and_compute(im, cfg) for im in images])
        return (Keypoints(*[torch.stack(f) for f in zip(*kps)]),
                torch.stack(descs))

    dev = images.device
    ii = torch.stack([integral_image(im, cfg.doubled) for im in images])
    pyr_b, mask_b = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr_b, cfg.hessian_schedule(h, w), cfg, cand_masks=mask_b,
                  nframes=B)
    _, valid_u, *fields, fid = _make_keypoints(ii, cand, cfg)
    count, valid, x, y, scale, strength, laplace, octave = _spread_frames(
        valid_u, fid, fields, B, cfg.max_pts)

    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=torch.zeros_like(x), octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, torch.zeros((B, cfg.max_pts, cfg.nfeatures),
                                dtype=torch.float32, device=dev)
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=dev).repeat_interleave(cfg.max_pts)
    desc = describe(ii, cfg, flat(x), flat(y), flat(scale),
                    torch.zeros_like(flat(x)), flat(valid), frame=frame)
    desc = torch.where(flat(valid)[:, None], desc, 0.0)
    return kps, desc.reshape(B, cfg.max_pts, cfg.nfeatures)


def _to_uint8(image, device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image, np.uint8)
                          if not isinstance(image, torch.Tensor) else image)
    return img.to(device, torch.uint8)


def require_device(device, who: str) -> torch.device:
    """-> torch.device for "cuda" or "cpu"; "cuda" without a card raises
    (the port never runs on the CPU unless asked to)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}(device='cuda'): no CUDA device is "
                           "available")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"{who}: unsupported device {device}")
    return device


class Surf:
    """The `Surfor` role (surf.h:20-62): a config bound to a device.

    `Surf(cfg, device="cuda")` runs the hand-written kernels and raises if
    no card is present; it never runs on the CPU instead.
    `device="cpu"` runs the plain PyTorch twins.
    """

    def __init__(self, cfg: SurfConfig | None = None, device="cuda", **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self.device = require_device(device, "Surf")

    def detect_and_compute(self, image):
        return detect_and_compute(_to_uint8(image, self.device), self.cfg)

    def detect_and_compute_batch(self, images):
        """(B, H, W) frames -> batched keypoints and descriptors."""
        return detect_and_compute_batch(_to_uint8(images, self.device),
                                        self.cfg)

    def match(self, kp1, desc1, kp2, desc2) -> Matches:
        return match_keypoints(kp1, desc1, kp2, desc2)
