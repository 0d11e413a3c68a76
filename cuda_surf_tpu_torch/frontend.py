"""SURF frontend pipeline (port of cuda_surf_tpu/frontend.py,
single-frame).

Mirror of Surfor::detectAndCompute (surf.cpp:205-355): integral image ->
kernel A (response layers + NMS mask per octave) -> compaction and
subpixel walk -> makePoint -> kernel D (orientation, unless upright) ->
kernel B (descriptor rows) -> L2 normalise.  Matching runs kernel C.
PyTorch runs eagerly, so there is nothing to compile; the kernels are
built at their first launch.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SurfConfig, require_slice
from .types import Keypoints, Matches, compact
from .ops.integral import integral_image
from .ops.extrema import detect
from .ops.fused_detect import fused_pyramid
from .ops.descriptor import describe
from .ops.matcher import match_keypoints
from .ops.orientation import assign_orientations


def _make_keypoints(ii, cand, cfg: SurfConfig):
    """Compaction + makePoint (surfd.cu:1001-1022): scale octave-space
    coords to image space, Laplacian sign on the integral image."""
    count, valid, nx, ny, ns, strength, octave = compact(
        cand["valid"], cfg.max_pts, cand["nx"], cand["ny"], cand["ns"],
        cand["strength"], cand["octave"])

    td = float(cfg.sampling * cfg.divisor)
    x = nx * td
    y = ny * td
    scale = 1.2 * ns * float(cfg.divisor)
    temp = torch.trunc(3.0 * ns + 0.5).to(torch.int32)
    cx = torch.trunc(nx * float(cfg.sampling) + 0.5).to(torch.int32)
    cy = torch.trunc(ny * float(cfg.sampling) + 0.5).to(torch.int32)
    x2 = torch.div(temp, 2, rounding_mode="floor")
    x3 = 2 * x2

    ih, iw = ii.shape

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
    vals = ii.reshape(-1)[(yy * iw + xx).long()]            # one gather
    b = vals[0::4] + vals[1::4] - vals[2::4] - vals[3::4]   # (4, K)
    lxx = b[0] - 3 * b[1]
    lyy = b[2] - 3 * b[3]
    laplace = torch.where(lxx + lyy > 0, 1, -1).to(torch.int32)
    return count, valid, x, y, scale, strength, laplace, octave


def detect_and_compute(image: torch.Tensor, cfg: SurfConfig,
                       compute_descriptors: bool = True):
    """uint8 (H, W) tensor -> (Keypoints, (max_pts, nfeatures)
    descriptors), on the image's device."""
    require_slice(cfg)
    h, w = image.shape
    ii = integral_image(image)
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    cand = detect(pyr, cfg.hessian_schedule(h, w), cfg, cand_masks=masks)
    count, valid, x, y, scale, strength, laplace, octave = \
        _make_keypoints(ii, cand, cfg)
    ori = torch.zeros_like(x)
    if compute_descriptors and not cfg.upright:
        ori = assign_orientations(ii, cfg, x, y, scale, valid)
        ori = torch.where(valid, ori, 0.0)
    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=ori, octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, torch.zeros((cfg.max_pts, cfg.nfeatures),
                                dtype=torch.float32, device=image.device)
    desc = describe(ii, cfg, x, y, scale, ori, valid)
    desc = torch.where(valid[:, None], desc, 0.0)
    return kps, desc


class Surf:
    """The `Surfor` role (surf.h:20-62): a config bound to a device.

    `Surf(cfg, device="cuda")` runs the hand-written kernels and raises if
    no card is present; it never runs on the CPU instead.
    `device="cpu"` runs the plain PyTorch twins.
    """

    def __init__(self, cfg: SurfConfig | None = None, device="cuda", **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        require_slice(self.cfg)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Surf(device='cuda'): no CUDA device is "
                               "available")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"Surf: unsupported device {self.device}")

    def detect_and_compute(self, image):
        img = torch.as_tensor(np.asarray(image, np.uint8)
                              if not isinstance(image, torch.Tensor) else image)
        return detect_and_compute(img.to(self.device, torch.uint8), self.cfg)

    def match(self, kp1, desc1, kp2, desc2) -> Matches:
        return match_keypoints(kp1, desc1, kp2, desc2)
