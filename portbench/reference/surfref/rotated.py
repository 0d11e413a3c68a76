"""The rotation-invariant SURF frontend, plain PyTorch: the reference of
the rotated cells.  Detection is the upright frontend's own (`frontend`:
integral image, response layers, compaction and subpixel walk, makePoint,
none of which depends on the orientation); each keypoint is then oriented
(`ops.orientation`, Bay et al. 2008 sec. 4.1 at the reference CUDA SURF's
contract) and described in its turned window (`ops.descriptor`, the
window's radius 1.4 times the upright one's).  One frame per call, or a
batch of frames with the keypoints in the (B, max_pts) layout; undoubled
frames only.
"""

from __future__ import annotations

import dataclasses

import torch

from . import frontend
from .config import SurfConfig
from .ops.descriptor import describe
from .ops.matcher import match_keypoints
from .ops.orientation import orientations
from .types import Matches

__all__ = ["SurfConfig", "Surf", "detect_and_compute",
           "detect_and_compute_batch", "detect_and_compute_windows"]


def _upright(cfg: SurfConfig) -> SurfConfig:
    if cfg.upright or cfg.doubled:
        raise ValueError("the rotated reference takes upright=False, "
                         "undoubled configurations")
    return dataclasses.replace(cfg, upright=True)


def _oriented(ii, cfg: SurfConfig, kps, frame=None):
    """Keypoints with (K,) fields -> (Keypoints with their angles, (K,
    nfeatures) descriptors, zero where invalid, window gap, top-two
    windows' angles)."""
    ori, gap, top2 = orientations(ii, kps.x, kps.y, kps.scale, kps.valid,
                                  frame)
    desc = describe(ii, cfg, kps.x, kps.y, kps.scale, ori, kps.valid,
                    frame=frame)
    desc = torch.where(kps.valid[:, None], desc, 0.0)
    return kps._replace(ori=ori), desc, gap, top2


def detect_and_compute_windows(image: torch.Tensor, cfg: SurfConfig):
    """uint8 (H, W) tensor -> (Keypoints, (max_pts, nfeatures)
    descriptors, (max_pts,) relative gap between the two heaviest
    orientation windows, (max_pts, 2) their angles)."""
    kps, _ = frontend.detect_and_compute(image, _upright(cfg),
                                         compute_descriptors=False)
    ii = frontend.integral_image(image)
    return _oriented(ii, cfg, kps)


def detect_and_compute(image: torch.Tensor, cfg: SurfConfig):
    """uint8 (H, W) tensor -> (Keypoints, (max_pts, nfeatures)
    descriptors)."""
    return detect_and_compute_windows(image, cfg)[:2]


def detect_and_compute_batch(images: torch.Tensor, cfg: SurfConfig):
    """uint8 (B, H, W) tensor -> (Keypoints with (B, max_pts) fields and a
    (B,) count, (B, max_pts, nfeatures) descriptors): the upright
    frontend's batch detection, then every slot oriented and described on
    the stack of integral images, each in its own frame."""
    B = images.shape[0]
    kb, _ = frontend.detect_and_compute_batch(images, _upright(cfg),
                                              compute_descriptors=False)
    ii = torch.stack([frontend.integral_image(im) for im in images])
    frame = torch.arange(B, dtype=torch.int32,
                         device=images.device).repeat_interleave(cfg.max_pts)
    flat = type(kb)(*[f.reshape(-1) for f in kb[:-1]], kb.count)
    kps, desc, _, _ = _oriented(ii, cfg, flat, frame)
    return (type(kb)(*[f.reshape(B, cfg.max_pts) for f in kps[:-1]],
                     kb.count),
            desc.reshape(B, cfg.max_pts, cfg.nfeatures))


class Surf:
    """The rotated frontend bound to a device, with the entry points of
    the program's `Surf`."""

    def __init__(self, cfg: SurfConfig, device="cuda"):
        _upright(cfg)
        self.cfg = cfg
        self.device = frontend.require_device(device, "Surf")

    def detect_and_compute(self, image):
        return detect_and_compute(frontend._to_uint8(image, self.device),
                                  self.cfg)

    def detect_and_compute_batch(self, images):
        return detect_and_compute_batch(frontend._to_uint8(images,
                                                           self.device),
                                        self.cfg)

    def match(self, kp1, desc1, kp2, desc2) -> Matches:
        return match_keypoints(kp1, desc1, kp2, desc2)
