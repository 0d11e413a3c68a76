"""Frame-batch frontend on one device (port of
cuda_surf_tpu/parallel/batch.py, single-device part).

The JAX class shards a frame batch across a device mesh and loops over
each device's local frames with the single-frame pipeline.  The port keeps
the per-frame loop on one device.  The mesh argument, the check that the
batch divides by the mesh size, and `parallel/mesh.py` wait for the
multi-device slice (ROADMAP.md Queue 1 item 14).
"""

from __future__ import annotations

import torch

from ..config import SurfConfig
from ..frontend import _to_uint8, detect_and_compute, require_device
from ..ops.matcher import match_keypoints
from ..types import Keypoints, Matches


class BatchSurf:
    """Batched SURF frontend: `detect_and_compute` takes (B, H, W) uint8
    frames and returns Keypoints with (B, max_pts) fields and (B, max_pts,
    nfeatures) descriptors; every frame goes through the single-frame
    pipeline, so each frame's result is that pipeline's.
    `frontend.detect_and_compute_batch` is the stacked, faster form.

    `BatchSurf(cfg, device="cuda")` raises if no card is present;
    `device="cpu"` runs the plain PyTorch twins.
    """

    def __init__(self, cfg: SurfConfig | None = None, device="cuda", **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self.device = require_device(device, "BatchSurf")

    def detect_and_compute(self, images):
        images = _to_uint8(images, self.device)
        kps, descs = zip(*[detect_and_compute(im, self.cfg) for im in images])
        return (Keypoints(*[torch.stack(f) for f in zip(*kps)]),
                torch.stack(descs))

    def match(self, kp1, d1, kp2, d2) -> Matches:
        """One-directional matching of corresponding frame pairs: all
        pairs in one launch of kernel C, each pair's result that of
        `match_keypoints` on the pair alone."""
        return match_keypoints(kp1, d1, kp2, d2)
