"""Data-parallel frame-batch frontend (port of
cuda_surf_tpu/parallel/batch.py).

The JAX class shards a frame batch across a device mesh and loops over
each device's local frames with the single-frame pipeline (`shard_map` +
`lax.map`), with no communication.  The port does the same one process
per device: each rank of the mesh runs only its own B / size frames
through the single-frame pipeline, on its device, and the results are then
all-gathered, so every rank holds the whole batch's keypoints and
descriptors (the host view of JAX's sharded output).  Without a mesh every
frame runs on the one device.
"""

from __future__ import annotations

import torch

from ..config import SurfConfig
from ..frontend import _to_uint8, detect_and_compute, require_device
from ..ops.matcher import match_keypoints
from ..types import Keypoints, Matches
from .mesh import Mesh, all_gather_rows


class BatchSurf:
    """Batched SURF frontend: `detect_and_compute` takes (B, H, W) uint8
    frames and returns Keypoints with (B, max_pts) fields and (B, max_pts,
    nfeatures) descriptors; every frame goes through the single-frame
    pipeline, so each frame's result is that pipeline's.
    `frontend.detect_and_compute_batch` is the stacked, faster form.

    `BatchSurf(cfg, device="cuda")` raises if no card is present;
    `device="cpu"` runs the plain PyTorch twins.  With `mesh`, B must be a
    multiple of the mesh size; this rank describes its frames on the
    mesh's device, which must be of the type `device` names.
    """

    def __init__(self, cfg: SurfConfig | None = None, device="cuda",
                 mesh: Mesh | None = None, **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self.device = require_device(device, "BatchSurf")
        self.mesh = mesh
        if mesh is not None:
            if mesh.device.type != self.device.type:
                raise ValueError(f"BatchSurf(device={device!r}): the mesh's "
                                 f"device is {mesh.device}")
            self.device = mesh.device

    def detect_and_compute(self, images):
        mesh = self.mesh
        if mesh is not None:
            n = len(images)
            if n % mesh.size:
                raise ValueError(f"batch {n} not divisible by mesh size "
                                 f"{mesh.size}")
            k = n // mesh.size
            images = images[mesh.rank * k:(mesh.rank + 1) * k]
        images = _to_uint8(images, self.device)
        kps, descs = zip(*[detect_and_compute(im, self.cfg) for im in images])
        kps = Keypoints(*[torch.stack(f) for f in zip(*kps)])
        descs = torch.stack(descs)
        if mesh is None:
            return kps, descs
        return (Keypoints(*[all_gather_rows(f, mesh) for f in kps]),
                all_gather_rows(descs, mesh))

    def match(self, kp1, d1, kp2, d2) -> Matches:
        """One-directional matching of corresponding frame pairs: all
        pairs in one launch of kernel C, each pair's result that of
        `match_keypoints` on the pair alone."""
        return match_keypoints(kp1, d1, kp2, d2)
