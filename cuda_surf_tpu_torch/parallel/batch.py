"""Data-parallel frame-batch frontend (port of
cuda_surf_tpu/parallel/batch.py).

The JAX class shards a frame batch across a device mesh and loops over
each device's local frames with the single-frame pipeline (`shard_map` +
`lax.map`), with no communication.  The port runs one process per device:
each rank of the mesh describes only its own B / size frames, in one call
of the stacked pipeline (`frontend.detect_and_compute_batch`), on its
device, and the results are then all-gathered, so every rank holds the
whole batch's keypoints and descriptors (the host view of JAX's sharded
output).  A sequence's pairs i -> i + 1 are matched the same way: each
rank matches the pairs that start in its frames and the matches are
all-gathered.  Without a mesh every frame runs on the one device.
"""

from __future__ import annotations

import torch

from .._build import require_device
from ..config import SurfConfig
from ..frontend import _to_uint8, detect_and_compute_batch
from ..ops.matcher import match_keypoints
from ..types import Keypoints, Matches
from ..utils.timing import span
from .mesh import Mesh, all_gather_fields, all_gather_rows


def _rows(t, lo: int, hi: int):
    """Rows lo .. hi - 1 of a NamedTuple of batched fields."""
    return type(t)(*[f[lo:hi] for f in t])


class BatchSurf:
    """Batched SURF frontend: `detect_and_compute` takes (B, H, W) uint8
    frames and returns Keypoints with (B, max_pts) fields and (B, max_pts,
    nfeatures) descriptors, those of `frontend.detect_and_compute_batch` on
    the whole batch (kernel A once, one compaction and walk, kernel D
    once when rotated, kernel B once, over the frames a rank holds).

    `BatchSurf(cfg, device="cuda")` raises if no card is present;
    `device="cpu"` runs the plain PyTorch twins.  With `mesh`, B must be a
    multiple of the mesh size; this rank describes its frames on the
    mesh's device, which must be of the type `device` names, and makes two
    all-gathers (the keypoints' fields packed in one, the descriptors).
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

    def _share(self, n: int) -> int:
        """The frames a rank holds of a batch of n."""
        if n % self.mesh.size:
            raise ValueError(f"batch {n} not divisible by mesh size "
                             f"{self.mesh.size}")
        return n // self.mesh.size

    def detect_and_compute(self, images):
        mesh = self.mesh
        if mesh is not None:
            k = self._share(len(images))
            images = images[mesh.rank * k:(mesh.rank + 1) * k]
        kps, descs = detect_and_compute_batch(
            _to_uint8(images, self.device), self.cfg)
        if mesh is None:
            return kps, descs
        return (Keypoints(*all_gather_fields(kps, mesh)),
                all_gather_rows(descs, mesh))

    def match(self, kp1, d1, kp2, d2) -> Matches:
        """One-directional matching of corresponding frame pairs: all
        pairs in one launch of kernel C, each pair's result that of
        `match_keypoints` on the pair alone."""
        return match_keypoints(kp1, d1, kp2, d2)

    def match_sequence(self, kps, descs) -> Matches:
        """The B - 1 pairs i -> i + 1 of a sequence batch that every rank
        holds whole (`detect_and_compute`'s output), as Matches with
        (B - 1, max_pts) fields, each pair's result that of
        `match_keypoints` on the pair alone.  With a mesh, rank r matches
        the pairs that start in its k frames, [r k, (r + 1) k) less the
        last frame, in one launch of kernel C, and one all-gather of the
        matches' fields gives every rank all of them.  The last rank's
        missing pair is padding, zero, dropped after the gather (a last
        rank of one frame matches it against itself instead)."""
        B = descs.shape[0]
        mesh = self.mesh
        if mesh is None:
            return self.match(_rows(kps, 0, B - 1), descs[:-1],
                              _rows(kps, 1, B), descs[1:])
        k = self._share(B)
        lo = mesh.rank * k
        hi = max(min(lo + k, B - 1), lo + 1)
        s = min(lo + 1, B - 1)
        with span("mesh.match"):
            m = self.match(_rows(kps, lo, hi), descs[lo:hi],
                           _rows(kps, s, s + hi - lo), descs[s:s + hi - lo])
            if hi - lo < k:
                m = Matches(*[torch.cat([f, f.new_zeros((k - hi + lo,
                                                         *f.shape[1:]))])
                              for f in m])
        return _rows(Matches(*all_gather_fields(m, mesh)), 0, B - 1)
