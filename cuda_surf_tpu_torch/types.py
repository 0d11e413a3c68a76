"""Core data model: fixed-capacity struct-of-arrays keypoint sets
(port of cuda_surf_tpu/types.py).

Keypoint sets are padded to a static capacity with a validity mask and
an explicit count, in the same field names, dtypes and `(N,)` layout as
the JAX package, so that one package's output can be held against the
other's field by field.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ._build import require_device


class Keypoints(NamedTuple):
    """Fixed-capacity SURF keypoint set (SurfPoint, surf_structures.h:7-31,
    minus the match slots, which live in :class:`Matches`)."""

    x: torch.Tensor         # (N,) f32, image-space x
    y: torch.Tensor         # (N,) f32
    scale: torch.Tensor     # (N,) f32 (already includes the 1.2 factor)
    strength: torch.Tensor  # (N,) f32 interpolated det-of-Hessian peak
    laplace: torch.Tensor   # (N,) i32 sign of Laplacian (+1/-1)
    ori: torch.Tensor       # (N,) f32 orientation (0 when upright)
    octave: torch.Tensor    # (N,) i32
    valid: torch.Tensor     # (N,) bool
    count: torch.Tensor     # () i32 number of valid points

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]


class Matches(NamedTuple):
    """One-directional nearest-neighbour assignment set1 -> set2
    (findMaxCorr's match slots, surfd.cu:2665-2669)."""

    score: torch.Tensor      # (N1,) f32 best cosine similarity
    index: torch.Tensor      # (N1,) i32 index into set2
    match_x: torch.Tensor    # (N1,) f32
    match_y: torch.Tensor    # (N1,) f32
    ambiguity: torch.Tensor  # (N1,) f32 second_best / (best + 1e-6)
    valid: torch.Tensor      # (N1,) bool


_KP_DTYPES = dict(x=torch.float32, y=torch.float32, scale=torch.float32,
                  strength=torch.float32, laplace=torch.int32,
                  ori=torch.float32, octave=torch.int32, valid=torch.bool,
                  count=torch.int32)


def keypoints_from_numpy(src, device="cuda") -> Keypoints:
    """Build :class:`Keypoints` from any object (or dict) carrying the
    fields as arrays, e.g. the JAX package's keypoints after `np.asarray`;
    on the card unless `device="cpu"`."""
    device = require_device(device, "keypoints_from_numpy")
    get = src.get if isinstance(src, dict) else (lambda k: getattr(src, k))
    return Keypoints(**{
        k: torch.as_tensor(np.asarray(get(k)), dtype=dt, device=device)
        for k, dt in _KP_DTYPES.items()})


def keypoints_to_numpy(kp: Keypoints) -> dict:
    return {k: getattr(kp, k).cpu().numpy() for k in _KP_DTYPES}


def compact(mask: torch.Tensor, capacity: int, *arrays):
    """Stream-compact the rows of `arrays` where `mask` is set into
    fixed-size buffers of length `capacity`: valid-first, stable index
    order, invalid slots zero, truncated to capacity in index order.

    The i-th output row is located by a binary search of the mask's
    prefix sum, so the order is the reference's scan order (an atomic
    append would scramble it) and no host sync is needed.
    Returns (count, valid, *compacted).
    """
    mask = mask.reshape(-1)
    n = mask.shape[0]
    slots = torch.arange(capacity, dtype=torch.int32, device=mask.device)
    if n:
        cs = torch.cumsum(mask, 0, dtype=torch.int32)
        count = torch.clamp(cs[-1], max=capacity)
        idx = torch.searchsorted(cs, slots + 1)
    else:
        count = torch.zeros((), dtype=torch.int32, device=mask.device)
        idx = torch.zeros_like(slots, dtype=torch.int64)
    out_valid = slots < count
    idx = torch.where(out_valid, idx, 0)
    outs = []
    for a in arrays:
        a = a.reshape(n, *a.shape[1:]) if a.ndim > 1 else a.reshape(-1)
        v = a[idx]
        keep = out_valid.reshape((capacity,) + (1,) * (a.ndim - 1))
        outs.append(torch.where(keep, v, torch.zeros((), dtype=a.dtype,
                                                     device=a.device)))
    return count.to(torch.int32), out_valid, *outs
