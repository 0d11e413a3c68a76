"""Frame-to-frame tracking: SURF match + ratio filter + RANSAC pose (port
of cuda_surf_tpu/slam/tracking.py).

The matcher applies no rejection (findMaxCorr, surfd.cu:2665-2669); the
SLAM layer filters by the recorded `ambiguity` ratio and by Laplacian-sign
agreement before RANSAC.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.epipolar import normalize_with_intrinsics, ransac_essential
from ..types import Intrinsics
from ..ops.matcher import match_keypoints
from ..types import Keypoints, Matches


class TrackResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor     # (N1,) bool over kp1 slots
    n_inliers: torch.Tensor
    matches: Matches
    points3d: torch.Tensor    # (N1, 3) triangulated, cam1 frame


def default_intrinsics(h: int, w: int) -> Intrinsics:
    f = 0.9 * max(h, w)
    return Intrinsics(fx=f, fy=f, cx=w / 2.0, cy=h / 2.0)


def filter_matches(kp1: Keypoints, kp2: Keypoints, m: Matches,
                   ratio: float = 0.95) -> torch.Tensor:
    """Valid matches under the ratio whose Laplacian signs agree; the
    match index is clamped to kp2's slots, as the reference's gather is."""
    idx = torch.clamp(m.index.long(), 0, kp2.laplace.shape[0] - 1)
    return m.valid & (m.ambiguity < ratio) & (kp1.laplace == kp2.laplace[idx])


def track_inputs(kp1: Keypoints, desc1, kp2: Keypoints, desc2,
                 intr: Intrinsics, ratio: float = 0.95):
    """Match kp1 -> kp2, filter, normalise: -> (matches, good, x1, x2),
    the correspondences RANSAC takes."""
    m = match_keypoints(kp1, desc1, kp2, desc2)
    good = filter_matches(kp1, kp2, m, ratio)
    x1 = normalize_with_intrinsics(torch.stack([kp1.x, kp1.y], -1),
                                   intr.fx, intr.fy, intr.cx, intr.cy)
    x2 = normalize_with_intrinsics(torch.stack([m.match_x, m.match_y], -1),
                                   intr.fx, intr.fy, intr.cx, intr.cy)
    return m, good, x1, x2


def track_pair(kp1: Keypoints, desc1, kp2: Keypoints, desc2,
               intr: Intrinsics, generator: torch.Generator | None = None,
               ratio: float = 0.95, n_hypotheses: int | None = None,
               inlier_thresh: float = 2e-5, solver: str = "5pt",
               raw: torch.Tensor | None = None) -> TrackResult:
    """Match, filter, RANSAC on the essential matrix, pose and
    triangulation.  The default solver is the Nister 5-point: its
    hypotheses lie on the essential manifold, so consensus ranking is
    honest where 8-point fits on quasi-planar scenes are not.  `raw`
    replaces RANSAC's draw from `generator` (see ransac_essential)."""
    if n_hypotheses is None:
        # each 5pt sample yields up to 10 manifold hypotheses
        n_hypotheses = 128 if solver == "5pt" else 512
    m, good, x1, x2 = track_inputs(kp1, desc1, kp2, desc2, intr, ratio)
    res = ransac_essential(x1, x2, good, generator,
                           n_hypotheses=n_hypotheses,
                           inlier_thresh=inlier_thresh, solver=solver,
                           raw=raw)
    return TrackResult(R=res.R, t=res.t, inliers=res.inliers,
                       n_inliers=res.n_inliers, matches=m,
                       points3d=res.points3d)
