"""Brute-force descriptor matching (port of cuda_surf_tpu/ops/matcher.py).

Re-derivation of findMaxCorr (surfd.cu:2535-2671): one-directional
set1 -> set2 nearest neighbour over cosine scores of L2-normalised
descriptors, ambiguity = second_best / (best + 1e-6)
(surfd.cu:2665-2669), no ratio-test rejection.  The one-directional
path runs kernel C (ops/matcher_kernel.py); `cross_check` needs the
whole score matrix and stays plain torch, as it stayed XLA in JAX.
"""

from __future__ import annotations

import torch

from ..types import Keypoints, Matches
from ..utils.timing import span
from .matcher_kernel import NEG, _best2_plain, fused_best2


def _matches(best, second, index, valid1, x2, y2) -> Matches:
    """Matches from the top-2 of each set-1 row; a leading pair dimension
    on every argument is kept."""
    il = index.long()
    return Matches(
        score=best,
        index=index,
        match_x=torch.gather(x2, -1, il),
        match_y=torch.gather(y2, -1, il),
        ambiguity=torch.where(second > NEG, second / (best + 1e-6),
                              torch.zeros_like(best)),
        valid=valid1 & (best > NEG),
    )


def match(desc1, valid1, desc2, valid2, x2, y2, scores=None) -> Matches:
    """Matches from the fp32 score matrix desc1 @ desc2.T (or `scores`)."""
    best, second, index = _best2_plain(desc1, desc2, valid2, scores)
    return _matches(best, second, index, valid1, x2, y2)


def match_keypoints(kp1: Keypoints, desc1: torch.Tensor,
                    kp2: Keypoints, desc2: torch.Tensor,
                    cross_check: bool = False) -> Matches:
    """One-directional set1 -> set2 matching (the reference semantics).
    Without `cross_check` the keypoint fields and descriptors may carry a
    leading pair dimension: P pairs are matched in one kernel launch.

    With `cross_check`, matches that are not mutual nearest neighbours
    are marked invalid, from one extra masked argmax over the same score
    matrix."""
    with span("surf.match"):
        if not cross_check:
            best, second, index = fused_best2(desc1, desc2, kp2.valid)
            return _matches(best, second, index, kp1.valid, kp2.x, kp2.y)
        scores = torch.matmul(desc1, desc2.T)
        m = match(desc1, kp1.valid, desc2, kp2.valid, kp2.x, kp2.y,
                  scores=scores)
        scores = torch.where(kp1.valid[:, None], scores, NEG)
        back = torch.argmax(scores, dim=0).to(torch.int32)      # (N2,)
        mutual = back[m.index.long()] == torch.arange(
            m.index.shape[0], dtype=torch.int32, device=back.device)
        return m._replace(valid=m.valid & mutual)
