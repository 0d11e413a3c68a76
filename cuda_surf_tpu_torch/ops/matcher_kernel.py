"""Kernel C's wrapper: fused best / second-best matcher (port of
cuda_surf_tpu/ops/matcher_pallas.py).

On a CUDA tensor `fused_best2` launches the hand-written kernel
(csrc/match.cu): fp32 FMA dot products folded into a running top-2, the
(N1, N2) score matrix never reaching device memory; set 2 is split over
several blocks per row block when N1 alone cannot fill the card, and a
second launch merges the splits.  On a CPU tensor it takes the plain
twin `_best2_plain` (an fp32 `torch.matmul` and masked max / argmax
passes).  Any other device raises.

Tie rules are those of ops/matcher.match: first-index argmax, a second
best that excludes only the argmax column, invalid set-2 columns scored
-1e30.  Kernel and twin sum the 64 products in different orders, so
scores agree to ~1e-6 and an index may differ only on a near tie.
"""

from __future__ import annotations

import torch

from .. import _build

NEG = -1e30


def _best2_plain(desc1, desc2, valid2, scores=None):
    """(best, second, index) over the masked score matrix desc1 @ desc2.T."""
    if scores is None:
        scores = torch.matmul(desc1, desc2.T)
    scores = torch.where(valid2[None, :], scores, NEG)
    best = torch.max(scores, dim=1).values
    index = torch.argmax(scores, dim=1)      # first index on exact ties
    cols = torch.arange(scores.shape[1], device=scores.device)
    second = torch.max(torch.where(cols[None, :] == index[:, None], NEG,
                                   scores), dim=1).values
    return best, second, index.to(torch.int32)


def fused_best2(desc1: torch.Tensor, desc2: torch.Tensor,
                valid2: torch.Tensor):
    """-> (best, second, index), each (N1,): the masked max / second-max /
    argmax of desc1 @ desc2.T over set 2."""
    if desc1.device.type == "cpu":
        return _best2_plain(desc1, desc2, valid2)
    if desc1.device.type != "cuda":
        raise ValueError(f"fused_best2: unsupported device {desc1.device}")
    d1 = desc1.contiguous()
    d2 = desc2.contiguous()
    v2 = valid2.to(torch.bool).contiguous()
    _build.require_cuda(d1, "desc1", torch.float32)
    _build.require_cuda(d2, "desc2", torch.float32)
    _build.require_cuda(v2, "valid2", torch.bool)
    N1, D = d1.shape
    N2 = d2.shape[0]
    if d2.shape[1] != D or v2.shape != (N2,):
        raise ValueError("fused_best2: desc1 (N1, D), desc2 (N2, D) and "
                         "valid2 (N2,) shapes disagree")
    # split set 2 across blocks until the launch has ~2 blocks per SM
    # (64 rows per block); a merge pass folds the splits together
    sms = torch.cuda.get_device_properties(d1.device).multi_processor_count
    row_blocks, tiles = -(-N1 // 64), -(-N2 // 64)
    splits = max(1, min(tiles, -(-2 * sms // max(row_blocks, 1))))
    best = torch.empty((N1,), dtype=torch.float32, device=d1.device)
    second = torch.empty_like(best)
    index = torch.empty((N1,), dtype=torch.int32, device=d1.device)
    pb, ps, pi = best, second, index        # per-split partials
    if splits > 1:
        pb = torch.empty((splits, N1), dtype=torch.float32, device=d1.device)
        ps = torch.empty_like(pb)
        pi = torch.empty((splits, N1), dtype=torch.int32, device=d1.device)
    with torch.cuda.device(d1.device):
        _build.launch(
            "surf_best2", _build.ptr(d1), _build.ptr(d2), _build.ptr(v2), N1,
            N2, D, splits, _build.ptr(pb), _build.ptr(ps), _build.ptr(pi),
            _build.ptr(best), _build.ptr(second), _build.ptr(index),
            _build.stream(d1.device))
    fused_best2.launches += 1
    return best, second, index


fused_best2.launches = 0
