"""Kernel C's wrapper: fused best / second-best matcher (port of
cuda_surf_tpu/ops/matcher_pallas.py).

On a CUDA tensor `fused_best2` launches the hand-written kernel
(csrc/match.cu): dot products on the tensor cores as 3xTF32 (a TF32 big
and small part of each operand, three products, fp32 sums: scores within
~1e-6 of fp32) folded into a running top-2, the (N1, N2) score matrix never
reaching device memory.  One launch takes one
pair of sets, `(N1, D)` x `(N2, D)`, or P pairs with a leading dimension,
`(P, N1, D)` x `(P, N2, D)`; set 2 is split over several blocks per block
of 128 set-1 rows when the row blocks alone cannot fill the card, and the
last block to finish merges the splits inside the same launch.  On a CPU
tensor it takes the plain twin `_best2_plain` (an fp32 `torch.matmul` and
masked max / argmax passes).  Any other device raises.

Tie rules are those of ops/matcher.match: first-index argmax, a second
best that excludes only the argmax column, invalid set-2 columns scored
-1e30.  Kernel and twin sum the products in different orders (and 3xTF32
drops each product's small x small part), so scores agree to ~1e-6 and an
index may differ only on a near tie.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import torch

from .. import _build

NEG = -1e30


ROWS, COLS, DEPTH = 128, 128, 32    # csrc/match.cu: Geometry::BM, BN; MT_BK
MAX_SPLITS = 8


def _best2_plain(desc1, desc2, valid2, scores=None):
    """(best, second, index) over the masked score matrix
    desc1 @ desc2.T; any leading pair dimensions are kept."""
    if scores is None:
        scores = torch.matmul(desc1, desc2.transpose(-1, -2))
    scores = torch.where(valid2[..., None, :], scores, NEG)
    best = torch.max(scores, dim=-1).values
    index = torch.argmax(scores, dim=-1)     # first index on exact ties
    cols = torch.arange(scores.shape[-1], device=scores.device)
    second = torch.max(torch.where(cols == index[..., None], NEG, scores),
                       dim=-1).values
    return best, second, index.to(torch.int32)


def plan_splits(pairs: int, n1: int, n2: int, sms: int) -> int:
    """Blocks that share one row block's set 2: the count, up to
    MAX_SPLITS, that minimises the busiest SM's work, in column tiles, one
    more a block for loading its rows and writing its result (the smaller
    count on a tie)."""
    row_blocks, tiles = pairs * -(-n1 // ROWS), max(1, -(-n2 // COLS))
    cost = lambda s: -(-row_blocks * s // sms) * (-(-tiles // s) + 1)
    return min(range(1, min(tiles, MAX_SPLITS) + 1), key=lambda s: (cost(s), s))


@functools.lru_cache(maxsize=8)
def _scratch(stream: torch.cuda.Stream, pairs: int, n1: int, splits: int):
    """The partial top-2s, the counters of the splits' merge and the
    numbering of the launches that use them, for launches on `stream`, kept
    for the most recent shapes (the key holds the stream, so its handle
    cannot pass to another stream meanwhile).  A counter holds a launch's
    number beside its count, so the kernel takes what any other launch left
    there, finished or not, for zero."""
    dev = stream.device
    f = torch.empty((2, pairs, splits, n1), dtype=torch.float32, device=dev)
    i = torch.empty((pairs, splits, n1), dtype=torch.int32, device=dev)
    done = torch.zeros((pairs * -(-n1 // ROWS),), dtype=torch.int32,
                       device=dev)
    return f[0], f[1], i, done, itertools.count(1)


def occupancy(depth: int) -> tuple[int, int]:
    """-> (blocks of the built kernel that fit one SM at descriptor depth
    `depth`, warps of a block)
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    blocks, warps = ctypes.c_int(0), ctypes.c_int(0)
    _build.launch("surf_best2_occupancy", depth, ctypes.byref(blocks),
                  ctypes.byref(warps))
    return blocks.value, warps.value


def fused_best2(desc1: torch.Tensor, desc2: torch.Tensor,
                valid2: torch.Tensor):
    """-> (best, second, index), each (N1,) or (P, N1): the masked max /
    second-max / argmax of desc1 @ desc2.T over set 2, for one pair
    `(N1, D)`, `(N2, D)`, `(N2,)` or P pairs `(P, N1, D)`, `(P, N2, D)`,
    `(P, N2)` in one launch."""
    if desc1.device.type == "cpu":
        return _best2_plain(desc1, desc2, valid2)
    if desc1.device.type != "cuda":
        raise ValueError(f"fused_best2: unsupported device {desc1.device}")
    if desc1.dim() not in (2, 3) or desc2.dim() != desc1.dim():
        raise ValueError("fused_best2: desc1 and desc2 must both be (N, D) "
                         "or both (P, N, D)")
    d1 = desc1.contiguous()
    d2 = desc2.contiguous()
    v2 = valid2.to(torch.bool).contiguous()
    _build.require_cuda(d1, "desc1", torch.float32)
    _build.require_cuda(d2, "desc2", torch.float32)
    _build.require_cuda(v2, "valid2", torch.bool)
    *lead, N1, D = d1.shape
    N2 = d2.shape[-2]
    P = lead[0] if lead else 1
    if tuple(d2.shape) != (*lead, N2, D) or tuple(v2.shape) != (*lead, N2):
        raise ValueError("fused_best2: desc1 ([P,] N1, D), desc2 ([P,] N2, D) "
                         "and valid2 ([P,] N2) shapes disagree")
    if D % DEPTH:
        raise ValueError(f"fused_best2: descriptor depth {D} is not a "
                         f"multiple of {DEPTH}")
    dev = d1.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = plan_splits(P, N1, N2, sms)
    best = torch.empty((*lead, N1), dtype=torch.float32, device=dev)
    second = torch.empty_like(best)
    index = torch.empty((*lead, N1), dtype=torch.int32, device=dev)
    if splits > 1 and P * N1 > 0:
        *parts, epochs = _scratch(torch.cuda.current_stream(dev), P, N1,
                                  splits)
        pb, ps, pi, done = (_build.ptr(t) for t in parts)
        epoch = next(epochs) % (1 << 24)
    else:
        pb = ps = pi = done = None
        epoch = 0
    with torch.cuda.device(dev):
        _build.launch(
            "surf_best2", _build.ptr(d1), _build.ptr(d2), _build.ptr(v2), P,
            N1, N2, D, splits, pb, ps, pi, done, epoch, _build.ptr(best),
            _build.ptr(second), _build.ptr(index), _build.stream(dev))
    return best, second, index
