"""The mesh's all-gathers (NCCL's `AllGather` kernels) in the `mesh`
request form: what every rank must receive a request, and the rate its
links can receive it at.

Bytes: after a request every rank holds every frame's keypoints (x, y,
scale, strength, laplace, ori, octave at 4 bytes, valid at 1, a count of
4), descriptors (nfeatures float32 a slot) and each pair's matches (score,
index, match_x, match_y, ambiguity at 4 bytes, valid at 1), `max_pts`
slots a frame; a rank already holds its own share, so it receives
(ranks - 1) / ranks of the whole.  Packing, padding and the pair that the
last rank pads are not counted, so the count is a lower bound.

Peak: the bytes a second this card can receive, each way: the sum of its
NVLink links' rates as `nvidia-smi nvlink -s` reads them, or without
NVLink its PCIe link's (`nvidia-smi`'s generation and width at their
maxima, 128b/130b encoding).  No card or no `nvidia-smi`: None.
"""

from __future__ import annotations

import functools
import os
import re
import subprocess

KERNEL = "AllGather"
PCIE_GT_PER_LANE = {3: 8e9, 4: 16e9, 5: 32e9}       # transfers a second


def request_bytes(surf: dict, frames: int) -> float:
    """What every rank holds of one request's results, in bytes."""
    n = surf["max_pts"]
    d = 128 if surf.get("extended", False) else 64
    keypoints = frames * (n * (7 * 4 + 1) + 4)
    descriptors = frames * n * d * 4
    matches = (frames - 1) * n * (5 * 4 + 1)
    return float(keypoints + descriptors + matches)


def received_bytes(surf: dict, frames: int, ranks: int) -> float:
    """What one rank receives of a request's all-gathers, in bytes."""
    return request_bytes(surf, frames) * (ranks - 1) / ranks


def _smi(*args) -> str:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True,
                              text=True, timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        return ""


@functools.lru_cache(maxsize=None)
def link_peak(index: str | None = None) -> float | None:
    """Bytes a second that card `index` (the first visible card by
    default) can receive over its links, each way."""
    if index is None:
        index = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    rates = re.findall(r"Link \d+: ([\d.]+) GB/s", _smi("nvlink", "-s", "-i",
                                                         index))
    if rates:
        return sum(float(r) for r in rates) * 1e9
    row = _smi("--query-gpu=pcie.link.gen.max,pcie.link.width.max",
               "--format=csv,noheader,nounits", "-i", index).split(",")
    try:
        gen, width = int(row[0]), int(row[1])
    except (ValueError, IndexError):
        return None
    if gen not in PCIE_GT_PER_LANE:
        return None
    return PCIE_GT_PER_LANE[gen] * width / 8 * 128 / 130
