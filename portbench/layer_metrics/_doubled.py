"""Readers of the kernels' shares of their rooflines in a doubled cell,
each the least time its work on the traced block needs over its device
time there, summed by kernel name, in per cent: kernel G's doubled passes
(`rooflines/integral_doubled.py`), kernel A on the doubled frames
(`rooflines/detect_doubled.py`), kernel B on their keypoints
(`rooflines/describe_doubled.py`)."""

from __future__ import annotations

from portbench.rooflines import (describe_doubled, detect_doubled,
                                 integral_doubled, peaks)


def _share(ctx, kernel, least):
    t = ctx.kernel_seconds(kernel)
    return None if t <= 0 or not least else 100.0 * least / t


def integral_roofline(ctx):
    """Only G's doubled kernels are read: where the frames are upsampled
    by torch operations before an undoubled G, as before G had a doubled
    mode, this reads nothing."""
    if not ctx.frames:
        return None
    return _share(ctx, integral_doubled.KERNEL, peaks.least_seconds(
        *integral_doubled.work(ctx.frames, *ctx.frame_hw)))


def detect_roofline(ctx):
    if not ctx.frames:
        return None
    nbytes, ops = detect_doubled.work(ctx.cfg["surf"], *ctx.frame_hw)
    return _share(ctx, detect_doubled.KERNEL,
                  ctx.frames * peaks.least_seconds(nbytes, ops))


def describe_roofline(ctx):
    return _share(ctx, describe_doubled.KERNEL, sum(
        peaks.least_seconds(*describe_doubled.work(kps, *ctx.frame_hw))
        for kps in ctx.described))
