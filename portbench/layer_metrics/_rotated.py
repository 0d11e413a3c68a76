"""Readers of the kernels' shares of their rooflines in a rotated cell:
kernel D's (`rooflines/orient.py`) and the rotated kernel B's
(`rooflines/describe_rotated.py`), each the least time its work on the
traced block's described keypoints needs over its device time there,
summed by kernel name, in per cent."""

from __future__ import annotations

from portbench.rooflines import describe_rotated, orient, peaks


def _share(ctx, count):
    t = ctx.kernel_seconds(count.KERNEL)
    if t <= 0 or not ctx.described:
        return None
    least = sum(peaks.least_seconds(*count.work(kps, *ctx.frame_hw))
                for kps in ctx.described)
    return 100.0 * least / t


def orient_roofline(ctx):
    return _share(ctx, orient)


def describe_roofline(ctx):
    return _share(ctx, describe_rotated)
