"""Readers shared by several per-layer metrics' files."""

from __future__ import annotations

from portbench.rooflines import describe, detect, peaks


def device_ops_per_frame(ctx):
    """Device operations in the traced block over the frames it completed."""
    if not ctx.device_ops or not ctx.frames:
        return None
    return len(ctx.device_ops) / ctx.frames


def device_idle_pct(ctx):
    """The share of the traced block in which no operation ran on the
    device, in per cent."""
    if not ctx.device_ops or ctx.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.union_busy() / ctx.window_s)


def detect_roofline(ctx):
    """Kernel A's share of its roofline, in per cent: the least time its
    work needs (rooflines/detect.py) over its device time in the traced
    block, summed by kernel name."""
    t = ctx.kernel_seconds(detect.KERNEL)
    if t <= 0 or not ctx.frames:
        return None
    nbytes, ops = detect.work(ctx.cfg["surf"], *ctx.frame_hw)
    return 100.0 * ctx.frames * peaks.least_seconds(nbytes, ops) / t


def describe_roofline(ctx):
    """Kernel B's share of its roofline, in per cent: the least time its
    work on the traced block's keypoints needs (rooflines/describe.py)
    over its device time there, summed by kernel name."""
    t = ctx.kernel_seconds(describe.KERNEL)
    if t <= 0 or not ctx.described:
        return None
    least = 0.0
    for kps in ctx.described:
        nbytes, ops = describe.work(kps, *ctx.frame_hw)
        least += peaks.least_seconds(nbytes, ops)
    return 100.0 * least / t
