"""Readers of the collectives' per-layer metrics in the `mesh` request
form, from rank 0's device trace: the all-gathers' kernel time a request,
and their share of what the card's links could receive in it.  On rank 0
the kernels' time includes their wait for the slowest rank."""

from __future__ import annotations

from portbench.forms.mesh import LAYOUT
from portbench.rooflines import gather


def _requests(ctx):
    """Requests in the traced block, and their all-gathers' device time."""
    t = ctx.kernel_seconds(gather.KERNEL)
    if t <= 0 or not ctx.frames or not LAYOUT:
        return None, t
    return ctx.frames / LAYOUT["frames"], t


def gather_ms(ctx):
    """NCCL all-gather kernel time a request, ms."""
    n, t = _requests(ctx)
    return None if n is None else 1e3 * t / n


def gather_link_pct(ctx):
    """The all-gathers' share of their roofline, in per cent: the least
    time in which rank 0's links could receive what it must
    (rooflines/gather.py) over the all-gathers' device time."""
    n, t = _requests(ctx)
    peak = gather.link_peak()
    if n is None or not peak:
        return None
    least = n * gather.received_bytes(ctx.cfg["surf"], LAYOUT["frames"],
                                      LAYOUT["ranks"]) / peak
    return 100.0 * least / t
