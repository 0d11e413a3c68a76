"""Kernel G's work in doubled mode (`surf_integral_doubled`,
csrc/integral.cu's `integral_doubled_totals`, `integral_doubled_carry`,
`integral_doubled_write`): the int32 integral image of each frame
upsampled 2x bilinearly onto the (2h - 1, 2w - 1) grid, (2h, 2w) a frame.

Bytes: each uint8 source byte read once and each int32 of the (2h, 2w)
output written once.  The band totals that the passes hand on through
their scratch are not counted: a one-pass kernel need not write them.
Operations: none in floating point; the sums and the means are integer
additions and shifts, which the bytes outweigh.
"""

KERNEL = "integral_doubled_"


def work(nframes: int, h: int, w: int) -> tuple[float, float]:
    """-> (bytes, operations) of nframes frames of h x w."""
    return float(nframes * (h * w + 4 * (2 * h) * (2 * w))), 0.0
