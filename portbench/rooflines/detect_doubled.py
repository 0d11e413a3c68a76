"""Kernel A's work in doubled mode (`surf_pyramid`, csrc/detect.cu's
`pyramid_kernel`): the Hessian responses of every octave, and their
candidate masks, from the integral image of the frame upsampled 2x.

Bytes: the int32 (2h, 2w) integral image, read once.  The response
layers and masks are not counted: a fused implementation need not write
them.
Operations: 37 a response sample (as `rooflines/detect.py` counts them),
over octave 0's first `max_scale` layers and each later octave's
`max_scale - 2`, each layer its octave's whole grid.  The grids are
SurfConfig.octave_shapes' (frozen here): the upsampled (2h - 1, 2w - 1)
grid sampled every 4 pixels (the sampling step 2, doubled) in octave 0,
halved in each later one.  The 27-neighbour test is not counted, so the
count is a lower bound.  Upright or not: the responses are the same.
"""

from portbench.rooflines.detect import OPS_PER_RESPONSE

KERNEL = "pyramid_kernel"


def octave_grids(cfg: dict, h: int, w: int):
    """[(layers computed, rows, cols)] an octave."""
    s = 2 * cfg.get("sampling_step", 2)
    max_scale = cfg.get("init_mask_size", 9) // 3 + 2
    rows, cols = (2 * h - 2) // s, (2 * w - 2) // s
    out = []
    for o in range(cfg["noctaves"]):
        out.append((max_scale if o == 0 else max_scale - 2, rows, cols))
        rows, cols = rows >> 1, cols >> 1
    return out


def work(cfg: dict, h: int, w: int) -> tuple[float, float]:
    """-> (bytes, operations) of one frame."""
    if not cfg.get("doubled", False):
        raise ValueError("the frame is not doubled: rooflines/detect.py")
    nbytes = 4.0 * (2 * h) * (2 * w)
    ops = OPS_PER_RESPONSE * sum(n * r * c for n, r, c in
                                 octave_grids(cfg, h, w))
    return nbytes, float(ops)
