"""Kernel A's work (`surf_pyramid`, csrc/detect.cu's `pyramid_kernel`):
the Hessian responses of every octave, and their candidate masks, from a
frame's integral image.

Bytes: the int32 integral image of (h + 1) x (w + 1), read once.  The
response layers and masks are not counted: a fused implementation need
not write them.
Operations: 37 a response sample computed from the integral image (the 8
box sums of Dxx, Dyy and Dxy at 3 additions each, their differences and
normalisation 8, the determinant 5), over octave 0's first `max_scale`
layers and each later octave's `max_scale - 2` (its two first layers are
the previous octave's, decimated), each layer the octave's whole grid.
The 27-neighbour test is not counted, so the count is a lower bound.
Upright, not doubled: the configurations the benchmark runs.
"""

KERNEL = "pyramid_kernel"
OPS_PER_RESPONSE = 37


def octave_grids(cfg: dict, h: int, w: int):
    """[(layers computed, rows, cols)] an octave (SurfConfig's
    octave_shapes and hessian_schedule, frozen)."""
    s = cfg.get("sampling_step", 2)
    max_scale = cfg.get("init_mask_size", 9) // 3 + 2
    rows, cols = h // s, w // s
    out = []
    for o in range(cfg["noctaves"]):
        out.append((max_scale if o == 0 else max_scale - 2, rows, cols))
        rows, cols = rows >> 1, cols >> 1
    return out


def work(cfg: dict, h: int, w: int) -> tuple[float, float]:
    """-> (bytes, operations) of one frame."""
    if cfg.get("doubled", False):
        raise ValueError("the doubled integral image is not counted here")
    nbytes = 4.0 * (h + 1) * (w + 1)
    ops = OPS_PER_RESPONSE * sum(n * r * c for n, r, c in
                                 octave_grids(cfg, h, w))
    return nbytes, float(ops)
