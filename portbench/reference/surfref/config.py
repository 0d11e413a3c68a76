"""Static configuration for the SURF frontend (port of cuda_surf_tpu/config.py).

The JAX package's `SurfConfig` is copied here, not imported: importing
anything under `cuda_surf_tpu` runs its `__init__`, which imports jax, and
this package never imports jax.  SURF has no learned weights, so this
config and the keypoint arrays are all the state that carries across from
the JAX package (`config_from_jax`).

The TPU-only knobs (`wavelet_method`, `detect_backend`, `detect_fit`) are
dropped: the port has one backend per device, and the sparse
per-candidate fit, which the JAX package documents as bit-identical to
the dense one.  All derivations mirror Surfor::init (surf.cpp:67-79).
"""

from __future__ import annotations

import dataclasses
import functools
import math

# Orientation constants of the reference (surfd.h:9-16).
NBIN = 72                        # orientation histogram bins
WINDOW = 1.0471975511965976      # pi / 3 sliding orientation window
SEP_ANGLE = 0.08726646259971647  # 2*pi / NBIN
HWN = 6                          # half window size in bins
ORADIUS = 9                      # orientation sampling disc radius (in steps)
ORADIUS_SQ = 81.5


@dataclasses.dataclass(frozen=True)
class SurfConfig:
    """User-facing SURF parameters plus all derived quantities.

    Defaults follow the reference demo (main.cpp:187-204): 4 octaves,
    threshold 4.0, no image doubling, initial 9x9 mask, sampling step 2,
    upright descriptors, 64-d.
    """

    noctaves: int = 4
    thresh: float = 4.0
    doubled: bool = False
    init_mask_size: int = 9
    sampling_step: int = 2
    upright: bool = True
    extended: bool = False
    desc_wsz: int = 4
    max_pts: int = 10000
    # static capacities (the reference appends with atomicInc; the port
    # keeps the JAX package's fixed-size, stably compacted buffers)
    candidates_per_octave: int = 4096
    interp_moves: int = 5

    @property
    def max_candidates(self) -> int:
        """Global pre-interpolation candidate capacity."""
        return 2 * self.max_pts

    # ---- derived parameters (Surfor::init, surf.cpp:67-79) ----

    @property
    def divisor(self) -> float:
        return 0.5 if self.doubled else 1.0

    @property
    def init_lobe(self) -> int:
        return self.init_mask_size // 3

    @property
    def max_scale(self) -> int:
        return self.init_lobe + 2

    @property
    def sampling(self) -> int:
        return self.sampling_step * (2 if self.doubled else 1)

    @property
    def mag_factor(self) -> int:
        return 12 // self.desc_wsz

    @property
    def orient_size(self) -> int:
        return 8 if self.extended else 4

    @property
    def nfeatures(self) -> int:
        return self.desc_wsz * self.desc_wsz * self.orient_size

    # ---- descriptor geometry bounds ----

    def _desc_geometry(self, scale: float) -> tuple[int, int, int]:
        """(step, iscale, iradius) for a keypoint scale (describeUR*,
        surfd.cu:1373-1387; rotated x1.4 at surfd.cu:2428)."""
        work = (3.3 if self.doubled else 1.65) * scale
        step = max(1, _round_half_even(work * 0.5))
        iscale = int(work)
        spacing = work * self.mag_factor
        rad = (1.0 if self.upright else 1.4) * spacing * (self.desc_wsz + 1) * 0.5
        return step, iscale, _round_half_even(rad / step)

    @functools.cached_property
    def _max_scale_value(self) -> float:
        """Upper bound on emitted keypoint scales: makePoint gives
        1.2 * ns * divisor (surfd.cu:1004-1006) with ns bounded by the last
        octave's top scale plus the +/-1.5 interpolation offset."""
        octave = 1 << (self.noctaves - 1)
        ns = (self.init_lobe + (octave - 1) * self.max_scale
              + (self.max_scale + 0.5) * 2.0 * octave) / 3.0
        return 1.2 * ns * self.divisor + 1.0

    @functools.cached_property
    def _desc_bounds(self) -> tuple[int, int]:
        """(max_iradius, max_span) over the reachable scale range; span =
        iradius*step + iscale + 1 is a keypoint's patch half-extent."""
        best_rad, best_span = 0, 0
        s = 0.5
        while s < self._max_scale_value:
            step, iscale, rad = self._desc_geometry(s)
            best_rad = max(best_rad, rad)
            best_span = max(best_span, rad * step + iscale + 1)
            s += 0.01
        return best_rad, best_span

    @property
    def max_iradius(self) -> int:
        return self._desc_bounds[0]

    @property
    def max_desc_span(self) -> int:
        return self._desc_bounds[1]

    @functools.lru_cache(maxsize=None)
    def desc_step_bounds(self, step: int) -> tuple[int, int]:
        """(max_iradius, max_iscale) over reachable scales whose descriptor
        sampling step equals `step`: static bounds for the static-step
        describe kernel.  +1 margins for the 0.01 scan granularity (both
        are piecewise constant in scale with unit jumps)."""
        best_rad, best_s = 0, 0
        s = 0.5
        while s < self._max_scale_value:
            st, iscale, rad = self._desc_geometry(s)
            if st == step:
                best_rad = max(best_rad, rad)
                best_s = max(best_s, iscale)
            s += 0.01
        return best_rad + 1, best_s + 1

    @functools.cached_property
    def max_ori_span(self) -> int:
        """Patch half-extent bound for orientation sampling
        (assignOrientationApprox geometry, surfd.cu:1746-1793)."""
        best = 0
        s = 0.5
        bound = self._max_scale_value * (2.0 if self.doubled else 1.0)
        while s < bound:
            pixsi = int(2.0 * s + 1.6)
            step = int(s + 0.8)
            best = max(best, ORADIUS * step + pixsi + 1)
            s += 0.01
        return best

    @property
    def desc_grid(self) -> int:
        """Side length of the descriptor sampling grid."""
        return 2 * self.max_iradius + 1

    # ---- image-geometry helpers (Surfor::allocMemory, surf.cpp:374-392) ----

    def integral_shape(self, h: int, w: int) -> tuple[int, int]:
        if self.doubled:
            return (h + h - 1, w + w - 1)
        return (h + 1, w + 1)

    def octave_shapes(self, h: int, w: int) -> list[tuple[int, int]]:
        ih, iw = self.integral_shape(h, w)
        shapes = [((ih - 1) // self.sampling, (iw - 1) // self.sampling)]
        for _ in range(1, self.noctaves):
            ph, pw = shapes[-1]
            shapes.append((ph >> 1, pw >> 1))
        return shapes

    def hessian_schedule(self, h: int, w: int) -> list["OctaveSchedule"]:
        """Host-side per-octave scale parameters.

        Mirrors the interleaved updates of Surfor::detectAndCompute
        (surf.cpp:240-294) and cuCalcHessianMulti (surfd.cu:2844-2865):
        `mask_size` carries across octaves, `border1` is threaded through the
        scale loop, and `borders[s]` records the pre-update value used by the
        NMS/interp stage.
        """
        schedules = []
        mask_size = self.init_lobe - 2
        octave = 1
        for o in range(self.noctaves):
            if o > 0:
                border1 = ((3 * (mask_size + 4 * octave)) // 2) // (self.sampling * octave) + 1
                borders = [border1, border1] + [0] * (self.max_scale - 2)
                init_scale = 2
            else:
                border1 = ((3 * (mask_size + 6 * octave)) // 2) // (self.sampling * octave) + 1
                borders = [0] * self.max_scale
                init_scale = 0
            scales = []
            for i, s in enumerate(range(init_scale, self.max_scale)):
                borders[s] = border1
                delta = self.sampling * octave
                msz = mask_size + 2 * octave * (i + 1)
                if s > 2:
                    border1 = 3 * msz // 2 // delta + 1
                norm = (9.0 / float(msz * msz)) ** 2
                scales.append(ScaleParams(
                    scale_index=s, mask_size=msz, border1=border1,
                    border2=delta * border1, delta=delta, norm=norm,
                    x2=msz // 2, x3=2 * (msz // 2), x4=3 * (msz // 2),
                ))
            mask_size = scales[-1].mask_size
            schedules.append(OctaveSchedule(
                octave=octave, init_scale=init_scale, scales=tuple(scales),
                borders=tuple(borders),
            ))
            octave += octave
        return schedules


# The main path: the reference demo's workload as bench.py:57-58 sets it.
MAIN_CONFIG = dict(noctaves=4, thresh=4.0, upright=True, max_pts=4096,
                   candidates_per_octave=4096)
# The rotation-invariant path: the main config with upright=False, as
# bench.py:294-310 times it (`rotated_pair_ms`).
ROTATED_CONFIG = dict(MAIN_CONFIG, upright=False)
# Doubled mode (the frame upsampled 2x before the integral image), upright
# and rotated, at the main config's capacities.
DOUBLED_CONFIG = dict(MAIN_CONFIG, doubled=True)
DOUBLED_ROTATED_CONFIG = dict(ROTATED_CONFIG, doubled=True)
# Frames per call of the batch path, as bench.py's frames-per-second metric.
BATCH_FRAMES = 8
# The visual-odometry cell's frontend: the JAX package's SLAM tests' config
# (tests/test_slam_sequence.py, _pipe) on 200x280 frames.
VO_CONFIG = dict(noctaves=3, thresh=2.0, max_pts=1024,
                 candidates_per_octave=1024)
# The RANSAC seeds of the JAX runs in golden_terrain_vo.npz: the cell's ATE
# is a property of the draws as well as of the code (a degenerate five-point
# candidate can win a pair), so the cell is read over several seeds.
VO_SEEDS = tuple(range(8))


@dataclasses.dataclass(frozen=True)
class ScaleParams:
    """Per-scale box-filter geometry (hessian_params rows, surfd.cu:2846-2859)."""
    scale_index: int
    mask_size: int
    border1: int
    border2: int
    delta: int
    norm: float
    x2: int
    x3: int
    x4: int


@dataclasses.dataclass(frozen=True)
class OctaveSchedule:
    octave: int          # 1, 2, 4, 8, ...
    init_scale: int      # 0 for octave 0, else 2 (scales 0-1 seeded by decimation)
    scales: tuple[ScaleParams, ...]
    borders: tuple[int, ...]  # NMS/interp borders per scale (surf.cpp:261-269)

    def maximum_borders(self) -> list[int]:
        """Extrema-cell borders per scale pair (cuFindMaximumWithInterp,
        surfd.cu:3062-3071): mborders[z] = borders[2z+2] + 1."""
        out = []
        max_scale = len(self.borders)
        for k in range(1, max_scale - 1, 2):
            out.append(self.borders[k + 1] + 1)
        return out


def config_from_jax(obj) -> SurfConfig:
    """Copy the shared fields off a JAX-package `SurfConfig` (or any object
    carrying them) by attribute name; the TPU-only knobs are left behind."""
    return SurfConfig(**{f.name: getattr(obj, f.name)
                         for f in dataclasses.fields(SurfConfig)})


def _round_half_even(x: float) -> int:
    """CUDA __float2int_rn: round to nearest, ties to even."""
    f = math.floor(x)
    d = x - f
    if d > 0.5:
        return f + 1
    if d < 0.5:
        return f
    return f + (f % 2)


def lut1() -> list[float]:
    """Orientation Gaussian weight LUT (Surfor::initLut, surf.cpp:360-364)."""
    return [math.exp(-(n + 0.5) / 12.5) for n in range(83)]


def bin_centers() -> list[float]:
    """72 histogram bin lower edges -pi..pi (surf.cpp:85-89)."""
    out = [-math.pi]
    for _ in range(1, NBIN):
        out.append(out[-1] + SEP_ANGLE)
    return out
