"""Doubled mode (the 2x upsampled integral image) of the port against the
JAX package and the NumPy oracle.

The integral image is int32 and bit-exact.  The doubled `Surf`, upright and
rotated, is held at the slice test's tolerances (tests/test_torch_slice.py):
keypoint sets equal slot for slot with coordinates at 1e-5 relative;
upright descriptors at row cosine >= 0.99999; orientations within 1e-4 rad
wherever the top-two window gap is >= 1e-5 relative, either top window on a
near tie; rotated descriptors at row cosine >= 0.9999 off the near ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
import cuda_surf_tpu_torch as cst
import oracle
from cuda_surf_tpu.ops import integral as ji
from cuda_surf_tpu_torch.io import render_plane_sequence
from cuda_surf_tpu_torch.ops import integral as ti
from cuda_surf_tpu_torch.ops.fused_detect import octave_plan
from cuda_surf_tpu_torch.ops.orientation import orientation_windows
from torch_parity import (assert_keypoints_match, check_orientations,
                          row_cosines)


@pytest.mark.parametrize("hw", [(2, 2), (7, 13), (120, 160), (241, 333)])
def test_doubled_integral_image_bit_exact(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = rng.integers(0, 256, hw, np.uint8)
    a = np.asarray(ji.integral_image(jnp.asarray(img), True))
    b = ti.integral_image(torch.as_tensor(img), doubled=True)
    assert b.dtype == torch.int32
    assert tuple(b.shape) == a.shape == (2 * hw[0], 2 * hw[1])
    np.testing.assert_array_equal(a, b.numpy())
    np.testing.assert_array_equal(oracle.integral_image(img, doubled=True),
                                  b.numpy())


def test_doubled_upsample_rounds_half_to_even():
    # averages of .5 and .25 / .75 fractions: 0.5 -> 0, 1.5 -> 2, 2.5 -> 2
    img = np.array([[0, 1, 4], [2, 3, 1]], np.uint8)
    ii = ti.integral_image(torch.as_tensor(img), doubled=True).numpy()
    up = np.diff(np.diff(ii, axis=0), axis=1)
    np.testing.assert_array_equal(up, [[0, 0, 1, 2, 4], [1, 2, 2, 2, 2],
                                       [2, 2, 3, 2, 1]])


@pytest.mark.parametrize("hw", [(240, 320), (960, 1280), (1080, 1920)])
def test_doubled_schedule_reads_inside_the_integral_image(hw):
    """Kernel A's static plan at the doubled shapes: `octave_plan` raises
    if a layer would read outside the (2H, 2W) integral image."""
    cfg = cst.SurfConfig(doubled=True)
    cj = jst.SurfConfig(doubled=True)
    h, w = hw
    assert cfg.octave_shapes(h, w) == cj.octave_shapes(h, w)
    scheds, shapes = cfg.hessian_schedule(h, w), cfg.octave_shapes(h, w)
    for o in range(cfg.noctaves):
        plan = octave_plan(cfg, scheds, shapes, o, 2 * h, 2 * w)
        assert (plan["oh"], plan["ow"]) == shapes[o] and plan["d"] == 4 << o
    for name in ("max_iradius", "max_desc_span", "max_ori_span", "sampling"):
        assert getattr(cfg, name) == getattr(cj, name), name


@pytest.fixture(scope="module")
def frame():
    return render_plane_sequence(1, 240, 320, seed=0, motion=0.02)[0][0]


def _both(frame, upright):
    cfg_j = jst.SurfConfig(noctaves=4, thresh=4.0, upright=upright,
                           doubled=True, max_pts=512,
                           candidates_per_octave=512,
                           wavelet_method="gather", detect_backend="xla")
    kj, dj = jst.Surf(cfg_j).detect_and_compute(frame)
    kt, dt = cst.Surf(cst.config_from_jax(cfg_j),
                      device="cpu").detect_and_compute(frame)
    return kj, np.asarray(dj), kt, dt.numpy()


def test_doubled_upright_surf_equals_jax(frame):
    kj, dj, kt, dt = _both(frame, upright=True)
    assert assert_keypoints_match(kj, kt) > 50
    v = np.asarray(kj.valid)
    assert row_cosines(dj[v], dt[v]).min() >= 0.99999
    assert (dt[~v] == 0).all()


def test_doubled_rotated_surf_equals_jax(frame):
    kj, dj, kt, dt = _both(frame, upright=False)
    assert assert_keypoints_match(kj, kt) > 50
    ii = ti.integral_image(torch.as_tensor(frame), doubled=True)
    ws, wa = orientation_windows(ii, kt.x, kt.y, kt.scale, kt.valid,
                                 doubled=True)
    near = check_orientations(np.asarray(kj.ori), kt.ori, ws, wa, kt.valid)
    assert near.sum() <= 3
    assert kt.ori[kt.valid].abs().max() > 1.0       # really rotated
    v = np.asarray(kj.valid) & ~near
    assert row_cosines(dj[v], dt[v]).min() >= 0.9999
    assert (dt[~np.asarray(kj.valid)] == 0).all()


def test_doubled_differs_from_plain(frame):
    """Doubled mode is another detector, not a no-op: it finds keypoints
    the plain mode does not (finer first octave)."""
    kw = dict(noctaves=4, thresh=4.0, max_pts=512, candidates_per_octave=512)
    k1, _ = cst.Surf(cst.SurfConfig(**kw), device="cpu").detect_and_compute(frame)
    k2, _ = cst.Surf(cst.SurfConfig(doubled=True, **kw),
                     device="cpu").detect_and_compute(frame)
    assert int(k2.count) != int(k1.count)
    assert float(k2.scale[k2.valid].min()) < float(k1.scale[k1.valid].min())
