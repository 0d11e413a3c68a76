"""Kernel D's module: the port's orientation assignment (its plain twin,
`assign_orientations_plain`) against the JAX package's
`assign_orientations`, with the Pallas "grids" kernel under the
interpreter and on the XLA gather path.

Inputs: `describe_scene()`'s 25 hand-placed keypoints plus one near-tie
keypoint built for the purpose (a point-symmetric patch, whose histogram
repeats itself half a turn on, so two opposite windows tie), and the
keypoints the port detects on a rendered 240x320 frame.

Tolerance: orientation within 1e-4 rad on the circle wherever the top-two
window gap is >= 1e-5 relative; below that (a near tie) either package
may pick either of the two top windows, and must agree with one of them
to 1e-4 rad.  The two sum the histogram in different orders, and the
JAX CPU reference may contract FMAs, so they are not compared bit for
bit.  `fast_atan2` agrees to 4e-7 rad (one float32 ulp of pi).

Kernel D's plan, walked in numpy: tests/test_torch_orientation_plan.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu import SurfConfig as JaxConfig
from cuda_surf_tpu.ops.integral import integral_image as jax_integral
from cuda_surf_tpu.ops.orientation import (assign_orientations as jax_orient,
                                           fast_atan2 as jax_atan2)

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.io import render_plane_sequence
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 fast_atan2,
                                                 orientation_windows,
                                                 top2_windows)
from torch_parity import check_orientations, describe_scene

TIE = (100, 236)   # (y, x) of the near-tie keypoint


def tie_scene():
    """describe_scene() with a point-symmetric 81x81 patch pasted around
    TIE and one more keypoint there (scale 2.5: its disc reaches 35 px)."""
    img, x, y, scale, valid = describe_scene()
    p = np.random.default_rng(9).integers(0, 128, (81, 81))
    sym = (p + p[::-1, ::-1]).astype(np.uint8)
    img = img.copy()
    img[TIE[0] - 40:TIE[0] + 41, TIE[1] - 40:TIE[1] + 41] = sym
    f32 = lambda a, v: np.append(a, np.float32(v))
    return (img, f32(x, TIE[1]), f32(y, TIE[0]), f32(scale, 2.5),
            np.append(valid, True))


def _port(img, x, y, scale, valid):
    t = torch.as_tensor
    ii = integral_image(t(img))
    args = (t(x), t(y), t(scale), t(valid))
    cfg = cst.SurfConfig(upright=False)
    return (assign_orientations(ii, cfg, *args),
            *orientation_windows(ii, *args))


def test_fast_atan2_matches_jax():
    rng = np.random.default_rng(1)
    yx = rng.normal(size=(2, 20000)).astype(np.float32)
    yx[:, :8] = [[0, 1, -1, 0, 2, -2, 3, -3], [1, 0, 0, -1, 2, 2, -3, -3]]
    got = fast_atan2(torch.as_tensor(yx[0]), torch.as_tensor(yx[1])).numpy()
    ref = np.asarray(jax_atan2(jnp.asarray(yx[0]), jnp.asarray(yx[1])))
    np.testing.assert_allclose(got, ref, rtol=0, atol=4e-7)
    assert np.abs(got).max() <= np.pi + 1e-6


def test_symmetric_patch_is_a_near_tie():
    img, x, y, scale, valid = tie_scene()
    sym = img[TIE[0] - 40:TIE[0] + 41, TIE[1] - 40:TIE[1] + 41]
    np.testing.assert_array_equal(sym, sym[::-1, ::-1])
    _, ws, wa = _port(img, x, y, scale, valid)
    gap = top2_windows(ws, wa)[0].numpy()
    assert gap[-1] < 1e-5
    assert (gap[:-1][valid[:-1]] >= 1e-5).sum() >= 15


@pytest.mark.parametrize("method", ["interpret", "gather"])
def test_orientation_matches_jax(method):
    img, x, y, scale, valid = tie_scene()
    cfg_j = JaxConfig(noctaves=4, upright=False, max_pts=x.size,
                      wavelet_method=method)
    ref = np.asarray(jax.jit(lambda *a: jax_orient(
        jax_integral(jnp.asarray(img)), cfg_j, *a))(
        *(jnp.asarray(a) for a in (x, y, scale, valid))))
    got, ws, wa = _port(img, x, y, scale, valid)
    near = check_orientations(ref, got, ws, wa, valid)
    assert near[-1]                       # the built tie is counted as one
    assert (got.numpy()[~valid] == 0).all()


def test_orientation_on_detected_keypoints_matches_jax():
    frame = render_plane_sequence(1, 240, 320, seed=0)[0][0]
    kp, _ = cst.detect_and_compute(torch.as_tensor(frame),
                                   cst.SurfConfig(max_pts=512,
                                                  candidates_per_octave=512),
                                   compute_descriptors=False)
    assert int(kp.count) > 50
    args = [a.numpy() for a in (kp.x, kp.y, kp.scale, kp.valid)]
    cfg_j = JaxConfig(noctaves=4, upright=False, max_pts=512,
                      wavelet_method="gather")
    ref = np.asarray(jax.jit(lambda *a: jax_orient(
        jax_integral(jnp.asarray(frame)), cfg_j, *a))(
        *(jnp.asarray(a) for a in args)))
    got, ws, wa = _port(frame, *args)
    near = check_orientations(ref, got, ws, wa, args[3])
    assert near.sum() <= 3


def test_orientation_wrapper_rejects_other_devices():
    img, x, y, scale, valid = describe_scene()
    t = lambda a: torch.as_tensor(a, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        assign_orientations(t(integral_image(torch.as_tensor(img))),
                            cst.SurfConfig(upright=False), t(x), t(y),
                            t(scale), t(valid))
