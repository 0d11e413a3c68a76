"""The port's integral image and box sums against the JAX package:
bit-exact (int32 throughout)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu.ops import integral as ji
from cuda_surf_tpu_torch.ops import integral as ti


@pytest.mark.parametrize("hw", [(1, 1), (7, 13), (120, 160), (241, 333)])
def test_integral_image_bit_exact(hw):
    rng = np.random.default_rng(hw[0] * 1000 + hw[1])
    img = rng.integers(0, 256, hw, np.uint8)
    a = np.asarray(ji.integral_image(jnp.asarray(img)))
    b = ti.integral_image(torch.as_tensor(img))
    assert b.dtype == torch.int32 and tuple(b.shape) == a.shape
    np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("shape, doubled", [((3, 7, 13), False),
                                            ((2, 41, 33), True),
                                            ((4, 120, 160), False)])
def test_integral_image_of_a_stack_is_per_frame(shape, doubled):
    """The (B, H, W) form: each frame's integral image equals the frame's
    own call and JAX's, bit for bit."""
    rng = np.random.default_rng(sum(shape))
    imgs = rng.integers(0, 256, shape, np.uint8)
    b = ti.integral_image(torch.as_tensor(imgs), doubled)
    h, w = (2 * shape[1], 2 * shape[2]) if doubled else (shape[1] + 1,
                                                         shape[2] + 1)
    assert b.dtype == torch.int32 and tuple(b.shape) == (shape[0], h, w)
    for f, img in enumerate(imgs):
        one = ti.integral_image(torch.as_tensor(img), doubled)
        assert torch.equal(b[f], one)
        np.testing.assert_array_equal(
            np.asarray(ji.integral_image(jnp.asarray(img), doubled)),
            b[f].numpy())


def test_integral_of_white_frame_is_exact_int32():
    # 255 * 960 * 1280 = 313,344,000: needs exact int32, not f32
    img = np.full((960, 1280), 255, np.uint8)
    b = ti.integral_image(torch.as_tensor(img))
    assert int(b[-1, -1]) == 255 * 960 * 1280


def test_box_sums_and_wavelets_bit_exact(small_image):
    rng = np.random.default_rng(11)
    iij = ji.integral_image(jnp.asarray(small_image))
    iit = ti.integral_image(torch.as_tensor(small_image))
    n = 200
    s = rng.integers(1, 8, n)
    x = rng.integers(8, small_image.shape[1] - 8, n)
    y = rng.integers(8, small_image.shape[0] - 8, n)
    for fj, ft in ((ji.wavelet_dx, ti.wavelet_dx), (ji.wavelet_dy, ti.wavelet_dy)):
        a = np.asarray(fj(iij, jnp.asarray(x), jnp.asarray(y), jnp.asarray(s)))
        b = ft(iit, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(s))
        np.testing.assert_array_equal(a, b.numpy())
    a = np.asarray(ji.box_sum(iij, jnp.asarray(x + s), jnp.asarray(y + s),
                              jnp.asarray(x - s), jnp.asarray(y - s)))
    b = ti.box_sum(iit, torch.as_tensor(x + s), torch.as_tensor(y + s),
                   torch.as_tensor(x - s), torch.as_tensor(y - s))
    np.testing.assert_array_equal(a, b.numpy())
