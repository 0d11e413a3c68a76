"""Kernel B's module: the port's descriptors against the JAX package's
`describe`, with its Pallas kernels under the interpreter (and its XLA
gather path), in all four modes: upright / rotated x 64-d / extended
128-d.  Rotated rows take the same seeded `ori` array on both sides.

The keypoint set holds spans (iradius*step + iscale + 1) both <= 63 and
> 63, so both TPU kernels kernel B replaces are held: patch_wavelets'
`_kernel_tiles_res` (span <= 63) and patch_bucketed's `_kernel` in
"desc" mode (span > 63), and with them the rotated and extended
branches of their shared `patch_common._bin_descriptor`.  Tolerance:
per-row cosine >= 0.99999 (the two sum the same samples in different
orders), invalid rows exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu import SurfConfig as JaxConfig
from cuda_surf_tpu.ops.descriptor import describe as jax_describe
from cuda_surf_tpu.ops.integral import integral_image as jax_integral

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, describe
from cuda_surf_tpu_torch.ops.integral import integral_image
from torch_parity import describe_scene, row_cosines


@pytest.fixture(scope="module")
def scene():
    return describe_scene()


def test_keypoint_set_covers_both_tpu_kernels(scene):
    img, x, y, scale, valid = scene
    cfg = cst.SurfConfig(noctaves=4, max_pts=x.size)
    _, _, step, iscale, irad, *_ = desc_geometry(
        cfg, torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(scale),
        None)
    span = (irad * step + iscale + 1).numpy()[valid]
    assert (span <= 63).sum() >= 5 and (span > 63).sum() >= 5, span


def _compare(scene, method, ori, **mode):
    img, x, y, scale, valid = scene
    cfg_j = JaxConfig(noctaves=4, max_pts=x.size, wavelet_method=method,
                      **mode)
    dj = np.asarray(jax.jit(lambda *a: jax_describe(
        jax_integral(jnp.asarray(img)), cfg_j, *a))(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(scale),
        jnp.asarray(ori), jnp.asarray(valid)))
    t = torch.as_tensor
    dt = describe(integral_image(t(img)), cst.config_from_jax(cfg_j), t(x),
                  t(y), t(scale), t(ori), t(valid)).numpy()
    assert dt.shape == dj.shape == (x.size, cfg_j.nfeatures)
    live = valid & (np.abs(dj).sum(1) > 0)
    assert live.sum() >= 15
    assert row_cosines(dj[live], dt[live]).min() >= 0.99999
    assert (dt[~valid] == 0).all()


@pytest.mark.parametrize("method", ["interpret", "gather"])
def test_describe_matches_jax(scene, method):
    _compare(scene, method, np.zeros_like(scene[1]))


@pytest.mark.parametrize("method", ["interpret", "gather"])
@pytest.mark.parametrize("mode", [dict(upright=False),
                                  dict(upright=True, extended=True),
                                  dict(upright=False, extended=True)],
                         ids=["rotated64", "upright128", "rotated128"])
def test_rotated_and_extended_describe_match_jax(scene, method, mode):
    ori = np.random.default_rng(4).uniform(-np.pi, np.pi, scene[1].shape)
    _compare(scene, method, ori.astype(np.float32), **mode)

