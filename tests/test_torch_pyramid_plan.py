"""Kernel A's cached plan (fused_detect.pyramid_plan) and the frame
dimension of `fused_pyramid`, on the CPU.

The CUDA kernel cannot run here, so what surrounds it is held instead:
the packed plan's geometry against `octave_plan`, the tile table's
coverage, and `torch_parity.emulate_kernel_a`, a plain-torch walk over
the plan as the kernel walks it (tile plus halo, -inf outside the octave,
the 32 corner offsets, the staged patch's column planes), whose layers
must equal `hessian.response_pyramid` bit for bit and whose masks
`extrema._candidate_mask`.  The stack form of `fused_pyramid` is held
against the per-frame form exactly and against the JAX package's fused
kernel (Pallas interpreter) as tests/test_torch_detect.py holds one
frame: layers at 1e-5 relative (XLA:CPU contracts FMAs), masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu import SurfConfig as JaxConfig
from cuda_surf_tpu.ops import fused_detect as jfd

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops import fused_detect as tfd
from cuda_surf_tpu_torch.ops.integral import integral_image
from torch_parity import emulate_kernel_a, kron_image

# (h, w, doubled): 240x320 as the detect tests; 97x131 and 150x211, where no
# octave is a multiple of the 14x30 tile; doubled frames (sampling step 4 at
# octave 0), one of them of such a size
SIZES = [(240, 320, False), (97, 131, False), (150, 211, False),
         (120, 160, True), (83, 109, True)]


def _scene(h, w, doubled):
    img = np.ascontiguousarray(kron_image()[:h, :w])
    cfg = cst.SurfConfig(noctaves=4, doubled=doubled)
    return cfg, integral_image(torch.as_tensor(img), doubled)


@pytest.mark.parametrize("h,w,doubled", SIZES)
def test_plan_geometry_equals_octave_plan(h, w, doubled):
    cfg, ii = _scene(h, w, doubled)
    plan = tfd.pyramid_plan(cfg, h, w, *ii.shape, "cpu")
    assert tfd.pyramid_plan(cfg, h, w, *ii.shape, "cpu") is plan      # cached
    scheds, shapes = cfg.hessian_schedule(h, w), cfg.octave_shapes(h, w)
    tab = plan.dev.numpy()
    assert tab.dtype == np.int32 and np.array_equal(tab, plan.table)
    assert tab[:3].tolist() == [cfg.noctaves, cfg.max_scale, len(plan.tiles)]
    total = 0
    for o in range(cfg.noctaves):
        want = tfd.octave_plan(cfg, scheds, shapes, o, *ii.shape)
        g = tab[tfd.PLAN_HEADER + o * tfd.OCT_INTS:][:tfd.OCT_INTS]
        assert g[:3].tolist() == [want["oh"], want["ow"], want["d"]]
        assert g[9] == plan.offsets[o] == total
        total += want["ms"] * want["oh"] * want["ow"]
        for li in range(want["ms"]):
            L = g[tfd.OCT_HEADER + li * tfd.LAYER_INTS:][:tfd.LAYER_INTS]
            assert L[:4].tolist() == want["geom"][li, :4].tolist()
            assert L[4:5].view(np.float32)[0] == want["norm"][li]
            assert L[5:9].tolist() == want["win"][li].tolist()
    assert plan.total == total
    # 24 KB of patch stages, at the sampling step 2 of octave 0 alone
    assert plan.staged == ((not doubled), False, False, False)
    words = cfg.max_scale * (tfd.TILE_H + 2) * (tfd.TILE_W + 2)
    assert plan.smem_bytes == 4 * (words + (0 if doubled else 64 * 96))


@pytest.mark.parametrize("h,w,doubled", SIZES)
def test_tile_table_covers_every_output_exactly_once(h, w, doubled):
    cfg, ii = _scene(h, w, doubled)
    plan = tfd.pyramid_plan(cfg, h, w, *ii.shape, "cpu")
    octs = plan.tiles[:, 0]
    assert (np.diff(octs) <= 0).all() and octs[-1] == 0    # octave 0 last
    for o, (oh, ow) in enumerate(cfg.octave_shapes(h, w)):
        seen = np.zeros((oh, ow), np.int32)
        for _, r, c in plan.tiles[octs == o].tolist():
            assert r % tfd.TILE_H == 0 and c % tfd.TILE_W == 0
            seen[r:r + tfd.TILE_H, c:c + tfd.TILE_W] += 1
        assert (seen == 1).all(), o


@pytest.mark.parametrize("h,w,doubled", SIZES)
def test_tiled_emulation_matches_twins(h, w, doubled):
    """The kernel's walk over the plan: octave 0's patch in shared memory
    and the other octaves gathering; on a doubled frame every octave
    gathers."""
    cfg, ii = _scene(h, w, doubled)
    plan = tfd.pyramid_plan(cfg, h, w, *ii.shape, "cpu")
    pyr, masks = tfd.fused_pyramid(ii, cfg, h, w)
    lay_e, mask_e, writes = emulate_kernel_a(ii, plan, cfg.thresh)
    for o in range(cfg.noctaves):
        assert (writes[o] == 1).all(), o
        assert torch.equal(lay_e[o], pyr[o]), o
        assert torch.equal(mask_e[o], masks[o]), o
    assert sum(int(m.sum()) for m in mask_e) > 50


def test_fused_pyramid_on_a_stack_equals_per_frame_and_jax():
    img = kron_image()
    frames = np.stack([img, np.ascontiguousarray(img[::-1, ::-1])])
    h, w = img.shape
    cfg_j = JaxConfig(noctaves=4, thresh=4.0, upright=True, max_pts=1024,
                      detect_backend="fused_interpret",
                      wavelet_method="gather")
    cfg = cst.config_from_jax(cfg_j)
    ii = torch.stack([integral_image(torch.as_tensor(f)) for f in frames])
    pyr_b, masks_b = tfd.fused_pyramid(ii, cfg, h, w)
    assert len(pyr_b) == len(masks_b) == cfg.noctaves
    for f in range(2):
        pyr, masks = tfd.fused_pyramid(ii[f], cfg, h, w)
        pyr_j, masks_j = jfd.fused_pyramid(jnp.asarray(frames[f]), cfg_j, h, w,
                                           interpret=True)
        for o in range(cfg.noctaves):
            assert pyr_b[o].shape == (2, *pyr[o].shape)
            assert masks_b[o].dtype == torch.bool
            assert torch.equal(pyr_b[o][f], pyr[o])
            assert torch.equal(masks_b[o][f], masks[o])
            a, b = np.asarray(pyr_j[o]), pyr_b[o][f].numpy()
            assert np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)) < 1e-5
            np.testing.assert_array_equal(np.asarray(masks_j[o]),
                                          masks_b[o][f].numpy())
        assert sum(int(m[f].sum()) for m in masks_b) > 10


def test_plan_and_wrapper_reject_what_the_kernel_does_not_take():
    cfg = cst.SurfConfig(noctaves=2, init_mask_size=21)    # 9 layers an octave
    with pytest.raises(ValueError, match="layers"):
        tfd.pyramid_plan(cfg, 240, 320, 241, 321, "cpu")
    ii = torch.zeros((2, 2, 50, 60), dtype=torch.int32)
    with pytest.raises(ValueError, match="ii must be"):
        tfd.fused_pyramid(ii, cst.SurfConfig(noctaves=1), 49, 59)
