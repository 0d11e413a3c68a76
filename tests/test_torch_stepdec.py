"""The static-step describe route of the port (`patch_wavelets.step_rows`,
`DEC_STEPS`) against the JAX package's step-decimated kernel and against
the port's own unrouted rows.

The scene is tests/test_patch_wavelets.py's: a 360x520 random image,
fourteen keypoints whose sampling steps cover 4..9, at interior and border
positions, one slot invalid.  `DEC_STEPS` is empty by default in both
packages; the tests set it to (4, 5, 6, 7, 8) and restore it.  The JAX
side runs `_kernel_sdec` under the Pallas interpreter.

Tolerances: against JAX, normalised descriptors at atol 2e-6 (that
test's own bar between the JAX routes) + 2e-6 for the FMAs XLA:CPU
contracts and the port does not; against the port's unrouted rows, exact:
the routed rows are the same twin on complementary masks, added.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.ops import patch_wavelets as jpw
from cuda_surf_tpu.ops.descriptor import describe as jax_describe

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops import patch_wavelets as tpw
from cuda_surf_tpu_torch.ops.descriptor import (desc_geometry, describe,
                                                describe_plain)
from cuda_surf_tpu_torch.ops.integral import integral_image

DEC = (4, 5, 6, 7, 8)


def scene():
    img = np.random.default_rng(0).integers(0, 256, (360, 520), np.uint8)
    scales = [4.5, 5.6, 6.8, 8.0, 9.2, 10.4, 11.0]
    xs = [60.3, 250.0, 510.5, 30.2, 400.8, 200.1, 8.0]
    ys = [55.7, 180.4, 300.9, 352.5, 12.3, 150.6, 355.0]
    x = np.array(xs * 2, np.float32)
    y = np.array(ys * 2, np.float32)
    scale = np.array(scales * 2, np.float32)
    valid = np.ones(x.shape, bool)
    valid[-1] = False
    return img, x, y, scale, np.zeros_like(x), valid


@pytest.fixture
def dec_steps():
    """Route steps 4..8 through the static-step path in both packages."""
    orig = jpw.DEC_STEPS, tpw.DEC_STEPS
    jpw.DEC_STEPS = tpw.DEC_STEPS = DEC
    yield DEC
    jpw.DEC_STEPS, tpw.DEC_STEPS = orig


def _torch_scene(cfg):
    img, x, y, scale, ori, valid = scene()
    t = torch.as_tensor
    ii = integral_image(t(img))
    return ii, (t(x), t(y), t(scale), t(ori)), t(valid)


def test_step_bounds_equal_jax():
    for kw in (dict(), dict(upright=False), dict(noctaves=5)):
        cj, ct = jst.SurfConfig(**kw), cst.SurfConfig(**kw)
        for sd in range(1, 14):
            assert ct.desc_step_bounds(sd) == cj.desc_step_bounds(sd), (kw, sd)
    assert jpw.DEC_STEPS == tpw.DEC_STEPS == ()       # off by default


def test_routed_describe_equals_jax_step_kernel(dec_steps):
    img, x, y, scale, ori, valid = scene()
    cj = jst.SurfConfig(noctaves=4, max_pts=x.size, wavelet_method="interpret")
    ii_j = integral_image(torch.as_tensor(img)).numpy()
    dj = jax.jit(lambda: jax_describe(
        jnp.asarray(ii_j), cj, *(jnp.asarray(a) for a in (x, y, scale, ori,
                                                          valid))))()
    ct = cst.config_from_jax(cj)
    ii, kp, v = _torch_scene(ct)
    dt = describe(ii, ct, *kp, v)
    assert np.any(dt.numpy() != 0)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=4e-6)


@pytest.mark.parametrize("mode", [dict(), dict(upright=False),
                                  dict(extended=True)],
                         ids=["upright64", "rotated64", "upright128"])
def test_routed_rows_equal_unrouted_rows(mode):
    cfg = cst.SurfConfig(noctaves=4, max_pts=14, **mode)
    ii, (x, y, scale, _), v = _torch_scene(cfg)
    ori = torch.as_tensor(np.random.default_rng(3).uniform(-3, 3, 14)
                          .astype(np.float32))
    geom = desc_geometry(cfg, x, y, scale, ori)
    plain = tpw.descriptor_rows(ii, cfg, *geom, v)
    tpw.DEC_STEPS = DEC
    try:
        routed = tpw.descriptor_rows(ii, cfg, *geom, v)
    finally:
        tpw.DEC_STEPS = ()
    assert torch.equal(routed, plain)
    assert (plain.abs().sum(1) > 0).sum() >= 10


def test_step_twin_takes_its_step_in_stable_order():
    cfg = cst.SurfConfig(noctaves=4, max_pts=14)
    ii, (x, y, scale, ori), v = _torch_scene(cfg)
    geom = desc_geometry(cfg, x, y, scale, ori)
    step = geom[2].numpy()
    assert set(DEC) <= set(step) and 9 in step        # a tail stays behind
    full = describe_plain(ii, cfg, *geom, v)
    seen = torch.zeros_like(v)
    for sd in DEC:
        rows, taken = tpw.step_rows(ii, cfg, *geom, v, elig=v, sd=sd)
        np.testing.assert_array_equal(taken.numpy(), v.numpy() & (step == sd))
        assert torch.equal(rows[taken], full[taken])
        assert not rows[~taken].any()
        seen |= taken
    assert not seen[-1] and seen.sum() == (v.numpy() & (step <= 8)).sum()


def test_cap_leaves_the_overflow_to_the_fallback():
    cfg = cst.SurfConfig(noctaves=4, max_pts=14)
    ii, (x, y, scale, ori), v = _torch_scene(cfg)
    scale = torch.full_like(scale, 6.8)                 # every step is 6
    geom = desc_geometry(cfg, x, y, scale, ori)
    assert (geom[2] == 6).all()
    rows, taken = tpw.step_rows(ii, cfg, *geom, v, elig=v, sd=6, cap=5)
    np.testing.assert_array_equal(np.flatnonzero(taken.numpy()),
                                  [0, 1, 2, 3, 4])     # the first five
    assert not rows[5:].any()
    taken2, slot, sel, count = tpw.step_selection(geom[2], v, 6, 5)
    assert int(count) == 5 and sel.tolist() == [0, 1, 2, 3, 4]
    assert slot.tolist() == [0, 1, 2, 3, 4] + [5] * 9
    # routed with the small cap: the fallback describes the other eight
    full = describe_plain(ii, cfg, *geom, v)
    rest = describe_plain(ii, cfg, *geom, v & ~taken)
    assert torch.equal(rows + rest, full)
    assert (rest[5:13].abs().sum(1) > 0).all() and not rest[:5].any()


def test_doubled_and_stacked_modes_skip_the_step_route(dec_steps):
    """As in the JAX package, the route is for one frame, not doubled."""
    cfg = cst.SurfConfig(noctaves=4, max_pts=14, doubled=True)
    ii, (x, y, scale, ori), v = _torch_scene(cst.SurfConfig())
    geom = desc_geometry(cfg, x / 2, y / 2, scale / 2, ori)
    calls = []
    orig = tpw.step_rows
    tpw.step_rows = lambda *a, **k: calls.append(k["sd"]) or orig(*a, **k)
    try:
        tpw.descriptor_rows(ii, cfg, *geom, v)
        cfg1 = dataclasses.replace(cfg, doubled=False)
        tpw.descriptor_rows(ii[None], cfg1, *geom, v,
                            frame=torch.zeros(14, dtype=torch.int32))
        assert calls == []
        tpw.descriptor_rows(ii, cfg1, *geom, v)
        assert calls == list(DEC)
    finally:
        tpw.step_rows = orig
