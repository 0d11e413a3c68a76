"""The PyTorch port's config, data model, IO and package structure, held
against the JAX package.  Exact comparisons throughout: everything here
is integer geometry, NumPy, or a stable index compaction."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu.config as jax_config
from cuda_surf_tpu import SurfConfig as JaxConfig
from cuda_surf_tpu.io.image import write_pgm, read_pgm as jax_read_pgm
from cuda_surf_tpu.slam.sequence import render_plane_sequence as jax_render
from cuda_surf_tpu.types import compact as jax_compact

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.io import read_pgm, render_plane_sequence
from cuda_surf_tpu_torch.types import (compact, keypoints_from_numpy,
                                       keypoints_to_numpy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("hw", [(120, 160), (240, 320), (960, 1280),
                                (1080, 1920)])
@pytest.mark.parametrize("kw", [{}, dict(noctaves=5, init_mask_size=15),
                                dict(upright=False, extended=True)])
def test_schedules_equal_jax(hw, kw):
    cj = JaxConfig(**kw)
    ct = cst.config_from_jax(cj)
    h, w = hw
    assert ct.octave_shapes(h, w) == cj.octave_shapes(h, w)
    sj, st = cj.hessian_schedule(h, w), ct.hessian_schedule(h, w)
    assert len(sj) == len(st)
    for a, b in zip(sj, st):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.maximum_borders() == b.maximum_borders()
    for name in ("max_candidates", "max_iradius", "max_desc_span",
                 "desc_grid", "nfeatures", "max_scale", "sampling",
                 "max_ori_span"):
        assert getattr(ct, name) == getattr(cj, name), name


def test_config_from_jax_round_trips():
    cj = JaxConfig(noctaves=3, thresh=2.5, max_pts=777,
                   candidates_per_octave=300, interp_moves=3,
                   wavelet_method="interpret", detect_backend="xla")
    ct = cst.config_from_jax(cj)
    shared = {f.name for f in dataclasses.fields(ct)}
    assert shared <= {f.name for f in dataclasses.fields(cj)}
    for name in shared:
        assert getattr(ct, name) == getattr(cj, name), name
    # and back: the copy builds an equal JAX config
    assert JaxConfig(**dataclasses.asdict(ct)) == dataclasses.replace(
        cj, wavelet_method="auto", detect_backend="auto", detect_fit="dense")
    assert cst.config_from_jax(ct) == ct


def test_orientation_constants_equal_jax():
    from cuda_surf_tpu_torch import config as tc
    for name in ("NBIN", "WINDOW", "SEP_ANGLE", "HWN", "ORADIUS",
                 "ORADIUS_SQ"):
        assert getattr(tc, name) == getattr(jax_config, name), name
    assert tc.lut1() == jax_config.lut1()
    assert tc.bin_centers() == jax_config.bin_centers()


@pytest.mark.parametrize("n,cap,p", [(50, 16, 0.5), (300, 64, 0.1),
                                     (40, 64, 0.3), (10, 4, 0.0)])
def test_compact_matches_jax(n, cap, p):
    rng = np.random.default_rng(n + cap)
    mask = rng.random(n) < p
    a = rng.normal(size=n).astype(np.float32)
    b = rng.integers(-9, 9, n).astype(np.int32)
    cj, vj, aj, bj = jax_compact(jnp.asarray(mask), cap, jnp.asarray(a),
                                 jnp.asarray(b))
    ct, vt, at, bt = compact(torch.as_tensor(mask), cap, torch.as_tensor(a),
                             torch.as_tensor(b))
    assert int(cj) == int(ct) == min(int(mask.sum()), cap)
    np.testing.assert_array_equal(np.asarray(vj), vt.numpy())
    np.testing.assert_array_equal(np.asarray(aj), at.numpy())
    np.testing.assert_array_equal(np.asarray(bj), bt.numpy())
    # stable, valid-first, zero-filled, truncated in index order
    np.testing.assert_array_equal(at.numpy()[:int(ct)], a[mask][:cap])
    assert (at.numpy()[int(ct):] == 0).all()


def test_keypoints_numpy_round_trip():
    rng = np.random.default_rng(3)
    n = 12
    src = dict(x=rng.random(n), y=rng.random(n), scale=rng.random(n) + 1,
               strength=rng.random(n), laplace=rng.choice([-1, 1], n),
               ori=np.zeros(n), octave=rng.integers(0, 4, n),
               valid=rng.random(n) < 0.5, count=np.int32(5))
    kp = keypoints_from_numpy(src, "cpu")
    assert kp.x.dtype == torch.float32 and kp.laplace.dtype == torch.int32
    assert kp.valid.dtype == torch.bool and kp.count.shape == ()
    assert kp.capacity == n
    back = keypoints_to_numpy(kp)
    for k, v in src.items():
        np.testing.assert_allclose(back[k], v, rtol=1e-6)


def test_renderer_and_pgm_reader_equal_jax(tmp_path):
    fj, cj, ij = jax_render(2, 60, 80, seed=5, motion=0.03)
    ft, ct, it = render_plane_sequence(2, 60, 80, seed=5, motion=0.03)
    np.testing.assert_array_equal(fj, ft)
    np.testing.assert_array_equal(cj, ct)
    assert tuple(ij) == tuple(it)
    path = str(tmp_path / "f.pgm")
    write_pgm(path, ft[1])
    np.testing.assert_array_equal(read_pgm(path), jax_read_pgm(path))
    np.testing.assert_array_equal(read_pgm(path), ft[1])


def test_package_never_imports_jax():
    code = ("import sys, cuda_surf_tpu_torch, cuda_surf_tpu_torch.io, "
            "cuda_surf_tpu_torch.frontend, cuda_surf_tpu_torch._build; "
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'cuda_surf_tpu.')) or m == 'cuda_surf_tpu'); "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=REPO, timeout=120)


def test_package_import_builds_nothing():
    build_dir = os.path.join(REPO, "cuda_surf_tpu_torch", "_build")
    before = os.path.exists(build_dir)
    code = "import cuda_surf_tpu_torch.ops.fused_detect, chip_smoke"
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert os.path.exists(build_dir) == before


def test_surf_on_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cst.Surf(cst.SurfConfig(), device="cuda")


def test_chip_smoke_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
