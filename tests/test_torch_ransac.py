"""RANSAC and tracking: the port's `ransac_essential` and `track_pair` on
the CPU against the JAX package's, with the JAX run's random draw handed
to the port (`raw`, from `jax.random.randint` on the JAX key, exactly as
epipolar.py:217 draws it), so both score the same samples.

Tolerances, in every case: R within 1e-3 rad of the JAX rotation; t's
direction within 1e-3 rad; `n_inliers` within 1 %; the inlier masks equal
except at points whose Sampson error lies within 1 % of the threshold.
`ransac_essential` runs on tests/test_geometry.py's synthetic pair (30 %
outliers, the last 7 rows masked) at three seeds, `track_pair` on frames 0
and 1 of the 12-frame terrain orbit at 200x280 through each package's own
`Surf` (the SLAM tests' config).

The 8-point solver's minimal fits are near-singular (the 9x9 normal matrix
of 8 points), and their unprojected scores tie within one inlier among the
all-inlier samples; which of those wins then rests on float32 rounding.
At seed 3 with the mask, the JAX program and eager JAX pick different
winners from the same samples, and the port, which picks as eager JAX
does, ends 7 degrees off.  The seeds here have a clear winner.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.geometry import epipolar as jep
from cuda_surf_tpu.slam import track_pair as jax_track_pair

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.geometry import epipolar as tep
from cuda_surf_tpu_torch.io import TERRAIN_VO, render_terrain_sequence
from cuda_surf_tpu_torch.slam import track_pair
from test_torch_epipolar import synthetic_pair


def jax_raw(key, n_hypotheses, n_pts):
    return np.array(jax.random.randint(key, (n_hypotheses, n_pts), 0,
                                       jnp.iinfo(jnp.int32).max))


def _angle(Ra, Rb):
    c = (np.trace(np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T)
         - 1) / 2
    return float(np.arccos(np.clip(c, -1, 1)))


def assert_same_geometry(res_t, res_j, x1, x2, valid, thresh):
    """The port's TwoViewResult / TrackResult against the JAX one."""
    assert _angle(res_t.R.numpy(), res_j.R) < 1e-3
    tt, tj = res_t.t.numpy().astype(np.float64), np.asarray(res_j.t,
                                                            np.float64)
    cos = tt @ tj / (np.linalg.norm(tt) * np.linalg.norm(tj))
    assert np.arccos(np.clip(cos, -1, 1)) < 1e-3
    nt, nj = int(res_t.n_inliers), int(res_j.n_inliers)
    assert abs(nt - nj) <= 0.01 * nj, (nt, nj)
    err = tep.sampson_error(_essential(res_t), torch.as_tensor(x1),
                            torch.as_tensor(x2)).numpy()
    edge = np.abs(err - thresh) < 0.01 * thresh
    differ = res_t.inliers.numpy() != np.asarray(res_j.inliers)
    assert not (differ & ~edge).any(), np.nonzero(differ & ~edge)
    assert not (res_t.inliers.numpy() & ~valid).any()
    return nt, nj


def _essential(res):
    """E = [t]x R of a result: the final E up to sign, which the inlier
    test read."""
    t = res.t
    tx = torch.stack([torch.stack([0 * t[0], -t[2], t[1]]),
                      torch.stack([t[2], 0 * t[0], -t[0]]),
                      torch.stack([-t[1], t[0], 0 * t[0]])])
    return tx @ res.R


@pytest.mark.parametrize("solver,n_hyp", [("8pt", 256), ("5pt", 128)])
def test_ransac_essential_matches_jax(solver, n_hyp):
    run_jax = jax.jit(jep.ransac_essential,
                      static_argnames=("n_hypotheses", "solver"))
    key = jax.random.PRNGKey(0)
    raw = torch.as_tensor(jax_raw(key, n_hyp, 8 if solver == "8pt" else 5))
    for seed in (4, 5, 6):
        x1, x2, R_true, _ = synthetic_pair(seed, noise=1e-4, outliers=0.3)
        valid = np.ones(len(x1), bool)
        valid[-7:] = False
        res_j = run_jax(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                        key, n_hypotheses=n_hyp, solver=solver)
        res_t = tep.ransac_essential(
            torch.as_tensor(x1), torch.as_tensor(x2), torch.as_tensor(valid),
            n_hypotheses=n_hyp, solver=solver, raw=raw)
        nt, _ = assert_same_geometry(res_t, res_j, x1, x2, valid, 1e-4)
        assert nt > 0.6 * len(x1)
        assert _angle(res_t.R.numpy(), R_true) < np.radians(1.0)
        assert res_t.points3d.shape == (len(x1), 3)
        assert res_t.n_inliers.dtype == torch.int32


def test_track_pair_terrain_matches_jax():
    frames, _, intr = render_terrain_sequence(**TERRAIN_VO, first=2)
    cfg_j = jst.SurfConfig(**VO_CONFIG, wavelet_method="gather",
                           detect_backend="xla")
    sj = jst.Surf(cfg_j)
    st = cst.Surf(cst.SurfConfig(**VO_CONFIG), device="cpu")
    (kj1, dj1), (kj2, dj2) = [sj.detect_and_compute(f) for f in frames]
    (kt1, dt1), (kt2, dt2) = [st.detect_and_compute(f) for f in frames]
    assert [int(k.count) for k in (kt1, kt2)] == \
        [int(k.count) for k in (kj1, kj2)]
    key = jax.random.PRNGKey(0)
    res_j = jax.jit(jax_track_pair)(kj1, dj1, kj2, dj2, intr, key)
    res_t = track_pair(kt1, dt1, kt2, dt2, intr,
                       raw=torch.as_tensor(jax_raw(key, 128, 5)))
    f = lambda x, y: tep.normalize_with_intrinsics(
        torch.stack([x, y], -1), *intr[:2], *intr[2:]).numpy()
    x1 = f(kt1.x, kt1.y)
    x2 = f(res_t.matches.match_x, res_t.matches.match_y)
    good = (res_t.matches.valid & (res_t.matches.ambiguity < 0.95)).numpy()
    nt, nj = assert_same_geometry(res_t, res_j, x1, x2, good, 2e-5)
    assert nt > 60, nt
    np.testing.assert_array_equal(res_t.matches.index.numpy(),
                                  np.asarray(res_j.matches.index))
