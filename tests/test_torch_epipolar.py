"""Two-view geometry: the port's `geometry.epipolar` on the CPU against the
JAX package's on the same correspondences (tests/test_geometry.py's
synthetic pair, from a local seeded generator).

Tolerances: `_eight_point` up to sign at 1e-4 after normalising to unit
norm, on 32-point fits (a minimal 8-point fit's 9x9 normal matrix is
nearly singular: two float32 solves of it differ at ~1e-2, and each is
as far from a float64 fit, port 9.4e-4 and JAX 3.5e-3 on this data);
`project_essential` as the product U diag(1, 1, 0) Vt at 1e-4 (the SVD's
column signs differ between LAPACK and XLA, the product does not);
`sampson_error` at 1e-4 relative; `_sampson_inlier_counts` equal, except
for points within 1e-4 relative of the threshold, which are counted apart;
`triangulate` at 1e-4 relative; `recover_pose`'s chosen R and t at 1e-4
(never its candidates, whose order depends on the SVD's signs).  Sampling:
the same valid rows as the reference's searchsorted for the same `raw`,
and clamped to the last row when no row is valid.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cuda_surf_tpu.geometry import epipolar as jep

from cuda_surf_tpu_torch.geometry import epipolar as tep


def _rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def synthetic_pair(seed, n=200, noise=0.0, outliers=0.0):
    """tests/test_geometry.py's _synthetic_pair with its own generator."""
    rng = np.random.default_rng(seed)
    R = _rotmat([0.2, 1.0, 0.1], 0.15)
    t = np.array([1.0, 0.1, 0.2])
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x1 = X[:, :2] / X[:, 2:]
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:]
    x1 += rng.normal(0, noise, x1.shape)
    x2 += rng.normal(0, noise, x2.shape)
    n_out = int(n * outliers)
    if n_out:
        x2[:n_out] = rng.uniform(-0.5, 0.5, (n_out, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R, t


def _unit(E):
    E = np.asarray(E, np.float64)
    return E / np.linalg.norm(E, axis=(-2, -1), keepdims=True)


def test_eight_point_and_projection_match_jax():
    x1, x2, _, _ = synthetic_pair(0, noise=1e-4, outliers=0.2)
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(np.arange(40, len(x1)), 32, replace=False)
                    for _ in range(16)])
    ones = np.ones(32, np.float32)
    Fj = jax.vmap(lambda i: jep._eight_point(jnp.asarray(x1)[i],
                                             jnp.asarray(x2)[i],
                                             jnp.asarray(ones)))(
        jnp.asarray(idx))
    Ft = tep._eight_point(torch.as_tensor(x1)[idx], torch.as_tensor(x2)[idx],
                          torch.ones(16, 32))
    a, b = _unit(Ft.numpy()), _unit(Fj)
    sign = np.sign((a * b).sum((-2, -1)))[:, None, None]
    np.testing.assert_allclose(a * sign, b, atol=1e-4)
    # a least-squares fit over a weighted mask, projected onto the manifold
    mask = (rng.random(len(x1)) < 0.7).astype(np.float32)
    Fj = jep._eight_point(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask))
    Ft = tep._eight_point(torch.as_tensor(x1), torch.as_tensor(x2),
                          torch.as_tensor(mask))
    Ej = _unit(jep.project_essential(Fj / jnp.linalg.norm(Fj)))
    Et = _unit(tep.project_essential(Ft / torch.linalg.norm(Ft)).numpy())
    sign = np.sign((Ej * Et).sum())
    np.testing.assert_allclose(Et * sign, Ej, atol=1e-4)
    np.testing.assert_allclose(np.linalg.svd(Et, compute_uv=False),
                               [2 ** -0.5, 2 ** -0.5, 0], atol=1e-5)


def test_sampson_error_and_inlier_counts_match_jax():
    x1, x2, R, t = synthetic_pair(2, noise=1e-3, outliers=0.3)
    rng = np.random.default_rng(3)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E0 = (tx @ R).astype(np.float32)
    Es = (E0 + rng.normal(0, 0.02, (48, 3, 3))).astype(np.float32)
    valid = rng.random(len(x1)) < 0.9
    thresh = 2e-5
    ej = np.asarray(jep.sampson_error(jnp.asarray(E0), jnp.asarray(x1),
                                      jnp.asarray(x2)))
    et = tep.sampson_error(torch.as_tensor(E0), torch.as_tensor(x1),
                           torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(et, ej, rtol=1e-4, atol=1e-12)
    cj = np.asarray(jep._sampson_inlier_counts(
        jnp.asarray(Es), jnp.asarray(x1), jnp.asarray(x2),
        jnp.asarray(valid), thresh))
    ct = tep._sampson_inlier_counts(
        torch.as_tensor(Es), torch.as_tensor(x1), torch.as_tensor(x2),
        torch.as_tensor(valid), thresh).numpy()
    assert ct.dtype == np.int32
    # points within 1e-4 relative of the threshold may land either side
    err = np.stack([tep.sampson_error(torch.as_tensor(E), torch.as_tensor(x1),
                                      torch.as_tensor(x2)).numpy()
                    for E in Es])
    near = ((np.abs(err - thresh) < 1e-4 * thresh) & valid).sum(1)
    assert (np.abs(ct - cj) <= near).all(), (ct, cj, near)
    assert cj.max() > 50
    xn = np.asarray(jep.normalize_with_intrinsics(
        jnp.asarray(x1) * 300 + 120, 300.0, 310.0, 120.0, 100.0))
    xt = tep.normalize_with_intrinsics(torch.as_tensor(x1) * 300 + 120,
                                       300.0, 310.0, 120.0, 100.0).numpy()
    np.testing.assert_allclose(xt, xn, rtol=1e-6)


def test_triangulate_matches_jax():
    x1, x2, R, t = synthetic_pair(4, noise=1e-4)
    R32, t32 = R.astype(np.float32), t.astype(np.float32)
    Xj = np.asarray(jep.triangulate(jnp.asarray(R32), jnp.asarray(t32),
                                    jnp.asarray(x1), jnp.asarray(x2)))
    Xt = tep.triangulate(torch.as_tensor(R32), torch.as_tensor(t32),
                         torch.as_tensor(x1), torch.as_tensor(x2)).numpy()
    np.testing.assert_allclose(Xt, Xj, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(Xt[:, :2] / Xt[:, 2:], x1, atol=1e-3)


def test_recover_pose_matches_jax():
    x1, x2, R, t = synthetic_pair(5, noise=1e-4, outliers=0.1)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    E = (tx @ R).astype(np.float32)
    mask = np.ones(len(x1), bool)
    mask[:20] = False                                  # the outliers
    Rj, tj, Xj = (np.asarray(a) for a in jep.recover_pose(
        jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(mask)))
    Rt, tt, Xt = (a.numpy() for a in tep.recover_pose(
        torch.as_tensor(E), torch.as_tensor(x1), torch.as_tensor(x2),
        torch.as_tensor(mask)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-4)
    np.testing.assert_allclose(tt, tj, atol=1e-4)
    np.testing.assert_allclose(Rt, R, atol=1e-4)          # the true pose
    np.testing.assert_allclose(tt, t, atol=1e-4)
    np.testing.assert_allclose(Xt[mask], Xj[mask], rtol=1e-4, atol=1e-5)


def test_sampling_matches_jax_and_clamps_without_valid_rows():
    rng = np.random.default_rng(6)
    raw = np.array(jax.random.randint(jax.random.PRNGKey(0), (128, 5), 0,
                                      jnp.iinfo(jnp.int32).max))
    valid = rng.random(300) < 0.4
    cdf = jnp.cumsum(jnp.asarray(valid).astype(jnp.int32))
    want = np.asarray(jnp.searchsorted(
        cdf, (jnp.asarray(raw) % max(int(valid.sum()), 1) + 1).reshape(-1))
    ).reshape(raw.shape)
    got = tep.sample_rows(torch.as_tensor(valid), torch.as_tensor(raw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert valid[got.numpy()].all()
    none = tep.sample_rows(torch.zeros(300, dtype=torch.bool),
                           torch.as_tensor(raw))
    assert none.shape == raw.shape and (none.numpy() == 299).all()
    draw = tep.draw_raw(64, 8, "cpu", torch.Generator().manual_seed(1))
    assert draw.dtype == torch.int32 and draw.shape == (64, 8)
    assert int(draw.min()) >= 0 and int(draw.max()) < 2 ** 31 - 1


def test_refits_from_no_or_one_inlier_match_jax():
    """A RANSAC winner with no inlier after projection is refitted from an
    empty mask: the 8-point system is then zero and F = 0 in both packages,
    which the reference's SVD projects to diag(1, 1, 0) (identity frames).
    A zero E would make every point an inlier (Sampson 0 / 0), and the
    tracking would report a pose of zeros.  One inlier gives F ~ 1e24;
    the projection must stay finite and equal to the reference's."""
    x1, x2, _, _ = synthetic_pair(3, noise=1e-4, outliers=0.2)
    for n_inl in (0, 1):
        mask = np.zeros(len(x1), np.float32)
        mask[:n_inl] = 1
        Fj = jep._eight_point(jnp.asarray(x1), jnp.asarray(x2),
                              jnp.asarray(mask))
        Ft = tep._eight_point(torch.as_tensor(x1), torch.as_tensor(x2),
                              torch.as_tensor(mask))
        Ej = np.asarray(jep.project_essential(Fj))
        Et = tep.project_essential(Ft).numpy()
        assert np.isfinite(Et).all(), n_inl
        np.testing.assert_allclose(Et, Ej, atol=1e-4, err_msg=str(n_inl))
    np.testing.assert_array_equal(tep.project_essential(torch.zeros(3, 3)),
                                  np.diag([1.0, 1.0, 0.0]))
    # refits from a winner that keeps no inlier end on a real E
    E, inl = tep.refit(torch.eye(3), torch.as_tensor(x1),
                       torch.as_tensor(x2),
                       torch.ones(len(x1), dtype=torch.bool), 1e-12)
    assert torch.linalg.norm(E) > 1.0 and int(inl.sum()) < len(x1)
