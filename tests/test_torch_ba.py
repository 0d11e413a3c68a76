"""Bundle adjustment: the port's `ba.core` on the CPU against the JAX
package's on the same problems (numpy arrays made from a local seeded
generator, handed to both).

Tolerances: residuals, Huber and plain cost, the closed-form Jacobians,
the reduced camera system (Sm, bv) and one `lm_step` at 1e-5 (relative,
with an absolute floor of 1e-5 of each array's largest entry: the JAX CPU
reference contracts FMAs, eager torch does not); `run_lm`'s final cost at
1e-4 relative.  The problems are tests/test_ba.py's 4-camera problem,
rebuilt here, and bench.py's 8 cameras x 512 points (`ba_step_ms`,
`io.synth.ba_problem`, checked against bench.py's construction).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu.ba import core as jba

from cuda_surf_tpu_torch.ba import core as tba
from cuda_surf_tpu_torch.io.synth import ba_problem


def _rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _test_ba_problem(seed, n_cam=4, n_pts=64, noise=1e-3, perturb=0.05,
                     outliers=0.0):
    """tests/test_ba.py's _make_problem as arrays, with an optional share
    of gross outliers (its Huber test's)."""
    rng = np.random.default_rng(seed)
    X = rng.uniform([-2, -2, 6], [2, 2, 12], (n_pts, 3))
    Rs = np.stack([_rotmat([0, 1, 0], 0.05 * c) for c in range(n_cam)])
    ts = np.stack([-Rs[c] @ np.array([0.5 * c, 0.02 * c, 0.0])
                   for c in range(n_cam)])
    cam_idx = np.tile(np.arange(n_cam), (n_pts, 1)).astype(np.int32)
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    uv = xc[..., :2] / xc[..., 2:] + rng.normal(0, noise, (n_pts, n_cam, 2))
    flat = uv.reshape(-1, 2)
    n_out = int(outliers * len(flat))
    flat[rng.choice(len(flat), n_out, replace=False)] += rng.normal(
        0, 0.3, (n_out, 2))
    mask = np.ones((n_pts, n_cam), bool)
    mask[rng.random((n_pts, n_cam)) < 0.1] = False     # a few missing
    Rp = np.stack([_rotmat(rng.normal(size=3), perturb * rng.uniform())
                   @ Rs[c] for c in range(n_cam)])
    tp = ts + rng.normal(0, perturb, ts.shape)
    Rp[0], tp[0] = Rs[0], ts[0]
    Xp = X + rng.normal(0, perturb, X.shape)
    return ((cam_idx, uv.astype(np.float32), mask),
            tuple(a.astype(np.float32) for a in (Rp, tp, Xp)))


def _both(problem):
    (ci, uv, mask), (R, t, X) = problem
    jprob = jba.BAProblem(jnp.asarray(ci), jnp.asarray(uv), jnp.asarray(mask))
    jstate = jba.BAState(jnp.asarray(R), jnp.asarray(t), jnp.asarray(X))
    return (jprob, jstate), (tba.problem_from_numpy(ci, uv, mask, "cpu"),
                             tba.state_from_numpy(R, t, X, "cpu"))


def _close(port, ref, rtol=1e-5, what=""):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=rtol * max(np.abs(ref).max(), 1e-30),
                               err_msg=what)


def test_residuals_and_cost_match_jax():
    (jp, js), (tp, ts) = _both(_test_ba_problem(1, outliers=0.1))
    rj, xj = jba.residuals(js, jp)
    rt, xt = tba.residuals(ts, tp)
    _close(rt, rj, what="residuals")
    _close(xt, xj, what="camera-frame points")
    for huber in (None, 1e-3):
        _close(tba.cost(ts, tp, huber), jba.cost(js, jp, huber),
               what=f"cost, huber {huber}")


def test_jacobians_and_schur_system_match_jax():
    (jp, js), (tp, ts) = _both(_test_ba_problem(2, outliers=0.1))
    for huber in (None, 1e-3):
        for a, b, name in zip(tba._jacobians(ts, tp, huber),
                              jba._jacobians(js, jp, huber),
                              ("Jc", "Jp", "r")):
            _close(a, b, what=f"{name}, huber {huber}")
        Sj, bj, *_ = jba._schur_system(js, jp, jnp.float32(1e-3), 4, huber)
        St, bt, *_ = tba._schur_system(ts, tp, 1e-3, 4, huber)
        _close(St, Sj, what=f"Sm, huber {huber}")
        _close(bt, bj, what=f"bv, huber {huber}")


@pytest.mark.parametrize("problem", ["test_ba", "bench"])
def test_lm_step_matches_jax(problem):
    prob = _test_ba_problem(3) if problem == "test_ba" else ba_problem()
    (jp, js), (tp, ts) = _both(prob)
    C = prob[1][0].shape[0]
    out_j = jba.lm_step(js, jp, jnp.float32(1e-3), C)
    out_t = tba.lm_step(ts, tp, 1e-3, C)
    for a, b, name in zip(out_t, out_j, ("R", "t", "points")):
        _close(a, b, what=name)
    _close(tba.cost(out_t, tp), jba.cost(out_j, jp), rtol=1e-4,
           what="cost after the step")


def test_run_lm_final_cost_matches_jax():
    """test_ba.py's test_lm_reduces_cost problem: 12 iterations, final cost
    at 1e-4 relative, and the JAX test's own bars on the port."""
    (jp, js), (tp, ts) = _both(_test_ba_problem(4))
    _, cj = jba.run_lm(js, jp, n_iters=12)
    out, ct = tba.run_lm(ts, tp, n_iters=12)
    _close(ct, cj, rtol=1e-4, what="final cost")
    c0 = float(tba.cost(ts, tp))
    assert np.isfinite(float(ct)) and float(ct) < 0.02 * c0
    rms = np.sqrt(2 * float(ct) / (float(tp.mask.sum()) * 2))
    assert rms < 5e-3
    assert torch.equal(out.R[0], ts.R[0]) and torch.equal(out.t[0], ts.t[0])


def test_ba_cell_is_bench_problem():
    """io.synth.ba_problem builds bench.py:202-219's problem, seed 0."""
    rng = np.random.default_rng(0)
    nc, npts = 8, 512
    X = rng.uniform(-1, 1, (npts, 3)) + [0, 0, 4]
    Rs = np.stack([np.eye(3)] * nc)
    ts = np.stack([[0.1 * c, 0, 0] for c in range(nc)])
    xc = np.einsum("cij,pj->pci", Rs, X) + ts[None]
    uv = xc[..., :2] / xc[..., 2:] + rng.normal(0, 1e-3, (npts, nc, 2))
    (ci, uv_c, mask), (R, t, Xc) = ba_problem()
    np.testing.assert_array_equal(ci, np.tile(np.arange(nc), (npts, 1)))
    np.testing.assert_array_equal(uv_c, uv.astype(np.float32))
    assert mask.all() and mask.shape == (npts, nc)
    for a, b in ((R, Rs), (t, ts), (Xc, X)):
        np.testing.assert_array_equal(a, b.astype(np.float32))
