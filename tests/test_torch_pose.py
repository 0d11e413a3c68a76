"""SO(3) / SE(3) utilities: the port's `geometry.pose` on the CPU against
the JAX package's on the same inputs (a local seeded generator; small
angles below 1e-7 rad included, where both take the first-order branch).

Tolerance: 1e-5 absolute on rotations, twists and points of unit scale.
`log_so3` only on angles below 3 rad: near pi its axis is ill-conditioned
in float32 and both packages lose digits in their own way.
"""

import jax.numpy as jnp
import numpy as np

from cuda_surf_tpu.geometry import pose as jpose

import torch

from cuda_surf_tpu_torch.geometry import pose as tpose

ATOL = 1e-5


def _vectors(seed, n=64, max_angle=2.9):
    """Axis-angle vectors of angles up to `max_angle`, a few tiny ones."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    ang = rng.uniform(0, max_angle, (n, 1))
    ang[:4, 0] = [0.0, 1e-9, 5e-8, 1e-6]
    return (axis * ang).astype(np.float32)


def _both(fn_name, *arrays):
    j = getattr(jpose, fn_name)(*(jnp.asarray(a) for a in arrays))
    t = getattr(tpose, fn_name)(*(torch.as_tensor(a) for a in arrays))
    return j, t


def _close(t, j, what):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=ATOL,
                               err_msg=what)


def test_hat_and_exp_so3_match_jax():
    w = _vectors(0)
    for name in ("hat", "exp_so3"):
        j, t = _both(name, w)
        _close(t, j, name)
    R = tpose.exp_so3(torch.as_tensor(w))
    eye = torch.eye(3).expand(R.shape)
    torch.testing.assert_close(R @ R.transpose(-1, -2), eye, atol=1e-5,
                               rtol=0)


def test_log_so3_matches_jax():
    w = _vectors(1)
    R = np.array(jpose.exp_so3(jnp.asarray(w)))
    j, t = _both("log_so3", R)
    _close(t, j, "log_so3")
    np.testing.assert_allclose(t.numpy(), w, atol=1e-4)


def test_exp_se3_matches_jax():
    rng = np.random.default_rng(2)
    xi = np.concatenate([rng.normal(size=(64, 3)).astype(np.float32),
                         _vectors(3)], 1)
    (Rj, tj), (Rt, tt) = _both("exp_se3", xi)
    _close(Rt, Rj, "R")
    _close(tt, tj, "t")


def test_compose_invert_transform_match_jax():
    rng = np.random.default_rng(4)
    Ra = np.array(jpose.exp_so3(jnp.asarray(_vectors(5, 8))))
    Rb = np.array(jpose.exp_so3(jnp.asarray(_vectors(6, 8))))
    ta, tb = (rng.normal(size=(8, 3)).astype(np.float32) for _ in range(2))
    pts = rng.normal(size=(8, 16, 3)).astype(np.float32)
    for name, args in (("compose", (Ra, ta, Rb, tb)), ("invert", (Ra, ta)),
                       ("transform", (Ra, ta, pts))):
        j, t = _both(name, *args)
        for a, b in zip((t,) if name == "transform" else t,
                        (j,) if name == "transform" else j):
            _close(a, b, name)
