"""Kernel C's module: the port's matcher against the JAX package's
`fused_best2` (Pallas kernel under the interpreter) and `match` /
`match_keypoints` (XLA).

Scores are compared at 1e-5 (the JAX kernel's bf16x3 products and the
port's fp32 products round differently), indices wherever best - second
>= 1e-5.  The tie rules are compared exactly on a score matrix handed to
both packages: first index wins an exact tie, second best excludes only
the argmax column, invalid columns score -1e30.

The pair dimension and kernel C's merge rule: tests/test_torch_matcher_pairs.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu.ops.matcher import match as jax_match
from cuda_surf_tpu.ops.matcher import match_keypoints as jax_match_keypoints
from cuda_surf_tpu.ops.matcher_pallas import fused_best2 as jax_fused_best2
from cuda_surf_tpu.types import Keypoints as JaxKeypoints

from cuda_surf_tpu_torch.ops.matcher import match, match_keypoints
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from cuda_surf_tpu_torch.types import keypoints_from_numpy
from torch_parity import match_sets


@pytest.fixture(scope="module")
def sets():
    return match_sets()


def test_fused_best2_matches_jax_kernel(sets):
    d1, d2, _, valid2 = sets
    bj, sj, ij = (np.asarray(a) for a in jax_fused_best2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(valid2), interpret=True))
    bt, st, it = (a.numpy() for a in fused_best2(
        torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(valid2)))
    assert it.dtype == np.int32
    np.testing.assert_allclose(bt, bj, atol=1e-5)
    np.testing.assert_allclose(st, sj, atol=1e-5)
    clear = (bj - sj) >= 1e-5
    assert clear.sum() >= 90
    np.testing.assert_array_equal(it[clear], ij[clear])
    assert valid2[it].all()                      # never an invalid column


def test_tie_rules_equal_jax_on_shared_scores(sets):
    d1, d2, valid1, valid2 = sets
    scores = (d1.astype(np.float64) @ d2.T.astype(np.float64)).astype(np.float32)
    scores[10, [20, 30, 40]] = 2.0               # three-way exact tie
    scores[11, 60] = scores[11, 61] = 1.5        # tie, second == best
    scores[12, :] = 0.25                         # a row of ties
    x2 = np.arange(d2.shape[0], dtype=np.float32)
    y2 = -x2
    mj = jax_match(jnp.asarray(d1), jnp.asarray(valid1), jnp.asarray(d2),
                   jnp.asarray(valid2), jnp.asarray(x2), jnp.asarray(y2),
                   scores=jnp.asarray(scores))
    mt = match(torch.as_tensor(d1), torch.as_tensor(valid1),
               torch.as_tensor(d2), torch.as_tensor(valid2),
               torch.as_tensor(x2), torch.as_tensor(y2),
               scores=torch.as_tensor(scores))
    for name in mj._fields:
        np.testing.assert_array_equal(np.asarray(getattr(mj, name)),
                                      getattr(mt, name).numpy(), err_msg=name)
    assert mt.index[10] == 20 and mt.index[11] == 60 and mt.index[12] == 0
    assert float(mt.ambiguity[11]) > 0.99


def test_all_columns_invalid_equal_jax(sets):
    d1, d2, valid1, _ = sets
    none = np.zeros(d2.shape[0], bool)
    bj, sj, ij = (np.asarray(a) for a in jax_fused_best2(
        jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(none), interpret=True))
    bt, st, it = (a.numpy() for a in fused_best2(
        torch.as_tensor(d1), torch.as_tensor(d2), torch.as_tensor(none)))
    np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(st, sj)
    np.testing.assert_array_equal(it, ij)


def _kps(x, y, valid):
    n = x.shape[0]
    z = np.zeros(n, np.float32)
    return dict(x=x, y=y, scale=z + 1, strength=z, laplace=np.ones(n, np.int32),
                ori=z, octave=np.zeros(n, np.int32), valid=valid,
                count=np.int32(valid.sum()))


@pytest.mark.parametrize("cross_check", [False, True])
def test_match_keypoints_matches_jax(sets, cross_check):
    d1, d2, valid1, valid2 = sets
    rng = np.random.default_rng(9)
    k1 = _kps(*rng.random((2, d1.shape[0]), np.float32) * 100, valid1)
    k2 = _kps(*rng.random((2, d2.shape[0]), np.float32) * 100, valid2)
    mj = jax_match_keypoints(
        JaxKeypoints(**{k: jnp.asarray(v) for k, v in k1.items()}),
        jnp.asarray(d1),
        JaxKeypoints(**{k: jnp.asarray(v) for k, v in k2.items()}),
        jnp.asarray(d2), cross_check=cross_check)
    mt = match_keypoints(keypoints_from_numpy(k1), torch.as_tensor(d1),
                         keypoints_from_numpy(k2), torch.as_tensor(d2),
                         cross_check=cross_check)
    np.testing.assert_allclose(mt.score.numpy(), np.asarray(mj.score), atol=1e-5)
    b, s = _best2_plain(torch.as_tensor(d1), torch.as_tensor(d2),
                        torch.as_tensor(valid2))[:2]
    clear = ((b - s) >= 1e-5).numpy()
    for name in ("index", "match_x", "match_y", "valid"):
        np.testing.assert_array_equal(getattr(mt, name).numpy()[clear],
                                      np.asarray(getattr(mj, name))[clear],
                                      err_msg=name)
    np.testing.assert_allclose(mt.ambiguity.numpy(), np.asarray(mj.ambiguity),
                               atol=1e-4)
    if cross_check:
        assert 0 < mt.valid.sum() < valid1.sum()
