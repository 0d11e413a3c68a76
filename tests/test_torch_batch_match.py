"""`BatchSurf.match` of the port (all pairs in one call of kernel C's
wrapper, the twin on the CPU) against the JAX package's `BatchSurf.match`
on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.parallel import BatchSurf as JaxBatchSurf
from cuda_surf_tpu.types import Keypoints as JaxKeypoints

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain
from cuda_surf_tpu_torch.types import keypoints_from_numpy
from test_torch_matcher_pairs import pair_sets


def test_batchsurf_match_equals_jax_batchsurf_match():
    """`BatchSurf.match` on three pairs of descriptor sets (ragged
    validity, exact duplicate rows, one set 2 all invalid) against the JAX `BatchSurf.match` on
    the same numpy inputs: scores at 1e-5 (the JAX matcher's products
    round differently), ambiguity at 1e-4, index / matched coordinates /
    validity equal wherever best - second >= 1e-5."""
    P = 3
    d1, d2, valid1, valid2 = pair_sets(P)
    rng = np.random.default_rng(2)

    def kps(valid):
        n = valid.shape[1]
        z = np.zeros((P, n), np.float32)
        x, y = rng.random((2, P, n), np.float32) * 100
        return dict(x=x, y=y, scale=z + 1, strength=z,
                    laplace=np.ones((P, n), np.int32), ori=z,
                    octave=np.zeros((P, n), np.int32), valid=valid,
                    count=valid.sum(1).astype(np.int32))

    k1, k2 = kps(valid1), kps(valid2)
    jk = lambda k: JaxKeypoints(**{f: jnp.asarray(v) for f, v in k.items()})
    mj = JaxBatchSurf(jst.SurfConfig()).match(jk(k1), jnp.asarray(d1),
                                              jk(k2), jnp.asarray(d2))
    mt = cst.BatchSurf(cst.SurfConfig(), device="cpu").match(
        keypoints_from_numpy(k1, "cpu"), torch.as_tensor(d1),
        keypoints_from_numpy(k2, "cpu"), torch.as_tensor(d2))
    assert mt.score.shape == (P, d1.shape[1])
    np.testing.assert_allclose(mt.score.numpy(), np.asarray(mj.score),
                               atol=1e-5)
    np.testing.assert_allclose(mt.ambiguity.numpy(), np.asarray(mj.ambiguity),
                               atol=1e-4)
    b, s = _best2_plain(torch.as_tensor(d1), torch.as_tensor(d2),
                        torch.as_tensor(valid2))[:2]
    clear = ((b - s) >= 1e-5).numpy()
    assert clear[:-1].mean() > 0.9 and not mt.valid[-1].any()
    for name in ("index", "match_x", "match_y", "valid"):
        np.testing.assert_array_equal(getattr(mt, name).numpy()[clear],
                                      np.asarray(getattr(mj, name))[clear],
                                      err_msg=name)
