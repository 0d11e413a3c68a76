"""The port's distributed Schur-complement BA (cuda_surf_tpu_torch/ba/
distributed.py) against the JAX package's `make_distributed_lm` at the same
mesh size, and against the port's own `run_lm`.

The port's ranks are processes on the CPU over gloo
(tests/torch_multidevice_worker.py, started through the port's launcher,
every rank killed on a failure or a timeout); the JAX side runs in this
process on conftest's virtual CPU devices, `make_mesh(n)`.  The problem is
tests/test_ba.py's `_make_problem` (4 cameras, 64 points) from a local
`default_rng`.

Tolerances: against JAX at the same mesh size, the final cost at 1e-4
relative and t at 1e-4 (the two sum their parts in other orders and XLA:CPU
contracts FMAs); against the port's `run_lm`, tests/test_ba.py's own
tolerances for the distributed LM (cost 1e-2 relative, t 1e-3: every rank
adds the damping's 1e-9 and the gauge block before the sum, so the summed
system differs from the single-device one); the ranks' replicated outputs
bit-equal; a world of one (no process group) equal to `run_lm` bit for
bit.
"""

import jax
import numpy as np
import pytest
import torch

from cuda_surf_tpu.ba import make_distributed_lm as jax_make_distributed_lm
from cuda_surf_tpu.ba import shard_problem as jax_shard_problem
from cuda_surf_tpu.parallel import make_mesh as jax_make_mesh
from test_ba import _make_problem

from cuda_surf_tpu_torch.ba import core as tba
from cuda_surf_tpu_torch.ba.distributed import (make_distributed_lm,
                                                shard_problem)
from cuda_surf_tpu_torch.io.synth import ba_problem
from cuda_surf_tpu_torch.parallel import Mesh, make_mesh
from torch_parity import assert_ranks_equal, one_torch_thread  # noqa: F401
from torch_parity import run_ranks

N_ITERS = 12


def _problem(seed):
    prob, state, _ = _make_problem(np.random.default_rng(seed), n_pts=64)
    return prob, state, dict(
        cam_idx=np.asarray(prob.cam_idx), uv=np.asarray(prob.uv),
        mask=np.asarray(prob.mask), R=np.asarray(state.R),
        t=np.asarray(state.t), X=np.asarray(state.points))


def _port(arrays):
    a = arrays
    return (tba.problem_from_numpy(a["cam_idx"], a["uv"], a["mask"], "cpu"),
            tba.state_from_numpy(a["R"], a["t"], a["X"], "cpu"))


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_lm_matches_jax_and_run_lm(world, tmp_path):
    prob, state, arrays = _problem(world)
    mesh = jax_make_mesh(world)
    jprob, jstate = jax_shard_problem(prob, state, mesh)
    jfinal, jcost = jax_make_distributed_lm(mesh, n_cameras=4,
                                            n_iters=N_ITERS)(jstate, jprob)
    ranks = run_ranks("ba", world, tmp_path,
                      dict(arrays, n_iters=np.int64(N_ITERS)))
    assert_ranks_equal(ranks, ("R", "t", "points", "cost", "cost0"))
    got = ranks[0]
    assert str(got["backend"]) == "gloo"
    np.testing.assert_allclose(got["cost"], float(jcost), rtol=1e-4)
    np.testing.assert_allclose(got["t"], np.asarray(jfinal.t), atol=1e-4,
                               rtol=0)
    assert float(got["cost"]) < 0.02 * float(got["cost0"])
    tprob, tstate = _port(arrays)
    single, c1 = tba.run_lm(tstate, tprob, n_iters=N_ITERS)
    np.testing.assert_allclose(got["cost"], float(c1), rtol=1e-2)
    np.testing.assert_allclose(got["t"], single.t.numpy(), atol=1e-3)


@pytest.mark.parametrize("which", ["test_ba", "bench"])
def test_world_of_one_is_run_lm_bit_for_bit(which):
    """No process group: a mesh of one device whose collectives are the
    identity; bench.py's 8 x 512 problem and tests/test_ba.py's."""
    if which == "bench":
        (ci, uv, mask), (R, t, X) = ba_problem()
        arrays = dict(cam_idx=ci, uv=uv, mask=mask, R=R, t=t + 0.01,
                      X=X + 0.02)
    else:
        arrays = _problem(7)[2]
    prob, state = _port(arrays)
    mesh = make_mesh(devices="cpu")
    assert mesh.size == 1 and mesh.group is None
    C = state.R.shape[0]
    sprob, sstate = shard_problem(prob, state, mesh)
    got, cost = make_distributed_lm(mesh, C, n_iters=10)(sstate, sprob)
    want, wcost = tba.run_lm(state, prob, n_iters=10)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.equal(cost, wcost)


def test_shard_problem_needs_a_divisible_point_count():
    prob, state = _port(_problem(3)[2])
    two = Mesh("frames", 2, 0, torch.device("cpu"))
    odd = tba.BAProblem(*(a[:63] for a in prob))
    with pytest.raises(ValueError, match="not divisible by mesh size 2"):
        shard_problem(odd, state._replace(points=state.points[:63]), two)
    # the rank's half of an even split
    p2, s2 = shard_problem(prob, state, two)
    assert p2.uv.shape[0] == 32 and torch.equal(s2.points, state.points[:32])
    with pytest.raises(ValueError, match="process group holds 1"):
        make_mesh(2, devices="cpu")
