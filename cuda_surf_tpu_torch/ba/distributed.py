"""Distributed Schur-complement bundle adjustment over a mesh of ranks (port
of cuda_surf_tpu/ba/distributed.py).

The map (points + observations) is split over the ranks along the point
axis; the cameras are replicated.  Each rank eliminates its own point
blocks and builds its part of the reduced camera system with the
single-device `_schur_system`; the parts are summed by ONE all-reduce of
(Sm, bv) packed into a single buffer, (6C)^2 + 6C floats (9.4 KB at C = 8),
independent of the number of points.  The small dense camera solve is
replicated (`solve_ex`), the back-substitution of the points stays local,
and one more all-reduce sums the candidate's cost.  Accept / reject is a
select on the device, on all-reduced costs, so every rank takes the same
decision.

`_schur_system` adds the damping `lam * diag + 1e-9` and the 1e9 gauge
block of camera 0 on every rank before the sum, as the JAX package's
`local_iteration` does: the summed system carries them times the world
size.  At a world of one the LM here is `run_lm` operation for operation.
"""

from __future__ import annotations

import torch

from ..parallel.mesh import Mesh, psum, replicated, shard_rows
from .core import (BAProblem, BAState, _schur_system, _solve_and_update,
                   cost, lm_select)


def shard_problem(prob: BAProblem, state: BAState, mesh: Mesh):
    """This rank's points and observations, the cameras whole, all on the
    rank's device.  Raises when the points do not divide by the mesh size."""
    prob = BAProblem(*(shard_rows(a, mesh) for a in prob))
    state = BAState(replicated(state.R, mesh), replicated(state.t, mesh),
                    shard_rows(state.points, mesh))
    return prob, state


def allreduce_bytes(n_cameras: int) -> int:
    """Bytes of the one all-reduce of the camera system an iteration."""
    m = 6 * n_cameras
    return 4 * (m * m + m)


def lm_iteration(mesh: Mesh, n_cameras: int, state: BAState, prob: BAProblem,
                 lam, c0):
    """One LM iteration on this rank's shard: local Schur pieces -> one
    all-reduce -> replicated camera solve, local point update -> all-reduced
    candidate cost -> accept / reject.  -> (state, lam, cost)."""
    Sm, bv, Vinv, W, g_p = _schur_system(state, prob, lam, n_cameras)
    m = Sm.shape[0]
    packed = psum(torch.cat([Sm.reshape(-1), bv]), mesh)
    Sm, bv = packed[:m * m].reshape(m, m), packed[m * m:]
    cand = _solve_and_update(state, prob, n_cameras, Sm, bv, Vinv, W, g_p)
    return lm_select(state, cand, lam, c0, psum(cost(cand, prob), mesh))


def make_distributed_lm(mesh: Mesh, n_cameras: int, n_iters: int = 10,
                        lam0: float = 1e-3):
    """The distributed LM over `mesh`: `run(state, prob)` on this rank's
    shard (`shard_problem`) -> (state with this rank's points, the total
    final cost)."""

    def run(state: BAState, prob: BAProblem):
        c0 = psum(cost(state, prob), mesh)
        lam = torch.full((), lam0, dtype=torch.float32, device=c0.device)
        for _ in range(n_iters):
            state, lam, c0 = lm_iteration(mesh, n_cameras, state, prob, lam,
                                          c0)
        return state, c0

    return run
