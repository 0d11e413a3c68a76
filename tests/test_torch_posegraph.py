"""The SE(3) pose graph on the CPU against the JAX package's
(cuda_surf_tpu/slam/posegraph.py) on the same graphs: tests/test_posegraph.py's
noisy circle (`_circle_graph`) at n = 16 (dense path) and n = 80 (the
smallest graph on the CG path), each with its own `default_rng`.

Tolerances: residuals within 4e-6 (a few float32 ulps of the translations,
|t| ~ 10, which the residual's translation part cancels); the normal
blocks H within 1e-6 of their largest entry and b within 4e-6 x the largest
Jacobian entry (the residual's rounding carried through J); an increment
from the same blocks within 5e-4 of its largest entry (dense: the LU
solves of LAPACK and XLA on a system of condition 1.1e6; CG: the same
rounds, summed in another order); a
whole optimisation's R within 1e-4, t within 5e-5 x max |t| and each
step's cost within 1 % + 1e-6 x the first cost (the last steps' costs sit
at the rounding floor).  The CG chunking is exact: any chunk size gives the
same bits, and the round count equals the while loop's.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu.slam import posegraph as jpg
from cuda_surf_tpu.slam.loopclosure import (LoopClosure as JaxLoopClosure,
                                            optimize_with_loops as jax_owl)
from test_posegraph import _circle_graph

from cuda_surf_tpu_torch.slam import posegraph as tpg
from cuda_surf_tpu_torch.slam.loopclosure import (LoopClosure,
                                                  optimize_with_loops)
from torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"


def _graphs(n, n_loops, seed):
    g, Rs, ts = _circle_graph(n, n_loops, np.random.default_rng(seed))
    return g, tpg.graph_from_numpy(g, device=CPU), ts


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def check_blocks(jax_blocks, port_blocks):
    r, Hii, Hjj, Hij, bi, bj = map(_np, jax_blocks)
    pr, *rest = map(_np, port_blocks)
    np.testing.assert_allclose(pr, r, atol=4e-6, rtol=0)
    jmax = np.sqrt(max(np.abs(Hii).max(), np.abs(Hjj).max()))
    for a, b, name in zip((Hii, Hjj, Hij, bi, bj), rest,
                          ("Hii", "Hjj", "Hij", "bi", "bj")):
        atol = 1e-6 * np.abs(a).max() if name[0] == "H" else 4e-6 * jmax
        np.testing.assert_allclose(b, a, atol=atol, rtol=0, err_msg=name)


def check_state(port, jax_state, names=("R", "t")):
    for k in names:
        want = np.asarray(getattr(jax_state, k))
        atol = 5e-5 * np.abs(want).max() if k == "t" else 1e-4
        np.testing.assert_allclose(getattr(port, k).numpy(), want, atol=atol,
                                   rtol=0, err_msg=k)


def check_costs(port, want):
    want = np.asarray(want)
    np.testing.assert_allclose(port.numpy(), want, rtol=1e-2,
                               atol=1e-6 * want[0])


# the JAX functions jitted, as their callers run them (eager JAX dispatches
# each operation on its own)
jax_blocks = jax.jit(jpg._edge_blocks)
jax_dense = jax.jit(jpg._solve_dense, static_argnums=1)
jax_cg = jax.jit(jpg._solve_cg, static_argnums=(1, 9))


@pytest.mark.parametrize("n, n_loops", [(16, 3), (80, 5)])
def test_edge_blocks_and_residuals(n, n_loops):
    g, gt, _ = _graphs(n, n_loops, 3)
    jb = jax_blocks(g, g.R, g.t)
    check_blocks(jb, tpg._edge_blocks(gt, gt.R, gt.t))
    np.testing.assert_allclose(tpg.edge_residuals(gt).numpy(),
                               np.asarray(jb[0]), atol=4e-6, rtol=0)
    # no NaN from the tangent of exp_so3 at the zero increment
    assert all(torch.isfinite(b).all() for b in
               tpg._edge_blocks(gt, gt.R, gt.t))


def test_dense_and_cg_solves_on_jax_blocks():
    """The increment from the JAX package's own blocks: dense at n = 16, CG
    at n = 80 (the same number of rounds as the JAX while loop)."""
    for n, solver in ((16, "dense"), (80, "cg")):
        g, gt, _ = _graphs(n, 4, 5)
        blocks = jax_blocks(g, g.R, g.t)[1:]
        tb = [torch.as_tensor(np.array(b)) for b in blocks]
        if solver == "dense":
            want = jax_dense(g, n, 1e-6, *blocks)
            got = tpg._solve_dense(gt, n, 1e-6, *tb)
        else:
            want = jax_cg(g, n, 1e-6, *blocks, max(8 * n, 200))
            s = tpg._cg_system(gt, tpg.segment_table(gt, n), n, 1e-6, *tb,
                               max(8 * n, 200))
            got = tpg._solve_cg(s)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want,
                                   atol=5e-4 * np.abs(want).max(), rtol=0,
                                   err_msg=solver)


def test_optimize_huber_mask_matches_jax():
    """Huber IRLS on the loop edges only, with one loop edge pulled off,
    on the dense path and on the CG path (n = 30 forced to CG, and n = 80)."""
    for n, solver in ((30, "dense"), (30, "cg"), (80, "auto")):
        g, gt, _ = _graphs(n, 4, 12)
        E = int(g.edge_i.shape[0])
        rel_t = np.array(g.rel_t)
        rel_t[E - 1] += np.array([0.4, -0.3, 0.2], np.float32)
        g = g._replace(rel_t=jnp.asarray(rel_t))
        gt = gt._replace(rel_t=torch.as_tensor(rel_t))
        mask = np.arange(E) >= n - 1
        jo, jc = jax.jit(lambda g: jpg.optimize(
            g, n_iters=8, solver=solver, robust_delta=0.1,
            robust_mask=jnp.asarray(mask)))(g)
        to, tc = tpg.optimize(gt, n_iters=8, solver=solver, robust_delta=0.1,
                              robust_mask=torch.as_tensor(mask))
        check_state(to, jo)
        check_costs(tc, jc)


def test_cg_chunks_are_the_while_loop(monkeypatch):
    """Chunk sizes 1, 7 and 32 give the same bits; the rounds are counted
    and the host reads the stop flag once a chunk."""
    _, gt, ts = _graphs(80, 5, 7)
    runs = {}
    for chunk in (1, 7, 32):
        monkeypatch.setattr(tpg, "CG_CHUNK", chunk)
        stats = {}
        out, costs = tpg.optimize(gt, n_iters=3, solver="cg", stats=stats)
        runs[chunk] = (out, costs, stats)
        assert stats["host_reads"] == [max(1, -(-k // chunk))
                                       for k in stats["cg_rounds"]]
    for chunk in (7, 32):
        assert runs[chunk][2]["cg_rounds"] == runs[1][2]["cg_rounds"]
        for a, b in zip(runs[chunk][0], runs[1][0]):
            assert torch.equal(a, b)
        assert torch.equal(runs[chunk][1], runs[1][1])
    # the segment table holds every edge end once, in row order per node
    table = tpg.segment_table(gt, 80)
    rows = table[table < 2 * gt.edge_i.shape[0]]
    assert sorted(rows.tolist()) == list(range(2 * gt.edge_i.shape[0]))
    assert float(runs[32][1][-1]) < 1e-3 * float(runs[32][1][0])


def test_gross_outlier_loop_rejected_matches_jax():
    """tests/test_posegraph.py::test_gross_outlier_loop_rejected's graph:
    one good loop and one whose depth scale claims ~50 units.  With the
    chi-square cut both packages cut every loop and return the chain
    untouched, equal bit for bit.  Without it the Huber-weighted outlier
    bends the chain by ~66 units and 10 steps do not converge (JAX's cost
    3011), so there only the JAX test's own bound is held, in both: the
    chain ends at least 0.1 further from the truth than with the cut."""
    g, Rs, ts = _circle_graph(30, 0, np.random.default_rng(4), drift=0.01)
    frames = [SimpleNamespace(R=np.asarray(g.R[k], np.float64),
                              t=np.asarray(g.t[k], np.float64))
              for k in range(30)]

    def rel(i, j):
        Rr = Rs[j] @ Rs[i].T
        return Rr, ts[j] - Rr @ ts[i]

    Rg, tg = rel(3, 18)
    tg = tg if np.linalg.norm(tg) > 1e-9 else np.array([1.0, 0, 0])
    Rb, _ = rel(5, 20)
    bad_dir = np.array([0.8, 0.0, 0.6])
    loops = [dict(i=3, j=18, R=Rg, t=tg / np.linalg.norm(tg), n_inliers=100,
                  med_depth=40.0),
             dict(i=5, j=20, R=Rb, t=bad_dir / np.linalg.norm(bad_dir),
                  n_inliers=100, med_depth=0.1)]
    kw = dict(n_iters=10, max_rot=10.0, max_trans=1e9,
              frame_depths=[5.0] * 30)
    err = {}
    for reject in (1.0, None):
        Rj, tj, cj = jax_owl(frames, [JaxLoopClosure(**d) for d in loops],
                             reject_residual=reject, **kw)
        Rp, tp, cp = optimize_with_loops(
            frames, [LoopClosure(**d) for d in loops], reject_residual=reject,
            device=CPU, **kw)
        err[reject] = (np.abs(tj - ts).max(), np.abs(tp - ts).max())
        if reject is not None:
            np.testing.assert_array_equal(Rp, Rj)
            np.testing.assert_array_equal(tp, tj)
            assert cp == cj == 0.0
            np.testing.assert_array_equal(tp, np.stack([f.t for f in frames]))
    for k in range(2):
        assert err[1.0][k] < 0.2 and err[None][k] > err[1.0][k] + 0.1, err
