"""The Sim(3) pose graph on the CPU against the JAX package's
(cuda_surf_tpu/slam/sim3graph.py): tests/test_posegraph.py's exact Sim(3)
circle (`_sim3_circle`) with its scales drifted by 0.97^k, at n = 16
(dense path) and n = 80 (CG path), each with its own `default_rng`.

Tolerances, as in test_torch_posegraph.py: residuals within 4e-6, H within
1e-6 of its largest entry, b within 4e-6 x the largest Jacobian entry; an
optimisation's s within 1e-5, R within 1e-4, t within 5e-5 x max |t|, each
step's cost within 1 % + 1e-6 x the first cost; camera centres within
1e-4 x their largest coordinate.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_surf_tpu.slam import sim3graph as js3
from cuda_surf_tpu.slam.loopclosure import LoopClosure as JaxLoopClosure
from test_posegraph import _sim3_circle
from test_torch_posegraph import check_blocks, check_costs, check_state

from cuda_surf_tpu_torch.slam import sim3graph as ts3
from cuda_surf_tpu_torch.slam.loopclosure import LoopClosure
from torch_parity import one_torch_thread  # noqa: F401

CPU = "cpu"


def _graphs(n, n_loops, seed, gamma=0.97):
    g, Rs, ts, ss = _sim3_circle(n, n_loops, np.random.default_rng(seed))
    g = g._replace(s=g.s * jnp.asarray(gamma ** np.arange(n), jnp.float32))
    return g, ts3.graph_from_numpy(g, device=CPU), (Rs, ts, ss)


@pytest.mark.parametrize("n, n_loops", [(16, 3), (80, 5)])
def test_edge_blocks(n, n_loops):
    g, gt, _ = _graphs(n, n_loops, 3)
    w = np.ones((g.weight.shape[0], 3), np.float32)
    w[n - 1:] = (5.0, 2.0, 3.0)          # per-component loop weights
    g = g._replace(weight=jnp.asarray(w))
    gt = gt._replace(weight=torch.as_tensor(w))
    check_blocks(jax.jit(js3._edge_blocks)(g, g.s, g.R, g.t),
                 ts3._edge_blocks(gt, gt.s, gt.R, gt.t))


def test_optimize_dense_and_cg_match_jax():
    """Dense at n = 16, CG at n = 80, and robust (Huber on the loop edges)
    on both paths at n = 16."""
    runs = [(16, "dense", None), (80, "auto", None), (16, "dense", 0.1),
            (16, "cg", 0.1)]
    for n, solver, delta in runs:
        g, gt, (Rs, ts, ss) = _graphs(n, 3, 9)
        mask = np.arange(g.edge_i.shape[0]) >= n - 1
        kw = dict(n_iters=10, solver=solver, robust_delta=delta)
        jo, jc = jax.jit(lambda g: js3.optimize(
            g, robust_mask=jnp.asarray(mask), **kw))(g)
        to, tc = ts3.optimize(gt, robust_mask=torch.as_tensor(mask), **kw)
        np.testing.assert_allclose(to.s.numpy(), np.asarray(jo.s), atol=1e-5,
                                   rtol=0)
        check_state(to, jo)
        check_costs(tc, jc)
        cj, cp = js3.centres(jo), ts3.centres(to)
        np.testing.assert_allclose(cp, cj, atol=1e-4 * np.abs(cj).max(),
                                   rtol=0)
        if delta is None:
            # the JAX test's own bar: the drift is corrected
            np.testing.assert_allclose(to.s.numpy(), ss, atol=5e-3)


def _chain(seed, n=24):
    """A drifting VO chain around a circle (world->cam poses; the camera
    steps shrink by 0.98 a frame: scale drift), its true centres, and loop
    closures from frame i to frame j = i + n - 4 measured from the truth,
    one of them with a rotation 1.2 rad off (gated) and one whose
    translation points the wrong way (cut by the chi-square test)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 1.8 * np.pi, n)
    Rs, cs = [], []
    for k in range(n):
        c, s = np.cos(th[k]), np.sin(th[k])
        Rs.append(np.array([[c, s, 0], [-s, c, 0], [0, 0, 1.0]]))
        cs.append(np.array([3 * c, 3 * s, 0.05 * k]))
    Rs, cs = np.stack(Rs), np.stack(cs)
    ts = -np.einsum("nij,nj->ni", Rs, cs)
    # drifted estimate: relative motions shrunk by 0.98^k, rotations noisy
    Re, ce = [Rs[0]], [cs[0]]
    for k in range(1, n):
        step = (cs[k] - cs[k - 1]) * 0.98 ** k
        Re.append(Rs[k] @ Rs[k - 1].T @ Re[-1])
        ce.append(ce[-1] + step + rng.normal(0, 0.01, 3))
    Re = np.stack(Re)
    te = -np.einsum("nij,nj->ni", Re, np.stack(ce))
    frames = [SimpleNamespace(R=Re[k], t=te[k]) for k in range(n)]
    depths = 3.0 * 0.98 ** np.arange(n)
    loops = []
    for i in range(4):
        j = i + n - 4
        R = Rs[j] @ Rs[i].T
        t = ts[j] - R @ ts[i]
        if i == 1:
            R = R @ np.array([[1, 0, 0], [0, np.cos(1.2), -np.sin(1.2)],
                              [0, np.sin(1.2), np.cos(1.2)]])
        if i == 2:
            t = -t
        loops.append(dict(i=i, j=j, R=R, t=t / np.linalg.norm(t),
                          n_inliers=100, med_depth=3.0 / np.linalg.norm(t),
                          med_depth_j=3.1 / np.linalg.norm(t)))
    return frames, depths, loops, cs


def test_optimize_with_loops_sim3_matches_jax():
    frames, depths, loops, cs = _chain(5)
    for reject in (1.0, None):
        kw = dict(n_iters=12, min_gap=10, reject_residual=reject)
        sj, Rj, tj, cj, costj = js3.optimize_with_loops_sim3(
            frames, [JaxLoopClosure(**d) for d in loops], depths, **kw)
        sp, Rp, tp, cp, costp = ts3.optimize_with_loops_sim3(
            frames, [LoopClosure(**d) for d in loops], depths, device=CPU,
            **kw)
        np.testing.assert_allclose(sp, sj, atol=1e-5, rtol=0)
        np.testing.assert_allclose(Rp, Rj, atol=1e-4, rtol=0)
        np.testing.assert_allclose(tp, tj, atol=5e-5 * np.abs(tj).max(),
                                   rtol=0)
        np.testing.assert_allclose(cp, cj, atol=1e-4 * np.abs(cj).max(),
                                   rtol=0)
        assert abs(costp - costj) <= 1e-2 * abs(costj) + 1e-8, (costp, costj)
        assert np.isfinite(cp).all()


def test_scale_drift_corrected_like_jax():
    """tests/test_posegraph.py::test_sim3_corrects_scale_drift: n = 20, one
    loop, scales drifted by 0.97^k; the port's result against JAX's and the
    JAX test's bars."""
    g, gt, (Rs, ts, ss) = _graphs(20, 1, 5)
    jo, jc = jax.jit(lambda g: js3.optimize(g, n_iters=12))(g)
    to, tc = ts3.optimize(gt, n_iters=12)
    assert float(tc[-1]) < 1e-6
    np.testing.assert_allclose(to.s.numpy(), ss, atol=5e-3)
    cen_true = -np.einsum("nij,ni->nj", Rs.transpose(0, 2, 1), ts)
    np.testing.assert_allclose(ts3.centres(to), cen_true, atol=2e-2)
    np.testing.assert_allclose(to.s.numpy(), np.asarray(jo.s), atol=1e-5,
                               rtol=0)
    check_state(to, jo)
    check_costs(tc, jc)
