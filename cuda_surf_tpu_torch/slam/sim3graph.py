"""Sim(3) pose-graph optimisation: scale-drift-aware loop closure (port of
cuda_surf_tpu/slam/sim3graph.py, single device).

Monocular VO accumulates scale drift as well as pose drift, which an SE(3)
graph cannot absorb.  Each node carries (s, R, t) with x_cam = s R x_world
+ t; odometry edges measure relative scale 1 and loop edges the
accumulated relative scale, so Gauss-Newton spreads a loop's scale
discrepancy around the cycle (Strasdat et al., "Scale drift-aware large
scale monocular SLAM").  The 7-dof residual Jacobians come from forward
mode at the zero increment, vmapped over the edges; the solvers (one-hot
dense, chunked matrix-free CG) are the SE(3) graph's, in posegraph.py.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._build import require_device
from ..geometry.pose import exp_so3, log_so3
from .posegraph import (normal_blocks, residual_jacobians, solve_step,
                        solver_plan)


class Sim3Graph(NamedTuple):
    s: torch.Tensor        # (N,) scale, x_cam = s R x_world + t
    R: torch.Tensor        # (N, 3, 3)
    t: torch.Tensor        # (N, 3)
    edge_i: torch.Tensor   # (E,) int64
    edge_j: torch.Tensor   # (E,) int64
    rel_s: torch.Tensor    # (E,) measured scale of S_j S_i^-1
    rel_R: torch.Tensor    # (E, 3, 3) measured rotation cam_i -> cam_j
    rel_t: torch.Tensor    # (E, 3)
    weight: torch.Tensor   # (E, 3) per component (rot, trans, scale)


def graph_from_numpy(src, device="cuda") -> Sim3Graph:
    """A Sim3Graph from any object carrying the fields as arrays (e.g. the
    JAX package's graph), on the card unless `device="cpu"`."""
    device = require_device(device, "graph_from_numpy")
    f = lambda k, dt: torch.as_tensor(np.array(getattr(src, k)), dtype=dt,
                                      device=device)
    return Sim3Graph(
        **{k: f(k, torch.float32) for k in ("s", "R", "t", "rel_s", "rel_R",
                                            "rel_t", "weight")},
        edge_i=f("edge_i", torch.int64), edge_j=f("edge_j", torch.int64))


def _compose(sa, Ra, ta, sb, Rb, tb):
    """(A o B): x -> s_a R_a (s_b R_b x + t_b) + t_a."""
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _inverse(s, R, t):
    return 1.0 / s, R.T, -(R.T @ t) / s


def _edge_residual(si, Ri, ti, sj, Rj, tj, rel_s, rel_R, rel_t, w, xi):
    """7-dof weighted residual of one edge with local increments xi =
    (xi_i, xi_j) (14,) applied.

    Increment chart: s <- s exp(sigma), R <- exp(phi) R, t <- t + tau with
    xi = (phi, tau, sigma).  r = [log_so3, trans, log-scale] of
    M^-1 (S_j S_i^-1), each row times its component's weight (rot, rot,
    rot, t, t, t, scale)."""
    xi_i, xi_j = xi[:7], xi[7:]
    si = si * torch.exp(xi_i[6])
    Ri = exp_so3(xi_i[:3]) @ Ri
    ti = ti + xi_i[3:6]
    sj = sj * torch.exp(xi_j[6])
    Rj = exp_so3(xi_j[:3]) @ Rj
    tj = tj + xi_j[3:6]
    s_ij, R_ij, t_ij = _compose(sj, Rj, tj, *_inverse(si, Ri, ti))
    se, Re, te = _compose(*_inverse(rel_s, rel_R, rel_t), s_ij, R_ij, t_ij)
    r = torch.cat([log_so3(Re), te, torch.log(se)[None]])
    wr = torch.cat([w[0].expand(3), w[1].expand(3), w[2][None]])
    return r * wr


def _edge_blocks(graph: Sim3Graph, s, R, t):
    """-> weighted r (E, 7), Hii/Hjj/Hij (E, 7, 7), bi/bj (E, 7)."""
    ii, jj = graph.edge_i, graph.edge_j
    r, Ji, Jj = residual_jacobians(
        _edge_residual, 7, s[ii], R[ii], t[ii], s[jj], R[jj], t[jj],
        graph.rel_s, graph.rel_R, graph.rel_t, graph.weight)
    return (r, *normal_blocks(Ji, Jj, r))


def optimize(graph: Sim3Graph, n_iters: int = 12, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None,
             robust_delta: float | None = None,
             robust_mask: torch.Tensor | None = None,
             stats: dict | None = None):
    """Gauss-Newton over the Sim(3) graph on its device; the options are
    posegraph.optimize's.  -> (optimised Sim3Graph, costs (n_iters,))."""
    n = graph.R.shape[0]
    solver, cg_iters, table = solver_plan(graph, n, solver, cg_iters)
    s, R, t = graph.s, graph.R, graph.t
    costs = []
    for _ in range(n_iters):
        blocks = _edge_blocks(graph, s, R, t)
        dx = solve_step(graph, n, solver, damping, cg_iters, robust_delta,
                        robust_mask, blocks, table, stats)
        R = exp_so3(dx[:, :3]) @ R
        t = t + dx[:, 3:6]
        s = s * torch.exp(dx[:, 6])
        costs.append(torch.sum(blocks[0] * blocks[0]))
    return graph._replace(s=s, R=R, t=t), torch.stack(costs)


def centres(graph: Sim3Graph) -> np.ndarray:
    """Camera centres: s R c + t = 0 -> c = -(1/s) R^T t.

    A node whose scale collapsed toward zero is clamped rather than
    emitting inf / nan: callers compare ATE, where one meaningless but
    finite centre is better than poisoning the whole alignment."""
    s = graph.s.cpu().numpy()[:, None]
    s = np.where(np.abs(s) > 1e-12, s, 1e-12)
    R = graph.R.cpu().numpy()
    t = graph.t.cpu().numpy()
    return -np.einsum("nij,ni->nj", R.transpose(0, 2, 1), t) / s


def optimize_with_loops_sim3(frames, closures, frame_depths,
                             n_iters: int = 12, loop_weight: float = 5.0,
                             min_gap: int = 10, max_rot: float = 0.6,
                             robust_delta: float = 0.1,
                             reject_residual: float | None = 1.0,
                             device="cuda"):
    """Build and optimise the Sim(3) graph of a VO chain and its detected
    loop closures, on `device` (the card unless "cpu").

    `frames`: pipeline FrameStates (.R world->cam, .t).  Odometry edges
    measure the chain's relative SE(3) at relative scale 1; a loop (i, j)
    measures relative scale (fd_j med_i) / (fd_i med_j) from the frame
    depths and the closure's own triangulation, and translation b_i s_m t
    with the baseline b_i = fd_i / med_i.  Loops whose rotation disagrees
    with the chain by more than `max_rot` radians are dropped; after a
    robust pass, a loop whose weighted residual stays above
    `reject_residual` x loop_weight is cut and the graph re-optimised.

    Returns (s (N,), R (N,3,3), t (N,3), centres (N,3), final_cost).
    """
    device = require_device(device, "optimize_with_loops_sim3")
    n = len(frames)
    Ri = np.stack([f.R for f in frames]).astype(np.float32)
    ti = np.stack([f.t for f in frames]).astype(np.float32)
    edge_i = list(range(n - 1))
    edge_j = list(range(1, n))
    # odometry: M = S_{k+1} S_k^-1 at s=1
    rel_R = [Ri[k + 1] @ Ri[k].T for k in range(n - 1)]
    rel_t = [ti[k + 1] - rel_R[k] @ ti[k] for k in range(n - 1)]
    rel_s = [1.0] * (n - 1)
    weight = [(1.0, 1.0, 1.0)] * (n - 1)

    for lc in closures:
        if lc.j - lc.i < min_gap:
            continue
        # rotation consistency gate against the chain estimate
        est_R = Ri[lc.j] @ Ri[lc.i].T
        dR = lc.R.T @ est_R
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        if ang > max_rot:
            continue
        fd_i = float(frame_depths[lc.i]) if lc.i < len(frame_depths) else 0.0
        fd_j = float(frame_depths[lc.j]) if lc.j < len(frame_depths) else 0.0
        if fd_i <= 1e-9 or fd_j <= 1e-9 or lc.med_depth <= 1e-9:
            continue
        # s_m = unit_i / unit_j = (fd_j med_i) / (fd_i med_j): the med_i /
        # med_j factor cancels genuine scene-depth variation between the
        # two viewpoints out of the drift measurement
        med_j = lc.med_depth_j if lc.med_depth_j > 1e-9 else lc.med_depth
        s_m = (fd_j * lc.med_depth) / (fd_i * med_j)
        b_i = fd_i / lc.med_depth  # baseline in frame-i units
        edge_i.append(lc.i)
        edge_j.append(lc.j)
        rel_R.append(lc.R.astype(np.float32))
        rel_t.append((s_m * b_i * lc.t).astype(np.float32))
        rel_s.append(s_m)
        weight.append((loop_weight, loop_weight, loop_weight))

    def build(ei, ej, rs, rR, rt, w):
        f = lambda a, dt=torch.float32: torch.as_tensor(
            np.asarray(a), dtype=dt, device=device)
        return Sim3Graph(
            s=torch.ones(n, device=device), R=f(Ri), t=f(ti),
            edge_i=f(ei, torch.int64), edge_j=f(ej, torch.int64),
            rel_s=f(np.asarray(rs, np.float32)), rel_R=f(np.stack(rR)),
            rel_t=f(np.stack(rt)), weight=f(np.asarray(w, np.float32)))

    graph = build(edge_i, edge_j, rel_s, rel_R, rel_t, weight)
    is_loop = np.arange(len(edge_i)) >= (n - 1)
    out, costs = optimize(graph, n_iters=n_iters, robust_delta=robust_delta,
                          robust_mask=torch.as_tensor(is_loop, device=device))

    # a-posteriori chi-square loop rejection, as in the SE(3) path
    # (loopclosure.optimize_with_loops): Huber bounds a gross outlier's
    # influence but does not remove it
    if reject_residual is not None and len(edge_i) > n - 1:
        r, *_ = _edge_blocks(out, out.s, out.R, out.t)
        rn = np.linalg.norm(r.cpu().numpy(), axis=1)
        # the residuals are weighted: loop rows carry loop_weight, so the
        # threshold scales with it
        keep = ~is_loop | (rn < reject_residual * loop_weight)
        if not keep.all() and not keep[n - 1:].any():
            return (np.ones(n), Ri.astype(np.float64),
                    ti.astype(np.float64),
                    np.stack([-Ri[k].T @ ti[k] for k in range(n)]), 0.0)
        if not keep.all():
            ki = np.flatnonzero(keep)
            graph = build([edge_i[i] for i in ki], [edge_j[i] for i in ki],
                          [rel_s[i] for i in ki], [rel_R[i] for i in ki],
                          [rel_t[i] for i in ki], [weight[i] for i in ki])
            out, costs = optimize(
                graph, n_iters=n_iters, robust_delta=robust_delta,
                robust_mask=torch.as_tensor(ki >= (n - 1), device=device))
    return (out.s.cpu().numpy(), out.R.cpu().numpy(), out.t.cpu().numpy(),
            centres(out), float(costs[-1]))
