"""Pose-graph optimisation, Gauss-Newton over SE(3) relative constraints
(port of cuda_surf_tpu/slam/posegraph.py).

Per-edge residual Jacobians come from forward-mode autodiff at the zero
increment (`torch.func.jacfwd`, vmapped over the edges), as in the
reference.  Two solve paths, switched on graph size:

 - small graphs (n <= 64 by default): the dense (6n, 6n) system assembled
   with one-hot contractions and one LU solve (`solve_ex`, which does not
   check its result on the host);
 - large graphs: a matrix-free block-Jacobi-preconditioned conjugate
   gradient whose matvec gathers the two endpoint increments of every edge
   and sums the 6x6 block products back per node.

Every sum over edges runs in a fixed order: the dense path contracts with
one-hot matrices; the CG path gathers each node's edge ends through a
table padded to the largest degree and sums that axis.  `index_add_` on
the card adds with float atomics, in an order that changes from run to
run, so it is not used.

The reference's CG loop is a `lax.while_loop` that tests `r . r` on the
device.  Eager torch would read that test on the host every round, so the
rounds run in chunks of CG_CHUNK: each round applies its update only
where the stop test still holds (the result equals the while loop's), and
the host reads the stop flag once a chunk.

`optimize_distributed` splits the edges over the ranks of a mesh
(`parallel.mesh`): the CG path with an all-reduce after every segment sum.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .._build import require_device
from ..geometry.pose import compose, exp_so3, invert, log_so3
from ..parallel.mesh import psum, replicated, shard_rows

# Dense one-hot assembly up to this node count, matrix-free CG above.
_DENSE_MAX_NODES = 64
# CG rounds between two host reads of the stop flag.
CG_CHUNK = 32


class PoseGraph(NamedTuple):
    R: torch.Tensor        # (N, 3, 3) world->cam
    t: torch.Tensor        # (N, 3)
    edge_i: torch.Tensor   # (E,) int64
    edge_j: torch.Tensor   # (E,) int64
    rel_R: torch.Tensor    # (E, 3, 3) measured T_i^-1 T_j rotation
    rel_t: torch.Tensor    # (E, 3)
    weight: torch.Tensor   # (E,) f32


def graph_from_numpy(src, device="cuda") -> PoseGraph:
    """A PoseGraph from any object carrying the fields as arrays (e.g. the
    JAX package's graph), on the card unless `device="cpu"`."""
    device = require_device(device, "graph_from_numpy")
    f = lambda k, dt: torch.as_tensor(np.array(getattr(src, k)), dtype=dt,
                                      device=device)
    return PoseGraph(
        **{k: f(k, torch.float32) for k in ("R", "t", "rel_R", "rel_t",
                                            "weight")},
        edge_i=f("edge_i", torch.int64), edge_j=f("edge_j", torch.int64))


def _edge_residual(Ri, ti, Rj, tj, rel_R, rel_t, xi):
    """Residual of one edge with local increments xi = (xi_i, xi_j) (12,)
    applied: r = log( rel^{-1} * (T_i [+] xi_i)^{-1} (T_j [+] xi_j) )."""
    Ri = exp_so3(xi[:3]) @ Ri
    ti = ti + xi[3:6]
    Rj = exp_so3(xi[6:9]) @ Rj
    tj = tj + xi[9:]
    Rinv, tinv = invert(Ri, ti)
    Rij, tij = compose(Rinv, tinv, Rj, tj)
    Rrel_inv, trel_inv = invert(rel_R, rel_t)
    Re, te = compose(Rrel_inv, trel_inv, Rij, tij)
    return torch.cat([log_so3(Re), te])


def residual_jacobians(residual, d: int, *edge_args):
    """Residuals (E, r) and Jacobians Ji, Jj (E, r, d) of `residual(*args,
    xi)` at xi = 0, with respect to the d-dim increments of the two end
    nodes (xi = (xi_i, xi_j)), vmapped over the edges.  Forward mode
    carries some tangents of 0-dim intermediates in float64; they are
    rounded to float32 here."""
    E = edge_args[0].shape[0]
    zero = torch.zeros(E, 2 * d, device=edge_args[0].device)

    def with_value(*args):
        r = residual(*args)
        return r, r

    J, r = vmap(jacfwd(with_value, argnums=len(edge_args), has_aux=True))(
        *edge_args, zero)
    J = J.to(torch.float32)
    return r, J[..., :d], J[..., d:]


def normal_blocks(Ji, Jj, r):
    """Per-edge blocks of the normal equations:
    Hii = Ji^T Ji, Hjj, Hij = Ji^T Jj, bi = -Ji^T r, bj."""
    JiT, JjT = Ji.transpose(1, 2), Jj.transpose(1, 2)
    return (JiT @ Ji, JjT @ Jj, JiT @ Jj, -(JiT @ r[..., None])[..., 0],
            -(JjT @ r[..., None])[..., 0])


def _edge_blocks(graph: PoseGraph, R, t):
    """Residuals + weighted per-edge normal-equation blocks.

    -> r (E, 6), Hii/Hjj/Hij (E, 6, 6), bi/bj (E, 6)."""
    ii, jj = graph.edge_i, graph.edge_j
    r, Ji, Jj = residual_jacobians(_edge_residual, 6, R[ii], t[ii], R[jj],
                                   t[jj], graph.rel_R, graph.rel_t)
    Hii, Hjj, Hij, bi, bj = normal_blocks(Ji, Jj, r)
    w = graph.weight[:, None, None]
    wb = graph.weight[:, None]
    return r, w * Hii, w * Hjj, w * Hij, wb * bi, wb * bj


def _one_hot(idx, n):
    return torch.nn.functional.one_hot(idx, n).to(torch.float32)


def _solve_dense(graph, n, damping, Hii, Hjj, Hij, bi, bj):
    """One-hot dense assembly + LU solve (small graphs).  The block
    dimension d is read off the edge blocks (6 for SE(3), 7 for the Sim(3)
    graph in sim3graph.py)."""
    d = Hii.shape[-1]
    ii, jj = graph.edge_i, graph.edge_j
    dev = Hii.device
    oh_hh = _one_hot(torch.cat([ii * n + ii, jj * n + jj, ii * n + jj,
                                jj * n + ii]), n * n)       # (4E, n^2)
    blocks = torch.cat([Hii, Hjj, Hij, Hij.transpose(1, 2)], 0)
    H = (oh_hh.T @ blocks.reshape(-1, d * d)).reshape(n, n, d, d)
    b = _one_hot(torch.cat([ii, jj]), n).T @ torch.cat([bi, bj], 0)
    Hm = H.permute(0, 2, 1, 3).reshape(d * n, d * n)
    Hm = Hm + damping * torch.eye(d * n, device=dev)
    # gauge: clamp node 0
    gauge = torch.arange(d * n, device=dev) < d
    Hm = torch.where(gauge[:, None] | gauge[None, :], 0.0, Hm)
    Hm = Hm + torch.diag(gauge.to(torch.float32))
    bv = b.reshape(-1) * (~gauge)
    x, _ = torch.linalg.solve_ex(Hm, bv)
    return x.reshape(n, d)


def segment_table(graph, n: int) -> torch.Tensor:
    """(n, max degree) int64: for each node, the rows of cat([ends at i,
    ends at j]) (2E rows) that belong to it, in row order, padded with 2E
    (a zero row appended by `segment_sum`).  Built on the host from the
    edge lists: one read of them a call of `optimize`."""
    seg = torch.cat([graph.edge_i, graph.edge_j]).cpu().numpy()
    order = np.argsort(seg, kind="stable")
    counts = np.bincount(seg, minlength=n)
    table = np.full((n, max(int(counts.max(initial=0)), 1)), len(seg),
                    np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(len(seg)) - np.repeat(starts, counts)
    table[seg[order], pos] = order
    return torch.as_tensor(table, device=graph.edge_i.device)


def segment_sum(rows: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Sum of `rows` (2E, ...) per node through `segment_table`, in a fixed
    order (no atomics)."""
    padded = torch.cat([rows, rows.new_zeros((1,) + rows.shape[1:])], 0)
    return padded[table].sum(1)


def _identity(x):
    return x


class CGState(NamedTuple):
    k: torch.Tensor        # () int64 rounds taken
    x: torch.Tensor        # (n, d)
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor       # ()


class CGSystem(NamedTuple):
    graph: PoseGraph
    table: torch.Tensor
    damping: float
    Hii: torch.Tensor
    Hjj: torch.Tensor
    Hij: torch.Tensor
    Dinv: torch.Tensor
    b: torch.Tensor
    stop: torch.Tensor     # () the reference's cg_tol * (|b|^2 + 1e-30)
    cg_iters: int
    reduce: Callable = _identity   # sums a per-node array over the ranks


def _cg_system(graph, table, n, damping, Hii, Hjj, Hij, bi, bj,
               cg_iters, cg_tol=1e-8, reduce=_identity):
    """The CG system of the step.  `reduce` sums each per-node segment sum
    over the ranks that hold the other edges (`optimize_distributed`);
    the gauge and the damping are applied after it."""
    d = Hii.shape[-1]
    eye = torch.eye(d, device=Hii.device)
    b = reduce(segment_sum(torch.cat([bi, bj]), table))
    b = torch.cat([torch.zeros_like(b[:1]), b[1:]])        # gauge node 0
    # block-Jacobi preconditioner: inverse of the diagonal dxd blocks
    D = reduce(segment_sum(torch.cat([Hii, Hjj]), table))
    D = D + damping * eye + 1e-9 * eye
    D = torch.cat([eye[None], D[1:]])
    Dinv, _ = torch.linalg.inv_ex(D)
    stop = cg_tol * (torch.sum(b * b) + 1e-30)
    return CGSystem(graph, table, damping, Hii, Hjj, Hij, Dinv, b, stop,
                    cg_iters, reduce)


def _matvec(s: CGSystem, x):
    """H x, edge-wise: gather the endpoint increments, multiply the dxd
    blocks, sum back per node; row 0 is the identity (gauge)."""
    xg = torch.cat([torch.zeros_like(x[:1]), x[1:]])
    xi, xj = xg[s.graph.edge_i], xg[s.graph.edge_j]
    mv = lambda A, v: (A @ v[..., None])[..., 0]
    yi = mv(s.Hii, xi) + mv(s.Hij, xj)
    yj = mv(s.Hij.transpose(1, 2), xi) + mv(s.Hjj, xj)
    y = s.reduce(segment_sum(torch.cat([yi, yj]), s.table)) + \
        s.damping * xg
    return torch.cat([x[:1], y[1:]])


def _precond(s: CGSystem, v):
    return (s.Dinv @ v[..., None])[..., 0]


def cg_start(s: CGSystem) -> CGState:
    z0 = _precond(s, s.b)
    return CGState(torch.zeros((), dtype=torch.int64, device=s.b.device),
                   torch.zeros_like(s.b), s.b, z0, z0, torch.sum(s.b * z0))


def cg_running(s: CGSystem, c: CGState) -> torch.Tensor:
    """The reference's loop condition, on the device."""
    return (c.k < s.cg_iters) & (torch.sum(c.r * c.r) > s.stop)


def cg_chunk(s: CGSystem, c: CGState, rounds: int) -> CGState:
    """`rounds` CG rounds, each applied only where the loop condition holds
    at its start; no host read."""
    for _ in range(rounds):
        run = cg_running(s, c)
        Hp = _matvec(s, c.p)
        alpha = c.rz / (torch.sum(c.p * Hp) + 1e-30)
        x = c.x + alpha * c.p
        r = c.r - alpha * Hp
        z = _precond(s, r)
        rz = torch.sum(r * z)
        p = z + (rz / (c.rz + 1e-30)) * c.p
        c = CGState(c.k + run.to(torch.int64),
                    *(torch.where(run, new, old) for new, old in
                      zip((x, r, z, p, rz), c[1:])))
    return c


def _solve_cg(s: CGSystem, stats: dict | None = None):
    """Run CG chunk by chunk (CG_CHUNK rounds); one host read (the stop
    flag and the round count, in one copy) a chunk."""
    c = cg_start(s)
    reads = 0
    while True:
        c = cg_chunk(s, c, CG_CHUNK)
        running, k = torch.stack([cg_running(s, c).to(torch.int64),
                                  c.k]).tolist()
        reads += 1
        if not running:
            break
    if stats is not None:
        stats.setdefault("cg_rounds", []).append(k)
        stats.setdefault("host_reads", []).append(reads)
    return c.x


def edge_residuals(graph: PoseGraph) -> torch.Tensor:
    """Unweighted per-edge residuals (E, 6) at the graph's current state:
    the a-posteriori consistency check behind chi-square edge rejection
    (loopclosure.optimize_with_loops)."""
    r, *_ = _edge_blocks(graph, graph.R, graph.t)
    return r


def robust_factors(r, robust_delta, robust_mask):
    """Huber IRLS edge weights: 1 inside `robust_delta`, delta/||r||
    outside; `robust_mask` restricts the reweighting to the marked edges
    (loop edges: odometry residuals near a correction are legitimately
    large mid-optimisation)."""
    rnorm = torch.sqrt(torch.sum(r * r, -1) + 1e-20)
    f = torch.clamp(robust_delta / rnorm, max=1.0)
    if robust_mask is not None:
        f = torch.where(robust_mask, f, 1.0)
    return f


def solve_step(graph, n, solver, damping, cg_iters, robust_delta,
               robust_mask, blocks, table=None, stats=None,
               reduce=_identity):
    """The increment dx (n, d) of one Gauss-Newton step from the edge
    blocks (r, Hii, Hjj, Hij, bi, bj), shared by the SE(3) and Sim(3)
    graphs and by `optimize_distributed` (CG, with its `reduce`)."""
    r, Hii, Hjj, Hij, bi, bj = blocks
    if robust_delta is not None:
        f = robust_factors(r, robust_delta, robust_mask)
        Hii, Hjj, Hij = (f[:, None, None] * H for H in (Hii, Hjj, Hij))
        bi, bj = f[:, None] * bi, f[:, None] * bj
    if solver == "dense":
        return _solve_dense(graph, n, damping, Hii, Hjj, Hij, bi, bj)
    s = _cg_system(graph, table, n, damping, Hii, Hjj, Hij, bi, bj,
                   cg_iters, reduce=reduce)
    return _solve_cg(s, stats)


def solver_plan(graph, n, solver, cg_iters):
    """-> (solver, cg_iters, segment table or None)."""
    if solver == "auto":
        solver = "dense" if n <= _DENSE_MAX_NODES else "cg"
    if cg_iters is None:
        cg_iters = max(8 * n, 200)
    return solver, cg_iters, segment_table(graph, n) if solver == "cg" \
        else None


def optimize(graph: PoseGraph, n_iters: int = 10, damping: float = 1e-6,
             solver: str = "auto", cg_iters: int | None = None,
             robust_delta: float | None = None,
             robust_mask: torch.Tensor | None = None,
             stats: dict | None = None):
    """`solver`: "dense" | "cg" | "auto" (dense up to 64 nodes).
    `robust_delta`: Huber IRLS threshold on the per-edge residual norm
    (None = pure least squares); `robust_mask` (E,) bool restricts the
    reweighting to the marked edges.  `stats`, when given, gathers the CG
    rounds and host reads of each step.  Runs on the graph's device.
    -> (optimised PoseGraph, costs (n_iters,): the cost before each step)."""
    n = graph.R.shape[0]
    solver, cg_iters, table = solver_plan(graph, n, solver, cg_iters)
    R, t = graph.R, graph.t
    costs = []
    for _ in range(n_iters):
        blocks = _edge_blocks(graph, R, t)
        dx = solve_step(graph, n, solver, damping, cg_iters, robust_delta,
                        robust_mask, blocks, table, stats)
        R = exp_so3(dx[:, :3]) @ R
        t = t + dx[:, 3:]
        costs.append(torch.sum(blocks[0] * blocks[0]))
    return graph._replace(R=R, t=t), torch.stack(costs)


# ----------------------------------------------------- distributed (mesh)

def _pad_graph_edges(graph: PoseGraph, multiple: int) -> PoseGraph:
    """Pad the edge axis to a multiple with zero-weight identity
    self-edges (0, 0, rel=I): their weight zeroes every normal-equation
    block, so padding is inert."""
    E = graph.edge_i.shape[0]
    pad = (-E) % multiple
    if pad == 0:
        return graph
    zi = graph.edge_i.new_zeros(pad)
    eye = torch.eye(3, dtype=graph.rel_R.dtype,
                    device=graph.rel_R.device).expand(pad, 3, 3)
    return graph._replace(
        edge_i=torch.cat([graph.edge_i, zi]),
        edge_j=torch.cat([graph.edge_j, zi]),
        rel_R=torch.cat([graph.rel_R, eye]),
        rel_t=torch.cat([graph.rel_t, graph.rel_t.new_zeros(pad, 3)]),
        weight=torch.cat([graph.weight, graph.weight.new_zeros(pad)]))


def optimize_distributed(graph: PoseGraph, mesh, n_iters: int = 10,
                         damping: float = 1e-6,
                         cg_iters: int | None = None,
                         robust_delta: float | None = None,
                         robust_mask: torch.Tensor | None = None,
                         stats: dict | None = None):
    """Pose-graph Gauss-Newton with the EDGE axis split over the ranks of
    `mesh` (every rank passes the whole graph).

    The edges are padded to a multiple of the mesh size with inert
    self-edges and split; each rank linearises only its own edges and sums
    them per node through its own `segment_table`, and one all-reduce after
    each segment sum (b, D, and every CG matvec: `CG_CHUNK` a chunk, masked
    rounds included) completes the node-indexed normal equations, on which
    the gauge and the damping are applied.  The stop test reads
    all-reduced values, so every rank stops at the same chunk.  Nodes are
    replicated.  At a world of one this is `optimize(solver="cg")`.

    Returns (optimised PoseGraph [original edge count], costs (n_iters,):
    the cost before each step, summed over the ranks)."""
    E = graph.edge_i.shape[0]
    gp = _pad_graph_edges(graph, mesh.size)
    rmask = None
    if robust_delta is not None:
        rmask = torch.ones(E, dtype=torch.bool) if robust_mask is None \
            else robust_mask.cpu()
        rmask = shard_rows(torch.cat([rmask, torch.zeros(
            gp.edge_i.shape[0] - E, dtype=torch.bool)]), mesh)
    local = PoseGraph(replicated(gp.R, mesh), replicated(gp.t, mesh),
                      *(shard_rows(a, mesh) for a in gp[2:]))
    n = gp.R.shape[0]
    _, cg_iters, table = solver_plan(local, n, "cg", cg_iters)
    reduce = lambda x: psum(x, mesh)
    R, t = local.R, local.t
    costs = []
    for _ in range(n_iters):
        blocks = _edge_blocks(local, R, t)
        dx = solve_step(local, n, "cg", damping, cg_iters, robust_delta,
                        rmask, blocks, table, stats, reduce)
        R = exp_so3(dx[:, :3]) @ R
        t = t + dx[:, 3:]
        costs.append(reduce(torch.sum(blocks[0] * blocks[0])))
    return graph._replace(R=R, t=t), torch.stack(costs)
