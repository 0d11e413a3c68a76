"""The port's edge-split pose graph (`slam.posegraph.optimize_distributed`)
against the JAX package's at the same mesh size, and against the port's
`optimize(solver="cg")`.

The cases are tests/test_posegraph.py's distributed ones: the noisy circle
`_circle_graph(40, 6)` at seed 11 (plain, 6 steps) and `_circle_graph(30,
4)` at seed 12 with its last loop edge pulled off and Huber IRLS on the
loop edges (robust, 8 steps).  Their 45 and 33 edges divide by neither 2
nor 4, so both pad.  The port's ranks are gloo processes on the CPU
(tests/torch_multidevice_worker.py); JAX runs here on
`Mesh(jax.devices()[:n], ("edges",))`.

Tolerances: against JAX, t at 1e-4 and each step's cost at 1e-4 relative
with tests/test_posegraph.py's absolute floor of 1e-7 (the last steps sit
at float32's rounding floor, ~1e-11); against the port's single-device CG,
tests/test_posegraph.py's distributed tolerances (t 1e-3, costs 1e-3
relative + 1e-7).  The ranks' nodes, costs and CG rounds bit-equal (every
rank stops at the same chunk); a world of one equal to `optimize` bit for
bit.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from cuda_surf_tpu.slam.posegraph import (optimize_distributed as
                                          jax_optimize_distributed)
from test_posegraph import _circle_graph

from cuda_surf_tpu_torch.parallel import make_mesh
from cuda_surf_tpu_torch.slam import posegraph as tpg
from torch_parity import assert_ranks_equal, one_torch_thread  # noqa: F401
from torch_parity import run_ranks


def _cases():
    """{name: (JAX graph, robust mask or None, meta)}."""
    g, _, _ = _circle_graph(40, 6, np.random.default_rng(11))
    plain = (g, None, dict(n_iters=6))
    g, _, _ = _circle_graph(30, 4, np.random.default_rng(12))
    E = int(g.edge_i.shape[0])
    rel_t = np.asarray(g.rel_t).copy()
    rel_t[E - 1] += np.array([0.4, -0.3, 0.2], np.float32)
    g = g._replace(rel_t=jnp.asarray(rel_t))
    robust = (g, np.arange(E) >= 29, dict(n_iters=8, robust_delta=0.1))
    return dict(plain=plain, robust=robust)


def _inputs(cases):
    out = dict(cases=np.str_(json.dumps(list(cases))))
    for name, (g, mask, meta) in cases.items():
        out.update({f"{name}_{k}": np.asarray(getattr(g, k))
                    for k in tpg.PoseGraph._fields})
        out[f"{name}_meta"] = np.str_(json.dumps(meta))
        if mask is not None:
            out[f"{name}_robust_mask"] = mask
    return out


def _port_single(g, mask, meta):
    return tpg.optimize(tpg.graph_from_numpy(g, "cpu"), solver="cg",
                        n_iters=meta["n_iters"],
                        robust_delta=meta.get("robust_delta"),
                        robust_mask=None if mask is None
                        else torch.as_tensor(mask))


@pytest.mark.parametrize("world", [2, 4])
def test_distributed_matches_jax_and_single(world, tmp_path):
    cases = _cases()
    ranks = run_ranks("posegraph", world, tmp_path, _inputs(cases))
    assert_ranks_equal(ranks, [f"{c}_{k}" for c in cases
                               for k in ("R", "t", "costs", "rounds")])
    got = ranks[0]
    jmesh = JaxMesh(np.asarray(jax.devices()[:world]), ("edges",))
    for name, (g, mask, meta) in cases.items():
        jg, jc = jax_optimize_distributed(
            g, jmesh, n_iters=meta["n_iters"],
            robust_delta=meta.get("robust_delta"),
            robust_mask=None if mask is None else jnp.asarray(mask))
        t, costs = got[f"{name}_t"], got[f"{name}_costs"]
        np.testing.assert_allclose(t, np.asarray(jg.t), atol=1e-4, rtol=0,
                                   err_msg=name)
        np.testing.assert_allclose(costs, np.asarray(jc), rtol=1e-4,
                                   atol=1e-7, err_msg=name)
        single, sc = _port_single(g, mask, meta)
        np.testing.assert_allclose(t, single.t.numpy(), atol=1e-3,
                                   err_msg=name)
        np.testing.assert_allclose(costs, sc.numpy(), rtol=1e-3, atol=1e-7,
                                   err_msg=name)


def test_world_of_one_is_optimize_bit_for_bit():
    mesh = make_mesh(devices="cpu")
    for name, (g, mask, meta) in _cases().items():
        stats_d, stats_s = {}, {}
        tg = tpg.graph_from_numpy(g, "cpu")
        mask_t = None if mask is None else torch.as_tensor(mask)
        got, gc = tpg.optimize_distributed(
            tg, mesh, n_iters=meta["n_iters"],
            robust_delta=meta.get("robust_delta"), robust_mask=mask_t,
            stats=stats_d)
        want, wc = tpg.optimize(tg, solver="cg", n_iters=meta["n_iters"],
                                robust_delta=meta.get("robust_delta"),
                                robust_mask=mask_t, stats=stats_s)
        assert torch.equal(got.R, want.R) and torch.equal(got.t, want.t), name
        assert torch.equal(gc, wc), name
        assert stats_d == stats_s, name


def test_padding_edges_are_inert():
    """45 edges padded to 48: three zero-weight identity self-edges at node
    0, whose normal-equation blocks are exactly zero; `optimize` of the
    padded graph is the unpadded one's within rounding (the per-node
    table grows, so its sums run over more zeros)."""
    g = tpg.graph_from_numpy(_cases()["plain"][0], "cpu")
    gp = tpg._pad_graph_edges(g, 4)
    assert gp.edge_i.shape[0] == 48 and tpg._pad_graph_edges(g, 5) is g
    assert torch.equal(gp.edge_i[45:], torch.zeros(3, dtype=torch.int64))
    assert torch.equal(gp.edge_j[45:], gp.edge_i[45:])
    assert torch.equal(gp.weight[45:], torch.zeros(3))
    _, *blocks = tpg._edge_blocks(gp, gp.R, gp.t)
    assert all(torch.equal(b[45:], torch.zeros_like(b[45:]))
               for b in blocks)
    a, ca = tpg.optimize(gp, solver="cg", n_iters=6)
    b, cb = tpg.optimize(g, solver="cg", n_iters=6)
    np.testing.assert_allclose(a.t.numpy(), b.t.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ca.numpy(), cb.numpy(), rtol=1e-5, atol=1e-9)
