"""The multi-device layer on the card, at small shapes.

Every test here is marked `cuda` and skips without a GPU; the file imports
no jax, so it runs on the card's machine with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

World of one: NCCL in this process (`initialize_from_env` from the SURF_*
contract, the group destroyed after); the mesh `BatchSurf` of 4 rendered
120x160 frames equal to the single-device `BatchSurf`, the distributed LM
(4 cameras x 64 points) to `run_lm` and `optimize_distributed` (a noisy
circle of 80 nodes, CG) to `optimize(solver="cg")`, all bit for bit, with
kernel launches A 1, the stacked B 1, C 1 (a rank's frames in one call of
the stacked pipeline).  World of two: two processes on one card over gloo
(NCCL refuses two ranks on one GPU), tests/torch_multidevice_worker.py:
the batch equal to the single-device one exactly, with launches A 1, B 1,
C 1 a rank; the BA cost at 1e-4 relative
and t at tests/test_ba.py's 1e-3 for the distributed LM (the gauge fixes
camera 0 alone, so the scale of the camera line drifts with the rounding
of the sums), the graph's t at 1e-4 and costs at 1e-4 relative + 1e-7;
the ranks' replicated outputs bit-equal.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cuda_surf_tpu_torch import BatchSurf, SurfConfig, _build
from cuda_surf_tpu_torch.ba import core as tba
from cuda_surf_tpu_torch.ba.distributed import (make_distributed_lm,
                                                shard_problem)
from cuda_surf_tpu_torch.io.synth import ba_problem, render_plane_sequence
from cuda_surf_tpu_torch.parallel import global_mesh, initialize_from_env
from cuda_surf_tpu_torch.parallel.dryrun import free_port
from cuda_surf_tpu_torch.slam import posegraph
from torch_parity import (assert_ranks_equal, cuda_device,  # noqa: F401
                          run_ranks)

pytestmark = pytest.mark.cuda

KW = dict(noctaves=2, max_pts=256, candidates_per_octave=512)
KERNELS = dict(A="surf_pyramid", B="surf_describe_stacked", C="surf_best2")


def _frames():
    return render_plane_sequence(n_frames=4, h=120, w=160, seed=3)[0]


def _ba_arrays():
    (ci, uv, mask), (R, t, X) = ba_problem(4, 64, seed=1)
    rng = np.random.default_rng(1)
    t = t + rng.normal(0, 0.02, t.shape).astype(np.float32)
    t[0] = 0.0
    X = X + rng.normal(0, 0.02, X.shape).astype(np.float32)
    return dict(cam_idx=ci, uv=uv, mask=mask, R=R, t=t, X=X)


def _circle(n=80, n_loops=5, seed=11):
    """A noisy SE(3) circle with loop edges (tests/test_posegraph.py's
    `_circle_graph` in numpy)."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    Rs = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                    [0, 0, 1]] for a in th])
    ts = np.stack([[10 * np.cos(a), 10 * np.sin(a), 0] for a in th])
    li = rng.integers(0, n // 2, n_loops)
    ei = np.concatenate([np.arange(n - 1), li])
    ej = np.concatenate([np.arange(1, n), li + n // 2])
    return dict(R=Rs, t=ts + rng.normal(0, 0.05, ts.shape), edge_i=ei,
                edge_j=ej, rel_R=np.einsum("eji,ejk->eik", Rs[ei], Rs[ej]),
                rel_t=np.einsum("eji,ej->ei", Rs[ei], ts[ej] - ts[ei]),
                weight=np.ones(len(ei)))


def _single(device):
    """The single-device results: BatchSurf of the frames, run_lm (10
    iterations), optimize(solver="cg") (4 steps)."""
    ks, ds = BatchSurf(SurfConfig(**KW), device=device).detect_and_compute(
        _frames())
    a = _ba_arrays()
    prob = tba.problem_from_numpy(a["cam_idx"], a["uv"], a["mask"], device)
    state = tba.state_from_numpy(a["R"], a["t"], a["X"], device)
    ba, cost = tba.run_lm(state, prob, n_iters=10)
    g = posegraph.graph_from_numpy(SimpleNamespace(**_circle()), device)
    pg, pc = posegraph.optimize(g, n_iters=4, solver="cg")
    return (ks, ds), (prob, state, ba, cost), (g, pg, pc)


def test_world_of_one_nccl_is_single_device(cuda_device, monkeypatch):
    (ks, ds), (prob, state, ba, cost), (g, pg, pc) = _single(cuda_device)
    monkeypatch.setenv("SURF_COORDINATOR", f"127.0.0.1:{free_port()}")
    monkeypatch.setenv("SURF_NUM_PROCESSES", "1")
    monkeypatch.setenv("SURF_PROCESS_ID", "0")
    try:
        assert initialize_from_env(backend="nccl", device="cuda:0")
        mesh = global_mesh()
        assert (mesh.size, mesh.backend) == (1, "nccl")
        before = _build.launch_counts.copy()
        bs = BatchSurf(SurfConfig(**KW), device="cuda", mesh=mesh)
        km, dm = bs.detect_and_compute(_frames())
        bs.match(km, dm, km, dm)
        torch.cuda.synchronize()
        assert {k: _build.launch_counts[e] - before[e]
                for k, e in KERNELS.items()} == dict(A=1, B=1, C=1)
        assert all(torch.equal(a, b) for a, b in zip(km, ks))
        assert torch.equal(dm, ds)
        sprob, sstate = shard_problem(prob, state, mesh)
        got, gcost = make_distributed_lm(mesh, 4, n_iters=10)(sstate, sprob)
        assert all(torch.equal(a, b) for a, b in zip(got, ba))
        assert torch.equal(gcost, cost)
        dg, dc = posegraph.optimize_distributed(g, mesh, n_iters=4)
        assert torch.equal(dg.R, pg.R) and torch.equal(dg.t, pg.t)
        assert torch.equal(dc, pc)
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def test_two_ranks_on_one_card(cuda_device, tmp_path):
    (ks, ds), (_, _, ba, cost), (_, pg, pc) = _single(cuda_device)
    run = lambda task, inp: run_ranks(task, 2, tmp_path, inp,
                                      device="cuda:0", backend="gloo")
    batch = run("batch", dict(frames=_frames(), cfg=np.str_(json.dumps(KW))))
    assert_ranks_equal(batch, ["descs", "match_score", "match_index"]
                       + [f"kp_{f}" for f in ks._fields])
    for res in batch:
        assert str(res["backend"]) == "gloo"
        assert str(res["device"]) == "cuda:0"
        assert [int(res[f"launches_{k}"]) for k in "ABC"] == [1, 1, 1]
        for f in ks._fields:
            np.testing.assert_array_equal(res[f"kp_{f}"],
                                          getattr(ks, f).cpu().numpy())
        np.testing.assert_array_equal(res["descs"], ds.cpu().numpy())
    ranks = run("ba", dict(_ba_arrays(), n_iters=np.int64(10)))
    assert_ranks_equal(ranks, ("R", "t", "points", "cost"))
    np.testing.assert_allclose(ranks[0]["cost"], float(cost), rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["t"], ba.t.cpu().numpy(), atol=1e-3,
                               rtol=0)
    g = _circle()
    inp = {f"c_{k}": v for k, v in g.items()}
    inp.update(cases=np.str_('["c"]'), c_meta=np.str_('{"n_iters": 4}'))
    ranks = run("posegraph", inp)
    assert_ranks_equal(ranks, ("c_R", "c_t", "c_costs", "c_rounds"))
    np.testing.assert_allclose(ranks[0]["c_t"], pg.t.cpu().numpy(),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["c_costs"], pc.cpu().numpy(),
                               rtol=1e-4, atol=1e-7)
