"""The SLAM backend on the card against the port on the CPU: the SE(3) and
Sim(3) pose graphs, and a loop-detecting SlamPipeline.

Every test here is marked `cuda` and skips without a GPU; the file imports
no jax, so it runs on the card's machine with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

The graphs are golden_posegraph.npz's (n = 64 dense, n = 600 CG); the
pipeline runs the VO cell's 12 terrain frames with `loop_min_gap=6` on the
draws of golden_terrain_loops.npz / golden_terrain_vo.npz (seed 0) on both
devices.  Tolerances: the graphs' R within 1e-4, t within 5e-5 x max |t|,
s within 1e-5, each step's cost within 1 % + 1e-6 x the first (CPU and
card round the sums differently); a second run on the card equal bit for
bit (no float atomics); the pipeline's verified pairs equal, their inliers
within 2 % (or 2 points), the same closures wherever the inliers lie more
than 10 % from `min_inliers` (60).  The trajectories are not
compared: on this cell a match at the ratio test's threshold gives pair
4 -> 5 other RANSAC samples on one device than on the other, and the VO
ATE of seed 0 reads 0.026 on the card against 0.077 on the CPU (ROADMAP
Queue 3, "RANSAC ties"); they are held finite.  `optimize`'s dense path,
and one chunk of the CG path, run with torch's sync debug mode set to
raise: the chunk's stop read, after it, is the solver's only host read.
"""

import ast
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.io.synth import TERRAIN_VO, render_terrain_sequence
from cuda_surf_tpu_torch.slam import SlamPipeline, posegraph, sim3graph
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "cuda_surf_tpu_torch", "data")
CASES = ("se3_64", "se3_600", "sim3_64", "sim3_600")


def _case(case, device):
    g = np.load(os.path.join(DATA, "golden_posegraph.npz"))
    meta = ast.literal_eval(str(g[f"{case}_meta"]))
    mod = sim3graph if case.startswith("sim3") else posegraph
    fields = (mod.Sim3Graph if mod is sim3graph else mod.PoseGraph)._fields
    src = SimpleNamespace(**{k: g[f"{case}_in_{k}"] for k in fields})
    return mod, mod.graph_from_numpy(src, device), meta


@pytest.mark.parametrize("case", CASES)
def test_posegraph_card_vs_cpu(cuda_device, case):
    runs = []
    for dev in ("cpu", cuda_device, cuda_device):
        mod, graph, meta = _case(case, dev)
        runs.append(mod.optimize(graph, n_iters=meta["n_iters"],
                                 solver=meta["solver"]))
    (cpu, ccpu), (card, ccard), (card2, ccard2) = runs
    for a, b in zip(card, card2):
        assert torch.equal(a, b)
    assert torch.equal(ccard, ccard2)
    names = ("s", "R", "t") if case.startswith("sim3") else ("R", "t")
    for k in names:
        want = getattr(cpu, k).numpy()
        atol = {"s": 1e-5, "R": 1e-4, "t": 5e-5 * np.abs(want).max()}[k]
        np.testing.assert_allclose(getattr(card, k).cpu().numpy(), want,
                                   atol=atol, rtol=0, err_msg=k)
    c = ccpu.numpy()
    np.testing.assert_allclose(ccard.cpu().numpy(), c, rtol=1e-2,
                               atol=1e-6 * c[0])


def test_dense_path_and_cg_chunk_without_host_sync(cuda_device):
    mod, graph, meta = _case("se3_64", cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, costs = posegraph.optimize(graph, n_iters=2, solver="dense")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(out.t).all() and torch.isfinite(costs).all()
    mod, graph, meta = _case("se3_600", cuda_device)
    n = graph.R.shape[0]
    table = posegraph.segment_table(graph, n)      # one read of the edges
    blocks = posegraph._edge_blocks(graph, graph.R, graph.t)[1:]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        s = posegraph._cg_system(graph, table, n, 1e-6, *blocks,
                                 max(8 * n, 200))
        c = posegraph.cg_chunk(s, posegraph.cg_start(s), posegraph.CG_CHUNK)
        running = posegraph.cg_running(s, c)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(running) and int(c.k) == posegraph.CG_CHUNK


def test_loop_pipeline_card_vs_cpu(cuda_device):
    frames, _, intr = render_terrain_sequence(**TERRAIN_VO)
    g = np.load(os.path.join(DATA, "golden_terrain_loops.npz"))
    vo = np.load(os.path.join(DATA, "golden_terrain_vo.npz"))
    gap = int(g["min_gap"])
    runs = []
    for dev in ("cpu", cuda_device):
        raws = torch.as_tensor(vo["raws"][0], device=dev)
        pair = {(int(i), int(j)): torch.as_tensor(r, device=dev)
                for (i, j), r in zip(g["loop_pairs"], g["loop_raws"])}
        pipe = SlamPipeline(cst.SurfConfig(**VO_CONFIG), intrinsics=intr,
                            loop_detect=True, loop_min_gap=gap, device=dev)
        for k, f in enumerate(frames):
            pipe.process(f, raw=raws[k - 1] if k else None,
                         loop_raws={i: r for (i, j), r in pair.items()
                                    if j == k})
        runs.append(pipe)
    cpu, card = runs
    assert [v[:2] for v in card._detector.verified] == \
        [v[:2] for v in cpu._detector.verified]
    for (i, j, nc), (_, _, nd) in zip(cpu._detector.verified,
                                      card._detector.verified):
        assert abs(nd - nc) <= max(0.02 * nc, 2), (i, j, nc, nd)
    assert card.loops
    clear = lambda p: {(lc.i, lc.j) for lc in p.loops
                       if abs(lc.n_inliers - 60) > 6}
    assert clear(card) == clear(cpu)
    assert np.isfinite(card.optimize_posegraph())
    assert np.isfinite(card.trajectory()).all()
