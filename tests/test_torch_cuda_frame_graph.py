"""`Surf.detect_and_compute`'s CUDA graph on the card.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda_frame_graph.py

The first call at an (H, W) shape runs the single-frame pipeline eagerly,
the second captures it after kernel G as a CUDA graph, and every later
call runs G on its frame and replays the graph.  Every call equals the
module's eager `detect_and_compute` on its own frame bit for bit, a
replaying call launches kernel G alone through an entry point, a later
call leaves an earlier call's tensors as they were, and
`frontend.graph_counts` counts each call by what it did.  A graph keeps
the cached plans and tables its launches read, so a replay is right after
their caches drop them and their memory is taken again.  The benchmark's
planted faults patch `frontend._make_keypoints` and `frontend.describe`,
and reach a replay because the capture calls them through those names.
"""

import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import _build, frontend
from cuda_surf_tpu_torch.config import ROTATED_CONFIG
from cuda_surf_tpu_torch.io import main_batch
from cuda_surf_tpu_torch.ops import extrema, fused_detect, orientation
from portbench import faults

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def frames():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.as_tensor(main_batch(3)).cuda()


def _bits(a):
    return a.view(torch.int32) if a.is_floating_point() else a


def _equal(got, want) -> bool:
    (kp, d), (kw, dw) = got, want
    return (all(torch.equal(_bits(a), _bits(b)) for a, b in zip(kp, kw))
            and torch.equal(_bits(d), _bits(dw)))


@pytest.mark.parametrize("mode", [dict(upright=True), dict(),
                                  dict(extended=True), dict(doubled=True)],
                         ids=["upright", "rotated", "extended", "doubled"])
def test_surf_frame_replays_its_graph(frames, mode):
    """An eager call, the capture, then replays on other frames: each
    equals the eager pipeline on its own frame; a replay launches only G;
    the earlier calls' tensors are unchanged by the later ones."""
    cfg = cst.SurfConfig(**dict(ROTATED_CONFIG, **mode))
    order = [0, 1, 2, 0]
    want = [cst.detect_and_compute(frames[f], cfg) for f in range(3)]
    surf = cst.Surf(cfg, device="cuda")
    counts = frontend.graph_counts.copy()
    got = [surf.detect_and_compute(frames[f]) for f in order[:2]]
    before = _build.launch_counts.copy()
    got.append(surf.detect_and_compute(frames[order[2]]))
    torch.cuda.synchronize()
    g = "surf_integral_doubled" if cfg.doubled else "surf_integral"
    assert _build.launch_counts - before == {g: 1}
    got.append(surf.detect_and_compute(frames[order[3]]))
    torch.cuda.synchronize()
    assert frontend.graph_counts - counts == {
        ("frame", "eager"): 1, ("frame", "capture"): 1,
        ("frame", "replay"): 2}
    for f, out in zip(order, got):
        assert _equal(out, want[f]), f
    assert int(got[1][0].count) > 1000
    assert not _equal(got[1], want[0])


def test_planted_faults_reach_the_replay(frames):
    """Each fault of `portbench/faults.py` that alters what the frontend
    makes, planted around a `Surf`'s calls as the benchmark plants it,
    alters the replay's outputs where it alters the eager call's."""
    cfg = cst.SurfConfig(**dict(ROTATED_CONFIG, upright=True))
    want = [cst.detect_and_compute(frames[f], cfg) for f in range(3)]
    for name, field in (("descriptor_altered", None), ("keypoint_moved", "x"),
                        ("laplace_flipped", "laplace")):
        with faults.FAULTS[name][0]():
            surf = cst.Surf(cfg, device="cuda")
            counts = frontend.graph_counts.copy()
            got = [surf.detect_and_compute(frames[f]) for f in range(3)]
        assert frontend.graph_counts - counts == {
            ("frame", "eager"): 1, ("frame", "capture"): 1,
            ("frame", "replay"): 1}
        for (kp, d), (kw, dw) in zip(got, want):
            if field is None:
                assert (d != dw).nonzero().tolist() == [[0, 0]], name
                assert all(torch.equal(a, b) for a, b in zip(kp, kw))
            else:
                a, b = getattr(kp, field), getattr(kw, field)
                assert (a != b).nonzero().flatten().tolist() == [0], name
                assert torch.equal(a[1:], b[1:])


@pytest.mark.parametrize("path", ["frame", "batch"])
def test_graph_keeps_the_tables_it_reads(frames, path):
    """Kernels A, F and D read their plans and tables from cached device
    tensors, by the address the capture gave them.  With the caches
    emptied and their tensors' memory allocated again and zeroed, a
    replay still equals the eager pipeline bit for bit."""
    cfg = cst.SurfConfig(**ROTATED_CONFIG)
    images = frames[0] if path == "frame" else frames
    call = dict(frame=cst.Surf.detect_and_compute,
                batch=cst.Surf.detect_and_compute_batch)[path]
    eager = dict(frame=cst.detect_and_compute,
                 batch=cst.detect_and_compute_batch)[path]
    want = eager(images, cfg)
    surf = cst.Surf(cfg, device="cuda")
    for _ in range(2):      # the eager call, then the capture
        call(surf, images)
    held = surf._graphs[tuple(images.shape)].held
    assert len(held) == 3       # A's plan, F's plan, D's table
    sizes = {t.numel() * t.element_size()
             for t in (getattr(h, "dev", h) for h in held)}
    for cache in (fused_detect.pyramid_plan, extrema.extrema_plan,
                  orientation.tables):
        cache.cache_clear()
    junk = [torch.zeros(n, dtype=torch.uint8, device="cuda")
            for n in sizes for _ in range(64)]
    got = call(surf, images)
    torch.cuda.synchronize()
    assert _equal(got, want)
