"""Kernel E (csrc/fivepoint.cu), the five-point solver, against its plain
twin `_five_point_plain`, both on the card.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Kernel E repeats the twin's rounding: it follows each torch operation's
kernel on the card (the reduction trees, nvcc's FMA contraction, cuBLAS's
getrf / getrs blocks, the GEMM and GEMV sums).  cuBLAS picks its kernels by
batch size, so the twin runs at a RANSAC call's shape, (128, 5, 2) a call,
also where the kernel takes two leading dimensions in one launch; there
its candidates are the kernel's bit for bit.  The checks:

  * `valid` equal except on roots within 1 % of the `near_real` test's edge
    (|im| against 1e-2 (1 + |re|)): there a last bit moves a root in or out;
  * every candidate valid on both sides equal up to sign at 1e-4 of its
    unit norm, the float32 digits that the Gauss-Newton polish leaves;
  * on the 64 draws of golden_terrain_track.npz, the winning candidate and
    the best score of RANSAC's scoring equal the twin's: 7-20 candidates tie
    at the best score and the first of them wins, so a winner that moved
    would show a rounding the kernel does not share (ROADMAP Queue 3,
    "RANSAC ties");
  * one launch a call and no host synchronisation (torch's sync debug mode
    set to raise).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import Intrinsics, Surf, SurfConfig, _build
from cuda_surf_tpu_torch.config import MAIN_CONFIG
from cuda_surf_tpu_torch.geometry import epipolar as tep
from cuda_surf_tpu_torch.geometry import fivepoint as tfp
from cuda_surf_tpu_torch.slam.tracking import track_inputs
from torch_parity import cuda_device, minimal_problems  # noqa: F401

pytestmark = pytest.mark.cuda

N = 128            # hypotheses of a RANSAC call (track_pair's 5-point)
TRACK_THRESH = 2e-5


def _twin(fn, x1, x2):
    """fn on each (N, 5, 2) block of x1, x2 -> its outputs, each stacked
    back into the inputs' leading shape."""
    outs = [fn(a, b) for a, b in zip(x1.reshape(-1, N, 5, 2),
                                     x2.reshape(-1, N, 5, 2))]
    return [torch.stack(o).reshape(*x1.shape[:-2], *o[0].shape[1:])
            for o in zip(*outs)]


def _root_margin(x1, x2):
    """(..., 20) |im| / (1e-2 (1 + |re|)) of the twin's Durand-Kerner
    roots: `near_real` is margin < 1."""
    M = tfp._constraint_matrix(tfp._nullspace_basis(x1, x2))
    M = M / torch.clamp(torch.amax(torch.abs(M), -1, keepdim=True), min=1e-30)
    z, _ = tfp._dk_complex_roots(tfp._det_bz(*tfp._bz_rows(M)))
    return torch.abs(z.imag) / (1e-2 * (1.0 + torch.abs(z.real)))


def _check_candidates(x1, x2, gn_iters):
    """Kernel E against the twin on one call's inputs."""
    Ek, vk = tfp.five_point(x1, x2, gn_iters=gn_iters)
    Ep, vp = _twin(lambda a, b: tfp._five_point_plain(a, b, gn_iters), x1, x2)
    assert Ek.shape == Ep.shape and vk.shape == vp.shape
    assert vk.dtype == torch.bool and torch.isfinite(Ek).all()
    margin, = _twin(lambda a, b: (_root_margin(a, b),), x1, x2)
    edge = (torch.abs(margin - 1.0) < 0.01).cpu().numpy()
    vk, vp = vk.cpu().numpy(), vp.cpu().numpy()
    assert not ((vk != vp) & ~edge).any()
    Ek, Ep = (a.cpu().numpy().astype(np.float64) for a in (Ek, Ep))
    dist = np.minimum(np.linalg.norm(Ek - Ep, axis=(-2, -1)),
                      np.linalg.norm(Ek + Ep, axis=(-2, -1)))
    both = vk & vp
    assert both.sum() > 0
    assert dist[both].max() <= 1e-4, dist[both].max()


def _winner(x1, x2, good, sample, solve):
    """RANSAC's scoring of one draw (ransac_essential's stages) with the
    solver `solve` -> (winning candidate, best score)."""
    Es, ok = solve(x1[sample], x2[sample], gn_iters=4)
    counts = tep._sampson_inlier_counts(Es.reshape(-1, 3, 3), x1, x2, good,
                                        TRACK_THRESH)
    scores = torch.where(ok.reshape(-1), counts, -1)
    return int(torch.argmax(scores)), int(scores.max())


def test_kernel_e_on_the_track_fixture_draws(cuda_device):
    """The 64 JAX draws of golden_terrain_track.npz on the terrain pair's
    correspondences (1280x960, kernels A, B, C): every draw's candidates,
    and RANSAC's winner and best score, are the twin's."""
    g = np.load(Path(cst.__file__).parent / "data"
                / "golden_terrain_track.npz")
    intr = Intrinsics(*(float(v) for v in g["intrinsics"]))
    surf = Surf(SurfConfig(**MAIN_CONFIG), device=cuda_device)
    (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in g["frames"]]
    _, good, x1, x2 = track_inputs(k1, d1, k2, d2, intr)
    plain = lambda a, b, gn_iters: tfp._five_point_plain(a, b, gn_iters)
    for raw in g["raws"]:
        raw = torch.as_tensor(raw, device=cuda_device)
        sample = tep.sample_rows(good, raw)
        _check_candidates(x1[sample], x2[sample], 4)
        assert _winner(x1, x2, good, sample, tfp.five_point) == \
            _winner(x1, x2, good, sample, plain)


@pytest.mark.parametrize("lead,gn_iters", [((N,), 4), ((N,), 8),
                                           ((2, N), 4), ((2, N), 8)])
def test_kernel_e_on_minimal_problems(cuda_device, lead, gn_iters):
    """Seeded random minimal problems (tests/test_geometry.py's
    generator), with one and two leading dimensions."""
    n = int(np.prod(lead))
    x1, x2, _ = minimal_problems(17 + n + gn_iters, n)
    t = lambda a: torch.as_tensor(a, device=cuda_device).reshape(
        *lead, 5, 2)
    _check_candidates(t(x1), t(x2), gn_iters)


def test_kernel_e_launches_once_without_sync_and_refuses(cuda_device):
    """One launch (the counter and the profiler's device kernels) and no
    host synchronisation a call; float64, a trailing shape other than
    (5, 2) and a non-contiguous input raise."""
    x1, x2, _ = minimal_problems(5, N)
    x1, x2 = (torch.as_tensor(a, device=cuda_device) for a in (x1, x2))
    tfp.five_point(x1, x2, gn_iters=4)         # builds the kernel library
    torch.cuda.synchronize()
    before = _build.launch_counts["surf_fivepoint"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            tfp.five_point(x1, x2, gn_iters=4)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    assert _build.launch_counts["surf_fivepoint"] == before + 1
    kernels = [e.name for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "fivepoint" in kernels[0], kernels
    bad = [(x1.double(), x2.double()),
           (torch.cat([x1, x1[..., :1]], -1),
            torch.cat([x2, x2[..., :1]], -1)),
           (x1.mT.contiguous().mT, x2)]
    for a, b in bad:
        with pytest.raises(ValueError):
            tfp.five_point(a, b)
