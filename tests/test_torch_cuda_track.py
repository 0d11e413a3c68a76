"""The visual-odometry path on the card against the port on the CPU:
`ransac_essential`, `track_pair`, `lm_step` / `run_lm` and `SlamPipeline`.

Every test here is marked `cuda` and skips without a GPU; the file imports
no jax, so it runs on the card's machine with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Both sides get the same inputs and the same RANSAC draw (`raw`, from a
seeded CPU generator).  Torch's CPU and CUDA kernels round the glue
differently in the last bit (keypoint coordinates at 1e-5 relative,
tests/test_torch_cuda.py), so the tolerances are the CPU parity tests':
R within 1e-3 rad, t's direction within 1e-3 rad, `n_inliers` within 1 %
and the inlier masks equal off points within 1 % of the threshold; the BA
state after one step at 1e-5 and `run_lm`'s cost at 1e-4 relative; the
pipeline's world rotations within 0.1 degree and inliers within 2 %.
RANSAC (either solver, drawing or handed its draw), `lm_step` and `run_lm`
put no host synchronisation on the card (torch's sync debug mode set to
raise): the reference's programs have none inside them.
"""

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ba import core as tba
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.geometry import epipolar as tep
from cuda_surf_tpu_torch.io.synth import (TERRAIN_VO, ba_problem,
                                          render_terrain_sequence)
from cuda_surf_tpu_torch.slam import SlamPipeline, track_pair
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda

CPU = torch.device("cpu")


def _rotmat(axis, angle):
    axis = np.asarray(axis, np.float64)
    axis = axis / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]],
                  [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def _synthetic_pair(seed, n=200, noise=1e-4, outliers=0.3):
    rng = np.random.default_rng(seed)
    R = _rotmat([0.2, 1.0, 0.1], 0.15)
    t = np.array([1.0, 0.1, 0.2])
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    x1 = X[:, :2] / X[:, 2:] + rng.normal(0, noise, (n, 2))
    Xc2 = X @ R.T + t
    x2 = Xc2[:, :2] / Xc2[:, 2:] + rng.normal(0, noise, (n, 2))
    x2[:int(n * outliers)] = rng.uniform(-0.5, 0.5, (int(n * outliers), 2))
    return x1.astype(np.float32), x2.astype(np.float32)


def _raw(n_hypotheses, n_pts, seed=0):
    return tep.draw_raw(n_hypotheses, n_pts, CPU,
                        torch.Generator().manual_seed(seed))


def _angle(Ra, Rb):
    Ra, Rb = (np.asarray(a.cpu(), np.float64) for a in (Ra, Rb))
    return float(np.arccos(np.clip((np.trace(Ra @ Rb.T) - 1) / 2, -1, 1)))


def _same_geometry(card, cpu, x1, x2, thresh):
    assert _angle(card.R, cpu.R) < 1e-3
    tc, tp = (np.asarray(a.t.cpu(), np.float64) for a in (card, cpu))
    assert np.arccos(np.clip(tc @ tp / np.linalg.norm(tc)
                             / np.linalg.norm(tp), -1, 1)) < 1e-3
    nc, n_cpu = int(card.n_inliers), int(cpu.n_inliers)
    assert abs(nc - n_cpu) <= 0.01 * n_cpu, (nc, n_cpu)
    t, R = cpu.t, cpu.R
    z = torch.zeros_like(t[0])
    E = torch.stack([torch.stack([z, -t[2], t[1]]),
                     torch.stack([t[2], z, -t[0]]),
                     torch.stack([-t[1], t[0], z])]) @ R
    err = tep.sampson_error(E, x1.cpu(), x2.cpu()).numpy()
    edge = np.abs(err - thresh) < 0.01 * thresh
    differ = card.inliers.cpu().numpy() != cpu.inliers.numpy()
    assert not (differ & ~edge).any()


@pytest.mark.parametrize("solver,n_hyp", [("8pt", 256), ("5pt", 128)])
def test_ransac_essential_card_matches_cpu(cuda_device, solver, n_hyp):
    x1, x2 = _synthetic_pair(5)
    valid = np.ones(len(x1), bool)
    valid[-7:] = False
    raw = _raw(n_hyp, 8 if solver == "8pt" else 5)
    cpu, card = (tep.ransac_essential(
        *(torch.as_tensor(v, device=dev) for v in (x1, x2, valid)),
        n_hypotheses=n_hyp, solver=solver, raw=raw.to(dev))
        for dev in (CPU, cuda_device))
    assert card.R.device.type == card.inliers.device.type == cuda_device.type
    _same_geometry(card, cpu, torch.as_tensor(x1), torch.as_tensor(x2), 1e-4)
    assert int(card.n_inliers) > 0.6 * len(x1)


def test_track_pair_card_matches_cpu(cuda_device):
    frames, _, intr = render_terrain_sequence(**TERRAIN_VO, first=2)
    raw = _raw(128, 5, seed=1)

    def run(dev):
        surf = cst.Surf(cst.SurfConfig(**VO_CONFIG), device=dev)
        (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in frames]
        return k1, track_pair(k1, d1, k2, d2, intr, raw=raw.to(dev))

    (k1_cpu, cpu), (k1, card) = run(CPU), run(cuda_device)
    assert int(k1.count) == int(k1_cpu.count)
    x = lambda kx, ky: tep.normalize_with_intrinsics(
        torch.stack([kx, ky], -1).cpu(), *intr[:2], *intr[2:])
    _same_geometry(card, cpu, x(k1_cpu.x, k1_cpu.y),
                   x(cpu.matches.match_x, cpu.matches.match_y), 2e-5)
    assert int(card.n_inliers) > 60


def test_lm_step_and_run_lm_card_match_cpu(cuda_device):
    (ci, uv, mask), (R, t, X) = ba_problem()

    def run(dev):
        prob = tba.problem_from_numpy(ci, uv, mask, dev)
        state = tba.state_from_numpy(R, t, X, dev)
        step = tba.lm_step(state, prob, 1e-3, R.shape[0])
        _, c10 = tba.run_lm(state, prob, n_iters=10)
        return ([a.cpu().numpy() for a in step], float(tba.cost(step, prob)),
                float(c10))

    (sp, cp, lp), (sc, cc, lc) = run(CPU), run(cuda_device)
    for a, b in zip(sc, sp):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=1e-5 * np.abs(b).max())
    np.testing.assert_allclose(cc, cp, rtol=1e-4)
    np.testing.assert_allclose(lc, lp, rtol=1e-4)


def test_pipeline_card_matches_cpu(cuda_device):
    frames, centres, intr = render_terrain_sequence(**TERRAIN_VO, first=5)
    raws = [_raw(128, 5, seed=s) for s in range(len(frames))]

    def run(dev):
        pipe = SlamPipeline(cst.SurfConfig(**VO_CONFIG), intrinsics=intr,
                            window_ba=4, device=dev)
        for f, raw in zip(frames, raws):
            pipe.process(f, raw=raw.to(dev))
        return pipe.frames

    cpu, card = run(CPU), run(cuda_device)
    for fc, fp in zip(card, cpu):
        assert np.degrees(_angle(torch.as_tensor(fc.R),
                                 torch.as_tensor(fp.R))) < 0.1
        assert abs(fc.n_inliers - fp.n_inliers) <= 0.02 * fp.n_inliers
    assert all(f.n_inliers > 60 for f in card[1:])


def test_no_host_sync(cuda_device):
    x1, x2 = (torch.as_tensor(a, device=cuda_device)
              for a in _synthetic_pair(6))
    valid = torch.ones(x1.shape[0], dtype=torch.bool, device=cuda_device)
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    (ci, uv, mask), (R, t, X) = ba_problem()
    prob = tba.problem_from_numpy(ci, uv, mask, cuda_device)
    state = tba.state_from_numpy(R, t, X, cuda_device)
    raws = {s: _raw(128, n).to(cuda_device) for s, n in (("5pt", 5),
                                                          ("8pt", 8))}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for solver, raw in raws.items():
            for kw in (dict(generator=gen), dict(raw=raw)):
                tep.ransac_essential(x1, x2, valid, n_hypotheses=128,
                                     solver=solver, **kw)
        tba.lm_step(state, prob, 1e-3, R.shape[0])
        tba.run_lm(state, prob, n_iters=3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
