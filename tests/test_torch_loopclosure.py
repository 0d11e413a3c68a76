"""The port's LoopDetector on the CPU against the JAX package's
(cuda_surf_tpu/slam/loopclosure.py), on tests/test_loopclosure.py's
out-and-back strip (synthetic keypoints, one descriptor a landmark; its
constants and generator), shortened to 12 frames out and 11 back, on the
JAX detector's own draws: each pair's `raw` is `randint(fold_in(PRNGKey(1),
i * 100003 + j))`, handed to the port through `query(j, raws=)`.  The way
back is shifted by 0.1 along the strip: the JAX test's exact revisits have
a zero baseline, where every translation fits every point and RANSAC's
answer is arbitrary in both packages.

Checked: the signatures (within 1e-6) and the prescreen's candidates equal
to JAX's, so the same pairs are verified in the same order; each pair's
inliers within 2 % of JAX's (or 2 points); the same closures wherever
JAX's inliers lie more than 10 % from `min_inliers`, with the same
inliers; the `max_store` ring evicting the same frames; and, on the port's
own per-pair generators, that a pair's verdict does not depend on the
verifications before it.  A closure's R and t are not compared: on these
short baselines (0.1-0.75 against depths of 5-9) nearly every point is an
inlier of many hypotheses, and which one wins rests on float32 rounding
in both packages (ROADMAP Queue 3, "RANSAC ties"); they are held to be a
rotation and a unit vector.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_surf_tpu.slam.loopclosure import LoopDetector as JaxDetector
from cuda_surf_tpu.types import Keypoints as JaxKeypoints
from test_loopclosure import CAP, N_LMK, VIS
from torch_parity import jax_pair_raw, record_jax_verifications

from cuda_surf_tpu_torch.io.synth import Intrinsics
from cuda_surf_tpu_torch.slam.loopclosure import LoopDetector
from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("x", "y", "scale", "strength", "laplace", "ori", "octave",
          "valid", "count")
DET = dict(min_gap=8, min_inliers=60, prescreen_topk=3)
N_FWD = 12


def _strip_frames(n_fwd, back_shift=0.1):
    """tests/test_loopclosure.py::_make_frames with the way back shifted:
    -> [(fields as numpy, desc)], the same as JAX Keypoints, intrinsics."""
    rng = np.random.default_rng(7)
    X = np.stack([np.linspace(0, 0.25 * n_fwd, N_LMK),
                  rng.uniform(-1.5, 1.5, N_LMK),
                  rng.uniform(5.0, 9.0, N_LMK)], axis=1)
    desc_bank = rng.normal(size=(N_LMK, 64)).astype(np.float32)
    desc_bank /= np.linalg.norm(desc_bank, axis=1, keepdims=True)
    lap_bank = np.where(rng.uniform(size=N_LMK) < 0.5, 1, -1).astype(np.int32)
    intr = Intrinsics(fx=400.0, fy=400.0, cx=320.0, cy=240.0)
    cam_x = [0.25 * k for k in range(n_fwd)]
    cam_x += [x + back_shift for x in cam_x[-2::-1]]
    host = []
    for cx in cam_x:
        vis = np.flatnonzero(np.abs(X[:, 0] - cx) < VIS)[:CAP]
        k = len(vis)
        xc = X[vis] - np.array([cx, 0.0, 0.0])
        f = dict(x=np.zeros(CAP, np.float32), y=np.zeros(CAP, np.float32),
                 scale=np.full(CAP, 2.0, np.float32),
                 strength=np.ones(CAP, np.float32),
                 laplace=np.ones(CAP, np.int32),
                 ori=np.zeros(CAP, np.float32),
                 octave=np.zeros(CAP, np.int32), valid=np.arange(CAP) < k,
                 count=np.asarray(k, np.int32))
        f["x"][:k] = intr.fx * xc[:, 0] / xc[:, 2] + intr.cx
        f["y"][:k] = intr.fy * xc[:, 1] / xc[:, 2] + intr.cy
        f["laplace"][:k] = lap_bank[vis]
        desc = np.zeros((CAP, 64), np.float32)
        desc[:k] = desc_bank[vis]
        host.append((f, desc))
    frames = [(JaxKeypoints(**{k: jnp.asarray(v) for k, v in f.items()}),
               jnp.asarray(d)) for f, d in host]
    return frames, host, intr


@pytest.fixture(scope="module")
def strip():
    return _strip_frames(N_FWD)


@pytest.fixture(scope="module")
def runs(strip):
    """The JAX detector and the port's on the JAX draws, prescreened."""
    frames, host, intr = strip
    return _run_jax(frames, intr, **DET), _run_port(host, intr, **DET)


def _run_jax(frames, intr, **kw):
    det, log, closures = JaxDetector(intr, **kw), [], []
    record_jax_verifications(det, log)
    for kps, desc in frames:
        det.add(kps, desc)
        closures += det.query()
    return det, log, closures


def _run_port(host, intr, jax_draws=True, **kw):
    det, closures = LoopDetector(intr, device="cpu", **kw), []
    for kps, desc in host:
        j = det.add(kps, desc)
        raws = ({i: jax_pair_raw(i, j) for i in det._candidates(j)}
                if jax_draws else None)
        closures += det.query(raws=raws)
    return det, closures


def check_same(jdet, jlog, jcl, pdet, pcl, min_inliers):
    assert jdet.n_verifications == pdet.n_verifications
    assert [v[:2] for v in jlog] == [v[:2] for v in pdet.verified]
    for (i, j, nj), (_, _, nt) in zip(jlog, pdet.verified):
        assert abs(nt - nj) <= max(0.02 * nj, 2), (i, j, nj, nt)
    clear = lambda n: abs(n - min_inliers) > 0.1 * min_inliers
    jset = {(lc.i, lc.j) for lc in jcl if clear(lc.n_inliers)}
    pset = {(lc.i, lc.j) for lc in pcl}
    assert jset <= pset
    assert {(i, j) for i, j, n in jlog if clear(n)} & pset == jset
    for lc in pcl:
        np.testing.assert_allclose(lc.R @ lc.R.T, np.eye(3), atol=1e-5)
        assert abs(np.linalg.norm(lc.t) - 1) < 1e-5
        assert np.isfinite([lc.med_depth, lc.med_depth_j]).all()


def test_signatures_and_candidates_equal_jax(strip):
    frames, host, intr = strip
    jdet, tdet = JaxDetector(intr, **DET), LoopDetector(intr, device="cpu",
                                                       **DET)
    for (kps, desc), (hk, hd) in zip(frames, host):
        jdet.add(kps, desc)
        j = tdet.add(hk, hd)
        np.testing.assert_allclose(tdet._sigs[j], jdet._sigs[j], atol=1e-6)
        assert tdet._candidates(j) == jdet._candidates(j)


def test_detector_matches_jax_on_jax_draws(strip, runs):
    (jdet, jlog, jcl), (pdet, pcl) = runs
    n_queries = len(strip[1]) - DET["min_gap"]
    assert len(jcl) >= 4 and pdet.n_verifications <= 3 * n_queries
    assert all(lc.j - lc.i >= DET["min_gap"] for lc in pcl)
    check_same(jdet, jlog, jcl, pdet, pcl, DET["min_inliers"])


def test_max_store_eviction_matches_jax(strip):
    frames, host, intr = strip
    sub = list(range(6)) + list(range(len(host) - 8, len(host)))
    kw = dict(DET, max_store=10)
    jdet, jlog, jcl = _run_jax([frames[k] for k in sub], intr, **kw)
    pdet, pcl = _run_port([host[k] for k in sub], intr, **kw)
    assert [f is None for f in pdet._frames] == \
        [f is None for f in jdet._frames]
    assert sum(f is None for f in pdet._frames) == len(sub) - 10
    assert pdet.n_verifications > 0
    check_same(jdet, jlog, jcl, pdet, pcl, DET["min_inliers"])
    with pytest.raises(ValueError, match="evicted"):
        pdet.query(0)
    with pytest.raises(ValueError, match="max_store"):
        LoopDetector(intr, max_store=0, device="cpu")


def test_pair_verdicts_do_not_depend_on_order(strip):
    """On the port's own per-pair generators: the last frame's query,
    exhaustive (every candidate, in index order) and prescreened (3, after
    every earlier query ran), gives the same inliers on every pair both
    verify, and the prescreen keeps the strongest closure."""
    _, host, intr = strip
    j = len(host) - 1
    pre = LoopDetector(intr, device="cpu", **DET)
    ex = LoopDetector(intr, device="cpu", **dict(DET, prescreen_topk=None))
    for k, (kps, desc) in enumerate(host):
        pre.add(kps, desc)
        ex.add(kps, desc)
        c_pre = pre.query()
    c_ex = ex.query(j)
    assert ex.n_verifications == j - DET["min_gap"] + 1
    v_ex = {(i, jj): n for i, jj, n in ex.verified}
    for i, jj, n in pre.verified:
        if jj == j:
            assert v_ex[(i, j)] == n
    pairs_pre = {(lc.i, lc.j) for lc in c_pre}
    assert pairs_pre <= {(lc.i, lc.j) for lc in c_ex}
    best = max(c_ex, key=lambda lc: lc.n_inliers)
    assert (best.i, best.j) in pairs_pre
