"""The port's data-parallel `BatchSurf(mesh=)` at a world of 2 against the
JAX package's `BatchSurf(mesh=make_mesh(2))`, and against the port's own
single-device `BatchSurf`.

Frames: 4 rendered plane frames at 120x160 (`io.synth.render_plane_sequence`,
seed 3), so each rank describes 2; config tests/test_parallel.py's
(noctaves=2, max_pts=256, candidates_per_octave=512).  The port's ranks
are gloo processes on the CPU (tests/torch_multidevice_worker.py); each
describes its own frames and all-gathers the batch.

Tolerances: against JAX, the port's standing frontend ones: keypoint sets
equal (counts, validity, octave and Laplacian sign; x / y / scale /
strength at 1e-5 relative: `torch_parity.assert_keypoints_match`),
descriptor rows at cosine >= 0.99999 (a ring-edge keypoint,
`torch_parity.ring_edge_keypoints`, at 0.9999); against the port's
single-device `BatchSurf`, every field and every descriptor exactly (the
same stacked pipeline on the same values); the two ranks' gathered
batches and matches bit-equal.

A sequence as the mesh serves it (`detect_and_compute`, then
`match_sequence`) at worlds 2 and 4: bit for bit the single-device
`detect_and_compute_batch` + `match_keypoints` of the whole batch on every
rank, within the standing frontend tolerances of the benchmark's plain
reference (`portbench/reference/surfref`; matches: validity and index
equal, score at 1e-5), in at most 3 all-gathers whose host events all lie
in the `mesh.all_gather` span.
"""

import json

import numpy as np
import pytest
import torch

import cuda_surf_tpu as jst
from cuda_surf_tpu.parallel import BatchSurf as JaxBatchSurf
from cuda_surf_tpu.parallel import make_mesh as jax_make_mesh

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.io.synth import render_plane_sequence
from cuda_surf_tpu_torch.ops.matcher import match_keypoints
from cuda_surf_tpu_torch.parallel import Mesh, make_mesh
from cuda_surf_tpu_torch.types import Keypoints, Matches
from portbench.reference import surfref
from torch_parity import (assert_keypoints_match, assert_ranks_equal,
                          one_torch_thread, ring_edge_keypoints,  # noqa: F401
                          row_cosines, run_ranks)

KW = dict(noctaves=2, max_pts=256, candidates_per_octave=512)
FIELDS = Keypoints._fields


def _frames(n=4):
    return render_plane_sequence(n_frames=n, h=120, w=160, seed=3)[0]


def _frame(kps, i):
    return Keypoints(*[np.asarray(getattr(kps, f))[i] for f in FIELDS])


def test_mesh_batch_matches_jax_and_single_device(tmp_path):
    frames = _frames()
    ranks = run_ranks("batch", 2, tmp_path, dict(
        frames=frames, cfg=np.str_(json.dumps(KW))))
    keys = [f"kp_{f}" for f in FIELDS] + ["descs", "match_score",
                                          "match_index"]
    assert_ranks_equal(ranks, keys)
    got = ranks[0]
    gk = Keypoints(*[got[f"kp_{f}"] for f in FIELDS])

    single = cst.BatchSurf(cst.SurfConfig(**KW), device="cpu")
    sk, sd = single.detect_and_compute(frames)
    for f in FIELDS:
        np.testing.assert_array_equal(gk._asdict()[f],
                                      getattr(sk, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(got["descs"], sd.numpy())

    cfg = jst.SurfConfig(**KW)
    jk, jd = JaxBatchSurf(cfg, mesh=jax_make_mesh(2)).detect_and_compute(
        frames)
    n_edge = 0
    for i in range(len(frames)):
        n = assert_keypoints_match(_frame(jk, i), _frame(gk, i))
        assert n > 20
        edge = ring_edge_keypoints(
            single.cfg, (frames.shape[1] + 1, frames.shape[2] + 1),
            gk.x[i], gk.y[i], gk.scale[i], gk.ori[i], gk.valid[i])
        n_edge += int(edge.sum())
        v = gk.valid[i]
        cos = row_cosines(got["descs"][i][v], np.asarray(jd[i])[v])
        assert cos[~edge[v]].min(initial=1) >= 0.99999
        assert cos[edge[v]].min(initial=1) >= 0.9999
    assert n_edge <= 2              # the rule exempts few


def test_batch_must_divide_and_world_of_one_is_single_device():
    frames = _frames()
    cfg = cst.SurfConfig(**KW)
    two = Mesh("frames", 2, 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="batch 3 not divisible by mesh "
                       "size 2"):
        cst.BatchSurf(cfg, "cpu", mesh=two).detect_and_compute(frames[:3])
    with pytest.raises(ValueError, match="the mesh's device"):
        cst.BatchSurf(cfg, "cpu", mesh=Mesh("frames", 1, 0,
                                            torch.device("meta")))
    one = cst.BatchSurf(cfg, "cpu", mesh=make_mesh(devices="cpu"))
    k1, d1 = one.detect_and_compute(frames[:2])
    k0, d0 = cst.BatchSurf(cfg, "cpu").detect_and_compute(frames[:2])
    assert all(torch.equal(a, b) for a, b in zip(k1, k0))
    assert torch.equal(d1, d0)


@pytest.mark.parametrize("world,n", [(2, 8), (4, 4)])
def test_mesh_sequence_is_the_stacked_batch(world, n, tmp_path):
    """k = n / world frames a rank: 4 (pairs 3 -> 4 cross the ranks) and 1
    (every pair crosses; the last rank's own pair is padding)."""
    frames = _frames(n)
    ranks = run_ranks("sequence", world, tmp_path, dict(
        frames=frames, cfg=np.str_(json.dumps(KW))))
    keys = [k for k in ranks[0] if k.startswith(("kp_", "match_", "descs"))]
    assert_ranks_equal(ranks, keys)
    got = ranks[0]
    cfg = cst.SurfConfig(**KW)
    kb, db = cst.Surf(cfg, device="cpu").detect_and_compute_batch(frames)
    sub = lambda sl: Keypoints(*[f[sl] for f in kb])
    mb = match_keypoints(sub(slice(0, -1)), db[:-1], sub(slice(1, None)),
                         db[1:])
    for f in FIELDS:
        np.testing.assert_array_equal(got[f"kp_{f}"], getattr(kb, f).numpy(),
                                      err_msg=f)
    for f in Matches._fields:
        np.testing.assert_array_equal(got[f"match_{f}"],
                                      getattr(mb, f).numpy(), err_msg=f)
    np.testing.assert_array_equal(got["descs"], db.numpy())

    k, N = n // world, KW["max_pts"]
    words = k * (8 * N + 1) + k * N * 64 + k * 6 * N     # a rank's share
    for res in ranks:
        assert int(res["all_gathers"]) == 3
        assert int(res["all_gather_bytes"]) == 4 * (world - 1) * words
        spans = set(res["gather_spans"].tolist())
        assert spans == {"mesh.all_gather"}, spans

    ref = surfref.Surf(surfref.SurfConfig(**KW), device="cpu")
    refs = [ref.detect_and_compute(f) for f in frames]
    for i, (kr, dr) in enumerate(refs):
        assert assert_keypoints_match(kr, _frame(Keypoints(*[
            got[f"kp_{f}"] for f in FIELDS]), i)) > 20
        v = got["kp_valid"][i]
        assert row_cosines(got["descs"][i][v],
                           dr.numpy()[v]).min() >= 0.99999
        if i + 1 < n:
            mr = ref.match(kr, dr, *refs[i + 1])
            ok = mr.valid.numpy()
            np.testing.assert_array_equal(got["match_valid"][i], ok)
            np.testing.assert_array_equal(got["match_index"][i][ok],
                                          mr.index.numpy()[ok])
            np.testing.assert_allclose(got["match_score"][i][ok],
                                       mr.score.numpy()[ok], atol=1e-5)
