"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked `cuda` and skips without a GPU.  The file
imports no jax (the machine with the card has none), so it runs there
on its own, without tests/conftest.py, which imports jax:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: kernel A bit-exact (its determinant avoids FMA
contraction); kernel B, in each of its four modes (upright / rotated x
64 / 128-d), row cosine >= 0.99999 and bit-identical across launches
(fixed-order reduction); kernel C, at D = 64 and 128, scores within
1e-5, indices equal wherever best - second >= 1e-5, exact ties to the
smaller index; kernel D orientations within 1e-4 rad wherever the
top-two window gap is >= 1e-5 relative, one of the two top windows below
that, and bit-identical across launches.
"""

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.io import render_plane_sequence
from cuda_surf_tpu_torch.ops import fused_detect as tfd
from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, describe_plain
from cuda_surf_tpu_torch.ops.extrema import _candidate_mask
from cuda_surf_tpu_torch.ops.hessian import response_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orientation_windows)
from cuda_surf_tpu_torch.ops.patch_wavelets import descriptor_rows
from torch_parity import (assert_keypoints_match, check_orientations,
                          cuda_device, describe_scene,  # noqa: F401
                          kron_image, match_sets, row_cosines, unit_rows)

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("source", ["kron", "plane"])
def test_kernel_a_matches_twin(cuda_device, source):
    img = (kron_image() if source == "kron"
           else render_plane_sequence(1, 480, 640, seed=3)[0][0])
    cfg = cst.SurfConfig(noctaves=4)
    h, w = img.shape
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    scheds = cfg.hessian_schedule(h, w)
    before = tfd.fused_octave.launches
    pyr_k, masks_k = tfd.fused_pyramid(ii, cfg, h, w)
    torch.cuda.synchronize()
    assert tfd.fused_octave.launches == before + cfg.noctaves
    n_cand = 0
    for o, p in enumerate(response_pyramid(ii, cfg, h, w)):
        assert torch.equal(pyr_k[o], p), o
        assert torch.equal(masks_k[o], _candidate_mask(p, scheds[o], cfg)), o
        n_cand += int(masks_k[o].sum())
    assert n_cand > 10


@pytest.mark.parametrize("mode", [dict(), dict(upright=False),
                                  dict(extended=True),
                                  dict(upright=False, extended=True)],
                         ids=["upright64", "rotated64", "upright128",
                              "rotated128"])
def test_kernel_b_matches_twin(cuda_device, mode):
    img, x, y, scale, valid = describe_scene()
    cfg = cst.SurfConfig(noctaves=4, max_pts=x.size, **mode)
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    ori = np.random.default_rng(4).uniform(-np.pi, np.pi, x.shape)
    geom = desc_geometry(cfg, *(torch.as_tensor(a, device=cuda_device)
                                for a in (x, y, scale,
                                          ori.astype(np.float32))))
    v = torch.as_tensor(valid, device=cuda_device)
    rows_k = descriptor_rows(ii, cfg, *geom, v)
    rows_p = describe_plain(ii, cfg, *geom, v)
    torch.cuda.synchronize()
    a, b = rows_k.cpu().numpy(), rows_p.cpu().numpy()
    assert a.shape == (x.size, cfg.nfeatures)
    assert (a[~valid] == 0).all()
    live = np.abs(b).sum(1) > 0
    assert live.sum() >= 15
    assert row_cosines(a[live], b[live]).min() >= 0.99999
    # deterministic reduction: a second launch repeats bit for bit
    assert torch.equal(rows_k, descriptor_rows(ii, cfg, *geom, v))


@pytest.mark.parametrize("source", ["scene", "kron"])
def test_kernel_d_matches_twin(cuda_device, source):
    cfg = cst.SurfConfig(noctaves=4, upright=False, max_pts=512,
                         candidates_per_octave=512)
    if source == "scene":
        img, *kp = describe_scene()
        kp = [torch.as_tensor(a, device=cuda_device) for a in kp]
    else:
        img = kron_image()
        k, _ = cst.detect_and_compute(torch.as_tensor(img, device=cuda_device),
                                      cfg, compute_descriptors=False)
        kp = [k.x, k.y, k.scale, k.valid]
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    before = assign_orientations.launches
    got = assign_orientations(ii, cfg, *kp)
    again = assign_orientations(ii, cfg, *kp)
    plain = assign_orientations_plain(ii, cfg, *kp)
    ws, wa = orientation_windows(ii, *kp)
    torch.cuda.synchronize()
    assert assign_orientations.launches == before + 2
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    valid = kp[3].cpu().numpy()
    assert valid.sum() >= 20
    assert (got.cpu().numpy()[~valid] == 0).all()
    check_orientations(plain, got, ws, wa, valid)


# set-2 splits per row block: 3, 5, 1, and 4 with the last split empty
@pytest.mark.parametrize("n1,n2", [(100, 130), (4096, 4096), (63, 1),
                                   (4224, 300)])
def test_kernel_c_matches_twin(cuda_device, n1, n2):
    d1, d2, _, valid2 = match_sets()
    if n1 > d1.shape[0]:
        rng = np.random.default_rng(n1 + n2)
        d1 = unit_rows(rng.normal(size=(n1, 64)))
        d2 = unit_rows(rng.normal(size=(n2, 64)))
        d2[1::7] = d2[::7][:d2[1::7].shape[0]]   # exact duplicate columns
        valid2 = rng.random(n2) < 0.9
    d1, d2, valid2 = d1[:n1], d2[:n2], valid2[:n2]
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    bk, sk, ik = fused_best2(t(d1), t(d2), t(valid2))
    bp, sp, ip = _best2_plain(t(d1), t(d2), t(valid2))
    torch.cuda.synchronize()
    assert (bk - bp).abs().max().item() <= 1e-5
    assert (sk - sp).abs().max().item() <= 1e-5
    clear = (bp - sp) >= 1e-5
    assert torch.equal(ik[clear], ip[clear])
    # exact ties inside the kernel: identical columns give identical fp32
    # dot products, so the smaller index must win and second == best
    groups = {}
    for c in np.flatnonzero(valid2):
        groups.setdefault(d2[c].tobytes(), []).append(int(c))
    ik_, bk_, sk_ = ik.cpu().numpy(), bk.cpu().numpy(), sk.cpu().numpy()
    n_ties = 0
    for i, j in enumerate(ik_):
        g = groups.get(d2[j].tobytes(), []) if valid2[j] else []
        if len(g) > 1:
            assert j == g[0] and sk_[i] == bk_[i], (i, j, g)
            n_ties += 1
    if n1 == 100:
        assert n_ties >= 3


def test_kernel_c_matches_twin_at_128(cuda_device):
    rng = np.random.default_rng(128)
    d1 = unit_rows(rng.normal(size=(4096, 128)))
    d2 = unit_rows(rng.normal(size=(4096, 128)))
    d2[1::9] = d2[::9][:d2[1::9].shape[0]]        # exact duplicate columns
    valid2 = rng.random(4096) < 0.9
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    bk, sk, ik = fused_best2(t(d1), t(d2), t(valid2))
    bp, sp, ip = _best2_plain(t(d1), t(d2), t(valid2))
    torch.cuda.synchronize()
    assert (bk - bp).abs().max().item() <= 1e-5
    assert (sk - sp).abs().max().item() <= 1e-5
    clear = (bp - sp) >= 1e-5
    assert clear.sum().item() > 3000
    assert torch.equal(ik[clear], ip[clear])


def test_kernel_c_all_columns_invalid(cuda_device):
    d1, d2, _, _ = match_sets()
    none = torch.zeros(d2.shape[0], dtype=torch.bool, device=cuda_device)
    b, s, i = fused_best2(torch.as_tensor(d1, device=cuda_device),
                          torch.as_tensor(d2, device=cuda_device), none)
    assert (b == -1e30).all() and (s == -1e30).all() and (i == 0).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda_device):
    d = torch.zeros((8, 64), dtype=torch.float64, device=cuda_device)
    v = torch.ones(8, dtype=torch.bool, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        fused_best2(d, d, v)
    ii = torch.zeros((50, 60), dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="int32"):
        tfd.fused_pyramid(ii, cst.SurfConfig(noctaves=1), 49, 59)


def test_slice_on_card_matches_slice_on_cpu(cuda_device):
    """Surf on the card (the three kernels) against Surf on the CPU (the
    twins) on a rendered pair: the same keypoint set, coordinates at 1e-5
    relative (torch's CPU and CUDA elementwise ops may round the subpixel
    fit's last bit differently), descriptors at cosine >= 0.99999,
    matches equal wherever best - second >= 1e-5."""
    pair = render_plane_sequence(2, 240, 320, seed=0, motion=0.02)[0]
    cfg = cst.SurfConfig(max_pts=512, candidates_per_octave=512)
    out = {}
    for dev in ("cpu", "cuda"):
        surf = cst.Surf(cfg, device=dev)
        (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in pair]
        out[dev] = (k1, d1, k2, d2, surf.match(k1, d1, k2, d2))
    for f in (0, 2):
        kc, kg = out["cpu"][f], out["cuda"][f]
        assert assert_keypoints_match(kc, kg) > 50
        v = kc.valid.numpy()
        assert row_cosines(out["cpu"][f + 1].numpy()[v],
                           out["cuda"][f + 1].cpu().numpy()[v]).min() >= 0.99999
    mc, mg = out["cpu"][4], out["cuda"][4]
    assert (mc.score - mg.score.cpu()).abs().max().item() <= 1e-5
    b, s, _ = _best2_plain(out["cpu"][1], out["cpu"][3], out["cpu"][2].valid)
    clear = (b - s) >= 1e-5
    assert torch.equal(mc.index[clear], mg.index.cpu()[clear])


@pytest.mark.parametrize("mode", [dict(upright=False), dict(extended=True)],
                         ids=["rotated", "extended"])
def test_rotated_and_extended_slice_on_card_match_cpu(cuda_device, mode):
    """Surf on the card (kernels A-D) against Surf on the CPU (the twins),
    rotated or extended, on a rendered pair: the same keypoint set;
    orientations as kernel D's test holds them; descriptors at cosine
    >= 0.9999 off the near ties (an orientation a few 1e-7 rad apart
    turns the sample frame); match scores at 2e-5 on rows that neither
    are nor match a near-tie keypoint."""
    pair = render_plane_sequence(2, 240, 320, seed=0, motion=0.02)[0]
    cfg = cst.SurfConfig(max_pts=512, candidates_per_octave=512, **mode)
    out = {}
    for dev in ("cpu", "cuda"):
        surf = cst.Surf(cfg, device=dev)
        (k1, d1), (k2, d2) = [surf.detect_and_compute(f) for f in pair]
        out[dev] = (k1, d1, k2, d2, surf.match(k1, d1, k2, d2))
    near = []
    for f, frame in zip((0, 2), pair):
        kc, kg = out["cpu"][f], out["cuda"][f]
        assert assert_keypoints_match(kc, kg) > 50
        ws, wa = orientation_windows(integral_image(torch.as_tensor(frame)),
                                     kc.x, kc.y, kc.scale, kc.valid)
        nr = check_orientations(kc.ori, kg.ori, ws, wa, kc.valid)
        near.append(nr)
        v = kc.valid.numpy() & ~nr
        dc, dg = out["cpu"][f + 1].numpy(), out["cuda"][f + 1].cpu().numpy()
        assert dg.shape == (512, cfg.nfeatures)
        assert row_cosines(dc[v], dg[v]).min() >= 0.9999
    mc, mg = out["cpu"][4], out["cuda"][4]
    ic, ig = mc.index.numpy(), mg.index.cpu().numpy()
    rows = mc.valid.numpy() & ~near[0] & ~near[1][ic] & ~near[1][ig]
    assert rows.sum() > 50
    assert np.abs(mc.score.numpy() - mg.score.cpu().numpy())[rows].max() <= 2e-5
