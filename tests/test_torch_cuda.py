"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Every test here is marked `cuda` and skips without a GPU.  The file
imports no jax (the machine with the card has none), so it runs there
on its own, without tests/conftest.py, which imports jax:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Tolerances: kernel A bit-exact (its determinant avoids FMA
contraction), one launch for all octaves, on one frame or on a stack of
frames, whose frames equal the single-frame launch's; kernel B, in each of its four modes (upright / rotated x
64 / 128-d), row cosine >= 0.99999 and bit-identical across launches
(fixed-order reduction); kernel C, at D = 64 and 128, scores within
1e-5, indices equal wherever best - second >= 1e-5, exact ties to the
smaller index (its two product engines, the pair dimension and the splits:
tests/test_torch_cuda_matcher.py); kernel D orientations within 1e-4 rad
wherever the top-two window gap is >= 1e-5 relative, one of the two top
windows below that, and bit-identical across launches (its in-kernel
geometry: tests/test_torch_cuda_orient.py).  Kernel B on stacked frames:
rows equal bit for bit to the single-frame kernel's on each frame, and the
twin with the frame offset at row cosine >= 0.99999.  The static-step
kernel: the taken mask equal to the twin's and rows equal bit for bit to
kernel B's.  Doubled mode: kernel A bit-exact, B and D at the tolerances
above, on the 2x upsampled integral image.
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
from cuda_surf_tpu_torch.ops import patch_wavelets as tpw
from cuda_surf_tpu_torch.ops.patch_wavelets import (descriptor_rows,
                                                    single_rows, stacked_rows,
                                                    step_rows,
                                                    step_rows_plain)
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
    before = tfd.fused_pyramid.launches
    pyr_k, masks_k = tfd.fused_pyramid(ii, cfg, h, w)
    torch.cuda.synchronize()
    assert tfd.fused_pyramid.launches == before + 1   # every octave at once
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


# set 2 in 2, 4, 1 and 3 splits per row block
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
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_best2(d.float()[:, :48].contiguous(),
                    d.float()[:, :48].contiguous(), v)
    with pytest.raises(ValueError, match="shapes disagree"):
        fused_best2(d.float()[None], d.float()[None], v)
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


def _stack_scene(device, upright):
    """Three 120x160 frames and 21 keypoints per frame, some at the top and
    bottom edges (their windows would reach into the next frame's rows)."""
    rng = np.random.default_rng(9)
    imgs = rng.integers(0, 256, (3, 120, 160), np.uint8)
    ii = torch.stack([integral_image(torch.as_tensor(f, device=device))
                      for f in imgs])
    ys = [0.4, 3.2, 9.0, 60.5, 111.3, 117.6, 119.9]
    xs = [5.5, 80.2, 155.1]
    y, x = (a.ravel().astype(np.float32)
            for a in np.meshgrid(ys, xs, indexing="ij"))
    scale = np.resize(np.float32([2.0, 3.5, 6.0, 9.0]), y.shape)
    ori = rng.uniform(-3, 3, y.shape).astype(np.float32)
    cfg = cst.SurfConfig(noctaves=4, upright=upright, max_pts=y.size)
    t = lambda a: torch.as_tensor(a, device=device).repeat(3)
    geom = desc_geometry(cfg, t(x), t(y), t(scale), t(ori))
    K = y.size
    frame = torch.arange(3, dtype=torch.int32,
                         device=device).repeat_interleave(K)
    valid = torch.ones(3 * K, dtype=torch.bool, device=device)
    valid[5] = False
    return cfg, ii, geom, valid, frame, K


@pytest.mark.parametrize("upright", [True, False], ids=["upright", "rotated"])
def test_stacked_kernel_b_matches_twin_and_single_frame_rows(cuda_device,
                                                             upright):
    cfg, ii, geom, valid, frame, K = _stack_scene(cuda_device, upright)
    before = stacked_rows.launches
    rows = descriptor_rows(ii, cfg, *geom, valid, frame=frame)
    torch.cuda.synchronize()
    assert stacked_rows.launches == before + 1
    assert torch.equal(rows, stacked_rows(ii, cfg, *geom, valid, frame=frame))
    twin = describe_plain(ii, cfg, *geom, valid, frame=frame)
    live = (twin.abs().sum(1) > 0).cpu().numpy()
    assert live.sum() > 2 * K and not rows[5].any()
    assert row_cosines(rows.cpu().numpy()[live],
                       twin.cpu().numpy()[live]).min() >= 0.99999
    assert not rows.cpu().numpy()[~live].any()
    for f in range(3):
        sl = slice(f * K, (f + 1) * K)
        own = single_rows(ii[f], cfg, *[g if g is None else g[sl]
                                        for g in geom], valid[sl])
        assert torch.equal(rows[sl], own), f
    # a frame index outside the stack is masked, never read
    bad = frame.clone()
    bad[:K], bad[K:2 * K] = -1, 3
    out = stacked_rows(ii, cfg, *geom, valid, frame=bad)
    torch.cuda.synchronize()
    assert not out[:2 * K].any() and torch.equal(out[2 * K:], rows[2 * K:])


@pytest.mark.parametrize("mode", [dict(), dict(upright=False),
                                  dict(extended=True)],
                         ids=["upright64", "rotated64", "upright128"])
def test_step_kernel_matches_twin_and_kernel_b(cuda_device, mode):
    """tests/test_torch_stepdec.py's scene: steps 4..9 at interior and
    border positions."""
    img = np.random.default_rng(0).integers(0, 256, (360, 520), np.uint8)
    scales = [4.5, 5.6, 6.8, 8.0, 9.2, 10.4, 11.0] * 2
    xs = [60.3, 250.0, 510.5, 30.2, 400.8, 200.1, 8.0] * 2
    ys = [55.7, 180.4, 300.9, 352.5, 12.3, 150.6, 355.0] * 2
    t = lambda a: torch.as_tensor(np.float32(a), device=cuda_device)
    cfg = cst.SurfConfig(noctaves=4, max_pts=14, **mode)
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    ori = t(np.random.default_rng(3).uniform(-3, 3, 14))
    geom = desc_geometry(cfg, t(xs), t(ys), t(scales), ori)
    v = torch.ones(14, dtype=torch.bool, device=cuda_device)
    v[-1] = False
    ref = single_rows(ii, cfg, *geom, v)
    n_taken = 0
    for sd in tpw.STEP_KERNELS:
        before = step_rows.launches
        rows, taken = step_rows(ii, cfg, *geom, v, elig=v, sd=sd)
        rows_p, taken_p = step_rows_plain(ii, cfg, *geom, v, elig=v, sd=sd)
        torch.cuda.synchronize()
        assert step_rows.launches == before + 1
        assert torch.equal(taken, taken_p)
        assert torch.equal(rows[taken], ref[taken]) and not rows[~taken].any()
        assert torch.equal(rows, step_rows(ii, cfg, *geom, v, elig=v,
                                           sd=sd)[0])
        tk = taken.cpu().numpy()
        if tk.any():
            assert row_cosines(rows.cpu().numpy()[tk],
                               rows_p.cpu().numpy()[tk]).min() >= 0.99999
        n_taken += int(tk.sum())
    assert n_taken >= 9
    # a cap below the eligible count: the first in order, the rest untaken
    same = desc_geometry(cfg, t(xs), t(ys), torch.full_like(t(scales), 6.8),
                         ori)
    rows, taken = step_rows(ii, cfg, *same, v, elig=v, sd=6, cap=5)
    assert taken.cpu().tolist() == [True] * 5 + [False] * 9
    assert torch.equal(rows[:5], single_rows(ii, cfg, *same, v)[:5])
    assert not rows[5:].any()
    # the whole route returns kernel B's rows
    tpw.DEC_STEPS = tpw.STEP_KERNELS
    try:
        routed = descriptor_rows(ii, cfg, *geom, v)
    finally:
        tpw.DEC_STEPS = ()
    assert torch.equal(routed, ref)
    with pytest.raises(ValueError, match="no kernel for step"):
        step_rows(ii, cfg, *geom, v, elig=v, sd=3)


def test_doubled_kernels_match_twins(cuda_device):
    img = render_plane_sequence(1, 240, 320, seed=0, motion=0.02)[0][0]
    cfg = cst.SurfConfig(noctaves=4, doubled=True, upright=False,
                         max_pts=512, candidates_per_octave=512)
    h, w = img.shape
    ii = integral_image(torch.as_tensor(img, device=cuda_device), True)
    assert tuple(ii.shape) == (2 * h, 2 * w)
    scheds = cfg.hessian_schedule(h, w)
    pyr_k, masks_k = tfd.fused_pyramid(ii, cfg, h, w)
    for o, p in enumerate(response_pyramid(ii, cfg, h, w)):
        assert torch.equal(pyr_k[o], p), o
        assert torch.equal(masks_k[o], _candidate_mask(p, scheds[o], cfg)), o
    k, _ = cst.detect_and_compute(torch.as_tensor(img, device=cuda_device),
                                  cfg, compute_descriptors=False)
    kp = (k.x, k.y, k.scale, k.valid)
    valid = k.valid.cpu().numpy()
    assert valid.sum() > 100
    ori = assign_orientations(ii, cfg, *kp)
    ws, wa = orientation_windows(ii, *kp, doubled=True)
    check_orientations(assign_orientations_plain(ii, cfg, *kp), ori, ws, wa,
                       valid)
    geom = desc_geometry(cfg, k.x, k.y, k.scale, ori)
    rows_k = descriptor_rows(ii, cfg, *geom, k.valid)
    rows_p = describe_plain(ii, cfg, *geom, k.valid)
    torch.cuda.synchronize()
    assert row_cosines(rows_k.cpu().numpy()[valid],
                       rows_p.cpu().numpy()[valid]).min() >= 0.99999


def test_batch_on_card_matches_single_frames_on_card(cuda_device):
    frames = render_plane_sequence(3, 240, 320, seed=0, motion=0.02)[0]
    cfg = cst.SurfConfig(max_pts=512, candidates_per_octave=512)
    surf = cst.Surf(cfg, device="cuda")
    kb, db = surf.detect_and_compute_batch(frames)
    ks, ds = cst.BatchSurf(cfg, device="cuda").detect_and_compute(frames)
    torch.cuda.synchronize()
    assert db.shape == (3, 512, 64) and kb.count.tolist() == ks.count.tolist()
    for f in range(3):
        n = int(kb.count[f])
        assert n > 50
        for name in ("x", "y", "scale", "strength", "laplace", "octave"):
            assert torch.equal(getattr(kb, name)[f, :n],
                               getattr(ks, name)[f, :n]), name
            assert not getattr(kb, name)[f, n:].any(), name
        assert torch.equal(db[f], ds[f])


def test_kernel_a_on_a_stack_equals_per_frame(cuda_device):
    """One launch on a (B, ih, iw) stack: every frame's layers and masks
    equal the single-frame launch's and the twins', bit for bit."""
    frames = render_plane_sequence(3, 240, 320, seed=0, motion=0.02)[0]
    cfg = cst.SurfConfig(noctaves=4)
    h, w = frames[0].shape
    ii = torch.stack([integral_image(torch.as_tensor(f, device=cuda_device))
                      for f in frames])
    scheds = cfg.hessian_schedule(h, w)
    before = tfd.fused_pyramid.launches
    pyr_b, masks_b = tfd.fused_pyramid(ii, cfg, h, w)
    torch.cuda.synchronize()
    assert tfd.fused_pyramid.launches == before + 1
    for f in range(3):
        pyr_1, masks_1 = tfd.fused_pyramid(ii[f], cfg, h, w)
        for o, p in enumerate(response_pyramid(ii[f], cfg, h, w)):
            assert pyr_b[o].shape == (3, *p.shape)
            assert torch.equal(pyr_b[o][f], p), (f, o)
            assert torch.equal(pyr_b[o][f], pyr_1[o]), (f, o)
            assert torch.equal(masks_b[o][f],
                               _candidate_mask(p, scheds[o], cfg)), (f, o)
            assert torch.equal(masks_b[o][f], masks_1[o]), (f, o)
        assert sum(int(m[f].sum()) for m in masks_b) > 10


@pytest.mark.parametrize("mode", [dict(), dict(upright=False),
                                  dict(extended=True),
                                  dict(upright=False, extended=True)],
                         ids=["upright64", "rotated64", "upright128",
                              "rotated128"])
def test_describe_kernels_agree_bit_for_bit(cuda_device, mode):
    """Kernel B, kernel B on a stack and the static-step kernel are one
    body: the same keypoint gets the same row from each, and a second
    launch of each repeats the first."""
    img = np.random.default_rng(0).integers(0, 256, (360, 520), np.uint8)
    scales = [4.5, 5.6, 6.8, 8.0, 9.2, 10.4, 11.0, 2.1, 3.3, 14.0] * 2
    xs = [60.3, 250.0, 510.5, 30.2, 400.8, 200.1, 8.0, 100.9, 333.3, 260.0] * 2
    ys = [55.7, 180.4, 300.9, 352.5, 12.3, 150.6, 355.0, 99.1, 250.2, 180.0] * 2
    K = len(xs)
    t = lambda a: torch.as_tensor(np.float32(a), device=cuda_device)
    cfg = cst.SurfConfig(noctaves=4, max_pts=K, **mode)
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    ori = t(np.random.default_rng(3).uniform(-3, 3, K))
    geom = desc_geometry(cfg, t(xs), t(ys), t(scales), ori)
    v = torch.ones(K, dtype=torch.bool, device=cuda_device)
    v[-1] = False
    ref = single_rows(ii, cfg, *geom, v)
    assert torch.equal(ref, single_rows(ii, cfg, *geom, v))
    assert int((ref.abs().sum(1) > 0).sum()) >= K - 3 and not ref[-1].any()
    # the same frame twice in a stack, the keypoints in the second copy
    stack = torch.stack([ii, ii])
    frame = torch.ones(K, dtype=torch.int32, device=cuda_device)
    rows_s = stacked_rows(stack, cfg, *geom, v, frame=frame)
    assert torch.equal(rows_s, ref)
    assert torch.equal(rows_s, stacked_rows(stack, cfg, *geom, v, frame=frame))
    n_taken = 0
    for sd in tpw.STEP_KERNELS:
        rows, taken = step_rows(ii, cfg, *geom, v, elig=v, sd=sd)
        assert torch.equal(rows[taken], ref[taken]), sd
        assert torch.equal(rows, step_rows(ii, cfg, *geom, v, elig=v,
                                           sd=sd)[0]), sd
        n_taken += int(taken.sum())
    assert n_taken >= 10
