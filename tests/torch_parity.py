"""Shared helpers of the tests that hold the PyTorch port
(cuda_surf_tpu_torch) against the JAX package on the same inputs."""

import numpy as np
import pytest
import torch


@pytest.fixture
def cuda_device():
    """The card for tests marked `cuda`; skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return torch.device("cuda")


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_keypoints_match(ka, kb, rtol=1e-5):
    """Same keypoint set, slot for slot: counts, validity, octave and
    Laplacian sign equal; x / y / scale / strength within `rtol`
    relative (1e-5 absolute near zero).  The JAX CPU reference contracts
    FMAs in its subpixel fit, the port does not, so the last bits move.
    Either set may be the JAX package's or the port's."""
    assert int(ka.count) == int(kb.count)
    v = _np(ka.valid)
    assert (v == _np(kb.valid)).all()
    for name in ("octave", "laplace"):
        np.testing.assert_array_equal(_np(getattr(ka, name))[v],
                                      _np(getattr(kb, name))[v], err_msg=name)
    for name in ("x", "y", "scale", "strength"):
        np.testing.assert_allclose(_np(getattr(kb, name))[v],
                                   _np(getattr(ka, name))[v],
                                   rtol=rtol, atol=1e-5, err_msg=name)
    return int(v.sum())


def row_cosines(a, b):
    """Per-row cosine of two (K, D) arrays, in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    den = np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
    return (a * b).sum(1) / np.maximum(den, 1e-300)


def kron_image():
    """240x320 blocky texture + noise (the fixture of test_fused_detect.py):
    plenty of extrema at every octave."""
    rng = np.random.default_rng(7)
    base = rng.integers(0, 256, (30, 40), np.uint8)
    up = np.kron(base, np.ones((8, 8), np.uint8))
    noise = rng.integers(0, 32, up.shape).astype(np.uint8)
    return np.clip(up.astype(np.int32) + noise, 0, 255).astype(np.uint8)


def describe_scene():
    """A 200x320 random image and 25 keypoints: five scales from 2.5 to 14
    (patch spans from ~35 to ~200 px), interior and border positions,
    three invalid slots.  -> (img, x, y, scale, valid)."""
    rng = np.random.default_rng(21)
    img = rng.integers(0, 256, (200, 320), np.uint8)
    ys = [30.4, 99.5, 150.2, 12.0, 190.7]
    xs = [40.6, 160.5, 290.3, 8.2, 311.9]
    y, x = (a.ravel() for a in np.meshgrid(ys, xs, indexing="ij"))
    scale = np.resize([2.5, 3.8, 6.0, 9.5, 14.0], y.shape)
    valid = np.ones(y.shape, bool)
    valid[[3, 11, 17]] = False
    f32 = lambda a: np.asarray(a, np.float32)
    return img, f32(x), f32(y), f32(scale), valid


def circ_diff(a, b):
    """|a - b| on the circle, in radians."""
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    return np.abs(np.remainder(d + np.pi, 2 * np.pi) - np.pi)


def check_orientations(ref, got, win_sums, win_asums, valid, tol=1e-4,
                       gap=1e-5):
    """Hold orientations `got` against `ref` on the valid slots, given the
    (K, 72) window sums of one of them: within `tol` rad on the circle
    wherever the top-two window gap is >= `gap` relative; on a near tie
    (gap below that) each may pick either of the two top windows, so each
    must lie within `tol` of one of their angles.  -> near-tie mask."""
    ws, wa = (np.asarray(_np(a), np.float64) for a in (win_sums, win_asums))
    top2 = np.argsort(-ws, axis=1, kind="stable")[:, :2]
    rows = np.arange(ws.shape[0])[:, None]
    best = ws[rows, top2]
    near = (best[:, 0] - best[:, 1]) < gap * np.abs(best[:, 0])
    with np.errstate(invalid="ignore", divide="ignore"):
        cand = wa[rows, top2] / best                  # the two windows' angles
    v = _np(valid).astype(bool)
    ref, got = _np(ref), _np(got)
    clear = v & ~near
    assert circ_diff(ref[clear], got[clear]).max(initial=0) <= tol
    for a in (ref, got):
        d = np.minimum(circ_diff(a, cand[:, 0]), circ_diff(a, cand[:, 1]))
        assert d[v & near].max(initial=0) <= tol
    return v & near


def ring_edge_keypoints(cfg, shape, x, y, scale, ori, valid, ulps=4):
    """Keypoints with a live descriptor sample whose squared radius
    rpos^2 + cpos^2 lies within `ulps` float32 ulps of an integer in
    1..39.  The sample's Gaussian weight is picked by trunc of that
    radius, a step of ~12 % from one ring to the next, so there one
    rounding (an FMA that XLA:CPU contracts in the JAX package's turned
    geometry, none in the port) may move a whole sample to the other
    ring.  Geometry from the port's `desc_geometry` / `sample_frame`.
    -> (K,) bool."""
    from cuda_surf_tpu_torch.ops.descriptor import desc_geometry, sample_frame
    t = lambda a: torch.as_tensor(np.asarray(_np(a)))
    geom = desc_geometry(cfg, t(x), t(y), t(scale), t(ori))
    rpos, cpos, ok, _, _ = sample_frame(cfg, *shape, *geom, t(valid))
    r2 = (rpos * rpos + cpos * cpos).numpy()
    ring = np.round(r2)
    with np.errstate(invalid="ignore"):
        edge = (np.abs(r2 - ring) <= ulps * np.spacing(ring.astype(np.float32))) \
            & (ring >= 1) & (ring <= 39)
    return (edge & ok.numpy()).any(1)


def unit_rows(a):
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


def match_sets():
    """Set 2 with exact duplicate rows (exact score ties: 7/40, 12/77,
    55/101) and invalid rows; set 1 = noisy copies of set-2 rows (the
    first three exact copies of a duplicated row) plus unrelated rows.
    -> (d1 (100, 64), d2 (130, 64), valid1, valid2)."""
    rng = np.random.default_rng(5)
    n1, n2, d = 100, 130, 64
    d2 = unit_rows(rng.normal(size=(n2, d)))
    d2[[40, 77, 101]] = d2[[7, 12, 55]]
    valid2 = np.ones(n2, bool)
    valid2[[3, 90, 91, 129]] = False
    src = rng.integers(0, n2, n1)
    d1 = unit_rows(d2[src] + 0.3 * rng.normal(size=(n1, d)))
    d1[:3] = d2[[7, 12, 55]]
    d1[90:] = unit_rows(rng.normal(size=(10, d)))
    valid1 = np.ones(n1, bool)
    valid1[[5, 50]] = False
    return d1, d2, valid1, valid2


def merge_top2(a, b):
    """Kernel C's merge of two partial top-2s (csrc/match.cu:merge_top2),
    each (best, second, index) of one score row: the larger best wins, the
    smaller index on equal bests, whose tie value becomes second."""
    (b1, s1, i1), (b2, s2, i2) = a, b
    if b2 > b1 or (b2 == b1 and i2 < i1):
        return b2, (b1 if b2 == b1 else max(s2, b1)), i2
    return b1, (b1 if b2 == b1 else max(s1, b2)), i1


def fold_top2(scores, cols):
    """Kernel C's running top-2 of one thread over the score row's columns
    `cols`, visited in increasing order, from (-1e30, -1e30, 0)."""
    neg = np.float32(-1e30)
    best, second, index = neg, neg, 0
    for c in cols:
        v = scores[c]
        second = max(second, min(v, best))
        if v > best:
            best, index = v, int(c)
    return best, second, index


def emulate_kernel_d(ii, x, y, scale, valid, doubled=False):
    """Kernel D (csrc/orient.cu) in numpy, keypoint by keypoint, following
    the kernel's plan: the 253 disc positions of its table in 8 rounds of 32
    lanes; a sample's rank in its bin is the bin's count before the round
    plus the lower lanes of the round in the same bin; an exclusive prefix
    over the 72 counts gives the bins' offsets; the samples' (angle,
    weighted magnitude) are scattered to offset + rank; each bin's three
    sums run over its own run in sequential float32 adds; the 72 windows
    follow in the twin's order and the first maximum wins.  The samples'
    values come from the twin's own `disc_samples`.
    -> (angles (K,) float32, per-bin sums (K, 72, 3) float32
    [angle, psum, angle*psum], counts (K, 72))."""
    from cuda_surf_tpu_torch.config import HWN, NBIN
    from cuda_surf_tpu_torch.ops import orientation as to
    f32 = np.float32
    tab = to.tables(ii.device)
    geom = to.orient_geometry(x, y, scale, doubled)
    ok, hid, angle, psum = (a.numpy() for a in to.disc_samples(
        ii, tab["lut"], *geom, valid))
    table = to.disc_positions()
    assert table.shape == (253,)
    K = ok.shape[0]
    bins, base_l, base_r = (tab[k].numpy() for k in ("bins", "base_l",
                                                     "base_r"))
    two_pi, sep = f32(2 * np.pi), f32(to._SEP)
    out = np.zeros(K, f32)
    sums = np.zeros((K, NBIN, 3), f32)
    counts = np.zeros((K, NBIN), np.int64)
    for k in np.flatnonzero(valid.numpy()):
        cnt = np.zeros(NBIN, np.int64)
        placed = []                                   # (bin, rank, sample)
        for r0 in range(0, len(table), 32):           # a round of 32 lanes
            lanes = [q for q in table[r0:r0 + 32] if ok[k, q]]
            before = cnt.copy()
            for n, q in enumerate(lanes):
                b = hid[k, q]
                lower = sum(hid[k, p] == b for p in lanes[:n])
                placed.append((b, before[b] + lower, q))
                cnt[b] += 1
        off = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        s_ang = np.zeros(256, f32)
        s_ps = np.zeros(256, f32)
        for b, rank, q in placed:
            s_ang[off[b] + rank] = angle[k, q]
            s_ps[off[b] + rank] = psum[k, q]
        part, avg = np.zeros(NBIN, f32), np.zeros(NBIN, f32)
        pas = np.zeros(NBIN + 2 * HWN, f32)
        for b in range(NBIN):
            asum = ps = aps = f32(0)
            for e in range(off[b], off[b] + cnt[b]):
                asum = f32(asum + s_ang[e])
                ps = f32(ps + s_ps[e])
                aps = f32(aps + f32(s_ang[e] * s_ps[e]))
            sums[k, b] = asum, ps, aps
            part[b] = ps
            avg[b] = f32(asum / f32(cnt[b])) if cnt[b] else bins[b]
            pas[b + HWN] = aps
            if b >= NBIN - HWN:
                pas[b - (NBIN - HWN)] = f32(aps - f32(two_pi * ps))
            if b < HWN:
                pas[b + NBIN + HWN] = f32(aps + f32(two_pi * ps))
        counts[k] = cnt
        top = top_a = None
        for w in range(NBIN):
            ws = was = f32(0)
            for j in range(-HWN + 1, HWN):
                ws = f32(ws + part[(w + j) % NBIN])
                was = f32(was + pas[w + j + HWN])
            ratio_l = f32(f32(base_l[w] - avg[w]) / sep)
            ws = f32(ws + f32(ratio_l * part[(w - HWN) % NBIN]))
            was = f32(was + f32(ratio_l * pas[w]))
            ratio_r = f32(f32(avg[w] + base_r[w]) / sep)
            ws = f32(ws + f32(ratio_r * part[(w + HWN) % NBIN]))
            was = f32(was + f32(ratio_r * pas[w + 2 * HWN]))
            if top is None or ws > top:               # first maximum
                top, top_a = ws, was
        with np.errstate(invalid="ignore", divide="ignore"):
            out[k] = f32(top_a / top)
    return out, sums, counts


def emulate_kernel_a(ii, plan, thresh):
    """Kernel A (csrc/detect.cu) in plain torch, tile by tile, driven by the
    packed plan alone as the kernel is: per tile of the plan's table the
    `ms` layers on the tile plus a one-cell halo (-inf outside the octave,
    zero outside a layer's rectangle, else the determinant from the 32
    corner offsets; a staged octave reads them from the tile's patch in
    its column-plane layout), the tile's layers written once, and the
    3x3x3 test taken from the halo block inside the NMS windows.
    `ii`: (ih, iw) int32 on the CPU; `plan`: fused_detect.PyramidPlan.
    -> (layers, masks, writes): per-octave tensors and how often each
    output element was written."""
    from cuda_surf_tpu_torch.ops import fused_detect as fd
    from cuda_surf_tpu_torch.ops.hessian import RR
    tab = plan.table
    noct, ms, ntiles = (int(v) for v in tab[:3])
    ih, iw = ii.shape
    flat = ii.reshape(-1)
    HH, HW = fd.TILE_H + 2, fd.TILE_W + 2
    pre_t = float(np.float32(0.8) * np.float32(thresh))
    layers = [torch.full((ms, p["oh"], p["ow"]), float("nan"))
              for p in plan.octaves]
    masks = [torch.zeros((ms, p["oh"], p["ow"]), dtype=torch.bool)
             for p in plan.octaves]
    writes = [torch.zeros((ms, p["oh"], p["ow"]), dtype=torch.int32)
              for p in plan.octaves]
    tiles = tab[fd.PLAN_HEADER + noct * fd.OCT_INTS:].reshape(ntiles, 3)
    hr, hc = torch.meshgrid(torch.arange(HH), torch.arange(HW), indexing="ij")
    for o, row0, col0 in tiles.tolist():
        g = tab[fd.PLAN_HEADER + o * fd.OCT_INTS:][:fd.OCT_INTS]
        oh, ow, d, staged, dy0, dx0, ph, pcols, pwd = (int(v) for v in g[:9])
        r, c = row0 - 1 + hr, col0 - 1 + hc
        inside = (r >= 0) & (r < oh) & (c >= 0) & (c < ow)
        if staged:
            y = d * (row0 - 1) + dy0 + torch.arange(ph)[:, None]
            x = d * (col0 - 1) + dx0 + torch.arange(pcols)[None, :]
            ok = (y >= 0) & (y < ih) & (x >= 0) & (x < iw)
            vals = torch.where(ok, ii[y.clamp(0, ih - 1), x.clamp(0, iw - 1)],
                               0)
            src = torch.zeros(ph * d * pwd, dtype=torch.int32)
            px = torch.arange(pcols)
            src[(torch.arange(ph)[:, None] * d * pwd
                 + ((px % d) * pwd + px // d)[None, :]).reshape(-1)] = \
                vals.reshape(-1)
            base = d * hr * d * pwd + hc
        else:
            src = flat
            base = d * r * iw + d * c
        lay = torch.full((ms, HH, HW), -float("inf"))
        for li in range(ms):
            L = g[fd.OCT_HEADER + li * fd.LAYER_INTS:][:fd.LAYER_INTS]
            r0, r1, c0, c1 = (int(v) for v in L[:4])
            norm = float(L[4:5].view(np.float32)[0])
            rect = inside & (r >= r0) & (r < r1) & (c >= c0) & (c < c1)
            q = torch.as_tensor(L[fd.LAYER_CORNERS:fd.LAYER_CORNERS + 32])
            at = torch.where(rect, base, 0)[..., None] + q      # (HH, HW, 32)
            at = torch.where(rect[..., None], at, 0)
            v = src[at.long()]
            box = (v[..., 0::4] + v[..., 1::4]) - v[..., 2::4] - v[..., 3::4]
            dxx = (box[..., 0] - 3 * box[..., 1]).float()
            dyy = (box[..., 2] - 3 * box[..., 3]).float()
            dxy = 0.6 * (((box[..., 4] + box[..., 5]) - box[..., 6])
                         - box[..., 7]).float()
            det = RR * (dxx * dyy - dxy * dxy) * norm
            lay[li] = torch.where(rect, det, torch.where(inside, 0.0,
                                                         -float("inf")))
        core = inside[1:-1, 1:-1]
        rr_, cc_ = r[1:-1, 1:-1][core], c[1:-1, 1:-1][core]
        nb = torch.nn.functional.max_pool3d(lay[None, None], 3, stride=1,
                                            padding=(1, 0, 0))[0, 0]
        for s in range(ms):
            w0, w1, w2, w3 = (int(v) for v in
                              g[fd.OCT_HEADER + s * fd.LAYER_INTS + 5:][:4])
            v = lay[s, 1:-1, 1:-1]
            win = ((r[1:-1, 1:-1] >= w0) & (r[1:-1, 1:-1] < w1)
                   & (c[1:-1, 1:-1] >= w2) & (c[1:-1, 1:-1] < w3))
            ok = win & (v >= pre_t) & (v >= nb[s])
            layers[o][s, rr_, cc_] = v[core]
            masks[o][s, rr_, cc_] = ok[core]
            writes[o][s, rr_, cc_] += 1
    return layers, masks, writes
