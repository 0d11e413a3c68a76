"""3x3x3 non-max extrema detection + iterative subpixel interpolation
(port of cuda_surf_tpu/ops/extrema.py, sparse fit; one frame or the
union of a batch's frames).

Re-derivation of findMaximumWithInterp (surfd.cu:676-832), fitQuadrat
(surfd.cu:942-988) and solveLinearSystem (surfd.cu:835-887):

  1. a dense NMS mask (`_candidate_mask`, the plain twin of kernel A's
     mask): a position is a candidate iff its response is >= 0.8*thresh
     and >= every value of its 3x3x3 neighbourhood, inside the
     reference's per-scale-pair cell windows;
  2. one global stable compaction of candidate linear indices across
     all octaves (types.compact: prefix sum, never an atomic append,
     which would scramble keypoint order);
  3. a fixed-iteration interpolation walk: every candidate gathers its
     19 stencil neighbours and solves the 3x3 fit in closed form; after
     the first step the still-walking candidates are compacted into a
     max(cap//8, 64) active set, and overflow walkers keep their
     first-step fit (the JAX package's rule, extrema.py:377-419).

`detect` runs steps 2-3 as kernel F (csrc/extrema.cu, three launches, no
host sync) on a CUDA tensor and as the eager twin `_detect_plain` on a
CPU one; any other device raises.  The kernel reads kernel A's layers and
masks in place and takes its geometry from `extrema_plan`, a table built
once per shape and kept on the device.

Invalid slots carry linear index 0, so `lin + off` can go negative;
every stencil index is clamped into the pyramid before it is read
(torch raises, and CUDA device-asserts, where JAX silently clamps).
The clamp never moves a valid candidate's read: candidates sit strictly
inside the per-scale windows and the walk stays inside the borders.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import _build
from ..config import SurfConfig, OctaveSchedule
from ..types import compact


def _candidate_mask(resp: torch.Tensor, osched: OctaveSchedule,
                    cfg: SurfConfig) -> torch.Tensor:
    """Dense NMS candidate mask, (ms, oh, ow) bool."""
    ms, oh, ow = resp.shape
    # 3x3x3 max with -inf outside the octave (reduce_window "SAME")
    nbhd_max = F.max_pool3d(resp[None, None], 3, stride=1, padding=1)[0, 0]
    pre = resp >= float(np.float32(0.8) * np.float32(cfg.thresh))
    is_max = resp >= nbhd_max
    row_ok, col_ok = _cell_windows(osched, ms, oh, ow)
    window = (torch.as_tensor(row_ok, device=resp.device)
              & torch.as_tensor(col_ok, device=resp.device))
    return pre & is_max & window


def _cell_windows(osched: OctaveSchedule, ms: int, oh: int, ow: int):
    """Per-scale cell windows as static 1-D row / column masks."""
    mborders = osched.maximum_borders()
    row_ok = np.zeros((ms, oh, 1), bool)
    col_ok = np.zeros((ms, 1, ow), bool)
    for s, (r_lo, r_hi, c_lo, c_hi) in nms_windows(mborders, ms, oh, ow).items():
        row_ok[s, r_lo:r_hi, 0] = True
        col_ok[s, 0, c_lo:c_hi] = True
    return row_ok, col_ok


def nms_windows(mborders, ms: int, oh: int, ow: int) -> dict:
    """{scale: (row_lo, row_hi, col_lo, col_hi)} of the reference's 2x2x2
    cells: scales s in {2z+1, 2z+2} share cell border mborders[z], except
    the very last scale plane (the cas <= 3 restriction at surfd.cu:737)."""
    out = {}
    for s in range(1, ms - 1):
        z = (s - 1) // 2
        if z < len(mborders):
            mb = mborders[z]
            hc = max(0, (oh - 2 * mb - 1) // 2 + 1)
            wc = max(0, (ow - 2 * mb - 1) // 2 + 1)
            out[s] = (mb, mb + 2 * hc, mb, mb + 2 * wc)
    return out


def _fit_closed_form(g_s, g_r, g_c, h_ss, h_rr, h_cc, h_sr, h_sc, h_rc,
                     center):
    """Elementwise partial-pivot 3x3 solve + peak strength from fit
    stencil values (solveLinearSystem, surfd.cu:835-887), pivot swaps as
    selects."""
    rows = [
        [h_ss, h_sr, h_sc, -g_s],
        [h_sr, h_rr, h_rc, -g_r],
        [h_sc, h_rc, h_cc, -g_c],
    ]

    def pick(p, a, b, c):
        return torch.where(p == 0, a, torch.where(p == 1, b, c))

    a0, a1, a2 = (torch.abs(rows[0][0]), torch.abs(rows[1][0]),
                  torch.abs(rows[2][0]))
    p0 = torch.where(a1 > a0, 1, 0)
    p0 = torch.where(a2 > torch.maximum(a0, a1), 2, p0)
    r0 = [pick(p0, rows[0][j], rows[1][j], rows[2][j]) for j in range(4)]
    r1 = [torch.where(p0 == 1, rows[0][j], rows[1][j]) for j in range(4)]
    r2 = [torch.where(p0 == 2, rows[0][j], rows[2][j]) for j in range(4)]
    f1 = r1[0] / r0[0]
    f2 = r2[0] / r0[0]
    r1 = [r1[j] - f1 * r0[j] for j in range(4)]
    r2 = [r2[j] - f2 * r0[j] for j in range(4)]
    swap = torch.abs(r2[1]) > torch.abs(r1[1])
    r1, r2 = ([torch.where(swap, r2[j], r1[j]) for j in range(4)],
              [torch.where(swap, r1[j], r2[j]) for j in range(4)])
    f3 = r2[1] / r1[1]
    r2 = [r2[j] - f3 * r1[j] for j in range(4)]
    x2 = r2[3] / r2[2]
    x1 = (r1[3] - r1[2] * x2) / r1[1]
    x0 = (r0[3] - r0[1] * x1 - r0[2] * x2) / r0[0]
    strength = center + 0.5 * (x0 * g_s + x1 * g_r + x2 * g_c)
    return x0, x1, x2, strength


# Stencil gather offsets of the per-candidate fit: every distinct
# (ds, dr, dc) the 10 fit inputs touch (19 of the 27 neighbours).
_FIT_OFFSETS = [
    (0, 0, 0),
    (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    (1, 1, 0), (1, -1, 0), (-1, 1, 0), (-1, -1, 0),
    (1, 0, 1), (1, 0, -1), (-1, 0, 1), (-1, 0, -1),
    (0, 1, 1), (0, 1, -1), (0, -1, 1), (0, -1, -1),
]


def fit_sparse(resp_flat: torch.Tensor, lin: torch.Tensor,
               plane: torch.Tensor, ow: torch.Tensor, offsets: torch.Tensor):
    """Per-candidate quadratic fit (fitQuadrat, surfd.cu:942-988).

    resp_flat: (T,) all-octave flattened pyramid; lin: (cap,) flat
    indices; plane: (cap,) per-candidate scale-plane size (oh*ow);
    ow: (cap,) per-candidate row stride; offsets: `_FIT_OFFSETS` as an
    int32 (3, 19) tensor on lin's device.
    Returns (off_s, off_r, off_c, strength), each (cap,).
    """
    # all 19 neighbours in one (19, cap) gather: one index expression and
    # one gather launch instead of 19 of each
    ds, dr, dc = offsets[:, :, None]
    idx = lin[None] + ds * plane[None] + dr * ow[None] + dc
    idx = torch.clamp(idx, 0, resp_flat.shape[0] - 1)
    vals = resp_flat[idx.long()]
    slot = {o: k for k, o in enumerate(_FIT_OFFSETS)}

    def v(ds, dr, dc):
        return vals[slot[(ds, dr, dc)]]

    c = v(0, 0, 0)
    g_s = (v(1, 0, 0) - v(-1, 0, 0)) * 0.5
    g_r = (v(0, 1, 0) - v(0, -1, 0)) * 0.5
    g_c = (v(0, 0, 1) - v(0, 0, -1)) * 0.5
    h_ss = v(1, 0, 0) + v(-1, 0, 0) - 2.0 * c
    h_rr = v(0, 1, 0) + v(0, -1, 0) - 2.0 * c
    h_cc = v(0, 0, 1) + v(0, 0, -1) - 2.0 * c
    h_sr = ((v(1, 1, 0) - v(1, -1, 0)) - (v(-1, 1, 0) - v(-1, -1, 0))) * 0.25
    h_sc = ((v(1, 0, 1) - v(1, 0, -1)) - (v(-1, 0, 1) - v(-1, 0, -1))) * 0.25
    h_rc = ((v(0, 1, 1) - v(0, 1, -1)) - (v(0, -1, 1) - v(0, -1, -1))) * 0.25
    return _fit_closed_form(g_s, g_r, g_c, h_ss, h_rr, h_cc,
                            h_sr, h_sc, h_rc, c)


def _tables(shapes, borders, octaves):
    """The small tables of a detection, from each octave's (ms, oh, ow),
    its schedule's walk borders (surf.cpp:261-269) and octave number:
    (octab (4, noct): per octave [oh, ow, first element in a frame,
    octave number]; btab (noct * ms_p,): the borders zero-padded to the
    longest schedule; fit_offsets (3, 19): `_FIT_OFFSETS` as (ds, dr, dc)
    rows), int32."""
    offs = np.cumsum([0] + [ms * oh * ow for ms, oh, ow in shapes])[:-1]
    octab = np.array([[oh for _, oh, _ in shapes], [ow for *_, ow in shapes],
                      offs, octaves], np.int32)
    ms_p = max(len(b) for b in borders)
    btab = np.array([v for b in borders
                     for v in list(b) + [0] * (ms_p - len(b))], np.int32)
    return octab, btab, np.array(_FIT_OFFSETS, np.int32).T.copy()


# Kernel F's limits and constants (csrc/extrema.cu): octaves, scales an
# octave, mask bytes a chunk, and the plan's layout.
MAX_OCTAVES, MAX_SCALES = 8, 16
CHUNK = 4092
PLAN_HEADER, OCT_INTS = 8, 8


@dataclasses.dataclass(frozen=True, eq=False)
class ExtremaPlan:
    table: np.ndarray       # the packed int32 plan
    dev: torch.Tensor       # `table` on the device
    nchunks: int            # chunks of the whole stack (the launch grid)


@functools.lru_cache(maxsize=32)
def extrema_plan(shapes: tuple, borders: tuple, octaves: tuple, nframes: int,
                 device: str) -> ExtremaPlan:
    """Kernel F's static plan for `nframes` stacked frames whose octaves'
    layers are `shapes` ((ms, oh, ow) each), with the schedules' walk
    `borders` and `octaves` numbers, packed and copied to `device` once:

      header (PLAN_HEADER ints): noct, nframes, elements a frame, chunks a
        frame, ms_p, 19, CHUNK, 0;
      per octave (OCT_INTS): oh, ow, ms, ms * oh * ow, first element in a
        frame, octave number, first chunk in a frame, 0;
      the walk borders (noct * ms_p) and the stencil (3 * 19), as `_tables`
        gives them to the twin.
    """
    noct = len(shapes)
    if not 1 <= noct <= MAX_OCTAVES:
        raise ValueError(f"kernel F takes 1 to {MAX_OCTAVES} octaves, "
                         f"got {noct}")
    if max(len(b) for b in borders) > MAX_SCALES:
        raise ValueError(f"kernel F takes at most {MAX_SCALES} scales")
    octab, btab, stencil = _tables(shapes, borders, octaves)
    sizes = [ms * oh * ow for ms, oh, ow in shapes]
    chunks = [-(-n // CHUNK) for n in sizes]
    total_f = sum(sizes)
    if total_f * nframes >= 2 ** 31:
        raise ValueError(f"detect: {nframes} frames of {total_f} responses "
                         "overflow the int32 candidate index")
    rows = np.zeros((noct, OCT_INTS), np.int32)
    rows[:, 0:2] = octab[:2].T
    rows[:, 2] = [ms for ms, _, _ in shapes]
    rows[:, 3] = sizes
    rows[:, 4:6] = octab[2:].T
    rows[:, 6] = np.cumsum([0] + chunks)[:-1]
    header = np.array([noct, nframes, total_f, sum(chunks),
                       btab.size // noct, stencil.shape[1], CHUNK, 0],
                      np.int32)
    table = np.concatenate([header, rows.reshape(-1), btab,
                            stencil.reshape(-1)]).astype(np.int32)
    return ExtremaPlan(table, torch.as_tensor(table).to(device),
                       nframes * sum(chunks))


def detect(pyr, scheds, cfg: SurfConfig, cand_masks, cap: int | None = None,
           nframes: int = 1):
    """All-octave detection: NMS mask -> global compaction -> batched
    interpolation walk.  Returns a dict of (cap,) tensors: valid, nx, ny,
    ns, strength, octave (octave-local interpolated coords, ready for
    makePoint scaling), frame, and the candidate count and the number of
    step-1 movers (`walkers`), both 0-dim.

    `cand_masks` are the per-octave (ms, oh, ow) bool NMS masks that
    `fused_detect.fused_pyramid` returns with the layers.

    `nframes=B` stacks frames: every `pyr[o]` and `cand_masks[o]` carries
    a leading (B, ...) axis, and ONE compaction and ONE walk run over the
    union of the B frames' candidates.  The flat layout is frame-major,
    [frame0: oct0..octN | frame1: ...], so each frame's block is the
    single-frame layout; the capacity and the walk's active set scale to
    B * cap, and `frame` holds each candidate's frame.

    CUDA: kernel F, one call of three launches whatever B, no host sync.
    CPU: the twin `_detect_plain`.
    """
    dev = pyr[0].device
    if dev.type == "cpu":
        return _detect_plain(pyr, scheds, cfg, cand_masks, cap, nframes)
    if dev.type != "cuda":
        raise ValueError(f"detect: unsupported device {dev}")
    B, noct = nframes, len(pyr)
    if len(cand_masks) != noct or len(scheds) != noct:
        raise ValueError(f"detect: {noct} octaves of layers, "
                         f"{len(cand_masks)} of masks, {len(scheds)} "
                         "schedules")
    shapes = []
    for p, m in zip(pyr, cand_masks):
        _build.require_cuda(p, "detect: pyr", torch.float32)
        _build.require_cuda(m, "detect: cand_masks", torch.bool)
        if p.device != dev or m.device != dev or p.shape != m.shape \
                or p.ndim not in (3, 4) \
                or p.numel() != B * p.shape[-3:].numel():
            raise ValueError(f"detect: layers {tuple(p.shape)} and masks "
                             f"{tuple(m.shape)} on {p.device} / {m.device} "
                             f"are not {B} frames of (ms, oh, ow) on {dev}")
        shapes.append(tuple(p.shape[-3:]))
    cap = (cfg.max_candidates if cap is None else cap) * B
    if cap < 1:
        raise ValueError(f"detect: capacity {cap}")
    plan = _build.keep(extrema_plan(tuple(shapes),
                                    tuple(s.borders for s in scheds),
                                    tuple(s.octave for s in scheds), B,
                                    str(dev)))
    valid = torch.empty(cap, dtype=torch.bool, device=dev)
    fields = torch.empty((4, cap), dtype=torch.float32, device=dev)
    ints = torch.empty(2 * cap + 2 + 4 * plan.nchunks, dtype=torch.int32,
                       device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * noct)(*[t.data_ptr() for t in ts])
    with torch.cuda.device(dev):
        _build.launch(
            "surf_extrema", ptrs(pyr), ptrs(cand_masks), noct,
            _build.ptr(plan.dev), plan.nchunks, cap, max(cap // 8, 64),
            cfg.interp_moves, cfg.thresh, cfg.init_lobe, cfg.max_scale,
            _build.ptr(ints[2 * cap + 2:]), _build.ptr(valid),
            _build.ptr(fields), _build.ptr(ints), _build.stream(dev))
    return dict(valid=valid, nx=fields[0], ny=fields[1], ns=fields[2],
                strength=fields[3], octave=ints[:cap], frame=ints[cap:2 * cap],
                count=ints[2 * cap], walkers=ints[2 * cap + 1])


def _detect_plain(pyr, scheds, cfg: SurfConfig, cand_masks,
                  cap: int | None = None, nframes: int = 1):
    """`detect` in eager torch, kernel F's plain twin: the same outputs.

    With `nframes=B` ONE compaction and ONE walk run over the union of the
    B frames' candidates, so their hundreds of small launches are paid
    once per batch and not once per frame.
    """
    noct = len(pyr)
    B = nframes
    cap = (cfg.max_candidates if cap is None else cap) * B
    dev = pyr[0].device
    masks, offs, shapes = [], [0], []
    for o in range(noct):
        resp = pyr[o]
        masks.append(cand_masks[o].reshape(B, -1))
        offs.append(offs[-1] + resp.numel() // B)
        shapes.append(tuple(resp.shape[-3:]))
    mask = torch.cat(masks, 1).reshape(-1)
    resp_flat = torch.cat([r.reshape(B, -1) for r in pyr], 1).reshape(-1)
    total_f = offs[-1]          # per-frame element count
    total = total_f * B
    if total >= 2 ** 31:
        raise ValueError(f"detect: {B} frames of {total_f} responses "
                         "overflow the int32 candidate index")

    lin0 = torch.arange(total, dtype=torch.int32, device=dev)
    count, valid, lin = compact(mask, cap, lin0)

    # --- static per-candidate geometry decoded from the linear index ---
    # every small table in one host-to-device copy
    octab, btab, fit_offsets = _tables(
        shapes, [s.borders for s in scheds], [s.octave for s in scheds])
    ms_p = btab.shape[0] // noct
    consts = torch.as_tensor(np.concatenate(
        [octab.reshape(-1), btab, fit_offsets.reshape(-1)])).to(dev)
    octab = consts[:4 * noct].reshape(4, noct)
    btab = consts[4 * noct:4 * noct + len(btab)]
    fit_offsets = consts[4 * noct + len(btab):].reshape(3, len(_FIT_OFFSETS))

    # (the frame block first, then the single-frame octave decode on the
    # frame-relative index; the fit gathers keep the global index)
    if B > 1:
        frame = lin // total_f
        rel_lin = lin - frame * total_f
    else:
        frame = torch.zeros((cap,), dtype=torch.int32, device=dev)
        rel_lin = lin
    octv = torch.zeros((cap,), dtype=torch.int32, device=dev)
    for o in range(1, noct):
        octv += (rel_lin >= offs[o]).to(torch.int32)
    oh_t, ow_t, off_t, octave_t = octab[:, octv.long()]
    rel = rel_lin - off_t
    s_idx = rel // (oh_t * ow_t)
    rem = rel - s_idx * oh_t * ow_t
    r = rem // ow_t
    c = rem - r * ow_t
    border = btab[(octv * ms_p + s_idx).long()]

    def step(lin, r, c, border, oh_t, ow_t, active):
        """One fit + walk move; returns fit outputs and moved state."""
        x0, x1, x2, s = fit_sparse(resp_flat, lin, oh_t * ow_t, ow_t,
                                   fit_offsets)
        one = torch.ones_like(r)
        zero = torch.zeros_like(r)
        dr = (torch.where(active & (x1 > 0.6) & (r < oh_t - border), one, zero)
              - torch.where(active & (x1 < -0.6) & (r > border), one, zero))
        dc = (torch.where(active & (x2 > 0.6) & (c < ow_t - border), one, zero)
              - torch.where(active & (x2 < -0.6) & (c > border), one, zero))
        moved = active & ((dr != 0) | (dc != 0))
        return (torch.stack([x0, x1, x2], -1), s, r, c,
                lin + dr * ow_t + dc, r + dr, c + dc, moved)

    # Iteration 1 runs on all candidates; the (few) that keep walking are
    # compacted into a cap//8 active set for the remaining iterations
    # (the reference's per-thread early exit, surfd.cu:800-809).
    off, strength, r_fit, c_fit, lin, r, c, active = step(
        lin, r, c, border, oh_t, ow_t, valid)
    off = torch.where(valid[:, None], off, 0.0)
    strength = torch.where(valid, strength, 0.0)

    cap2 = max(cap // 8, 64)
    slots = torch.arange(cap, dtype=torch.int32, device=dev)
    (_, v2, idx2, lin2, r2, c2, b2, oh2, ow2) = compact(
        active, cap2, slots, lin, r, c, border, oh_t, ow_t)
    idx2 = idx2.long()
    off2, strength2 = off[idx2], strength[idx2]
    rf2, cf2 = r_fit[idx2], c_fit[idx2]
    act2 = v2
    for _ in range(cfg.interp_moves - 1):
        off_n, s_n, rf_n, cf_n, lin2, r2, c2, moved = step(
            lin2, r2, c2, b2, oh2, ow2, act2)
        off2 = torch.where(act2[:, None], off_n, off2)
        strength2 = torch.where(act2, s_n, strength2)
        rf2 = torch.where(act2, rf_n, rf2)
        cf2 = torch.where(act2, cf_n, cf2)
        act2 = moved

    # merge the walked subset back by rank (compact is stable, so the
    # i-th active slot landed at compacted row i); overflow walkers
    # beyond cap2 keep their first-iteration fit
    rank = torch.cumsum(active, 0, dtype=torch.int32) - 1
    walked = active & (rank < cap2)
    rk = torch.where(walked, rank, 0).long()
    off = torch.where(walked[:, None], off2[rk], off)
    strength = torch.where(walked, strength2[rk], strength)
    r_fit = torch.where(walked, rf2[rk], r_fit)
    c_fit = torch.where(walked, cf2[rk], c_fit)

    good = valid.clone()
    good &= ~torch.any(torch.isnan(off), dim=1)
    good &= ~torch.any(torch.abs(off) > 1.5, dim=1)
    good &= strength >= cfg.thresh

    octave = octave_t.to(torch.float32)
    ns = (float(cfg.init_lobe) + (octave - 1.0) * float(cfg.max_scale)
          + (s_idx.to(torch.float32) + off[:, 0]) * 2.0 * octave) / 3.0
    ny = octave * (r_fit.to(torch.float32) + off[:, 1])
    nx = octave * (c_fit.to(torch.float32) + off[:, 2])
    return dict(valid=good, nx=nx, ny=ny, ns=ns, strength=strength,
                octave=octv, frame=frame, count=count,
                walkers=torch.sum(active, dtype=torch.int32))
