"""Kernel A's wrapper: every octave's response layers + NMS candidate
masks, for one frame or a stack of frames (port of
cuda_surf_tpu/ops/fused_detect.py).

On a CUDA tensor `fused_pyramid` launches kernel A (csrc/detect.cu) once,
whatever the number of octaves and frames; on a CPU tensor it takes the
plain twins, `hessian.response_pyramid` and `extrema._candidate_mask`.
Any other device raises.  The kernel reads its box-sum corners straight
from the int32 integral image, so no phase planes are built.

Layer geometry (`octave_plan`): layer `li` of octave `o` holds, at grid
position (R, C) inside its embed rectangle, the determinant read from
integral-image entries (d*R + dy, d*C + dx), d being the octave's
sampling delta.  For the two seed layers of octaves > 0 the offsets are
the previous octave's scale geometry and the rectangle is the part of
the previous octave's nonzero region that 2x decimation keeps: the
decimated value at R is the previous layer's value at 2R, which read
(d/2)*2R + dy, the same integral-image entry.

`pyramid_plan` packs the geometry of all octaves and the table of output
tiles into one int32 tensor, once per configuration, frame size and
device; csrc/detect.cu documents the layout.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .. import _build
from ..config import SurfConfig, ScaleParams
from .extrema import _candidate_mask, nms_windows
from .hessian import RR, response_pyramid


def _corner_offsets(sp: ScaleParams):
    """(dy, dx) of every integral-image corner the layer's box filters read
    (getSum corners of the dxx, dyy and dxy boxes)."""
    m, x2, x3, x4 = sp.mask_size, sp.x2, sp.x3, sp.x4
    boxes = [(m + x2, x3, -m - x2, -x3), (x2, x3, -x2, -x3),
             (x3, m + x2, -x3, -m - x2), (x3, x2, -x3, -x2),
             (x4, 0, 0, -x4), (0, x4, -x4, 0), (x4, x4, 0, 0),
             (0, 0, -x4, -x4)]
    out = []
    for x1, y1, xx2, y2 in boxes:
        out += [(y1 + 1, x1 + 1), (y2, xx2), (y2, x1 + 1), (y1 + 1, xx2)]
    return out


def octave_plan(cfg: SurfConfig, scheds, shapes, o: int, ih: int, iw: int):
    """Static geometry of octave o's kernel A launches."""
    sched = scheds[o]
    oh, ow = shapes[o]
    d = sched.scales[0].delta
    ms = cfg.max_scale
    layers = []  # (r0, r1, c0, c1, ScaleParams)
    if o > 0:
        prev = scheds[o - 1]
        poh, pow_ = shapes[o - 1]
        for li in (ms - 3, ms - 1):
            sp = prev.scales[li - prev.init_scale]
            b1 = sp.border1
            # previous layer is nonzero on [b1, prev_dim - b1); decimated
            # position y maps to 2y
            r_lo, r_hi = -(-b1 // 2), min((poh - b1 + 1) // 2, oh)
            c_lo, c_hi = -(-b1 // 2), min((pow_ - b1 + 1) // 2, ow)
            layers.append((r_lo, max(r_hi, r_lo), c_lo, max(c_hi, c_lo), sp))
    for sp in sched.scales:
        b1 = sp.border1
        r_hi, c_hi = max(oh - b1, b1), max(ow - b1, b1)
        layers.append((b1, r_hi, b1, c_hi, sp))
    if len(layers) != ms:
        raise ValueError(f"octave {o}: {len(layers)} layers, expected {ms}")

    geom = np.zeros((ms, 8), np.int32)
    norm = np.zeros((ms,), np.float32)
    for li, (r0, r1, c0, c1, sp) in enumerate(layers):
        geom[li] = (r0, r1, c0, c1, sp.mask_size, sp.x2, sp.x3, sp.x4)
        norm[li] = np.float32(sp.norm)
        if r1 > r0 and c1 > c0:
            offs = _corner_offsets(sp)
            dys = [dy for dy, _ in offs]
            dxs = [dx for _, dx in offs]
            if (d * r0 + min(dys) < 0 or d * (r1 - 1) + max(dys) > ih - 1
                    or d * c0 + min(dxs) < 0
                    or d * (c1 - 1) + max(dxs) > iw - 1):
                raise ValueError(f"octave {o} layer {li} reads outside the "
                                 "integral image")

    win = np.zeros((ms, 4), np.int32)
    for s, w in nms_windows(sched.maximum_borders(), ms, oh, ow).items():
        win[s] = w
    return dict(d=d, oh=oh, ow=ow, ms=ms, geom=geom, norm=norm, win=win)


# The kernel's constants (csrc/detect.cu).
TILE_H, TILE_W = 14, 30
MAX_LAYERS = 8
PLAN_HEADER, OCT_HEADER, LAYER_INTS, LAYER_CORNERS = 8, 16, 48, 16
OCT_INTS = OCT_HEADER + MAX_LAYERS * LAYER_INTS
# An octave stages its tile's integral-image patch in shared memory when
# the patch takes at most this many bytes (octave 0 not doubled: 24 KB).
# Every other patch is 60 KB and more, three blocks an SM at best: staging
# the doubled frame's octave 0 that way measured slower than gathering.
STAGE_MAX_BYTES = 32 * 1024


@dataclasses.dataclass(frozen=True, eq=False)
class PyramidPlan:
    octaves: tuple          # `octave_plan` of every octave
    staged: tuple           # per octave: the patch goes to shared memory
    tiles: np.ndarray       # (ntiles, 3) int32: octave, first row, first col
    offsets: tuple          # per octave: first element in the outputs, per frame
    total: int              # elements of all octaves, per frame
    smem_bytes: int         # the kernel's dynamic shared memory
    table: np.ndarray       # the packed int32 plan
    dev: torch.Tensor       # `table` on the device


def _tile_table(shapes):
    """Every (octave, first row, first column) of the TILE_H x TILE_W output
    tiles, the highest octave first: its blocks are the slowest (they
    gather corners a sector apart), so they start first and octave 0's
    many quick ones fill the tail."""
    return np.array([(o, r, c) for o, (oh, ow) in list(enumerate(shapes))[::-1]
                     for r in range(0, oh, TILE_H)
                     for c in range(0, ow, TILE_W)], np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=32)
def pyramid_plan(cfg: SurfConfig, h: int, w: int, ih: int, iw: int,
                 device: str) -> PyramidPlan:
    """Kernel A's static plan for (h, w) frames whose integral images are
    (ih, iw): per-octave geometry (`octave_plan`, which raises if a layer
    would read outside the integral image), each layer's 32 corner offsets
    from an output's base address, and the tile table, packed and copied
    to `device` once."""
    scheds = cfg.hessian_schedule(h, w)
    shapes = cfg.octave_shapes(h, w)
    ms = cfg.max_scale
    if ms > MAX_LAYERS:
        raise ValueError(f"kernel A holds {MAX_LAYERS} layers an octave, "
                         f"the config has {ms}")
    octaves = tuple(octave_plan(cfg, scheds, shapes, o, ih, iw)
                    for o in range(cfg.noctaves))
    tiles = _tile_table(shapes)
    table = np.zeros(PLAN_HEADER + cfg.noctaves * OCT_INTS + tiles.size,
                     np.int32)
    table[:3] = (cfg.noctaves, ms, len(tiles))
    offsets, staged, total, patch_words = [], [], 0, 0
    for o, plan in enumerate(octaves):
        d, oh, ow = plan["d"], plan["oh"], plan["ow"]
        sps = ([scheds[o - 1].scales[li - scheds[o - 1].init_scale]
                for li in (ms - 3, ms - 1)] if o > 0 else []) \
            + list(scheds[o].scales)
        corners = [_corner_offsets(sp) for sp in sps]
        dys = [dy for offs in corners for dy, _ in offs]
        dxs = [dx for offs in corners for _, dx in offs]
        dy0, dx0 = min(dys), min(dxs)
        # the patch of a tile and its halo: rows and columns, then the
        # columns split into d planes of pwd words
        ph = d * (TILE_H + 1) + max(dys) - dy0 + 1
        pcols = d * (TILE_W + 1) + max(dxs) - dx0 + 1
        pwd = -(-pcols // d)
        stage = 4 * ph * d * pwd <= STAGE_MAX_BYTES
        if stage:
            patch_words = max(patch_words, ph * d * pwd)
        g = table[PLAN_HEADER + o * OCT_INTS:][:OCT_INTS]
        g[:10] = (oh, ow, d, stage, dy0, dx0, ph, pcols, pwd, total)
        for li, offs in enumerate(corners):
            L = g[OCT_HEADER + li * LAYER_INTS:][:LAYER_INTS]
            L[:4] = plan["geom"][li, :4]
            L[4] = plan["norm"][li:li + 1].view(np.int32)[0]
            L[5:9] = plan["win"][li]
            L[LAYER_CORNERS:LAYER_CORNERS + 32] = [
                (dy - dy0) * d * pwd + ((dx - dx0) % d) * pwd + (dx - dx0) // d
                if stage else dy * iw + dx for dy, dx in offs]
        offsets.append(total)
        staged.append(bool(stage))
        total += ms * oh * ow
    table[PLAN_HEADER + cfg.noctaves * OCT_INTS:] = tiles.reshape(-1)
    smem = 4 * (ms * (TILE_H + 2) * (TILE_W + 2) + patch_words)
    return PyramidPlan(octaves, tuple(staged), tiles, tuple(offsets), total,
                       smem, table, torch.as_tensor(table).to(device))


def fused_pyramid(ii: torch.Tensor, cfg: SurfConfig, h: int, w: int):
    """-> (pyr, masks): per-octave response layers (ms, oh, ow) float32 and
    NMS candidate masks (ms, oh, ow) bool of the (ih, iw) integral image
    `ii`; with a (B, ih, iw) stack of frames, (B, ms, oh, ow) each.
    CUDA: kernel A, one launch.  CPU: the plain twins, frame by frame."""
    if ii.ndim not in (2, 3):
        raise ValueError(f"fused_pyramid: ii must be (ih, iw) or (B, ih, iw), "
                         f"got {tuple(ii.shape)}")
    if ii.device.type == "cpu":
        scheds = cfg.hessian_schedule(h, w)
        frames = []
        for frame in (ii if ii.ndim == 3 else ii[None]):
            pyr = response_pyramid(frame, cfg, h, w)
            frames.append((pyr, [_candidate_mask(p, s, cfg)
                                 for p, s in zip(pyr, scheds)]))
        if ii.ndim == 2:
            return frames[0]
        return tuple([torch.stack([fr[part][o] for fr in frames])
                      for o in range(cfg.noctaves)] for part in (0, 1))
    if ii.device.type != "cuda":
        raise ValueError(f"fused_pyramid: unsupported device {ii.device}")
    _build.require_cuda(ii, "ii", torch.int32)
    ih, iw = ii.shape[-2:]
    B = ii.shape[0] if ii.ndim == 3 else 1
    plan = _build.keep(pyramid_plan(cfg, h, w, ih, iw, str(ii.device)))
    layers = torch.empty(B * plan.total, dtype=torch.float32, device=ii.device)
    masks = torch.empty(B * plan.total, dtype=torch.bool, device=ii.device)
    pre_t = float(np.float32(0.8) * np.float32(cfg.thresh))
    with torch.cuda.device(ii.device):
        _build.launch(
            "surf_pyramid", _build.ptr(ii), B, ih, iw, _build.ptr(plan.dev),
            len(plan.tiles), plan.smem_bytes, RR, pre_t, _build.ptr(layers),
            _build.ptr(masks), _build.stream(ii.device))
    lead = (B,) if ii.ndim == 3 else ()
    views = lambda flat: [
        flat[B * off:B * (off + cfg.max_scale * p["oh"] * p["ow"])].view(
            *lead, cfg.max_scale, p["oh"], p["ow"])
        for off, p in zip(plan.offsets, plan.octaves)]
    return views(layers), views(masks)
