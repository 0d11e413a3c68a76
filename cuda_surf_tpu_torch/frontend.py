"""SURF frontend pipeline (port of cuda_surf_tpu/frontend.py): one frame
per call, or a batch of frames per call for throughput.

Mirror of Surfor::detectAndCompute (surf.cpp:205-355): integral image ->
kernel A (response layers + NMS masks of all octaves) -> kernel F
(compaction and subpixel walk) -> makePoint -> kernel D (orientation,
unless upright) -> kernel B (descriptor rows) -> L2 normalise.  Matching
runs kernel C.  The module functions run eagerly; the kernels are built
at their first launch.

The eager glue between the kernels is launch-bound: makePoint of one
frame is about a hundred small launches.  `detect_and_compute_batch`
runs F, makePoint, D and B once over the union of B frames' candidates,
so a batch pays them once and not B times.  On the card `Surf` replays
all of it after kernel G as a CUDA graph, one a shape, from a shape's
second call on (`_Graph`); `graph_counts` counts its calls by what they
did.
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from . import _build
from ._build import require_device
from .config import SurfConfig
from .types import Keypoints, Matches, compact
from .ops.integral import integral_image
from .ops.extrema import detect
from .ops.fused_detect import fused_pyramid
from .ops.descriptor import describe
from .ops.matcher import match_keypoints
from .ops.orientation import assign_orientations
from .utils.timing import span

# (path, what) -> `Surf` calls: path "frame" (`detect_and_compute`) or
# "batch" (`detect_and_compute_batch`); what "eager", "capture" (the call
# that made its shape's CUDA graph) or "replay".  Counted on the host: no
# launch.  Read a difference of two snapshots (`graph_counts.copy()`).
graph_counts: collections.Counter = collections.Counter()


def _make_keypoints(ii, cand, cfg: SurfConfig):
    """Compaction + makePoint (surfd.cu:1001-1022): scale octave-space
    coords to image space, Laplacian sign on the integral image.

    With `ii` a (B, ih, iw) stack of B frames' integral images, `cand`
    holds the union of their candidates with their `frame` ids, and ONE
    compaction and ONE Laplacian gather serve all frames; the frame ids
    come back as a ninth value.  The Laplacian corners wrap
    and clamp frame-locally.  The union's capacity is B * max_pts: a
    frame with more than max_pts valid keypoints truncates as the
    single-frame path does, but its overflow can also displace later
    frames' slots when the union's total exceeds the capacity."""
    stacked = ii.ndim == 3
    extra = (cand["frame"],) if stacked else ()
    count, valid, nx, ny, ns, strength, octave, *fid = compact(
        cand["valid"], cfg.max_pts * (ii.shape[0] if stacked else 1),
        cand["nx"], cand["ny"], cand["ns"], cand["strength"], cand["octave"],
        *extra)

    td = float(cfg.sampling * cfg.divisor)
    x = nx * td
    y = ny * td
    scale = 1.2 * ns * float(cfg.divisor)
    temp = torch.trunc(3.0 * ns + 0.5).to(torch.int32)
    cx = torch.trunc(nx * float(cfg.sampling) + 0.5).to(torch.int32)
    cy = torch.trunc(ny * float(cfg.sampling) + 0.5).to(torch.int32)
    x2 = torch.div(temp, 2, rounding_mode="floor")
    x3 = 2 * x2

    ih, iw = ii.shape[-2:]

    def box_corners(x1, y1, x2_, y2_):
        # getSum corners (surfd.cu:334-343): +(y1+1,x1+1) +(y2,x2)
        # -(y2,x1+1) -(y1+1,x2)
        return [(x1 + 1, y1 + 1), (x2_, y2_), (x1 + 1, y2_), (x2_, y1 + 1)]

    boxes = (box_corners(cx + temp + x2, cy + x3, cx - temp - x2, cy - x3)
             + box_corners(cx + x2, cy + x3, cx - x2, cy - x3)
             + box_corners(cx + x3, cy + temp + x2, cx - x3, cy - temp - x2)
             + box_corners(cx + x3, cy + x2, cx - x3, cy - x2))
    xx = torch.stack([bx for bx, _ in boxes])               # (16, K)
    yy = torch.stack([by for _, by in boxes])
    # the JAX package's advanced-indexing semantics, made explicit:
    # negative indices wrap once, then clamp to the valid range
    xx = torch.clamp(torch.where(xx < 0, xx + iw, xx), 0, iw - 1)
    yy = torch.clamp(torch.where(yy < 0, yy + ih, yy), 0, ih - 1)
    flat = (yy * iw + xx).long()
    if fid:     # the frame's offset, after the frame-local clamp
        flat = flat + fid[0].long() * (ih * iw)
    vals = ii.reshape(-1)[flat]                             # one gather
    b = vals[0::4] + vals[1::4] - vals[2::4] - vals[3::4]   # (4, K)
    lxx = b[0] - 3 * b[1]
    lyy = b[2] - 3 * b[3]
    laplace = torch.where(lxx + lyy > 0, 1, -1).to(torch.int32)
    return (count, valid, x, y, scale, strength, laplace, octave, *fid)


def detect_and_compute(image: torch.Tensor, cfg: SurfConfig,
                       compute_descriptors: bool = True):
    """uint8 (H, W) tensor -> (Keypoints, (max_pts, nfeatures)
    descriptors), on the image's device."""
    h, w = image.shape
    with span("surf.integral"):
        ii = integral_image(image, cfg.doubled)
    return _frame_from_integral(ii, h, w, cfg, compute_descriptors)


def _frame_from_integral(ii: torch.Tensor, h: int, w: int, cfg: SurfConfig,
                         compute_descriptors: bool = True):
    """`detect_and_compute` from the frame's integral image on: kernels A,
    F, makePoint, D (unless upright) and B."""
    with span("surf.pyramid"):
        pyr, masks = fused_pyramid(ii, cfg, h, w)
    with span("surf.detect"):
        cand = detect(pyr, cfg.hessian_schedule(h, w), cfg, cand_masks=masks)
    with span("surf.makepoint"):
        count, valid, x, y, scale, strength, laplace, octave = \
            _make_keypoints(ii, cand, cfg)
    ori = torch.zeros_like(x)
    if compute_descriptors and not cfg.upright:
        with span("surf.orient"):     # 0 where invalid
            ori = assign_orientations(ii, cfg, x, y, scale, valid)
    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=ori, octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, torch.zeros((cfg.max_pts, cfg.nfeatures),
                                dtype=torch.float32, device=ii.device)
    with span("surf.describe"):
        desc = describe(ii, cfg, x, y, scale, ori, valid)
        desc = torch.where(valid[:, None], desc, 0.0)
    return kps, desc


def _spread_frames(valid_u, fid, fields, B: int, max_pts: int):
    """The union's keypoints -> the (B, max_pts) layout.  The union is
    frame-major and stable, so frame b's keypoints are a contiguous run of
    it: one gather per field moves each run to its row, and the padding
    slots are zero.  -> (count (B,), valid (B, max_pts), *fields)."""
    dev = valid_u.device
    fr = torch.arange(B, dtype=torch.int32, device=dev)
    inframe = (fid[None, :] == fr[:, None]) & valid_u[None, :]
    count = inframe.sum(1, dtype=torch.int32)
    starts = torch.cumsum(count, 0, dtype=torch.int32) - count
    jj = torch.arange(max_pts, dtype=torch.int32, device=dev)
    valid = jj[None, :] < count[:, None]
    idx = torch.where(valid, torch.clamp(starts[:, None] + jj[None, :],
                                         max=B * max_pts - 1), 0).long()
    return (count, valid,
            *(torch.where(valid, a[idx], torch.zeros((), dtype=a.dtype,
                                                     device=dev))
              for a in fields))


def detect_and_compute_batch(images: torch.Tensor, cfg: SurfConfig,
                             compute_descriptors: bool = True):
    """uint8 (B, H, W) tensor -> (Keypoints with (B, max_pts) fields and a
    (B,) count, (B, max_pts, nfeatures) descriptors), on the images'
    device: the throughput form of the pipeline.

    Kernel G makes the (B, ih, iw) stack of integral images in one call
    and kernel A runs once on it.  The compaction, the subpixel walk and
    makePoint run ONCE over the union of the B frames' candidates; the
    union is frame-major and stable, so each frame's keypoints are a
    contiguous run, which one gather spreads to the (B, max_pts) layout
    with zero-filled padding slots (the single-frame path leaves makePoint
    of zeroed coordinates there).  Rotated (upright=False), ONE launch of
    kernel D orients all B * max_pts slots over the (B, ih, iw) stack of
    integral images, each keypoint reading its own frame; then ONE launch
    of kernel B describes them the same way.  A valid slot's keypoint,
    orientation and descriptor are those of the single-frame path on its
    frame.
    """
    with span("surf.integral"):
        ii = integral_image(images, cfg.doubled)
    return _from_integral(ii, *images.shape, cfg, compute_descriptors)


def _from_integral(ii: torch.Tensor, B: int, h: int, w: int, cfg: SurfConfig,
                   compute_descriptors: bool = True):
    """`detect_and_compute_batch` from the (B, ih, iw) stack of the frames'
    integral images on: kernels A, F, makePoint, D and B."""
    dev = ii.device
    with span("surf.pyramid"):
        pyr_b, mask_b = fused_pyramid(ii, cfg, h, w)
    with span("surf.detect"):
        cand = detect(pyr_b, cfg.hessian_schedule(h, w), cfg,
                      cand_masks=mask_b, nframes=B)
    with span("surf.makepoint"):
        _, valid_u, *fields, fid = _make_keypoints(ii, cand, cfg)
        count, valid, x, y, scale, strength, laplace, octave = \
            _spread_frames(valid_u, fid, fields, B, cfg.max_pts)

    kps = Keypoints(x=x, y=y, scale=scale, strength=strength,
                    laplace=laplace, ori=torch.zeros_like(x), octave=octave,
                    valid=valid, count=count)
    if not compute_descriptors:
        return kps, torch.zeros((B, cfg.max_pts, cfg.nfeatures),
                                dtype=torch.float32, device=dev)
    flat = lambda a: a.reshape(-1)
    frame = torch.arange(B, dtype=torch.int32,
                         device=dev).repeat_interleave(cfg.max_pts)
    ori = flat(kps.ori)
    if not cfg.upright:
        with span("surf.orient"):     # 0 where invalid
            ori = assign_orientations(ii, cfg, flat(x), flat(y), flat(scale),
                                      flat(valid), frame=frame)
        kps = kps._replace(ori=ori.reshape(B, cfg.max_pts))
    with span("surf.describe"):
        desc = describe(ii, cfg, flat(x), flat(y), flat(scale), ori,
                        flat(valid), frame=frame)
        desc = torch.where(flat(valid)[:, None], desc, 0.0)
    return kps, desc.reshape(B, cfg.max_pts, cfg.nfeatures)


def _to_uint8(image, device) -> torch.Tensor:
    img = torch.as_tensor(np.asarray(image, np.uint8)
                          if not isinstance(image, torch.Tensor) else image)
    return img.to(device, torch.uint8)


class _Graph:
    """A `Surf` call at one shape on the card, a frame's (H, W) or a
    batch's (B, H, W): kernel G run eagerly on the caller's frames into an
    integral image of its own, then the rest of the pipeline (`body`:
    `_frame_from_integral` or `_from_integral`) captured as a CUDA graph
    over it, so the graph's launch overlaps G.  The pipeline has no host
    sync and no shape that depends on the data, so the graph is the eager
    pipeline's launches, bit for bit; its outputs live in the graph's
    memory pool and are copied out on each call.  The body reaches
    `_make_keypoints` and `describe` through this module's globals while
    it is captured, as the eager pipeline does at each call.  `held` keeps
    the cached plans and tables that the captured launches read
    (`_build.keep`), so their caches may drop them."""

    def __init__(self, body, images: torch.Tensor, cfg: SurfConfig):
        self.cfg = cfg
        with span("surf.integral"):
            self.ii = integral_image(images, cfg.doubled)
        self.graph = torch.cuda.CUDAGraph()
        with _build.holding() as self.held, torch.cuda.graph(self.graph):
            self.out = body(self.ii, *images.shape, cfg)

    def __call__(self, images: torch.Tensor):
        """The pipeline on `images`: G into the graph's integral image,
        then the replay."""
        with span("surf.integral"):
            integral_image(images, self.cfg.doubled, out=self.ii)
        return self.replay()

    def replay(self):
        """The graph on the integral image it holds; outputs of their own."""
        self.graph.replay()
        kps, desc = self.out
        return Keypoints(*[f.clone() for f in kps]), desc.clone()


class Surf:
    """The `Surfor` role (surf.h:20-62): a config bound to a device.

    `Surf(cfg, device="cuda")` runs the hand-written kernels and raises if
    no card is present; it never runs on the CPU instead.
    `device="cpu"` runs the plain PyTorch twins.

    On the card the first call at a shape runs the pipeline eagerly (and
    builds what it builds at first use); the second captures all of it
    after kernel G as a CUDA graph (`_Graph`), and every later call at the
    shape runs G on its frames and replays the graph: G's call and one
    graph launch in place of ~160 launches a frame or ~200 a batch, so
    the card no longer waits on the host between them.  One graph a
    shape, frame or batch; every call returns tensors of its own.  On the
    CPU every call is eager.
    """

    def __init__(self, cfg: SurfConfig | None = None, device="cuda", **kw):
        self.cfg = cfg if cfg is not None else SurfConfig(**kw)
        self.device = require_device(device, "Surf")
        self._graphs = {}     # shape -> None (seen once) | _Graph

    def detect_and_compute(self, image):
        """An (H, W) frame -> keypoints and (max_pts, nfeatures)
        descriptors."""
        return self._run("frame", detect_and_compute, _frame_from_integral,
                         _to_uint8(image, self.device))

    def detect_and_compute_batch(self, images):
        """(B, H, W) frames -> batched keypoints and descriptors."""
        return self._run("batch", detect_and_compute_batch, _from_integral,
                         _to_uint8(images, self.device))

    def _run(self, path: str, eager, body, images: torch.Tensor):
        """`eager` (the module function) at a shape's first call or on the
        CPU; the graph of `body` from its second call on the card."""
        key = tuple(images.shape)     # (H, W) frames, (B, H, W) batches
        on_card = images.device.type == "cuda"
        if not on_card or key not in self._graphs:
            out = eager(images, self.cfg)
            if on_card:     # a shape whose eager call raised is not kept
                self._graphs[key] = None
            graph_counts[path, "eager"] += 1
            return out
        if self._graphs[key] is None:
            graph = self._graphs[key] = _Graph(body, images, self.cfg)
            graph_counts[path, "capture"] += 1
            return graph.replay()
        graph_counts[path, "replay"] += 1
        return self._graphs[key](images)

    def match(self, kp1, desc1, kp2, desc2) -> Matches:
        return match_keypoints(kp1, desc1, kp2, desc2)
