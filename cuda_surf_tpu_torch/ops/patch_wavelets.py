"""The describe kernels' wrappers: unnormalised descriptor rows, 64-d or
extended 128-d, upright or rotated.

Hand-written CUDA kernels with one block per keypoint take the place of
four kernels of the JAX package and their shared body:

- kernel B (csrc/describe.cu) replaces patch_wavelets.py
  `_kernel_tiles_res` (keypoints with span <= 63) and patch_bucketed.py
  `_kernel` in "desc" mode (span > 63); called on a (B, ih, iw) stack of
  frames with a per-keypoint frame index it replaces `_kernel_tiles`, the
  frame-stacked rows of the batch frontend (`stacked_rows`);
- the static-step kernel (csrc/describe_step.cu) replaces
  patch_bucketed.py `_kernel_sdec` (`step_rows`);
- patch_common.py (`_emit_group_kp` / `_bin_descriptor`, with its rotated
  and extended branches) is csrc/describe_body.cuh, a template over
  upright / rotated and 4 / 8 channels, so each mode compiles to its own
  branch-free code.

The TPU split the keypoints by span only to fit its VMEM; the GPU gathers
integral-image corners directly, so there is no span routing, no limb
planes and no selection matmul.

`descriptor_rows` routes as the JAX package's does.  `DEC_STEPS` names
the sampling steps whose keypoints go through the static-step kernel
first (one frame, not doubled); it is empty, as in the JAX package, which
measured that route slower and keeps it off, so by default every keypoint
goes to kernel B.  On a CUDA tensor the wrappers launch the kernels; on
a CPU tensor they take the plain twins, `descriptor.describe_plain` and
`step_rows_plain`.  Any other device raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import SurfConfig
from ..types import compact
from .descriptor import describe_plain

# Sampling steps routed through the static-step kernel before kernel B.
DEC_STEPS = ()
# The steps csrc/describe_step.cu instantiates.
STEP_KERNELS = (4, 5, 6, 7, 8)
# Keypoints one static-step launch takes (`_run_step_dec`'s default).
STEP_CAP = 512


def _kernel_args(ii, cfg: SurfConfig, ix, iy, step, iscale, iradius, fracr,
                 fracc, spacing, sine, cose, valid, frame=None):
    """Validate, and pack the geometry for the kernels -> (meta int32
    (6 or 7, K), fpar f32 (3 or 5, K), wtab f32 (40,))."""
    if cfg.desc_wsz != 4:
        raise NotImplementedError("kernel B bins 4x4 cells (desc_wsz=4)")
    _build.require_cuda(ii, "ii", torch.int32)
    rows = [ix, iy, step, iscale, iradius, valid.to(torch.int32)]
    if frame is not None:
        rows.append(frame)
    meta = torch.stack(rows).to(torch.int32).contiguous()
    turn = [] if cfg.upright else [sine, cose]
    fpar = torch.stack([fracr, fracc, spacing] + turn
                       ).to(torch.float32).contiguous()
    # the twin's weight expression, on the same device, for the 40 values
    # trunc(r^2) can take
    wtab = torch.exp(-(torch.arange(40, dtype=torch.float32, device=ii.device)
                       + 0.5) * 0.125)
    return meta, fpar, wtab


def single_rows(ii: torch.Tensor, cfg: SurfConfig, *geom) -> torch.Tensor:
    """Kernel B on one frame's (ih, iw) integral image.  `geom` is
    `desc_geometry`'s tuple and the valid mask."""
    if ii.ndim != 2:
        raise ValueError(f"single_rows: ii must be (ih, iw), got {ii.shape}")
    meta, fpar, wtab = _kernel_args(ii, cfg, *geom)
    K = meta.shape[1]
    out = torch.empty((K, cfg.nfeatures), dtype=torch.float32,
                      device=ii.device)
    ih, iw = ii.shape
    with torch.cuda.device(ii.device):
        _build.launch(
            "surf_describe", _build.ptr(ii), ih, iw, _build.ptr(meta),
            _build.ptr(fpar), _build.ptr(wtab), K, cfg.max_iradius,
            int(cfg.upright), cfg.orient_size, _build.ptr(out),
            _build.stream(ii.device))
    return out


def stacked_rows(ii: torch.Tensor, cfg: SurfConfig, *geom,
                 frame: torch.Tensor) -> torch.Tensor:
    """Kernel B on a (B, ih, iw) stack of integral images: keypoint k lies
    in frame `frame[k]`, reads that frame only, and its border tests are
    frame-local, so its row is the row `single_rows` gives it on that
    frame alone.  A slot whose frame is outside [0, B) gets a zero row."""
    if ii.ndim != 3:
        raise ValueError(f"stacked_rows: ii must be (B, ih, iw), got "
                         f"{ii.shape}")
    meta, fpar, wtab = _kernel_args(ii, cfg, *geom, frame=frame)
    K = meta.shape[1]
    out = torch.empty((K, cfg.nfeatures), dtype=torch.float32,
                      device=ii.device)
    nframes, ih, iw = ii.shape
    with torch.cuda.device(ii.device):
        _build.launch(
            "surf_describe_stacked", _build.ptr(ii), nframes, ih, iw,
            _build.ptr(meta), _build.ptr(fpar), _build.ptr(wtab), K,
            cfg.max_iradius, int(cfg.upright), cfg.orient_size,
            _build.ptr(out), _build.stream(ii.device))
    return out


def step_selection(step: torch.Tensor, elig: torch.Tensor, sd: int, cap: int):
    """`_run_step_dec`'s selection: of the eligible keypoints with sampling
    step `sd`, the first `cap` in index order (a prefix sum, never an
    atomic append, which would scramble them).  -> (taken (K,) bool, rank
    (K,) int32: a taken keypoint's slot, `cap` for every other; sel (cap,)
    int32: slot j's keypoint; count () int32)."""
    want = elig & (step == sd)
    rank = torch.cumsum(want, 0, dtype=torch.int32) - 1
    taken = want & (rank < cap)
    idx = torch.arange(step.shape[0], dtype=torch.int32, device=step.device)
    count, _, sel = compact(taken, cap, idx)
    return taken, torch.where(taken, rank, cap), sel, count


def step_rows_plain(ii: torch.Tensor, cfg: SurfConfig, *geom, elig, sd: int,
                    cap: int = STEP_CAP):
    """The static-step kernel's plain twin: `step_selection` around
    `describe_plain` on the taken keypoints.  -> (rows (K, nfeatures),
    zero outside the taken set; taken (K,) bool)."""
    taken, *_ = step_selection(geom[2], elig & geom[-1], sd, cap)
    return describe_plain(ii, cfg, *geom[:-1], taken), taken


def step_rows(ii: torch.Tensor, cfg: SurfConfig, *geom, elig, sd: int,
              cap: int = STEP_CAP):
    """Descriptor rows of the eligible keypoints whose sampling step is
    the static `sd`, at most `cap` of them in stable order, one frame.
    -> (rows (K, nfeatures), zero outside the taken set; taken (K,) bool).
    Keypoints beyond `cap`, and every other step, stay untaken: the caller
    sends them to kernel B.  The kernel's rows equal kernel B's for the
    same keypoints bit for bit.  `cfg.desc_step_bounds(sd)` bounds the
    window radius of such keypoints; its iscale bound sized the TPU
    kernel's padded planes and is not needed here."""
    if ii.device.type == "cpu":
        return step_rows_plain(ii, cfg, *geom, elig=elig, sd=sd, cap=cap)
    if ii.device.type != "cuda":
        raise ValueError(f"step_rows: unsupported device {ii.device}")
    if sd not in STEP_KERNELS:
        raise ValueError(f"step_rows: no kernel for step {sd}; "
                         f"csrc/describe_step.cu has {STEP_KERNELS}")
    if ii.ndim != 2:
        raise ValueError(f"step_rows: ii must be (ih, iw), got {ii.shape}")
    meta, fpar, wtab = _kernel_args(ii, cfg, *geom)
    K = meta.shape[1]
    if K == 0:
        return (torch.zeros((0, cfg.nfeatures), dtype=torch.float32,
                            device=ii.device), geom[-1])
    cap = min(cap, K)
    taken, slot, sel, count = step_selection(geom[2], elig & geom[-1], sd, cap)
    sel, count = sel.contiguous(), count.reshape(1).contiguous()
    out = torch.empty((cap + 1, cfg.nfeatures), dtype=torch.float32,
                      device=ii.device)
    r_b, _ = cfg.desc_step_bounds(sd)
    ih, iw = ii.shape
    with torch.cuda.device(ii.device):
        _build.launch(
            "surf_describe_step", _build.ptr(ii), ih, iw, _build.ptr(meta),
            _build.ptr(fpar), _build.ptr(wtab), K, _build.ptr(sel),
            _build.ptr(count), cap, sd, min(r_b, cfg.max_iradius),
            int(cfg.upright), cfg.orient_size, _build.ptr(out),
            _build.stream(ii.device))
    return out[slot.long()], taken


def descriptor_rows(ii: torch.Tensor, cfg: SurfConfig, ix, iy, step, iscale,
                    iradius, fracr, fracc, spacing, sine, cose, valid,
                    frame=None) -> torch.Tensor:
    """-> (K, cfg.nfeatures) float32 unnormalised descriptor rows; invalid
    slots are zero rows.  The arguments are `desc_geometry`'s.  With
    `frame` (K,) int32, `ii` is a (B, ih, iw) stack of frames."""
    geom = (ix, iy, step, iscale, iradius, fracr, fracc, spacing, sine, cose)
    if ii.device.type not in ("cpu", "cuda"):
        raise ValueError(f"descriptor_rows: unsupported device {ii.device}")
    on_cpu = ii.device.type == "cpu"
    if frame is not None:
        if on_cpu:
            return describe_plain(ii, cfg, *geom, valid, frame=frame)
        return stacked_rows(ii, cfg, *geom, valid, frame=frame)
    rows, remaining = None, valid
    if not cfg.doubled:
        # the common large steps first; overflow beyond the cap and every
        # other step cascade to kernel B on the complementary mask
        for sd in DEC_STEPS:
            r, taken = step_rows(ii, cfg, *geom, valid, elig=remaining, sd=sd)
            rows = r if rows is None else rows + r
            remaining = remaining & ~taken
    rest = (describe_plain if on_cpu else single_rows)(ii, cfg, *geom,
                                                       remaining)
    return rest if rows is None else rows + rest
