"""Kernel B's wrapper: unnormalised descriptor rows, 64-d or extended
128-d, upright or rotated.

One hand-written CUDA kernel (csrc/describe.cu, one block per keypoint)
takes the place of three files of the JAX package: patch_wavelets.py
(`_kernel_tiles_res`, keypoints with span <= 63), patch_bucketed.py
(`_kernel` in "desc" mode, span > 63) and patch_common.py (their shared
`_emit_group_kp` / `_bin_descriptor`, with its rotated and extended
branches).  The kernel is a template over upright / rotated and 4 / 8
channels, so each mode compiles to its own branch-free code.  The TPU split the keypoints by
span only to fit its VMEM; the GPU gathers integral-image corners
directly, so there is no span routing, no limb planes and no selection
matmul.

On a CUDA tensor `descriptor_rows` launches the kernel; on a CPU tensor
it takes the plain twin, `descriptor.describe_plain`.  Any other device
raises.
"""

from __future__ import annotations

import torch

from .. import _build
from ..config import SurfConfig
from .descriptor import describe_plain


def descriptor_rows(ii: torch.Tensor, cfg: SurfConfig, ix, iy, step, iscale,
                    iradius, fracr, fracc, spacing, sine, cose,
                    valid) -> torch.Tensor:
    """-> (K, cfg.nfeatures) float32 unnormalised descriptor rows; invalid
    slots are zero rows.  The arguments are `desc_geometry`'s."""
    if ii.device.type == "cpu":
        return describe_plain(ii, cfg, ix, iy, step, iscale, iradius,
                              fracr, fracc, spacing, sine, cose, valid)
    if ii.device.type != "cuda":
        raise ValueError(f"descriptor_rows: unsupported device {ii.device}")
    if cfg.desc_wsz != 4:
        raise NotImplementedError("kernel B bins 4x4 cells (desc_wsz=4)")
    _build.require_cuda(ii, "ii", torch.int32)
    K = ix.shape[0]
    meta = torch.stack([ix, iy, step, iscale, iradius, valid.to(torch.int32)]
                       ).to(torch.int32).contiguous()
    turn = [] if cfg.upright else [sine, cose]
    fpar = torch.stack([fracr, fracc, spacing] + turn
                       ).to(torch.float32).contiguous()
    # the twin's weight expression, on the same device, for the 40 values
    # trunc(r^2) can take
    wtab = torch.exp(-(torch.arange(40, dtype=torch.float32, device=ii.device)
                       + 0.5) * 0.125)
    out = torch.empty((K, cfg.nfeatures), dtype=torch.float32,
                      device=ii.device)
    ih, iw = ii.shape
    with torch.cuda.device(ii.device):
        _build.check(_build.kernels().lib.surf_describe(
            _build.ptr(ii), ih, iw, _build.ptr(meta), _build.ptr(fpar),
            _build.ptr(wtab), K, cfg.max_iradius, int(cfg.upright),
            cfg.orient_size, _build.ptr(out), _build.stream(ii.device)),
            "surf_describe")
    descriptor_rows.launches += 1
    return out


descriptor_rows.launches = 0
