"""cuda_surf_tpu_torch: the PyTorch + CUDA port of cuda_surf_tpu.

The SURF frontend (detect, orientation, describe, match; upright or
rotated, 64-d or extended 128-d, doubled or not; one frame or a batch of
frames per call) on an NVIDIA H100, with hand-written CUDA kernels
(csrc/) in place of the JAX package's Pallas kernels.  This package
imports torch and never jax; the JAX package beside it is the reference
it is tested against.
"""

import torch

# Full fp32 everywhere: the plain twins' matmuls (descriptor binning,
# matcher scores) are held to ~1e-6, which TF32's 10-bit mantissa would
# break.  Set once, here.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .config import SurfConfig, config_from_jax  # noqa: E402
from .types import Keypoints, Matches  # noqa: E402
from .frontend import (Surf, detect_and_compute,  # noqa: E402
                       detect_and_compute_batch)
from .parallel import BatchSurf  # noqa: E402
from .ops.matcher import match_keypoints  # noqa: E402
from .ops.orientation import assign_orientations  # noqa: E402

__all__ = [
    "SurfConfig", "Keypoints", "Matches", "Surf", "BatchSurf",
    "detect_and_compute", "detect_and_compute_batch", "match_keypoints", "assign_orientations",
    "config_from_jax",
]
