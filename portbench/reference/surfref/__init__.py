"""The plain reference of the benchmark: SURF detect, describe and match,
and monocular visual odometry, in plain PyTorch on any device.

A frozen copy of the plain twins of `cuda_surf_tpu_torch` (its kernels'
plain versions, the eager glue, the geometry and the bundle adjustment),
kept under the benchmark so that a later change to the program does not
move the yardstick.  It imports nothing of the program and runs no
hand-written kernel; upright descriptors only.
"""

from .config import SurfConfig  # noqa: E402
from .frontend import Surf  # noqa: E402

__all__ = ["SurfConfig", "Surf"]
