from .pose import exp_so3, log_so3, exp_se3, compose, invert, transform, hat
from .epipolar import (
    ransac_essential, sampson_error, triangulate, recover_pose,
    normalize_with_intrinsics, TwoViewResult,
)

__all__ = [
    "exp_so3", "log_so3", "exp_se3", "compose", "invert", "transform", "hat",
    "ransac_essential", "sampson_error", "triangulate", "recover_pose",
    "normalize_with_intrinsics", "TwoViewResult",
]
