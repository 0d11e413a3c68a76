"""Kernel D's in-kernel geometry on the card.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Kernel D takes the disc's centre, sample spacing and Haar size from the
keypoints' x, y, scale itself; the twin takes them from `orient_geometry`.
Angles within 1e-4 rad wherever the top-two window gap is >= 1e-5
relative, one of the two top windows below that.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import DOUBLED_ROTATED_CONFIG, ROTATED_CONFIG
from cuda_surf_tpu_torch.io import main_pair
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import (assign_orientations,
                                                 assign_orientations_plain,
                                                 orientation_windows)
from torch_parity import (check_orientations, cuda_device,  # noqa: F401
                          kron_image)

pytestmark = pytest.mark.cuda

GOLDEN = {"golden_plane_pair_rotated.npz": ROTATED_CONFIG,
          "golden_plane_pair.npz": ROTATED_CONFIG,
          "golden_plane_pair_doubled_rotated.npz": DOUBLED_ROTATED_CONFIG,
          "golden_plane_pair_doubled.npz": DOUBLED_ROTATED_CONFIG}


@pytest.mark.parametrize("fixture", list(GOLDEN))
def test_kernel_d_geometry_on_the_golden_keypoints(cuda_device, fixture):
    """Kernel D takes the disc's centre, spacing and Haar size from x, y,
    scale itself; on every keypoint of the pair fixtures its angles are
    those of the twin, which takes them from `orient_geometry`; two
    launches agree bit for bit."""
    cfg = cst.SurfConfig(**GOLDEN[fixture])
    golden = np.load(Path(cst.__file__).parent / "data" / fixture)
    n_checked = 0
    for f, frame in enumerate(main_pair()):
        ii = integral_image(torch.as_tensor(frame, device=cuda_device),
                            cfg.doubled)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                      device=cuda_device)
        kp = [t(golden[f"{name}{f}"]) for name in ("x", "y", "scale")]
        kp.append(torch.ones_like(kp[0], dtype=torch.bool))
        got = assign_orientations(ii, cfg, *kp)
        assert torch.equal(got.view(torch.int32),
                           assign_orientations(ii, cfg, *kp).view(torch.int32))
        ws, wa = orientation_windows(ii, *kp, doubled=cfg.doubled)
        check_orientations(assign_orientations_plain(ii, cfg, *kp), got, ws,
                           wa, np.ones(kp[0].shape[0], bool))
        n_checked += kp[0].shape[0]
    assert n_checked > 5000


def test_kernel_d_geometry_on_rounding_edges(cuda_device):
    """Centres at exact halves (round half to even), scales at which
    scale + 0.8 or 2 scale + 1.6 sits on an integer: the kernel's geometry
    must step where `orient_geometry` steps."""
    img = kron_image()
    ii = integral_image(torch.as_tensor(img, device=cuda_device))
    cfg = cst.SurfConfig(upright=False)
    half = np.arange(40, 200, 1.0, dtype=np.float32) + 0.5
    scale = np.float32([1.2, 2.2, 3.2, 2.7, 1.7, 2.1999998, 2.2000003, 3.7])
    x = np.resize(half, 160)
    y = np.resize(half[::-1] * 0.5 + 60, 160).astype(np.float32)
    s = np.resize(scale, 160)
    for a in (x, y):
        a[1::4] = np.nextafter(a[1::4], np.float32(0))
        a[2::4] = np.nextafter(a[2::4], np.float32(1e9))
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    kp = (t(x), t(y), t(s), torch.ones(160, dtype=torch.bool,
                                       device=cuda_device))
    got = assign_orientations(ii, cfg, *kp)
    ws, wa = orientation_windows(ii, *kp)
    check_orientations(assign_orientations_plain(ii, cfg, *kp), got, ws, wa,
                       np.ones(160, bool))
