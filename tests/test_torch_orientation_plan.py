"""Kernel D's plan on the CPU.

Kernel D (csrc/orient.cu) itself runs only on a card; its plan (the
253-position table, warp-wise stable ranks, per-bin runs, sequential
float32 adds, first maximum) is walked in numpy by
`torch_parity.emulate_kernel_d` and held bit for bit to a plain per-bin
loop over the samples in index order, within 1e-4 rad off the near ties to
the twin `assign_orientations_plain`, and at the same tolerance to the JAX
package's `assign_orientations` (tests/test_torch_orientation.py states
it).  The literal table in the source is held to the disc.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cuda_surf_tpu import SurfConfig as JaxConfig
from cuda_surf_tpu.ops.integral import integral_image as jax_integral
from cuda_surf_tpu.ops.orientation import assign_orientations as jax_orient

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.ops.integral import integral_image
from cuda_surf_tpu_torch.ops.orientation import (disc_positions, disc_samples,
                                                 orient_geometry, tables)
from test_torch_orientation import _port, tie_scene
from torch_parity import check_orientations, emulate_kernel_d


def test_kernel_d_table_is_the_disc():
    """The literal table DISC_Q of csrc/orient.cu: the 253 grid positions
    within the radius, increasing, zero padded to whole rounds of 32."""
    src = (Path(cst.__file__).parent / "csrc" / "orient.cu").read_text()
    body = re.search(r"DISC_Q\[[^\]]*\] = \{([^}]*)\}", src).group(1)
    table = np.array([int(v) for v in re.findall(r"\d+", body)])
    want = disc_positions()
    assert want.shape == (253,) and (np.diff(want) > 0).all()
    np.testing.assert_array_equal(table, want)
    assert int(re.search(r"#define OR_DISC (\d+)", src).group(1)) == 253


def _emulated(scene):
    img, x, y, scale, valid = scene
    t = torch.as_tensor
    ii = integral_image(t(img))
    args = (t(x), t(y), t(scale), t(valid))
    return ii, args, emulate_kernel_d(ii, *args)


def test_kernel_d_plan_sums_each_bin_in_sample_order():
    """The sorted runs of the kernel's plan give, bit for bit, the sums of
    a plain loop over each bin's samples in increasing sample index."""
    ii, args, (_, sums, counts) = _emulated(tie_scene())
    ok, hid, angle, psum = (a.numpy() for a in disc_samples(
        ii, tables(ii.device)["lut"], *orient_geometry(*args[:3]), args[3]))
    f32 = np.float32
    n_live = 0
    for k in np.flatnonzero(args[3].numpy()):
        want = np.zeros((72, 3), f32)
        n = np.zeros(72, np.int64)
        for q in np.flatnonzero(ok[k]):          # increasing sample index
            b = hid[k, q]
            a, p = angle[k, q], psum[k, q]
            want[b] = (f32(want[b, 0] + a), f32(want[b, 1] + p),
                       f32(want[b, 2] + f32(a * p)))
            n[b] += 1
        np.testing.assert_array_equal(counts[k], n)
        np.testing.assert_array_equal(sums[k].view(np.int32),
                                      want.view(np.int32))
        n_live += int(n.sum())
    assert n_live > 20 * 150 and counts.max() >= 8   # runs longer than a lane


def test_kernel_d_plan_matches_twin():
    scene = tie_scene()
    ii, args, (got, _, _) = _emulated(scene)
    plain, ws, wa = _port(*scene)
    near = check_orientations(plain, got, ws, wa, scene[4])
    assert near[-1] and (scene[4] & ~near).sum() >= 15
    assert (got[~scene[4]] == 0).all()


def test_kernel_d_plan_matches_jax():
    scene = tie_scene()
    img, x, y, scale, valid = scene
    cfg_j = JaxConfig(noctaves=4, upright=False, max_pts=x.size,
                      wavelet_method="gather")
    ref = np.asarray(jax.jit(lambda *a: jax_orient(
        jax_integral(jnp.asarray(img)), cfg_j, *a))(
        *(jnp.asarray(a) for a in (x, y, scale, valid))))
    _, _, (got, _, _) = _emulated(scene)
    _, ws, wa = _port(*scene)
    check_orientations(ref, got, ws, wa, valid)
