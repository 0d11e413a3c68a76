"""Kernel G (csrc/integral.cu), the integral image of a frame or a
(B, H, W) stack, against its plain twin `_integral_plain` on the card.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

The sums are integers, so G equals the twin bit for bit: on 1280x960 and
640x480 frames and a stack of 32 1280x960 frames; on shapes whose width is
no multiple of 16 (the byte-load path), with one row or one column; at
every band length from one row to the whole frame; and on all-255 frames
at the doubled grid's size (the int32 ceiling).  Doubled mode, G's own
passes over the 2x upsampled grid, equals the twin's upsample and sums the
same way: on the 1280x960 frame, a stack of 32, odd and unaligned widths,
every band length, and all-255 frames.  One call is one count of
`surf_integral` (doubled: `surf_integral_doubled`) on
`_build.launch_counts`, whatever B: at most three device operations, all
G's kernels (the doubled ones named so), and no host synchronisation.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity

from cuda_surf_tpu_torch import _build
from cuda_surf_tpu_torch.ops.integral import (_integral_cuda, _integral_plain,
                                              integral_image)
from torch_parity import cuda_device  # noqa: F401

pytestmark = pytest.mark.cuda


def _frames(shape, seed, dev):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, 256, shape, np.uint8), device=dev)


def _check(img, doubled=False):
    got = integral_image(img, doubled)
    want = _integral_plain(img, doubled)
    assert got.dtype == torch.int32 and got.shape == want.shape
    bad = (got != want).nonzero()
    assert bad.numel() == 0, (tuple(img.shape), doubled, bad[:8].tolist())
    return got


@pytest.mark.parametrize("shape", [(960, 1280), (480, 640), (32, 960, 1280)])
def test_kernel_g_equals_twin(cuda_device, shape):
    """The benchmark's frames, the VO frame, batch32's stack; each frame of
    the stack also equals its own call."""
    img = _frames(shape, 1, cuda_device)
    got = _check(img)
    if img.ndim == 3:
        for f in (0, 17, 31):
            assert torch.equal(got[f], integral_image(img[f]))


def test_kernel_g_edge_shapes_and_band_lengths(cuda_device):
    """Widths that are no multiple of 16, one row or one column, a stack
    whose frames start off 16-byte alignment; then every band length of
    kernel G, from one row a band to one band a frame."""
    for shape in [(1, 1), (7, 13), (1, 4097), (4097, 1), (241, 333),
                  (3, 7, 13), (5, 241, 333), (2, 17, 1280)]:
        _check(_frames(shape, sum(shape), cuda_device))
    # a width of 1280 whose rows start one byte off 16-byte alignment
    _check(_frames((1 + 17 * 1280,), 9, cuda_device)[1:].view(17, 1280))
    img = _frames((3, 241, 336), 7, cuda_device)
    want = _integral_plain(img)
    for rows in (1, 2, 3, 8, 29, 240, 241, 1000):
        got = _integral_cuda(img, rows)
        assert torch.equal(got, want), rows
    assert torch.equal(_integral_cuda(img[1], 5)[0], want[1])


def test_kernel_g_doubled_path_and_int32_ceiling(cuda_device):
    """G's doubled passes against the twin's upsample and sums: the
    1280x960 frame, a stack of 32 (each frame also equal to its own call),
    widths that are no multiple of 8 or 16, one row or one column, frames
    off 8-byte alignment, every band length over the doubled grid; all-255
    frames at the doubled grid's size, 1919x2559 (the last sum 255 * 1919
    * 2559 = 1,252,276,455), directly and through the doubled path, on a
    frame and a stack."""
    _check(_frames((960, 1280), 3, cuda_device), doubled=True)
    stack = _frames((32, 960, 1280), 4, cuda_device)
    got = _check(stack, doubled=True)
    for f in (0, 13, 31):
        assert torch.equal(got[f], integral_image(stack[f], True))
    for shape in [(1, 1), (2, 2), (7, 13), (1, 4097), (4097, 1),
                  (241, 333), (3, 7, 13), (5, 241, 333), (2, 17, 1288)]:
        _check(_frames(shape, sum(shape), cuda_device), doubled=True)
    # a width of 1280 whose rows start one byte off 8-byte alignment
    _check(_frames((1 + 9 * 1280,), 8, cuda_device)[1:].view(9, 1280),
           doubled=True)
    img = _frames((3, 121, 168), 7, cuda_device)
    want = _integral_plain(img, True)
    for rows in (1, 2, 3, 8, 29, 240, 241, 1000):
        got = _integral_cuda(img, rows, doubled=True)
        assert torch.equal(got, want), rows
    assert torch.equal(_integral_cuda(img[1], 5, doubled=True)[0], want[1])
    full = torch.full((1919, 2559), 255, dtype=torch.uint8,
                      device=cuda_device)
    assert int(_check(full)[-1, -1]) == 255 * 1919 * 2559
    white = torch.full((2, 960, 1280), 255, dtype=torch.uint8,
                       device=cuda_device)
    ii = _check(white, doubled=True)
    assert ii[:, -1, -1].tolist() == [255 * 1919 * 2559] * 2


def test_kernel_g_launches_sync_and_refusals(cuda_device):
    """One call: one count of `surf_integral` (doubled:
    `surf_integral_doubled`) and one call of the kernel library, whatever
    B, no other launch and no host synchronisation.  A wrong dtype, rank,
    device or layout raises."""
    for shape in [(960, 1280), (32, 960, 1280)]:
        for doubled in (False, True):
            img = _frames(shape, 5, cuda_device)
            integral_image(img, doubled)              # built and loaded
            torch.cuda.synchronize()
            entry = "surf_integral_doubled" if doubled else "surf_integral"
            before = _build.launch_counts.copy()
            with _build.record_launches() as rec:
                torch.cuda.set_sync_debug_mode("error")
                try:
                    integral_image(img, doubled)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            assert _build.launch_counts - before == {entry: 1}
            assert [name for name, *_ in rec] == [entry]
            with torch.profiler.profile(activities=[
                    ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                integral_image(img, doubled)
                torch.cuda.synchronize()
            ops = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
            assert 1 <= len(ops) <= 3 and all(
                ("integral_doubled_" in n) == doubled and "integral_" in n
                for n in ops), ops

    before = _build.launch_counts["surf_integral"]
    img = _frames((48, 64), 6, cuda_device)
    bad = [img.to(torch.int32), img.float(), img[0], img[None, None],
           img[:0], img.t(), img.to("meta")]
    for b in bad:
        with pytest.raises(ValueError):
            integral_image(b)
    assert _build.launch_counts["surf_integral"] == before
