"""Kernel C on the card: the pair dimension and the splits against the
plain twin.

Marked `cuda`; skips without a GPU; imports no jax and runs without
tests/conftest.py, with the other card tests:

    python -m pytest --noconftest -q tests/test_torch_cuda*.py

Scores within 1e-5 of the twin, indices equal wherever best - second >=
1e-5, P pairs in one launch equal bit for bit to P launches of one pair,
any number of splits the same bits, exact ties to the smaller index.
"""

import numpy as np
import pytest
import torch

from cuda_surf_tpu_torch import _build
from cuda_surf_tpu_torch.ops import matcher_kernel
from cuda_surf_tpu_torch.ops.matcher_kernel import _best2_plain, fused_best2
from torch_parity import cuda_device, unit_rows  # noqa: F401

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("depth", [64, 128])
def test_kernel_c_pairs_in_one_launch(cuda_device, monkeypatch, depth):
    """P = 7 pairs of 4096 x 4096 in one launch: equal bit for bit to seven
    launches of one pair, within 1e-5 of the twin, the same bits whatever
    the number of splits; one pair's set 2 is all invalid."""
    P, n = 7, 4096
    rng = np.random.default_rng(depth)
    d1 = unit_rows(rng.normal(size=(P * n, depth))).reshape(P, n, depth)
    d2 = unit_rows(rng.normal(size=(P * n, depth))).reshape(P, n, depth)
    d2[:, 1::9] = d2[:, ::9][:, :d2[:, 1::9].shape[1]]   # duplicate columns
    valid2 = rng.random((P, n)) < 0.9
    valid2[3] = False
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    d1, d2, valid2 = t(d1), t(d2), t(valid2)
    before = _build.launch_counts["surf_best2"]
    out = fused_best2(d1, d2, valid2)
    torch.cuda.synchronize()
    assert _build.launch_counts["surf_best2"] == before + 1
    bp, sp, ip = _best2_plain(d1, d2, valid2)
    assert (out[0] - bp).abs().max().item() <= 1e-5
    assert (out[1] - sp).abs().max().item() <= 1e-5
    clear = (bp - sp) >= 1e-5
    assert clear.sum().item() > 6 * 3000
    assert torch.equal(out[2][clear], ip[clear])
    assert (out[0][3] == -1e30).all() and (out[2][3] == 0).all()
    for p in range(P):
        single = fused_best2(d1[p], d2[p], valid2[p])
        assert all(torch.equal(a[p], b) for a, b in zip(out, single)), p
    for splits in (1, 3, 8):
        monkeypatch.setattr(matcher_kernel, "plan_splits", lambda *a: splits)
        again = fused_best2(d1, d2, valid2)
        assert all(torch.equal(a, b) for a, b in zip(out, again)), splits


@pytest.mark.parametrize("n1,n2", [(100, 130), (4224, 300)])
def test_kernel_c_any_splits_match_twin(cuda_device, monkeypatch, n1, n2):
    """Ragged sizes (a last split that is short or empty) under every
    number of splits: the twin's scores, and the same bits as the planned
    launch."""
    rng = np.random.default_rng(n1)
    d1 = unit_rows(rng.normal(size=(n1, 64)))
    d2 = unit_rows(rng.normal(size=(n2, 64)))
    d2[1::7] = d2[::7][:d2[1::7].shape[0]]
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    d1, d2, valid2 = t(d1), t(d2), t(rng.random(n2) < 0.9)
    bk, sk, ik = fused_best2(d1, d2, valid2)
    for splits in range(1, 9):
        monkeypatch.setattr(matcher_kernel, "plan_splits", lambda *a: splits)
        again = fused_best2(d1, d2, valid2)
        assert all(torch.equal(a, b) for a, b in zip((bk, sk, ik), again))
    bp, sp, ip = _best2_plain(d1, d2, valid2)
    assert (bk - bp).abs().max().item() <= 1e-5
    assert (sk - sp).abs().max().item() <= 1e-5
    clear = (bp - sp) >= 1e-5
    assert torch.equal(ik[clear], ip[clear])
    tied = valid2[ik.long()] & valid2[(ik.long() - 1).clamp(min=0)] \
        & (ik % 7 == 1)
    assert not tied.any()       # a duplicate's first column wins the tie


def test_kernel_c_recovers_from_spoilt_counters(cuda_device):
    """Whatever an earlier launch left in the splits' merge counters (here:
    overwritten by hand, with small counts, with the number of the launch
    before and with all bits set) does not change the next one's answer."""
    rng = np.random.default_rng(5)
    t = lambda a: torch.as_tensor(a, device=cuda_device)
    d1 = t(unit_rows(rng.normal(size=(4096, 64))))
    d2 = t(unit_rows(rng.normal(size=(4096, 64))))
    valid2 = t(rng.random(4096) < 0.9)
    first = fused_best2(d1, d2, valid2)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    splits = matcher_kernel.plan_splits(1, 4096, 4096, sms)
    assert splits > 1
    done = matcher_kernel._scratch(
        torch.cuda.current_stream(cuda_device), 1, 4096, splits)[3]
    for spoilt in (3, None, -1):
        if spoilt is None:       # the launch before, one arrival short
            done.copy_(done - 1)
        else:
            done.fill_(spoilt)
        again = fused_best2(d1, d2, valid2)
        assert all(torch.equal(a, b) for a, b in zip(first, again)), spoilt
