"""Kernel C's pair dimension and merge rule on the CPU.

A leading pair dimension on `fused_best2` / `_best2_plain` must give each
pair's own result exactly (P = 1, 3; ragged validity; one set 2 all
invalid).  Kernel C's merge rule (`torch_parity.merge_top2`, a copy of
csrc/match.cu's) is held to `_best2_plain` under any split of the columns,
merged in any order, exact ties and -1e30 columns included.  The planned
number of splits stays within what the kernel takes.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from cuda_surf_tpu_torch.ops.matcher_kernel import (MAX_SPLITS, _best2_plain,
                                                    fused_best2, plan_splits)
from torch_parity import fold_top2, match_sets, merge_top2


def pair_sets(P):
    """P pairs from match_sets(): pair p's sets rolled by p rows, with
    ragged validity, and set 2 of the last of several pairs all invalid.
    -> (d1 (P, 100, 64), d2 (P, 130, 64), valid1 (P, 100), valid2 (P, 130))."""
    d1, d2, valid1, valid2 = match_sets()
    rng = np.random.default_rng(P)
    out = [], [], [], []
    for p in range(P):
        v2 = np.roll(valid2, 7 * p) & (rng.random(valid2.shape) < 0.9 - 0.2 * p)
        if p and p == P - 1:
            v2[:] = False
        for lst, a in zip(out, (np.roll(d1, p, 0), np.roll(d2, 3 * p, 0),
                                np.roll(valid1, p), v2)):
            lst.append(a)
    return tuple(np.stack(a) for a in out)


@pytest.mark.parametrize("P", [1, 3])
@pytest.mark.parametrize("fn", [fused_best2, _best2_plain],
                         ids=["fused_best2", "plain"])
def test_pair_dimension_equals_per_pair_calls(fn, P):
    d1, d2, _, valid2 = (torch.as_tensor(a) for a in pair_sets(P))
    best, second, index = fn(d1, d2, valid2)
    assert best.shape == second.shape == index.shape == (P, d1.shape[1])
    assert index.dtype == torch.int32
    for p in range(P):
        b, s, i = fn(d1[p], d2[p], valid2[p])
        assert torch.equal(best[p], b) and torch.equal(second[p], s)
        assert torch.equal(index[p], i)
    if P > 1:      # the all-invalid set 2
        assert (best[-1] == -1e30).all() and (second[-1] == -1e30).all()
        assert (index[-1] == 0).all()
        assert (best[0] > -1e30).all()


@settings(max_examples=60, deadline=None)
@given(st.data())
def test_merge_rule_any_splits_any_order(data):
    """Kernel C's plan on one score row: every split folds its columns in
    increasing order, the partial top-2s merge in an arbitrary order, and
    the result is `_best2_plain`'s, exact ties and -1e30 columns included."""
    n = data.draw(st.integers(1, 40), label="columns")
    # few distinct values, so that ties are common
    vals = data.draw(st.lists(st.sampled_from([-1e30, -0.5, 0.0, 0.25, 0.25,
                                               0.75, 1.0]),
                              min_size=n, max_size=n), label="scores")
    scores = np.asarray(vals, np.float32)
    splits = data.draw(st.integers(1, min(n, MAX_SPLITS)), label="splits")
    owner = data.draw(st.lists(st.integers(0, splits - 1), min_size=n,
                               max_size=n), label="owner")
    parts = [fold_top2(scores, [c for c in range(n) if owner[c] == s])
             for s in range(splits)]
    order = data.draw(st.permutations(range(splits)), label="order")
    acc = parts[order[0]]
    for s in order[1:]:
        acc = merge_top2(acc, parts[s])
    valid = scores > -1e30
    b, s_, i = _best2_plain(torch.zeros(1, 1), torch.zeros(n, 1),
                            torch.as_tensor(valid),
                            scores=torch.as_tensor(scores)[None])
    assert acc == (b.item(), s_.item(), i.item())


def test_plan_splits_fills_the_card_and_no_more():
    assert plan_splits(1, 4096, 4096, 132) == 4      # 32 row blocks x 4
    assert plan_splits(7, 4096, 4096, 132) <= 4      # 224 row blocks
    assert plan_splits(64, 4096, 4096, 132) == 1     # row blocks fill it
    assert plan_splits(1, 63, 1, 132) == 1           # one tile: nothing to split
    for p, n1, n2 in ((1, 100, 130), (3, 4224, 300), (1, 5000, 100000)):
        assert 1 <= plan_splits(p, n1, n2, 132) <= min(MAX_SPLITS,
                                                       -(-n2 // 128))
