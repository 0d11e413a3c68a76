"""Kernel F's cached plan (ops/extrema.extrema_plan) and the device
dispatch of `ops.extrema.detect`, on the CPU.

The CUDA kernel cannot run here, so what it reads is held instead: the
packed plan's octave rows, walk borders and stencil against the tables
the twin `_detect_plain` builds on every call (`_tables`) and against the
schedule itself, and the chunk grid, walked as csrc/extrema.cu walks it,
against the frame-major candidate order, at the main, VO and doubled
shapes and for stacks of 1 and 8 frames.  A CPU tensor takes the twin.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch import _build
from cuda_surf_tpu_torch.config import DOUBLED_CONFIG, MAIN_CONFIG, VO_CONFIG
from cuda_surf_tpu_torch.ops import extrema
from cuda_surf_tpu_torch.ops.extrema import (_FIT_OFFSETS, _detect_plain,
                                             _tables, detect, extrema_plan)
from cuda_surf_tpu_torch.ops.fused_detect import fused_pyramid
from cuda_surf_tpu_torch.ops.integral import integral_image
from torch_parity import kron_image

SHAPES = {"main": (MAIN_CONFIG, 960, 1280), "vo": (VO_CONFIG, 480, 640),
          "doubled": (DOUBLED_CONFIG, 960, 1280)}


def _chunks(tab, nframes):
    """(frame, octave, first element, end) of every block of the count and
    place launches, decoded from the plan as the kernel decodes it."""
    noct, nch_f = tab[0], tab[3]
    chunk = tab[6]
    rows = tab[extrema.PLAN_HEADER:][:noct * extrema.OCT_INTS].reshape(
        noct, extrema.OCT_INTS)
    out = []
    for g in range(nframes * nch_f):
        b, j = divmod(g, nch_f)
        o = noct - 1
        while o > 0 and rows[o, 6] > j:
            o -= 1
        e0 = (j - rows[o, 6]) * chunk
        out.append((b, o, e0, min(e0 + chunk, rows[o, 3])))
    return out


@pytest.mark.parametrize("name", list(SHAPES))
def test_plan_tables_are_the_twins(name):
    config, h, w = SHAPES[name]
    cfg = cst.SurfConfig(**config)
    scheds = cfg.hessian_schedule(h, w)
    shapes = tuple((cfg.max_scale, oh, ow)
                   for oh, ow in cfg.octave_shapes(h, w))
    borders = tuple(s.borders for s in scheds)
    octaves = tuple(s.octave for s in scheds)
    octab, btab, stencil = _tables(shapes, borders, octaves)
    sizes = [ms * oh * ow for ms, oh, ow in shapes]
    # the twin's tables, from the schedule
    assert octab.tolist() == [[oh for _, oh, _ in shapes],
                              [ow for *_, ow in shapes],
                              np.cumsum([0] + sizes)[:-1].tolist(),
                              [2 ** o for o in range(cfg.noctaves)]]
    assert btab.tolist() == [b for s in scheds for b in s.borders]
    assert stencil.T.tolist() == [list(o) for o in _FIT_OFFSETS]
    for B in (1, 8):
        plan = extrema_plan(shapes, borders, octaves, B, "cpu")
        assert extrema_plan(shapes, borders, octaves, B, "cpu") is plan
        tab = plan.dev.numpy()
        assert tab.dtype == np.int32 and np.array_equal(tab, plan.table)
        noct, ms_p = cfg.noctaves, cfg.max_scale
        chunks = [-(-n // extrema.CHUNK) for n in sizes]
        assert tab[:extrema.PLAN_HEADER].tolist() == [
            noct, B, sum(sizes), sum(chunks), ms_p, 19, extrema.CHUNK, 0]
        rows = tab[extrema.PLAN_HEADER:][:noct * extrema.OCT_INTS].reshape(
            noct, extrema.OCT_INTS)
        assert rows[:, [0, 1, 4, 5]].T.tolist() == octab.tolist()
        assert rows[:, 2].tolist() == [cfg.max_scale] * noct
        assert rows[:, 3].tolist() == sizes
        assert rows[:, 6].tolist() == np.cumsum([0] + chunks)[:-1].tolist()
        rest = tab[extrema.PLAN_HEADER + noct * extrema.OCT_INTS:]
        assert rest[:noct * ms_p].tolist() == btab.tolist()
        assert rest[noct * ms_p:].tolist() == stencil.reshape(-1).tolist()
        assert plan.nchunks == B * sum(chunks)
        # the chunks tile the stack in frame-major, octave-major order
        flat = [b * sum(sizes) + octab[2, o] + np.arange(e0, e1)
                for b, o, e0, e1 in _chunks(tab, B)]
        assert np.array_equal(np.concatenate(flat),
                              np.arange(B * sum(sizes)))


def test_plan_constants_are_the_kernels():
    src = (Path(extrema.__file__).parents[1] / "csrc"
           / "extrema.cu").read_text()
    const = lambda name: int(re.search(rf"constexpr int {name} = (\d+);",
                                       src).group(1))
    assert const("F_CHUNK") == extrema.CHUNK
    assert const("F_HEADER") == extrema.PLAN_HEADER
    assert const("F_OCT_INTS") == extrema.OCT_INTS
    assert const("F_MAX_OCT") == extrema.MAX_OCTAVES
    assert const("F_MAX_MS") == extrema.MAX_SCALES
    assert const("F_NFIT") == len(_FIT_OFFSETS)


@pytest.mark.parametrize("nframes", [1, 2])
def test_cpu_tensors_take_the_twin(nframes):
    """No launch is counted, the outputs are the twin's, and `walkers`
    counts the step-1 movers inside the capacity."""
    img = kron_image()
    cfg = cst.SurfConfig(noctaves=4, max_pts=1024)
    h, w = img.shape
    ii = integral_image(torch.as_tensor(img))
    if nframes > 1:
        ii = torch.stack([ii, ii.flip(1)])
    pyr, masks = fused_pyramid(ii, cfg, h, w)
    scheds = cfg.hessian_schedule(h, w)
    before = _build.launch_counts["surf_extrema"]
    got = detect(pyr, scheds, cfg, masks, nframes=nframes)
    want = _detect_plain(pyr, scheds, cfg, masks, nframes=nframes)
    assert _build.launch_counts["surf_extrema"] == before
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert got["walkers"].dtype == torch.int32 and got["walkers"].ndim == 0
    assert 0 < int(got["walkers"]) < int(got["count"])
    with pytest.raises(ValueError):
        detect([p.to("meta") for p in pyr], scheds, cfg,
               [m.to("meta") for m in masks], nframes=nframes)
