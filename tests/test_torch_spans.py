"""The port's stage spans (`utils.timing.span`): a shared no-op with no
profiler recording; under torch.profiler each span of `timing.SPANS`
appears under the parent span its stage has, and the outputs equal an
unprofiled run's bit for bit; `SlamPipeline.process` reaches its pair
tracking through `slam.pipeline.track_pair`, which the benchmark wraps."""

import re
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import cuda_surf_tpu_torch as cst
from cuda_surf_tpu_torch.config import VO_CONFIG
from cuda_surf_tpu_torch.io import synth
from cuda_surf_tpu_torch.slam import SlamPipeline
from cuda_surf_tpu_torch.slam import pipeline as pipeline_mod
from cuda_surf_tpu_torch.utils import SPANS, span
from torch_parity import one_torch_thread  # noqa: F401

PKG = Path(cst.__file__).resolve().parent
SMALL = dict(noctaves=3, thresh=4.0, max_pts=256, candidates_per_octave=256)

# (span, the span it opens in) over the calls of the tests below
SURF_SPANS = {("surf.integral", None), ("surf.pyramid", None),
              ("surf.detect", None), ("surf.makepoint", None),
              ("surf.orient", None), ("surf.describe", None),
              ("surf.match", None)}
VO_SPANS = {("vo.process", None), ("vo.track", "vo.process"),
            ("vo.fivepoint", "vo.track"), ("vo.score", "vo.track"),
            ("vo.refit", "vo.track"), ("vo.scale", "vo.process"),
            ("vo.window_ba", "vo.process"), ("surf.match", "vo.track")} | {
    (n, "vo.process") for n in ("surf.integral", "surf.pyramid",
                                "surf.detect", "surf.makepoint",
                                "surf.describe")}


def span_pairs(prof) -> set:
    """{(span name, the name of the innermost span it opened in)}."""
    out = set()
    for e in prof.events():
        if e.name not in SPANS:
            continue
        p = e.cpu_parent
        while p is not None and p.name not in SPANS:
            p = p.cpu_parent
        out.add((e.name, None if p is None else p.name))
    return out


def equal(a, b) -> bool:
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(equal(x, y) for x, y in zip(a, b))
    return a == b


def surf_calls():
    frames, _, _ = synth.render_plane_sequence(n_frames=3, h=96, w=128,
                                               seed=5)
    upright = cst.Surf(cst.SurfConfig(**SMALL), device="cpu")
    rotated = cst.Surf(cst.SurfConfig(**SMALL, upright=False), device="cpu")
    k1, d1 = upright.detect_and_compute(frames[0])
    k2, d2 = upright.detect_and_compute(frames[1])
    kb, db = upright.detect_and_compute_batch(frames)
    return (k1, d1, kb, db, rotated.detect_and_compute(frames[2]),
            upright.match(k1, d1, k2, d2))


def vo_run(frames):
    pipe = SlamPipeline(cst.SurfConfig(**VO_CONFIG), device="cpu",
                        window_ba=2, seed=7)
    return [(st.R, st.t, st.n_inliers) for st in map(pipe.process, frames)]


@pytest.fixture(scope="module")
def vo_frames():
    frames, _, _ = synth.render_plane_sequence(n_frames=3, h=200, w=280,
                                               seed=3)
    return frames


def test_span_is_one_shared_noop_without_a_profiler():
    off = span(SPANS[0])
    for name in SPANS + ("not.a.span",):
        assert span(name) is off
    with off:
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        assert span(SPANS[0]) is not off
        with pytest.raises(ValueError, match="not.a.span"):
            span("not.a.span")


def test_surf_spans_and_outputs_under_the_profiler():
    plain = surf_calls()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = surf_calls()
    assert equal(traced, plain)
    assert span_pairs(prof) == SURF_SPANS


def test_vo_spans_and_outputs_under_the_profiler(vo_frames):
    plain = vo_run(vo_frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = vo_run(vo_frames)
    for (Ra, ta, na), (Rb, tb, nb) in zip(traced, plain):
        assert (Ra == Rb).all() and (ta == tb).all() and na == nb
    assert span_pairs(prof) == VO_SPANS


def test_process_tracks_through_the_module_global(vo_frames, monkeypatch):
    calls = []
    inner = pipeline_mod.track_pair

    def counting(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    monkeypatch.setattr(pipeline_mod, "track_pair", counting)
    vo_run(vo_frames)
    assert len(calls) == len(vo_frames) - 1


def test_every_span_call_names_a_member_of_spans():
    named = []
    for path in PKG.rglob("*.py"):
        for arg in re.findall(r"\bspan\(([^)]*)\)", path.read_text()):
            if path.name == "timing.py" and arg == "name: str":
                continue             # the definition
            m = re.fullmatch(r'"([^"]+)"', arg.strip())
            assert m, f"{path.name}: span({arg}) names no literal"
            named.append(m.group(1))
    assert set(named) <= set(SPANS)
    assert set(named) == set(SPANS)       # and every span is placed
