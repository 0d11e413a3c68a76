"""The stage spans' side of the benchmark (`portbench/spans.py`): the
readers of the stage metrics, the host operations and idle gaps kept as
`trace.run_traced` has them, and tiny traced runs of every cell on the
CPU carrying their spans."""

import json
import math
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from portbench import spans, trace
from portbench.tests.helpers import ROOT, TINY

CELL_SPANS = {
    "surf_demo.pairs": {"surf.integral", "surf.pyramid", "surf.detect",
                        "surf.makepoint", "surf.describe", "surf.match"},
    "vo_tum.orbit": {"vo.process", "vo.track", "vo.fivepoint", "vo.score",
                     "vo.refit", "vo.scale", "vo.window_ba", "surf.integral",
                     "surf.pyramid", "surf.detect", "surf.makepoint",
                     "surf.describe", "surf.match"},
}
CELL_SPANS["surf_demo.batch32"] = CELL_SPANS["surf_demo.pairs"]
HOST_MS = {"surf_demo.pairs": {"detect_glue_ms.pair"},
           "vo_tum.orbit": {"track_ms.vo", "fivepoint_ms.vo",
                            "window_ba_ms.vo"},
           "surf_demo.batch32": set()}


def hand_built(frames=2, with_device=True):
    """Two frames: vo.process [0, 10] holding vo.track [1, 6] holding
    vo.fivepoint [2, 5], then vo.window_ba [7, 9]; surf.detect and
    surf.integral [11, 12] outside; device ops and syncs placed in each."""
    S = spans.Span
    proc = S("vo.process", 0.0, 10.0, None)
    track = S("vo.track", 1.0, 6.0, proc)
    five = S("vo.fivepoint", 2.0, 5.0, track)
    ba = S("vo.window_ba", 7.0, 9.0, proc)
    det = S("surf.detect", 11.0, 11.5, None)
    integ = S("surf.integral", 11.5, 12.0, None)
    under = [five, five, five, track, ba, det, det, integ, None]
    dev = [("k", 2.0 + 0.1 * i, 2.05 + 0.1 * i) for i in range(len(under))]
    if not with_device:
        dev, under = [], []
    return spans.SpanContext(
        dev, [], 12.0, frames, {}, (8, 8), [],
        spans=[proc, track, five, ba, det, integ], device_spans=under,
        syncs=[(five, 2.5), (ba, 7.5), (ba, 8.0), (proc, 9.5), (None, 11)])


def test_readers_on_a_hand_built_context():
    ctx = hand_built()
    got = {n: r(ctx) for n, (r, _, _) in spans.STAGE_METRICS.items()}
    assert got == pytest.approx({
        "detect_glue_ms.pair": 1e3 * 0.5 / 2,
        "detect_glue_ops.pair": 2 / 2,
        "integral_device_ms.surf": 1e3 * 0.05 / 2,
        "track_ms.vo": 1e3 * 5.0 / 2,
        "fivepoint_ms.vo": 1e3 * 3.0 / 2,
        "fivepoint_ops.vo": 3 / 2,
        "window_ba_ms.vo": 1e3 * 2.0 / 2,
        "host_syncs.vo": 4 / 2})
    assert ctx.span_device_ops("vo.track") == 4       # its child's too
    assert spans.stage_metrics(ctx, "surf_demo.pairs").keys() == {
        "detect_glue_ms.pair", "detect_glue_ops.pair"}
    # nothing to read: the accepted context, no frames, no device events
    plain = trace.TraceContext([], [], 1.0, 2, {}, (8, 8), [])
    cpu = hand_built(with_device=False)
    for name, (read, _, _) in spans.STAGE_METRICS.items():
        assert read(plain) is None and read(hand_built(frames=0)) is None
        assert (read(cpu) is None) == (name not in (
            "detect_glue_ms.pair", "track_ms.vo", "fivepoint_ms.vo",
            "window_ba_ms.vo"))


def without_spans(events):
    """The events as the profiler would give them had no span or root
    range been open: each remaining event's parent is its nearest
    ancestor that is neither."""
    gone = set(spans.SPANS) | {spans.ROOT}
    proxy = {}

    def of(e):
        while e is not None and e.name in gone:
            e = e.cpu_parent
        if e is None:
            return None
        if id(e) not in proxy:
            proxy[id(e)] = types.SimpleNamespace(
                name=e.name, time_range=e.time_range,
                device_type=e.device_type, cpu_parent=of(e.cpu_parent))
        return proxy[id(e)]

    return [p for p in map(of, events) if p is not None]


def test_host_ops_and_idle_gaps_as_without_spans():
    import cuda_surf_tpu_torch as lib
    from torch._C._profiler import _RecordFunctionFast

    from portbench import traffic
    tiny, cpu = TINY["surf_demo.pairs"], torch.device("cpu")
    cfg = json.loads((ROOT / "portbench/configs/surf_demo.json").read_text())
    cfg = {k: dict(cfg[k], **tiny[k]) for k in ("frame", "surf")}
    mix = dict(traffic.load_mix("pairs"), **tiny["mix"])
    inputs = traffic.make_inputs(mix, cfg["frame"], 3, cpu)
    call = traffic.part("forms", "pair").Requests(lib, cfg, inputs, cpu)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for i in range(2):
            with _RecordFunctionFast(spans.ROOT):
                call(i)
    events = prof.events()
    ctx = spans.collect(events, 1.0, 4, cfg, (96, 128), [])
    assert {s.name for s in ctx.spans} == CELL_SPANS["surf_demo.pairs"]
    plain = sorted([(e.name, e.time_range.start * 1e-6,
                     e.time_range.end * 1e-6) for e in without_spans(events)
                    if e.device_type != DeviceType.CUDA
                    and e.cpu_parent is None], key=lambda r: r[1])
    assert ctx.host_ops == plain and plain
    before = trace.TraceContext([], plain, 1.0, 4, cfg, (96, 128), [])
    t0 = spans.t_first(ctx)
    assert trace.idle_gaps(ctx, t0, t0 + 1.0) == trace.idle_gaps(
        before, t0, t0 + 1.0)


@pytest.mark.parametrize("cell", sorted(CELL_SPANS))
def test_traced_cpu_run_carries_its_spans(cell):
    line = spans.traced_line(cell, 2 ** 31 + 17, 2.0, device="cpu",
                             root=ROOT, overrides=TINY[cell],
                             log=lambda *a, **k: None)
    rows = line["breakdown"]["spans"]
    assert set(rows) - {spans.NO_SPAN} == CELL_SPANS[cell]
    assert line["breakdown"]["idle_gaps_by_span"]
    assert set(line["stage_metrics"]) == HOST_MS[cell]    # no device here
    for m in line["stage_metrics"].values():
        assert math.isfinite(m["value"]) and m["value"] > 0
