"""The program's stage spans in a traced block, and the per-stage metrics
that read them.

The port opens a span (`cuda_surf_tpu_torch.utils.timing.span`, one of
`timing.SPANS`) at each stage boundary of its frontend and its VO
pipeline.  Under torch.profiler a span is a host range on the profiler's
clock.  `run_traced` here profiles a block of requests as
`trace.run_traced` does, each request under one root range
(`portbench.request`), and then puts each device operation, each
synchronising runtime call and each idle gap of the device under the
innermost span open when it was launched, made or began:

- a device operation: the host event that launched it (the profiler's
  link from the kernel to its operator, else the runtime call with the
  kernel's correlation id), then that event's chain of parents; where no
  chain reaches a span, the span open at the launch's time on the host;
- a sync (`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
  `cudaEventSynchronize`, a blocking `cudaMemcpy*`): the same way;
- an idle gap (the block's gaps, as `trace.idle_gaps` finds them): the
  span open at the gap's middle.

The context it returns is a `trace.TraceContext` whose `host_ops` keep
their meaning (the outermost host events that are neither a span nor the
root) and whose `device_ops` hold no profiler annotation, plus the spans
and these attributions.  The breakdown gains `spans` and
`idle_gaps_by_span`; `STAGE_METRICS` reads the per-frame stage numbers.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs one cell as `python3 -m portbench.run ... --trace 1` does, with
this `run_traced` in place of `trace.run_traced`, and prints its result
line with the stage metrics under `stage_metrics`.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import json
import re
import sys
import time

from cuda_surf_tpu_torch.utils import timing

# (): a program without spans, whose traced block then reads as before
SPANS = getattr(timing, "SPANS", ())

from .trace import TraceContext, idle_gaps

ROOT = "portbench.request"
NO_SPAN = "(no span)"
_RUNTIME = re.compile(r"cu(da)?[A-Z]")
_SYNCS = {"cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize", "cuStreamSynchronize", "cuCtxSynchronize",
          "cuEventSynchronize"}


def _is_sync(name: str) -> bool:
    """A runtime call that makes the host wait for the device."""
    return name in _SYNCS or (name.startswith("cudaMemcpy")
                              and "Async" not in name)


@dataclasses.dataclass
class Span:
    name: str
    start: float              # profiler clock, s
    end: float
    parent: "Span | None"     # the innermost span it opened in

    @property
    def path(self) -> tuple:
        """The names from the outermost span down to this one."""
        return (self.parent.path if self.parent else ()) + (self.name,)


@dataclasses.dataclass
class SpanContext(TraceContext):
    spans: list = dataclasses.field(default_factory=list)    # [Span] by start
    device_spans: list = dataclasses.field(default_factory=list)
    #   [Span | None] aligned with device_ops
    syncs: list = dataclasses.field(default_factory=list)    # [(Span|None, t)]
    gaps: list = dataclasses.field(default_factory=list)     # [(Span|None, s)]

    def calls(self, name: str) -> int:
        return sum(s.name == name for s in self.spans)

    def span_seconds(self, name: str) -> float:
        """Host time inside `name`'s spans."""
        return sum(s.end - s.start for s in self.spans if s.name == name)

    def _under(self, sp, name: str) -> bool:
        return sp is not None and name in sp.path

    def span_device_ops(self, name: str) -> int:
        """Device operations launched inside `name`, its children's too."""
        return sum(self._under(sp, name) for sp in self.device_spans)

    def span_device_seconds(self, name: str) -> float:
        return sum(e - s for (_, s, e), sp in zip(self.device_ops,
                                                  self.device_spans)
                   if self._under(sp, name))

    def span_syncs(self, name: str) -> int:
        """Synchronising runtime calls made inside `name`."""
        return sum(self._under(sp, name) for sp, _ in self.syncs)


class _Spans:
    """The spans of one event list, and the innermost one open at a host
    event or at a time on the host."""

    def __init__(self, cpu_events):
        self.of = {}                 # id(host event) -> Span | None
        spans = sorted((e for e in cpu_events if e.name in SPANS),
                       key=lambda e: e.time_range.start)
        self.spans = []
        for e in spans:
            sp = Span(e.name, e.time_range.start * 1e-6,
                      e.time_range.end * 1e-6, self.at_event(e.cpu_parent))
            self.of[id(e)] = sp
            self.spans.append(sp)
        self.starts = [s.start for s in self.spans]

    def at_event(self, e):
        chain, sp = [], None
        while e is not None:
            if id(e) in self.of:
                sp = self.of[id(e)]
                break
            chain.append(id(e))
            e = e.cpu_parent
        for k in chain:
            self.of[k] = sp
        return sp

    def at_time(self, t: float):
        k = bisect.bisect_right(self.starts, t) - 1
        sp = self.spans[k] if k >= 0 else None
        while sp is not None and sp.end < t:
            sp = sp.parent
        return sp

    def of_launch(self, e):
        """The span open where the host event `e` ran: its chain of
        parents, else its time."""
        sp = self.at_event(e)
        return sp if sp is not None else self.at_time(e.time_range.start
                                                      * 1e-6)


def _idle_intervals(device_ops, t0: float, t1: float):
    gaps, end = [], t0
    for _, s, e in device_ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def collect(events, window_s: float, frames: int, cfg: dict, frame_hw,
            described) -> SpanContext:
    """A SpanContext from torch.profiler's `events()` of a traced block."""
    from torch.autograd import DeviceType
    dev_events, cpu = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                dev_events.append(e)
        else:
            cpu.append(e)
    sp = _Spans(cpu)
    transparent = set(SPANS) | {ROOT}
    host, ops, launches, syncs = [], {}, {}, []
    for e in cpu:
        if _RUNTIME.match(e.name):     # correlation ids of the runtime
            launches[e.id] = e
            if _is_sync(e.name):
                syncs.append((sp.of_launch(e), e.time_range.start * 1e-6))
        else:                          # an operator's (or a span's) own
            ops[e.id] = e
        if e.name in transparent:
            continue
        p = e.cpu_parent
        while p is not None and p.name in transparent:
            p = p.cpu_parent
        if p is None:
            host.append((e.name, e.time_range.start * 1e-6,
                         e.time_range.end * 1e-6))
    dev = []
    for d in dev_events:
        link = getattr(d, "linked_correlation_id", 0)
        by = ops.get(link) if link else None
        if by is None:
            by = launches.get(d.id)
        dev.append((d.name, d.time_range.start * 1e-6,
                    d.time_range.end * 1e-6,
                    sp.of_launch(by) if by is not None else None))
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    ctx = SpanContext([r[:3] for r in dev], host, window_s, frames, cfg,
                      tuple(frame_hw), described, spans=sp.spans,
                      device_spans=[r[3] for r in dev], syncs=syncs)
    t0 = t_first(ctx)
    ctx.gaps = [(sp.at_time(0.5 * (a + b)), b - a)
                for a, b in _idle_intervals(ctx.device_ops, t0, t0 + window_s)]
    return ctx


def t_first(ctx) -> float:
    """The block's start on the profiler's clock, as `trace.run_traced`
    takes it for the idle gaps."""
    return min([s for _, s, _ in ctx.host_ops + ctx.device_ops], default=0.0)


def span_breakdown(ctx: SpanContext) -> dict:
    """`spans`: each span's calls, host seconds (inclusive and its own,
    less its child spans), and the device operations, device seconds,
    syncs and idle seconds put under it as the innermost span (so each
    column sums to the block's, the `(no span)` row included);
    `idle_gaps_by_span`: the ten spans with the most idle time."""
    rows = collections.defaultdict(lambda: {
        "parent": None, "calls": 0, "host_s": 0.0, "self_s": 0.0,
        "device_ops": 0, "device_s": 0.0, "syncs": 0, "idle_s": 0.0})
    for s in ctx.spans:
        r = rows[s.name]
        r["parent"] = s.parent.name if s.parent else None
        r["calls"] += 1
        r["host_s"] += s.end - s.start
        r["self_s"] += s.end - s.start
        if s.parent is not None:
            rows[s.parent.name]["self_s"] -= s.end - s.start
    name = lambda sp: sp.name if sp is not None else NO_SPAN
    for (_, s, e), sp in zip(ctx.device_ops, ctx.device_spans):
        rows[name(sp)]["device_ops"] += 1
        rows[name(sp)]["device_s"] += e - s
    for sp, _ in ctx.syncs:
        rows[name(sp)]["syncs"] += 1
    idle = collections.Counter()
    for sp, g in ctx.gaps:
        rows[name(sp)]["idle_s"] += g
        idle[name(sp)] += g
    return {"spans": dict(rows),
            "idle_gaps_by_span": [[n, s] for n, s in idle.most_common(10)]}


def run_traced(call, n_requests: int, frames_per_request: int, cfg: dict,
               frame_hw, described_of, sync):
    """`trace.run_traced` with the program's spans: profile `call(i)` for
    i < n_requests, each under the root range -> (SpanContext,
    breakdown)."""
    import torch
    from torch._C._profiler import _RecordFunctionFast
    from torch.profiler import ProfilerActivity, profile
    described = []
    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_requests):
            with _RecordFunctionFast(ROOT):
                described += described_of(call(i))
        sync()
        window = time.perf_counter() - t0
    ctx = collect(prof.events(), window, n_requests * frames_per_request,
                  cfg, frame_hw, described)
    by_op = collections.Counter()
    for n, s, e in ctx.device_ops:
        by_op[n] += e - s
    by_gap = collections.Counter()
    t0 = t_first(ctx)
    for g, n in idle_gaps(ctx, t0, t0 + window):
        by_gap[n] += g
    breakdown = {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                 "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]}
    breakdown.update(span_breakdown(ctx))
    return ctx, breakdown


# ---- the stage metrics: per frame completed in the traced block -------

def _per_frame(span: str, of, scale: float = 1.0, device: bool = True):
    """A reader: `scale * of(ctx, span)` over the block's frames.  None
    where the block holds no `span` (a program without spans) or no
    frames, and for a device number where it holds no device event (the
    CPU)."""
    def read(ctx):
        if (not isinstance(ctx, SpanContext) or not ctx.frames
                or not ctx.calls(span) or (device and not ctx.device_ops)):
            return None
        return scale * of(ctx, span) / ctx.frames
    return read


_HOST_MS = dict(of=SpanContext.span_seconds, scale=1e3, device=False)

# name -> (reader, unit, the cell it is read in)
STAGE_METRICS = {
    "detect_glue_ms.pair": (_per_frame("surf.detect", **_HOST_MS),
                            "ms/frame", "surf_demo.pairs"),
    "detect_glue_ops.pair": (_per_frame("surf.detect",
                                        SpanContext.span_device_ops),
                             "ops/frame", "surf_demo.pairs"),
    "integral_device_ms.surf": (_per_frame("surf.integral",
                                           SpanContext.span_device_seconds,
                                           1e3),
                                "ms/frame", "surf_demo.batch32"),
    "track_ms.vo": (_per_frame("vo.track", **_HOST_MS), "ms/frame",
                    "vo_tum.orbit"),
    "fivepoint_ms.vo": (_per_frame("vo.fivepoint", **_HOST_MS), "ms/frame",
                        "vo_tum.orbit"),
    "fivepoint_ops.vo": (_per_frame("vo.fivepoint",
                                    SpanContext.span_device_ops),
                         "ops/frame", "vo_tum.orbit"),
    "window_ba_ms.vo": (_per_frame("vo.window_ba", **_HOST_MS), "ms/frame",
                        "vo_tum.orbit"),
    "host_syncs.vo": (_per_frame("vo.process", SpanContext.span_syncs),
                      "syncs/frame", "vo_tum.orbit"),
}


def stage_metrics(ctx, workload: str) -> dict:
    """The stage metrics of `workload` that find their span in ctx."""
    out = {}
    for name, (read, unit, cell) in STAGE_METRICS.items():
        v = read(ctx) if cell == workload else None
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def traced_line(workload: str, seed: int, seconds: float, **run_kw) -> dict:
    """`run.run(..., trace=True)` with this module's `run_traced`; the
    line gains `stage_metrics`.  `run.run` imports `trace.run_traced` when
    it traces, so that name is swapped for the call and put back."""
    from . import run, trace
    held = {}

    def traced(*a, **k):
        held["ctx"], breakdown = run_traced(*a, **k)
        return held["ctx"], breakdown

    plain = trace.run_traced
    trace.run_traced = traced
    try:
        line = run.run(workload, seed, seconds, True, **run_kw)
    finally:
        trace.run_traced = plain
    line["stage_metrics"] = stage_metrics(held["ctx"], workload)
    return line


def main(argv=None) -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.spans: no CUDA device", file=sys.stderr)
        return 3
    line = traced_line(a.workload, a.seed, a.seconds)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
