"""The traced block of a `--trace 1` run: torch.profiler over a fixed
number of requests, reduced to what the per-layer metrics read.

`TraceContext` holds the device's operations (name, start, end, in
seconds on the profiler's clock), the host's top-level operations, the
block's length on the host clock, the frames it completed, and what the
kernels' work counts need: the configuration, the frame size and the
keypoints each frame had described.  `union_busy` and `idle_gaps` are
copies of the device-operation arithmetic of the repository's
`probe_stages.device_ops`, extended to intervals.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

@dataclasses.dataclass
class TraceContext:
    device_ops: list          # [(name, start_s, end_s)] sorted by start
    host_ops: list            # [(name, start_s, end_s)] top-level, sorted
    window_s: float           # the block on the host clock
    frames: int               # frames the block completed
    cfg: dict                 # the configuration's file
    frame_hw: tuple           # (h, w)
    described: list           # [Keypoints] of every frame described

    def kernel_seconds(self, pattern: str) -> float:
        return sum(e - s for n, s, e in self.device_ops if pattern in n)

    def union_busy(self) -> float:
        busy, end = 0.0, None
        for _, s, e in self.device_ops:
            if end is None or s > end:
                busy += e - s
                end = e
            elif e > end:
                busy += e - end
                end = e
        return busy


def idle_gaps(ctx: TraceContext, t0: float, t1: float):
    """[(gap seconds, the host op running at its middle)] of the device's
    idle time between t0 and t1 (profiler clock)."""
    gaps, end = [], t0
    for _, s, e in ctx.device_ops:
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if t1 > end:
        gaps.append((end, t1))
    starts = [s for _, s, _ in ctx.host_ops]
    out = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        k = bisect.bisect_right(starts, mid) - 1
        name = "(no host op)"
        if k >= 0 and ctx.host_ops[k][2] >= mid:
            name = ctx.host_ops[k][0]
        out.append((b - a, name))
    return out


def run_traced(call, n_requests: int, frames_per_request: int, cfg: dict,
               frame_hw, described_of, sync):
    """Profile `call(i)` for i < n_requests -> (TraceContext, breakdown,
    device dict entries busy_s / window_s)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    described = []
    sync()
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(n_requests):
            described += described_of(call(i))
        sync()
        window = time.perf_counter() - t0
    evs = prof.events()
    dev, host = [], []
    for e in evs:
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type == DeviceType.CUDA:
            dev.append((e.name, s, t))
        elif e.cpu_parent is None:
            host.append((e.name, s, t))
    dev.sort(key=lambda r: r[1])
    host.sort(key=lambda r: r[1])
    ctx = TraceContext(dev, host, window, n_requests * frames_per_request,
                       cfg, tuple(frame_hw), described)
    by_op = collections.Counter()
    for n, s, e in dev:
        by_op[n] += e - s
    t_first = min([s for _, s, _ in host + dev], default=0.0)
    by_gap = collections.Counter()
    for g, n in idle_gaps(ctx, t_first, t_first + window):
        by_gap[n] += g
    breakdown = {"device_ops": [[n, s] for n, s in by_op.most_common(10)],
                 "idle_gaps": [[n, s] for n, s in by_gap.most_common(10)]}
    return ctx, breakdown
