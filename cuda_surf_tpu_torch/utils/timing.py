"""Timing and profiling helpers (port of cuda_surf_tpu/utils/timing.py).

The analogue of the reference's cpuTimer / GpuTimer (cuda_utils.h:71-108):
a host-clock timer that synchronises the card at both ends, a benchmark
loop timed with CUDA events (host clock on the CPU), and the named stage
spans that a torch.profiler trace shows beside the kernels.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

# Every stage span of the program, by name.  A span opens where its
# stage's work is queued: the device operations it launches, the host
# syncs it makes and the idle time of the device while it runs belong to
# it in a trace.
SPANS = (
    "surf.integral", "surf.pyramid", "surf.detect", "surf.makepoint",
    "surf.orient", "surf.describe", "surf.match",
    "vo.process", "vo.track", "vo.fivepoint", "vo.score", "vo.refit",
    "vo.scale", "vo.window_ba",
    "mesh.all_gather", "mesh.match",
)

_OFF = contextlib.nullcontext()


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Host-clock timer whose span covers the device work queued inside
    it: the card is synchronised on entry and on exit."""

    def __init__(self):
        self.elapsed_ms = 0.0

    def __enter__(self):
        _sync()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _sync()
        self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return False


def benchmark(fn, *args, iters: int = 100, warmup: int = 3,
              device="cuda") -> float:
    """Mean milliseconds per call of fn(*args) over `iters` calls after
    `warmup` (the reference's 100-iteration protocol, main.cpp:239-251).
    On the card the span is read from CUDA events around the loop, with one
    synchronise at its end; with `device="cpu"`, from the host clock."""
    for _ in range(warmup):
        fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    return (time.perf_counter() - t0) / iters * 1e3


def span(name: str):
    """The stage span `name` (a member of SPANS) as a context manager.

    With no torch profiler recording it is one shared no-op: the check
    costs a call and adds no host read, sync or device operation.  Under
    `torch.profiler.profile` it is a range named `name` on the profiler's
    clock, recorded as an operator (the FUNCTION scope of
    `_RecordFunctionFast`), so that no `gpu_user_annotation` range joins
    the device's events, as one does for `record_function`'s user scope:
    a trace's device operations stay the kernels and copies alone."""
    if not _profiler_enabled():
        return _OFF
    if name not in SPANS:
        raise ValueError(f"span {name!r} is not one of timing.SPANS")
    return _RecordFunctionFast(name)
