"""Timing and profiling helpers (port of cuda_surf_tpu/utils/timing.py).

The analogue of the reference's cpuTimer / GpuTimer (cuda_utils.h:71-108):
a host-clock timer that synchronises the card at both ends, a benchmark
loop timed with CUDA events (host clock on the CPU), and a named profiler
scope for torch.profiler traces.
"""

from __future__ import annotations

import contextlib
import time

import torch


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


@contextlib.contextmanager
def trace(name: str):
    """Named profiler scope (seen in a torch.profiler trace)."""
    with torch.profiler.record_function(name):
        yield
