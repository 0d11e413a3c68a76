"""Build and load the hand-written CUDA kernels (csrc/*.cu).

The sources have a plain C interface and include no PyTorch header, so
`nvcc` compiles them in seconds: one `nvcc -c` per source, all started
together, then one link into a shared library, which is loaded with
`ctypes`.  The build runs at the first kernel launch of a process, never
at import, and is redone when a source's hash or a flag changes.  Every C
entry point returns `cudaGetLastError()` after its launch; `launch` calls
one and raises on a non-zero code, and inside `record_launches()` it also
brackets the call with two CUDA events, which gives a kernel's own device
time without the eager glue of its wrapper.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

import torch

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
LIB_NAME = "libsurfkernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_U = ctypes.c_uint
_SIGNATURES = {
    # ii, nframes, ih, iw, plan, ntiles, smem_bytes, rr, pre_t, layers,
    # masks, stream
    "surf_pyramid": [_P, _I, _I, _I, _P, _I, _I, _F, _F, _P, _P, _P],
    # smem_bytes, blocks(out)
    "surf_pyramid_occupancy": [_I, _P],
    # ii, ih, iw, meta, fpar, wtab, K, R, upright, osz, out, stream
    "surf_describe": [_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P, _P],
    # ii, nframes, ih, iw, meta, fpar, wtab, K, R, upright, osz, out, stream
    "surf_describe_stacked": [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _I, _P,
                              _P],
    # upright, osz, blocks(out)
    "surf_describe_occupancy": [_I, _I, _P],
    # ii, ih, iw, meta, fpar, wtab, K, sel, count, cap, sd, R, upright, osz,
    # out, stream
    "surf_describe_step": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                           _I, _P, _P],
    # ii, ih, iw, x, y, scale, valid, doubled, tab, K, out, stream
    "surf_orient": [_P, _I, _I, _P, _P, _P, _P, _I, _P, _I, _P, _P],
    # blocks(out), warps per block(out)
    "surf_orient_occupancy": [_P, _P],
    # d1, d2, valid2, P, N1, N2, D, splits, part best/second/index, done,
    # epoch, best, second, index, stream
    "surf_best2": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _U, _P, _P,
                   _P, _P],
    # D, blocks(out), warps per block(out)
    "surf_best2_occupancy": [_I, _P, _P],
}


class KernelLib(NamedTuple):
    lib: ctypes.CDLL
    build_seconds: float   # 0.0 when an up-to-date library was reused
    build_log: str         # nvcc's output (ptxas register / spill report)


def _sources() -> list[Path]:
    return sorted(SRC_DIR.glob("*.cu"))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources + sorted(SRC_DIR.glob("*.cuh")):   # and their headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _run_all(cmds) -> str:
    """Run the commands in parallel; -> their output, or raise with the
    output of every command that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    bad = [f"{' '.join(c)} -> {p.returncode}\n{o}"
           for c, p, o in zip(cmds, procs, outs) if p.returncode != 0]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(bad))
    return "".join(outs)


def _build(sources, so: Path, stamp: Path, digest: str) -> str:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, p.stem + ".o") for p in sources]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", o, str(p)]
                        for p, o in zip(sources, objs)])
        tmp = os.path.join(tmpdir, LIB_NAME)
        log += _run_all([[nvcc, "-shared", "-o", tmp, *objs]])
        os.replace(tmp, so)
    stamp.write_text(digest)
    return log


@functools.cache
def kernels() -> KernelLib:
    """The loaded kernel library, built first if it is missing or stale."""
    sources = _sources()
    digest = _digest(sources)
    so, stamp = BUILD_DIR / LIB_NAME, BUILD_DIR / (LIB_NAME + ".sha256")
    t0 = time.perf_counter()
    log = ""
    if not (so.exists() and stamp.exists() and stamp.read_text() == digest):
        log = _build(sources, so, stamp, digest)
    seconds = time.perf_counter() - t0 if log else 0.0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.surf_error_string.argtypes = [ctypes.c_int]
    lib.surf_error_string.restype = ctypes.c_char_p
    return KernelLib(lib, seconds, log)


def check(err: int, name: str) -> None:
    if err != 0:
        msg = kernels().lib.surf_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


_recorded = None    # inside record_launches(): [(entry, start, end events)]


def launch(name: str, *args) -> None:
    """Call the library's entry point `name`, which launches its kernels on
    the stream it is given, and raise if the launch was refused."""
    fn = getattr(kernels().lib, name)
    if _recorded is None:
        check(fn(*args), name)
        return
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    check(fn(*args), name)
    end.record()
    _recorded.append((name, start, end))


@contextlib.contextmanager
def record_launches():
    """Within the block every `launch` records a pair of CUDA events on
    the current stream around its kernels.  Yields the list of (entry
    name, start, end); read `start.elapsed_time(end)` after a
    synchronise."""
    global _recorded
    _recorded = rec = []
    try:
        yield rec
    finally:
        _recorded = None


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Validate a tensor before its pointer goes to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
