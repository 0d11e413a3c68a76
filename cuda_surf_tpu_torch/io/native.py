"""ctypes bindings of the native image IO runtime (copy of
cuda_surf_tpu/io/native.py, on the same native/surfio.cpp).

A host image reader, not a kernel: the shared library is built on demand
with g++ into the git-ignored cuda_surf_tpu_torch/_build/, and every entry
point falls back to the pure-Python codecs when the toolchain or the
library is missing.  `FrameLoader.path` says which one a loader took.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "native", "surfio.cpp")
_LIB_PATH = os.path.join(_ROOT, "cuda_surf_tpu_torch", "_build",
                         "libsurfio.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    if not os.path.exists(_SRC):
        return None
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    # several ranks start at once: one builds, the others wait on the lock
    # (fcntl.flock, dropped when its holder exits) and load its library
    with open(f"{_LIB_PATH}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(_LIB_PATH) and (
                os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
            return _LIB_PATH
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                 _SRC, "-o", tmp], check=True, capture_output=True,
                timeout=120)
            os.replace(tmp, _LIB_PATH)
            return _LIB_PATH
        except (OSError, subprocess.SubprocessError):
            return None


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        path = _build()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.surfio_read_gray.argtypes = [ctypes.c_char_p, ip, ip, u8p,
                                         ctypes.c_long]
        lib.surfio_read_gray.restype = ctypes.c_int
        lib.surfio_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                           ctypes.c_int]
        lib.surfio_loader_open.restype = ctypes.c_void_p
        lib.surfio_loader_next.argtypes = [ctypes.c_void_p, ip, ip, u8p,
                                           ctypes.c_long]
        lib.surfio_loader_next.restype = ctypes.c_int
        lib.surfio_loader_close.argtypes = [ctypes.c_void_p]
        lib.surfio_loader_close.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


_PNM_EXTS = (".pgm", ".ppm", ".pnm")


def _is_pnm(path: str) -> bool:
    return os.path.splitext(path)[1].lower() in _PNM_EXTS


def _python_read(path: str) -> np.ndarray:
    from .image import imread_gray
    return imread_gray(path)


def read_gray(path: str) -> np.ndarray:
    """Decode an image to uint8 (H, W).  PGM / PPM go through the native
    codec when it is available; other formats (PNG) and any native decode
    failure fall back to the pure-Python loader."""
    lib = _load()
    if lib is None or not _is_pnm(path):
        return _python_read(path)
    w = ctypes.c_int()
    h = ctypes.c_int()
    null = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
    if lib.surfio_read_gray(path.encode(), ctypes.byref(w),
                            ctypes.byref(h), null, 0) != 0:
        return _python_read(path)
    out = np.empty((h.value, w.value), np.uint8)
    ah, aw = out.shape
    rc = lib.surfio_read_gray(
        path.encode(), ctypes.byref(w), ctypes.byref(h),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out.nbytes)
    # rc catches a file that grew between the size query and the fill, the
    # shape check one that shrank
    if rc != 0 or (h.value, w.value) != (ah, aw):
        return _python_read(path)
    return out


class FrameLoader:
    """Background-threaded prefetching loader over an image sequence: the
    host side of the per-frame read + upload, run ahead of the device.

    Iterates uint8 (H, W) frames.  `path` is "native" when the native
    library prefetches the sequence (every file PNM, library built) and
    "python" when frames are decoded synchronously in Python.
    """

    def __init__(self, paths, depth: int = 4):
        self._paths = [str(p) for p in paths]
        self._lib = _load()
        self._handle = None
        self._pos = 0
        # the native codec only speaks PNM: mixed or PNG sequences go to
        # the Python decoder up front rather than failing mid-sequence
        if (self._lib is not None and self._paths
                and all(_is_pnm(p) for p in self._paths)):
            blob = b"\x00".join(p.encode() for p in self._paths) + b"\x00"
            self._handle = self._lib.surfio_loader_open(
                blob, len(self._paths), depth)
        self.path = "native" if self._handle is not None else "python"

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        if self._handle is not None:
            w = ctypes.c_int()
            h = ctypes.c_int()
            null = ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8))
            rc = self._lib.surfio_loader_next(
                self._handle, ctypes.byref(w), ctypes.byref(h), null, 0)
            if rc == -2:
                raise StopIteration
            pos = self._pos
            self._pos += 1
            if rc != 0:
                # the native decode failed (its error return consumed the
                # frame): decode this frame in Python
                return _python_read(self._paths[pos])
            out = np.empty((h.value, w.value), np.uint8)
            rc = self._lib.surfio_loader_next(
                self._handle, ctypes.byref(w), ctypes.byref(h),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                out.nbytes)
            if rc != 0:
                return _python_read(self._paths[pos])
            return out
        if self._pos >= len(self._paths):
            raise StopIteration
        img = _python_read(self._paths[self._pos])
        self._pos += 1
        return img

    def close(self):
        if self._handle is not None:
            self._lib.surfio_loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
