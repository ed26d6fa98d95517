"""ctypes bindings for the native IO runtime (native/vstpu_io.cpp), as
visualslam_tpu/io/native.py binds it.

Provides: grayscale decode (PNG/JPEG/PGM), a multithreaded frame prefetcher
(decodes ahead of the SLAM loop), and C++ twins of the reference-format
descriptor serialization. This is host image IO, not the device path. The
library is compiled with g++ on first use into the port's git-ignored
`visualslam_tpu_torch/_build/` (named by a hash of the source and the
flags), never into `native/`. If that build fails (no compiler, or no
libpng / libjpeg headers), `available()` is False and callers use PIL
(utils/images.py, io/kitti.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "vstpu_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall")
LIBS = ("-lpng", "-ljpeg", "-lz", "-lpthread")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(FLAGS + LIBS).encode()).hexdigest()
    return BUILD_DIR / f"libvstpu_io-{digest[:16]}.so"


def build() -> Path:
    """Compile native/vstpu_io.cpp unless this source's library exists
    (to a temporary name, then renamed: a concurrent build never sees a
    half-written library). Raises when the compiler fails."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", tmp, *LIBS],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = build()
    except Exception:
        return None
    lib = ctypes.CDLL(str(so))
    lib.vstpu_decode_gray.restype = ctypes.c_int
    lib.vstpu_decode_gray.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.vstpu_prefetcher_create.restype = ctypes.c_void_p
    lib.vstpu_prefetcher_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.vstpu_prefetcher_next.restype = ctypes.c_int
    lib.vstpu_prefetcher_next.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int64]
    lib.vstpu_prefetcher_destroy.restype = None
    lib.vstpu_prefetcher_destroy.argtypes = [ctypes.c_void_p]
    lib.vstpu_write_descriptors.restype = ctypes.c_int
    lib.vstpu_write_descriptors.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    lib.vstpu_read_descriptors.restype = ctypes.c_int
    lib.vstpu_read_descriptors.argtypes = [
        ctypes.c_char_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def decode_gray(path: str) -> np.ndarray:
    """Native grayscale decode -> float32 [H, W] in [0, 1]."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    h = ctypes.c_int()
    w = ctypes.c_int()
    rc = lib.vstpu_decode_gray(path.encode(), None, ctypes.byref(h),
                               ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vstpu_decode_gray probe failed ({rc}) for {path}")
    out = np.empty((h.value, w.value), np.float32)
    rc = lib.vstpu_decode_gray(path.encode(),
                               out.ctypes.data_as(ctypes.c_void_p),
                               ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"vstpu_decode_gray failed ({rc}) for {path}")
    return out


class Prefetcher:
    """Multithreaded lookahead frame loader (in file order)."""

    def __init__(self, paths: Sequence[str], capacity: int = 8,
                 n_threads: int = 4, max_hw: tuple[int, int] = (4096, 8192)):
        lib = _load()
        if lib is None:
            raise RuntimeError("native IO library not available")
        self._lib = lib
        self._paths = [p.encode() for p in paths]
        arr = (ctypes.c_char_p * len(self._paths))(*self._paths)
        self._handle = lib.vstpu_prefetcher_create(
            arr, len(self._paths), capacity, n_threads)
        self._max_elems = max_hw[0] * max_hw[1]
        self._buf = np.empty(self._max_elems, np.float32)

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        h = ctypes.c_int()
        w = ctypes.c_int()
        rc = self._lib.vstpu_prefetcher_next(
            self._handle, self._buf.ctypes.data_as(ctypes.c_void_p),
            ctypes.byref(h), ctypes.byref(w), self._max_elems)
        if rc == 1:
            raise StopIteration
        if rc != 0:
            raise IOError(f"prefetcher_next failed ({rc})")
        return self._buf[: h.value * w.value].reshape(
            h.value, w.value).copy()

    def close(self) -> None:
        if self._handle:
            self._lib.vstpu_prefetcher_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def write_descriptors(path: str, desc: np.ndarray) -> None:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    desc = np.ascontiguousarray(desc, np.float32)
    rc = lib.vstpu_write_descriptors(
        path.encode(), desc.ctypes.data_as(ctypes.c_void_p),
        desc.shape[0], desc.shape[1])
    if rc != 0:
        raise IOError(f"vstpu_write_descriptors failed ({rc})")


def read_descriptors(path: str) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native IO library not available")
    n = ctypes.c_int()
    d = ctypes.c_int()
    rc = lib.vstpu_read_descriptors(path.encode(), None,
                                    ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise IOError(f"vstpu_read_descriptors probe failed ({rc})")
    out = np.empty((n.value, d.value), np.float32)
    rc = lib.vstpu_read_descriptors(path.encode(),
                                    out.ctypes.data_as(ctypes.c_void_p),
                                    ctypes.byref(n), ctypes.byref(d))
    if rc != 0:
        raise IOError(f"vstpu_read_descriptors failed ({rc})")
    return out
