"""Build and load the hand-written CUDA kernels.

Each `csrc/<name>.cu` has a plain C interface and is compiled by `nvcc` into
a shared library that `ctypes` loads (no PyTorch headers, so a build takes
seconds). Libraries go to `visualslam_tpu_torch/_build/` (git-ignored),
named by a hash of the source, the headers it includes and the flags, so an
edited source or header is rebuilt on its next use and an unchanged one is
loaded as it is. Nothing here runs at import: the first wrapper call that
launches a kernel builds it.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import re
import subprocess
import tempfile
from pathlib import Path

PACKAGE = Path(__file__).resolve().parents[2]
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (set CUDA_HOME)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]+"([^"]+)"', re.M)


def sources(name: str) -> list[Path]:
    """csrc/<name>.cu and the headers it includes with quotes, those
    headers' own included ones too: the files its library is built from."""
    out, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path not in out:
            out.append(path)
            todo += [path.parent / inc
                     for inc in _INCLUDE.findall(path.read_text())]
    return out


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in sources(name):
        digest.update(path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless this source's library exists. The
    compiler's report (registers, shared memory, spills per kernel) is kept
    beside the library as <library>.log."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temporary name and rename: a concurrent build of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{proc.stderr}")
        Path(str(out) + ".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


SOURCES = ("extrema", "descriptor", "blur", "distance", "segment",
           "triangulate", "small_linalg")


def build_all(names=SOURCES) -> list[Path]:
    """Compile several sources at once, one nvcc process each (nvcc is
    single-threaded; the builds overlap). Returns the library paths."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        return list(pool.map(build, names))


def build_log(name: str) -> str:
    """The compiler's report for the current source of csrc/<name>.cu."""
    return Path(str(library_path(name)) + ".log").read_text()


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu; cached per process."""
    return ctypes.CDLL(str(build(name)))


def check_launch(rc: int, kernel: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {rc}")


def on_device(device):
    """`torch.cuda.device(device)` where it is not the current device, else
    a no-op context (entering the device context costs host time on every
    launch)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def stream_handle(device) -> int:
    """The raw cudaStream_t of `device`'s current stream, as an int
    (`torch.cuda.current_stream(device).cuda_stream` builds a Stream object
    first, which costs host time on every launch)."""
    import torch

    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
