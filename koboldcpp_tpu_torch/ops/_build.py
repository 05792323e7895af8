"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

Each source compiles on first use into its own shared library with a plain
C interface — `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` — all sources in parallel, into
`koboldcpp_tpu_torch/_build/<hash of the sources and flags>/`. No PyTorch
header is compiled, so a cold build takes seconds. Nothing here runs at
import time: the tests import every module on machines without nvcc.

`launches` counts kernel launches by kernel id ("K1", "K2", "K3", "K5");
each wrapper adds one where it launches its kernel, and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("q4k_matvec", "q6k_matvec", "kq_matmul", "flash_decode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()
build_seconds = 0.0  # wall time of the last build (0 when it was cached)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_paths: dict[str, str] | None = None

P = ctypes.c_void_p  # device pointers and the stream
I = ctypes.c_int
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(CSRC)):
        if name.endswith((".cu", ".cuh")):
            h.update(name.encode())
            with open(os.path.join(CSRC, name), "rb") as f:
                h.update(f.read())
    return h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every source missing from the build directory, one nvcc per
    source, all started together. Returns {source: library path}."""
    global _paths, build_seconds
    with _lock:
        if _paths is not None:
            return _paths
        out_dir = os.path.join(BUILD_ROOT, _digest())
        os.makedirs(out_dir, exist_ok=True)
        paths = {s: os.path.join(out_dir, f"lib{s}.so") for s in SOURCES}
        todo = [s for s in SOURCES if not os.path.exists(paths[s])]
        t0 = time.perf_counter()
        procs = []
        for s in todo:
            tmp = f"{paths[s]}.{os.getpid()}.tmp"
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, f"{s}.cu")]
            procs.append((s, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for s, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{s}.cu:\n{log}")
            else:
                os.replace(tmp, paths[s])
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        build_seconds = time.perf_counter() - t0 if todo else 0.0
        _paths = paths
        return paths


def load(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from csrc/<source>.cu, with argtypes set for the
    given entry points (each returns a cudaError_t as int)."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(build_all()[source])
        lib.kcpp_error_string.argtypes = [I]
        lib.kcpp_error_string.restype = ctypes.c_char_p
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = I
        _libs[source] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kcpp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr() -> int:
    import torch

    return torch.cuda.current_stream().cuda_stream
