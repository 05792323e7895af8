"""Build and load the port's CUDA kernels (csrc/*.cu) through ctypes.

Each source compiles on first use into its own shared library with a plain
C interface — `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC` — all sources in parallel, into
`koboldcpp_tpu_torch/_build/<hash of the sources and flags>/`. No PyTorch
header is compiled, so a cold build takes seconds. Nothing here runs at
import time: the tests import every module on machines without nvcc.

`launches` counts kernel launches by kernel id ("K1" to "K10", and
"K1.q5_k", "K7.q5_k", "K2.q8_0", "K3.q5_k", "K3.q8_0" for the bodies of the
q5_k and q8_0 kinds, "K12.q2_k", "K12.q3_k", "K13.q2_k", "K13.q3_k" for the
q2_k and q3_k ones, "K12.<kind>" and "K13.<kind>" for the IQ kinds iq2p,
iq3px, iq3ps and iq1p; "K14" and "K14.q5_k" for the superblock batched
matvec, "K15b" (T = 1) and "K15a" (2 <= T <= 8) for the FFN megakernel;
"K12.q6_k_i8f", "K12.q3_k_n4", "K12.q2_k_n4", "K13.q4_k_i8" and
"K2.q8_0_bf16" for the bodies of the opt-in layouts and KCPP_MM_I8=0;
"K16" for the read-only single-sequence decode, "K17a" / "K17a.q5_k" and
"K17b" / "K17b.<kind>" for the layer-stacked matvecs and "K17c" for the
pooled-row flash decode of the scan decode path;
"K1", "K2", "K3", "K7", "K14", "K17a" and "K17b" count q4_k / q6_k
only);
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
SOURCES = ("q4k_matvec", "q6k_matvec", "q8_0_matvec", "q23k_matvec",
           "iq_matvec", "kq_matmul", "flash_decode", "flash_decode_wide",
           "flash_prefill",
           "q4k_sbq", "ffn_fused", "kq_expanded_matvec")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

launches: collections.Counter = collections.Counter()
build_seconds = 0.0  # wall time of the last build (0 when it was cached)
source_seconds: dict[str, float] = {}  # each source's nvcc time in it

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_paths: dict[str, str] | None = None

P = ctypes.c_void_p  # device pointers and the stream
I = ctypes.c_int
LL = ctypes.c_longlong
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
            log = open(f"{tmp}.log", "w+")
            procs.append((s, tmp, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        pending = {s: proc for s, _, _, proc in procs}
        while pending:  # each source's own time, all running together
            for s, proc in list(pending.items()):
                if proc.poll() is not None:
                    source_seconds[s] = time.perf_counter() - t0
                    del pending[s]
            time.sleep(0.05)
        errors = []
        for s, tmp, log, proc in procs:
            log.seek(0)
            text = log.read()
            log.close()
            os.remove(f"{tmp}.log")
            if proc.returncode != 0:
                errors.append(f"{s}.cu:\n{text}")
            else:
                os.replace(tmp, paths[s])
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
        build_seconds = time.perf_counter() - t0 if todo else 0.0
        _paths = paths
        return paths


def load(source: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """The library built from csrc/<source>.cu, with argtypes set for the
    given entry points (each returns a cudaError_t as int). Wrappers of one
    source may each name only their own entry points."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(build_all()[source])
        lib.kcpp_error_string.argtypes = [I]
        lib.kcpp_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        if f.argtypes is None:
            f.argtypes = argtypes
            f.restype = I
    return lib


_entries: dict[tuple[str, str], tuple] = {}


def entry(source: str, name: str, argtypes: list) -> tuple:
    """(library, entry point) of csrc/<source>.cu with its argtypes set,
    cached by (source, name): two libraries may export one name (the
    flash-decode ones do); a wrapper on a hot path pays one dict lookup per
    call."""
    found = _entries.get((source, name))
    if found is None:
        lib = load(source, {name: argtypes})
        found = _entries[source, name] = (lib, getattr(lib, name))
    return found


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error."""
    if err != 0:
        msg = lib.kcpp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr() -> int:
    import torch

    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:  # the same pointer without a Stream object
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream
