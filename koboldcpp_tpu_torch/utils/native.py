"""ctypes loader for the native helper library (native/kcpp_native.cpp).

Mirrors the reference's dlopen bridge pattern (init_library,
koboldcpp.py:317) at a much smaller scale: the TPU compute
path is XLA/Pallas, so only host-side hot-loop algorithms live in C++.
Falls back to pure-Python/numpy implementations when the .so is missing;
`make -C native` (run automatically on first import if a compiler exists)
builds it.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libkcpp_native.so")

_lib = None


def _try_build():
    try:
        subprocess.run(["make", "-C", _NATIVE_DIR], capture_output=True,
                       timeout=120, check=True)
        return True
    except Exception:
        return False


def get_lib():
    global _lib
    if _lib is not None:
        return _lib or None
    if not os.path.exists(_LIB_PATH):
        if not _try_build():
            _lib = False
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        _lib = False
        return None
    i64 = ctypes.c_int64
    p_i32 = ctypes.POINTER(ctypes.c_int32)
    p_i64 = ctypes.POINTER(ctypes.c_int64)
    lib.kcpp_longest_common_run.argtypes = [p_i32, i64, p_i32, i64, p_i64]
    lib.kcpp_longest_common_run.restype = None
    lib.kcpp_dry_repeat_scan.argtypes = [p_i32, i64, i64, p_i32]
    lib.kcpp_dry_repeat_scan.restype = None
    lib.kcpp_find_first_stop.argtypes = [
        ctypes.c_char_p, i64, ctypes.c_char_p, p_i64, i64]
    lib.kcpp_find_first_stop.restype = i64
    lib.kcpp_common_prefix.argtypes = [p_i32, i64, p_i32, i64]
    lib.kcpp_common_prefix.restype = i64
    p_f32 = ctypes.POINTER(ctypes.c_float)
    lib.kcpp_spm_new.argtypes = [ctypes.c_char_p, p_i64, p_f32, i64, p_i32,
                                 ctypes.c_int32]
    lib.kcpp_spm_new.restype = i64
    lib.kcpp_spm_free.argtypes = [i64]
    lib.kcpp_spm_free.restype = None
    lib.kcpp_spm_encode.argtypes = [i64, ctypes.c_char_p, i64, p_i32]
    lib.kcpp_spm_encode.restype = i64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    lib.kcpp_trie_new.argtypes = [p_u8, p_i64, p_f32, p_u8, i64]
    lib.kcpp_trie_new.restype = i64
    lib.kcpp_trie_free.argtypes = [i64]
    lib.kcpp_trie_free.restype = None
    lib.kcpp_rwkv_encode.argtypes = [i64, p_u8, i64, p_i32, i64]
    lib.kcpp_rwkv_encode.restype = i64
    lib.kcpp_ugm_encode.argtypes = [i64, p_u8, i64, ctypes.c_int32,
                                    ctypes.c_float, p_i32, i64]
    lib.kcpp_ugm_encode.restype = i64
    _lib = lib
    return lib


class NativeTrie:
    """Handle to a C++ byte-trie tokenizer core (native/trie_tokenizer.cpp):
    greedy longest-match (RWKV) and UGM Viterbi over pre-normalized bytes."""

    def __init__(self, token_bytes: list[bytes], scores=None, skip=None):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        blob = b"".join(token_bytes)
        offsets = np.zeros(len(token_bytes) + 1, np.int64)
        np.cumsum([len(b) for b in token_bytes], out=offsets[1:])
        self._blob = np.frombuffer(blob, np.uint8) if blob else np.zeros(1, np.uint8)
        self._offsets = offsets
        sc = (np.asarray(scores, np.float32) if scores is not None else None)
        sk = (np.asarray(skip, np.uint8) if skip is not None
              else np.zeros(len(token_bytes), np.uint8))
        self._handle = lib.kcpp_trie_new(
            self._blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            if sc is not None else None,
            sk.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            len(token_bytes))

    def rwkv_encode(self, data: bytes) -> list[int]:
        arr = np.frombuffer(data, np.uint8) if data else np.zeros(0, np.uint8)
        out = np.zeros(max(len(data), 1), np.int32)
        n = self._lib.kcpp_rwkv_encode(
            self._handle,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out))
        return out[:n].tolist()

    def ugm_encode(self, data: bytes, unk_id: int, unk_score: float) -> list[int]:
        if not data:
            return []
        arr = np.frombuffer(data, np.uint8)
        out = np.zeros(len(data) + 1, np.int32)
        n = self._lib.kcpp_ugm_encode(
            self._handle,
            arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(data),
            unk_id, unk_score,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(out))
        return out[:n].tolist()

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib:
            self._lib.kcpp_trie_free(self._handle)


class NativeSPM:
    """Handle to a C++ SPM tokenizer instance (native/spm_tokenizer.cpp)."""

    def __init__(self, tokens: list[str], scores, byte_tokens: dict[int, int],
                 unk_id: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        blobs = [t.encode("utf-8") for t in tokens]
        offsets = np.zeros(len(blobs) + 1, dtype=np.int64)
        for i, b in enumerate(blobs):
            offsets[i + 1] = offsets[i] + len(b)
        concat = b"".join(blobs)
        sc = np.ascontiguousarray(scores, dtype=np.float32)
        byte_ids = np.full(256, -1, dtype=np.int32)
        for b, tid in byte_tokens.items():
            byte_ids[b] = tid
        self._handle = lib.kcpp_spm_new(
            concat, offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            sc.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(blobs),
            byte_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), unk_id)

    def encode(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        out = np.empty(len(data) + 1, dtype=np.int32)
        n = self._lib.kcpp_spm_encode(
            self._handle, data, len(data),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        if n < 0:
            raise RuntimeError("native SPM encode failed")
        return out[:n].tolist()

    def __del__(self):
        try:
            self._lib.kcpp_spm_free(self._handle)
        except Exception:
            pass


def _as_i32(arr) -> np.ndarray:
    return np.ascontiguousarray(arr, dtype=np.int32)


def longest_common_run(a, b) -> tuple[int, int, int]:
    """(length, start_in_a, start_in_b) of the longest consecutive match."""
    lib = get_lib()
    aa, bb = _as_i32(a), _as_i32(b)
    if lib is not None:
        out = np.zeros(3, dtype=np.int64)
        lib.kcpp_longest_common_run(
            aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
            bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return int(out[0]), int(out[1]), int(out[2])
    # numpy fallback (diagonal DP)
    if len(aa) == 0 or len(bb) == 0:
        return 0, 0, 0
    eq = (aa[:, None] == bb[None, :]).astype(np.int32)
    run = np.zeros_like(eq)
    run[0, :] = eq[0, :]
    run[:, 0] = eq[:, 0]
    for i in range(1, eq.shape[0]):
        run[i, 1:] = (run[i - 1, :-1] + 1) * eq[i, 1:]
    idx = np.unravel_index(np.argmax(run), run.shape)
    ln = int(run[idx])
    return ln, int(idx[0]) - ln + 1, int(idx[1]) - ln + 1


def dry_repeat_scan(tokens, rep_limit: int) -> np.ndarray:
    """Reverse Z-algorithm repeat lengths (DRY sampler step 2)."""
    tt = _as_i32(tokens)
    n = len(tt)
    out = np.zeros(n, dtype=np.int32)
    if n < 2:
        return out
    lib = get_lib()
    if lib is not None:
        lib.kcpp_dry_repeat_scan(
            tt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), n,
            rep_limit, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out
    # python fallback
    last = n - 1
    rt = lt = 0
    for k in range(1, n):
        if k > rt:
            m = 0
            while m + k < n and tt[last - m] == tt[last - (m + k)]:
                m += 1
            out[last - k] = min(m, rep_limit)
            if m > 0:
                lt, rt = k, k + m - 1
        else:
            p = k - lt
            right_len = rt - k + 1
            if out[last - p] < right_len:
                out[last - k] = min(int(out[last - p]), rep_limit)
            else:
                i = rt + 1
                while i < n and tt[last - i] == tt[last - (i - k)]:
                    i += 1
                out[last - k] = min(i - k, rep_limit)
                lt, rt = k, i - 1
    return out


def find_first_stop(text: str, stops: list[str]) -> int | None:
    """Earliest index of any stop string in text, or None."""
    real = [s for s in stops if s]
    if not real or not text:
        return None
    lib = get_lib()
    if lib is not None:
        tb = text.encode("utf-8")
        sb = b"".join(s.encode("utf-8") for s in real)
        lens = np.array([len(s.encode("utf-8")) for s in real], dtype=np.int64)
        # byte offset -> char offset mapping needed; do the scan in bytes then
        # convert (utf-8 prefix decode)
        i = lib.kcpp_find_first_stop(
            tb, len(tb), sb, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(real))
        if i < 0:
            return None
        return len(tb[:i].decode("utf-8", errors="ignore"))
    best = None
    for s in real:
        i = text.find(s)
        if i >= 0 and (best is None or i < best):
            best = i
    return best


def common_prefix(a, b) -> int:
    aa, bb = _as_i32(a), _as_i32(b)
    lib = get_lib()
    if lib is not None:
        return int(lib.kcpp_common_prefix(
            aa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(aa),
            bb.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), len(bb)))
    n = min(len(aa), len(bb))
    i = 0
    while i < n and aa[i] == bb[i]:
        i += 1
    return i
