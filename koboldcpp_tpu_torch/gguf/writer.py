"""GGUF v3 writer — used by the quantize tool, converters and test fixtures.

Writes the same container format the reader parses (SURVEY.md Appendix A).
"""
from __future__ import annotations

import struct
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGUF_VERSION,
    GGMLType,
    GGUFValueType,
    GGML_BLOCK_SIZES,
)
from . import quants

_PACK = {
    GGUFValueType.UINT8: "<B", GGUFValueType.INT8: "<b",
    GGUFValueType.UINT16: "<H", GGUFValueType.INT16: "<h",
    GGUFValueType.UINT32: "<I", GGUFValueType.INT32: "<i",
    GGUFValueType.FLOAT32: "<f", GGUFValueType.BOOL: "<B",
    GGUFValueType.UINT64: "<Q", GGUFValueType.INT64: "<q",
    GGUFValueType.FLOAT64: "<d",
}

_NUMPY_VT = {
    np.dtype(np.uint8): GGUFValueType.UINT8, np.dtype(np.int8): GGUFValueType.INT8,
    np.dtype(np.uint16): GGUFValueType.UINT16, np.dtype(np.int16): GGUFValueType.INT16,
    np.dtype(np.uint32): GGUFValueType.UINT32, np.dtype(np.int32): GGUFValueType.INT32,
    np.dtype(np.float32): GGUFValueType.FLOAT32, np.dtype(np.uint64): GGUFValueType.UINT64,
    np.dtype(np.int64): GGUFValueType.INT64, np.dtype(np.float64): GGUFValueType.FLOAT64,
}


def _infer_vt(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.INT64 if (v < 0 or v >= 2**32) else GGUFValueType.UINT32
    if isinstance(v, float):
        return GGUFValueType.FLOAT32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    if isinstance(v, np.generic):
        return _NUMPY_VT[np.dtype(v.dtype)]
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


class GGUFWriter:
    def __init__(self, path: str, architecture: str | None = None,
                 alignment: int = GGUF_DEFAULT_ALIGNMENT):
        self.path = path
        self.alignment = alignment
        self.kv: list[tuple[str, GGUFValueType, Any]] = []
        self.tensors: list[tuple[str, tuple[int, ...], GGMLType, np.ndarray]] = []
        if architecture is not None:
            self.add("general.architecture", architecture)
        if alignment != GGUF_DEFAULT_ALIGNMENT:
            self.add("general.alignment", np.uint32(alignment))

    def add(self, key: str, value: Any, vtype: GGUFValueType | None = None):
        self.kv.append((key, vtype if vtype is not None else _infer_vt(value), value))

    def add_tensor(self, name: str, data: np.ndarray,
                   ggml_type: GGMLType | None = None):
        """Add a tensor. Float data is quantized to `ggml_type` if given,
        else stored as F32. Pre-packed uint8 data requires ggml_type."""
        if data.dtype == np.uint8:
            if ggml_type is None:
                raise ValueError("raw uint8 tensor needs explicit ggml_type")
            blk, sz = GGML_BLOCK_SIZES[ggml_type]
            n_last = data.shape[-1] // sz * blk
            shape = data.shape[:-1] + (n_last,)
            raw = np.ascontiguousarray(data).reshape(-1)
        else:
            t = ggml_type or GGMLType.F32
            if data.dtype == np.float16 and ggml_type is None:
                t = GGMLType.F16
            shape = data.shape
            raw = quants.quantize(np.asarray(data, dtype=np.float32), t).reshape(-1)
            ggml_type = t
        self.tensors.append((name, shape, GGMLType(ggml_type), raw))

    def add_tensor_raw(self, name: str, shape: tuple[int, ...],
                       ggml_type: GGMLType, raw: np.ndarray):
        """Add a tensor from already-packed bytes with an explicit logical
        shape (pass-through copy path used by gguf-split)."""
        self.tensors.append((name, tuple(shape), GGMLType(ggml_type),
                             np.ascontiguousarray(raw).reshape(-1)))

    # -- serialization -----------------------------------------------------
    def _w_str(self, f: BinaryIO, s: str):
        b = s.encode("utf-8")
        f.write(struct.pack("<Q", len(b)))
        f.write(b)

    def _w_value(self, f: BinaryIO, vt: GGUFValueType, v: Any):
        f.write(struct.pack("<I", int(vt)))
        self._w_value_raw(f, vt, v)

    def _w_value_raw(self, f: BinaryIO, vt: GGUFValueType, v: Any):
        if vt == GGUFValueType.STRING:
            self._w_str(f, str(v))
        elif vt == GGUFValueType.ARRAY:
            if isinstance(v, np.ndarray):
                et = _NUMPY_VT[v.dtype]
                f.write(struct.pack("<IQ", int(et), v.size))
                f.write(np.ascontiguousarray(v).tobytes())
            else:
                v = list(v)
                et = _infer_vt(v[0]) if v else GGUFValueType.UINT32
                f.write(struct.pack("<IQ", int(et), len(v)))
                for e in v:
                    self._w_value_raw(f, et, e)
        else:
            f.write(struct.pack(_PACK[vt], v))

    def write(self):
        align = self.alignment
        with open(self.path, "wb") as f:
            f.write(GGUF_MAGIC)
            f.write(struct.pack("<IQQ", GGUF_VERSION, len(self.tensors), len(self.kv)))
            for key, vt, v in self.kv:
                self._w_str(f, key)
                self._w_value(f, vt, v)
            offset = 0
            offsets = []
            for name, shape, t, raw in self.tensors:
                self._w_str(f, name)
                ne = tuple(reversed(shape))  # GGUF: contiguous dim first
                f.write(struct.pack("<I", len(ne)))
                for d in ne:
                    f.write(struct.pack("<Q", d))
                f.write(struct.pack("<I", int(t)))
                offset = (offset + align - 1) // align * align
                offsets.append(offset)
                f.write(struct.pack("<Q", offset))
                offset += raw.nbytes
            pos = f.tell()
            f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
            data_start = f.tell()
            for (name, shape, t, raw), off in zip(self.tensors, offsets):
                pad = data_start + off - f.tell()
                if pad:
                    f.write(b"\x00" * pad)
                f.write(raw.tobytes())
