"""mmap-based GGUF reader.

Binary layout per ggml/src/ggml.c:22234 (`gguf_init_from_file`)
and SURVEY.md Appendix A.  All integers little-endian.  Tensor data is exposed
as zero-copy numpy views over the mmap; callers repack into HBM layouts.
"""
from __future__ import annotations

import mmap
import os
from dataclasses import dataclass
from typing import Any, BinaryIO

import numpy as np

from .constants import (
    GGUF_DEFAULT_ALIGNMENT,
    GGUF_MAGIC,
    GGMLType,
    GGUFValueType,
    GGML_BLOCK_SIZES,
    Keys,
)

_SCALAR_DTYPES: dict[GGUFValueType, np.dtype] = {
    GGUFValueType.UINT8: np.dtype("<u1"),
    GGUFValueType.INT8: np.dtype("<i1"),
    GGUFValueType.UINT16: np.dtype("<u2"),
    GGUFValueType.INT16: np.dtype("<i2"),
    GGUFValueType.UINT32: np.dtype("<u4"),
    GGUFValueType.INT32: np.dtype("<i4"),
    GGUFValueType.FLOAT32: np.dtype("<f4"),
    GGUFValueType.BOOL: np.dtype("<u1"),
    GGUFValueType.UINT64: np.dtype("<u8"),
    GGUFValueType.INT64: np.dtype("<i8"),
    GGUFValueType.FLOAT64: np.dtype("<f8"),
}


@dataclass(frozen=True)
class TensorInfo:
    name: str
    shape: tuple[int, ...]  # logical row-major shape (ne reversed)
    ggml_type: GGMLType
    offset: int  # into the data section
    nbytes: int

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class _Cursor:
    """Sequential parser over a bytes-like buffer."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def scalar(self, vt: GGUFValueType):
        dt = _SCALAR_DTYPES[vt]
        v = np.frombuffer(self.buf, dtype=dt, count=1, offset=self.pos)[0]
        self.pos += dt.itemsize
        if vt == GGUFValueType.BOOL:
            return bool(v)
        return v.item()

    def u32(self) -> int:
        return self.scalar(GGUFValueType.UINT32)

    def u64(self) -> int:
        return self.scalar(GGUFValueType.UINT64)

    def string(self) -> str:
        n = self.u64()
        s = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return s.decode("utf-8", errors="replace")

    def value(self, vt: GGUFValueType) -> Any:
        vt = GGUFValueType(vt)
        if vt == GGUFValueType.STRING:
            return self.string()
        if vt == GGUFValueType.ARRAY:
            et = GGUFValueType(self.u32())
            n = self.u64()
            if et == GGUFValueType.STRING:
                return [self.string() for _ in range(n)]
            if et == GGUFValueType.ARRAY:
                return [self.value(GGUFValueType.ARRAY) for _ in range(n)]
            dt = _SCALAR_DTYPES[et]
            arr = np.frombuffer(self.buf, dtype=dt, count=n, offset=self.pos)
            self.pos += dt.itemsize * n
            return arr
        return self.scalar(vt)


class GGUFReader:
    """Parse a GGUF file; metadata eagerly, tensor payloads as lazy mmap views.

    `max_kv_bytes` bounds metadata parsing for the header-only fast path
    (equivalent of the reference's 8KB heuristic scan, koboldcpp.py:596).
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._file: BinaryIO = open(self.path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._parse()

    # -- lifecycle ---------------------------------------------------------
    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views still alive; the mmap pages stay mapped
            # until they are garbage collected, which is what we want
            pass
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- parsing -----------------------------------------------------------
    def _parse(self):
        mm = self._mm
        if mm[:4] != GGUF_MAGIC:
            raise ValueError(f"{self.path}: not a GGUF file (magic {mm[:4]!r})")
        cur = _Cursor(mm, 4)
        self.version = cur.u32()
        if self.version not in (2, 3):
            raise ValueError(f"unsupported GGUF version {self.version}")
        n_tensors = cur.u64()
        n_kv = cur.u64()
        for _ in range(n_kv):
            key = cur.string()
            vt = GGUFValueType(cur.u32())
            self.metadata[key] = cur.value(vt)

        infos = []
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.u32()
            ne = [cur.u64() for _ in range(n_dims)]
            ttype = GGMLType(cur.u32())
            offset = cur.u64()
            # GGUF stores ne with the contiguous dim first; numpy row-major
            # shape is the reverse
            shape = tuple(reversed(ne))
            blk, sz = GGML_BLOCK_SIZES[ttype]
            n_elem = int(np.prod(ne)) if ne else 1
            nbytes = n_elem // blk * sz
            infos.append(TensorInfo(name, shape, ttype, offset, nbytes))

        alignment = int(self.metadata.get(Keys.General.ALIGNMENT, GGUF_DEFAULT_ALIGNMENT))
        self.alignment = alignment
        pos = cur.pos
        self.data_offset = (pos + alignment - 1) // alignment * alignment
        self.tensors = {t.name: t for t in infos}

    # -- access ------------------------------------------------------------
    @property
    def architecture(self) -> str:
        return str(self.metadata.get(Keys.General.ARCHITECTURE, ""))

    def arch_key(self, template: str) -> Any:
        """Fetch a per-arch metadata key, e.g. arch_key(Keys.BLOCK_COUNT)."""
        return self.metadata.get(template.format(arch=self.architecture))

    def tensor_raw(self, name: str) -> np.ndarray:
        """Zero-copy uint8 view of a tensor's packed bytes, shaped (rows..., row_bytes)."""
        t = self.tensors[name]
        start = self.data_offset + t.offset
        raw = np.frombuffer(self._mm, dtype=np.uint8, count=t.nbytes, offset=start)
        blk, sz = GGML_BLOCK_SIZES[t.ggml_type]
        if len(t.shape) == 0:
            return raw
        row_bytes = t.shape[-1] // blk * sz if t.shape else t.nbytes
        return raw.reshape(t.shape[:-1] + (row_bytes,))

    def tensor_data(self, name: str, dtype=np.float32) -> np.ndarray:
        """Dequantized tensor as float, logical shape."""
        from . import quants

        t = self.tensors[name]
        raw = self.tensor_raw(name)
        if t.ggml_type in (GGMLType.I8, GGMLType.I16, GGMLType.I32, GGMLType.I64):
            dt = {GGMLType.I8: np.int8, GGMLType.I16: np.int16,
                  GGMLType.I32: np.int32, GGMLType.I64: np.int64}[t.ggml_type]
            return np.ascontiguousarray(raw).view(dt).reshape(t.shape)
        out = quants.dequantize(raw, t.ggml_type, dtype=dtype)
        return out.reshape(t.shape)


class ShardedGGUFReader:
    """Merged view over a gguf-split shard set.

    Counterpart of the reference's split-file loading (split KV constants in
    examples/gguf-split/gguf-split.cpp: `split.no`,
    `split.count`, `split.tensors.count`; filename pattern
    `<prefix>-%05d-of-%05d.gguf`). Shard 1 carries the model metadata; every
    shard has its own tensor index. Exposes the GGUFReader API.
    """

    SPLIT_NO = "split.no"
    SPLIT_COUNT = "split.count"
    SPLIT_TENSORS_COUNT = "split.tensors.count"

    def __init__(self, first_shard: str | os.PathLike):
        self.path = os.fspath(first_shard)
        first = GGUFReader(self.path)
        count = int(first.metadata.get(self.SPLIT_COUNT, 0))
        no = int(first.metadata.get(self.SPLIT_NO, 0))
        if count < 2:
            self.shards = [first]
        else:
            if no != 0:
                first.close()
                raise ValueError(
                    f"{self.path}: is shard {no + 1}/{count}; pass the first "
                    "shard (…-00001-of-…)")
            prefix = _split_prefix(self.path, no, count)
            self.shards = [first]
            for i in range(1, count):
                self.shards.append(GGUFReader(split_path(prefix, i, count)))
        self.version = first.version
        self.metadata: dict[str, Any] = {}
        self.tensors: dict[str, TensorInfo] = {}
        self._owner: dict[str, GGUFReader] = {}
        for shard in self.shards:
            for k, v in shard.metadata.items():
                self.metadata.setdefault(k, v)
            for name, info in shard.tensors.items():
                if name in self.tensors:
                    raise ValueError(f"duplicate tensor {name!r} across shards")
                self.tensors[name] = info
                self._owner[name] = shard

    def close(self):
        for shard in self.shards:
            shard.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def architecture(self) -> str:
        return str(self.metadata.get(Keys.General.ARCHITECTURE, ""))

    def arch_key(self, template: str) -> Any:
        return self.metadata.get(template.format(arch=self.architecture))

    def tensor_raw(self, name: str) -> np.ndarray:
        return self._owner[name].tensor_raw(name)

    def tensor_data(self, name: str, dtype=np.float32) -> np.ndarray:
        return self._owner[name].tensor_data(name, dtype=dtype)


def split_path(prefix: str, no: int, count: int) -> str:
    """Shard filename, reference pattern `%s-%05d-of-%05d.gguf`
    (llama_split_path, src/llama.cpp)."""
    return f"{prefix}-{no + 1:05d}-of-{count:05d}.gguf"


def _split_prefix(path: str, no: int, count: int) -> str:
    suffix = f"-{no + 1:05d}-of-{count:05d}.gguf"
    if not path.endswith(suffix):
        raise ValueError(
            f"{path}: split shard filename must end with {suffix!r}")
    return path[: -len(suffix)]


def open_gguf(path: str | os.PathLike) -> GGUFReader | ShardedGGUFReader:
    """Open a GGUF file; transparently merges gguf-split shard sets when the
    file carries `split.count` > 1."""
    r = GGUFReader(path)
    if int(r.metadata.get(ShardedGGUFReader.SPLIT_COUNT, 0)) >= 2:
        r.close()
        return ShardedGGUFReader(path)
    return r


def read_header_metadata(path: str | os.PathLike) -> dict[str, Any]:
    """Cheap header-only metadata read (no tensor index needed by callers).

    Counterpart of the reference's fast pre-load scan used for auto-sizing
    (koboldcpp.py:596 read_gguf_metadata).
    """
    with GGUFReader(path) as r:
        return dict(r.metadata)
