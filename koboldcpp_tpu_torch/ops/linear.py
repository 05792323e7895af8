"""Weight containers + matmul dispatch.

A `QTensor` holds either a dense weight or a packed quantized layout that
stays packed in device memory and is dequantized inside the matmul kernel
(ops/quant_matmul.py). Logical weight shape is (out, in) and matmul computes
x @ W^T, ggml's mul_mat contract.

Packed layouts keep only the logical fields (none of the JAX package's
TPU-specific transposed or plane-major sidecars):
  q4_k: qs2 (out, in/2) u8 — byte b of 256-col superblock s holds col 256s+b
        in the low nibble and col 256s+128+b in the high nibble; scale / min
        (out, in/32) bf16 in logical group order; w = q*scale - min.
  q6_k: ql (out, in/2) u8 and qh (out, in/4) u8 in ggml's block order (element
        256s+128h+32j+l: low nibble of ql[128s+64h+32(j&1)+l] (high nibble
        for j>=2), bits 2j..2j+1 of qh[64s+32h+l]); scale (out, in/16) bf16;
        w = (q6-32)*scale.
The bf16 scale products are bit-identical to the JAX packers'.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..gguf import quants as nq
from ..gguf.constants import GGMLType, QK_K


@dataclass
class QTensor:
    kind: str  # "dense" | "q4_k" | "q6_k"
    shape: tuple[int, ...]  # logical (out, in)
    data: dict[str, Any] = field(default_factory=dict)

    @property
    def in_features(self) -> int:
        return self.shape[1]


def _bf16(a: np.ndarray, device) -> torch.Tensor:
    """f32 numpy -> bf16 tensor (round to nearest even, like jnp.asarray)."""
    return torch.from_numpy(np.array(a, np.float32, order="C")).to(
        torch.bfloat16).to(device)


def _u8(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint8, order="C")).to(device)


def dense(w, dtype=torch.bfloat16, device="cpu") -> QTensor:
    w = torch.as_tensor(np.asarray(w) if not isinstance(w, torch.Tensor)
                        else w).to(device=device, dtype=dtype)
    return QTensor(kind="dense", shape=tuple(w.shape), data={"w": w})


# ---------------------------------------------------------------------------
# packed layouts (built on host from GGUF raw bytes, no dequant round-trip)
# ---------------------------------------------------------------------------

def pack_q4_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 144)
    d = blocks[:, :, 0:2].copy().view(np.float16).astype(np.float32)[..., 0]
    dmin = blocks[:, :, 2:4].copy().view(np.float16).astype(np.float32)[..., 0]
    sc, mn = nq._unpack_scale_min_k4(blocks[:, :, 4:16].reshape(-1, 12))
    scales = (d.reshape(-1, 1) * sc).reshape(rows, nsb * 8)
    mins = (dmin.reshape(-1, 1) * mn).reshape(rows, nsb * 8)
    qs = blocks[:, :, 16:].reshape(rows, nsb, 4, 32)
    # logical col order: ggml byte j of 64-group g holds cols 64g+j | 64g+32+j
    q = np.stack([qs & 0xF, qs >> 4], axis=3).reshape(rows, nsb, QK_K)
    qs2 = (q[:, :, :128] | (q[:, :, 128:] << 4)).reshape(rows, cols // 2)
    return QTensor(kind="q4_k", shape=tuple(shape), data={
        "qs2": _u8(qs2, device),
        "scale": _bf16(scales, device),
        "min": _bf16(mins, device),
    })


def pack_q6_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 210)
    ql = blocks[:, :, :128].reshape(rows, nsb * 128)
    qh = blocks[:, :, 128:192].reshape(rows, nsb * 64)
    sc8 = blocks[:, :, 192:208].view(np.int8).astype(np.float32)
    d = blocks[:, :, 208:210].copy().view(np.float16).astype(np.float32)[..., 0]
    scales = (d[..., None] * sc8).reshape(rows, nsb * 16)  # per 16-col group
    return QTensor(kind="q6_k", shape=tuple(shape), data={
        "ql": _u8(ql, device),
        "qh": _u8(qh, device),
        "scale": _bf16(scales, device),
    })


_PACKERS = {GGMLType.Q4_K: pack_q4_k, GGMLType.Q6_K: pack_q6_k}

# Types the JAX package keeps packed but this port does not serve yet, with
# the kernels that would serve them. Loading one raises instead of silently
# dequantizing it to a dense weight.
_UNPORTED = {GGMLType.Q5_K: "K1/K3 (q5_k bodies)", GGMLType.Q8_0: "K12/K13"}
for _t in (GGMLType.Q2_K, GGMLType.Q3_K, GGMLType.Q4_0, GGMLType.Q4_1,
           GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.IQ4_NL, GGMLType.IQ4_XS,
           GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ2_XXS,
           GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ1_S, GGMLType.IQ1_M,
           GGMLType.TQ1_0, GGMLType.TQ2_0):
    _UNPORTED[_t] = "K12/K13"
_32COL_TYPES = (GGMLType.Q8_0, GGMLType.IQ4_NL, GGMLType.IQ4_XS,
                GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ2_XXS,
                GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ1_S,
                GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0)
_BLOCK32_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)


def from_gguf(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...],
              packed: bool = True, dtype=torch.bfloat16,
              device="cpu") -> QTensor:
    """Build a QTensor from GGUF raw bytes. 2-D q4_k/q6_k weights keep their
    packed layout; the types the JAX package also dequantizes (f32/f16/bf16,
    1-D tensors, packed=False) become dense; the other packed types raise."""
    if packed and len(shape) == 2:
        cols = shape[1]
        need = 32 if ggml_type in _32COL_TYPES else QK_K
        if ggml_type in _PACKERS and cols % QK_K == 0:
            return _PACKERS[ggml_type](raw, shape, device)
        if ggml_type in _UNPORTED and (
                cols % need == 0
                or (ggml_type in _BLOCK32_TYPES and cols % 32 == 0)):
            raise NotImplementedError(
                f"{ggml_type.name} weights are served packed by kernel "
                f"{_UNPORTED[ggml_type]}, which is not ported yet")
    x = nq.dequantize(raw.reshape(-1, raw.shape[-1]), ggml_type).reshape(shape)
    return dense(x, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# dequant (the port of the JAX package's XLA dequant path)
# ---------------------------------------------------------------------------

def q4k_values(qs2: torch.Tensor) -> torch.Tensor:
    """(R, in/2) plane-split bytes -> (R, in) logical-order nibbles (u8)."""
    qs = qs2.reshape(qs2.shape[0], -1, 128)
    return torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(qs2.shape[0], -1)


def q6k_values(ql: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """ggml q6_k bytes -> (R, in) logical-order 6-bit values 0..63 (int32)."""
    rows = ql.shape[0]
    ql4 = ql.reshape(rows, -1, 2, 32).int()   # (R, nsb*2, byte-group, l)
    qhi = qh.reshape(rows, -1, 32).int()      # (R, nsb*2, l)
    planes = torch.stack([
        (ql4[:, :, 0] & 0xF) | ((qhi & 3) << 4),
        (ql4[:, :, 1] & 0xF) | (((qhi >> 2) & 3) << 4),
        (ql4[:, :, 0] >> 4) | (((qhi >> 4) & 3) << 4),
        (ql4[:, :, 1] >> 4) | (((qhi >> 6) & 3) << 4),
    ], dim=2)  # (R, nsb*2, plane, 32): elem 128h+32j+l
    return planes.reshape(rows, -1)


def dequant(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack a QTensor to a dense (out, in) tensor (f32 math)."""
    rows, cols = qt.shape
    if qt.kind == "dense":
        return qt.data["w"].to(dtype)
    if qt.kind == "q4_k":
        q = q4k_values(qt.data["qs2"]).float().reshape(rows, -1, 32)
        s = qt.data["scale"].float()[..., None]
        m = qt.data["min"].float()[..., None]
        return (q * s - m).reshape(rows, cols).to(dtype)
    if qt.kind == "q6_k":
        q = (q6k_values(qt.data["ql"], qt.data["qh"]) - 32).float()
        s = qt.data["scale"].float()[..., None]
        return (q.reshape(rows, -1, 16) * s).reshape(rows, cols).to(dtype)
    raise ValueError(f"unknown QTensor kind {qt.kind}")


# imatrix collection hook: when set, every matmul records sum-of-squared
# activations per input column (the importance statistics of llama.cpp's
# imatrix example)
_COLLECTOR = None


class ActivationCollector:
    """Accumulates per-column sum(x^2) for named QTensors (imatrix)."""

    def __init__(self, names: dict[int, str]):
        self.names = names  # id(QTensor) -> tensor name
        self.sums: dict[str, np.ndarray] = {}
        self.counts: dict[str, int] = {}

    def record(self, qt: QTensor, x: torch.Tensor) -> None:
        name = self.names.get(id(qt))
        if name is None:
            return
        x2 = x.detach().float().reshape(-1, qt.in_features)
        s = (x2 * x2).sum(dim=0).cpu().numpy()
        if name in self.sums:
            self.sums[name] += s
            self.counts[name] += x2.shape[0]
        else:
            self.sums[name] = s
            self.counts[name] = x2.shape[0]

    def weights(self) -> dict[str, np.ndarray]:
        return {n: s / max(self.counts[n], 1) for n, s in self.sums.items()}


def matmul(x: torch.Tensor, qt: QTensor, out_dtype=None) -> torch.Tensor:
    """y = x @ W^T for any QTensor. x: (..., in) -> (..., out). Packed
    weights go to the kernels; shapes no kernel covers dequantize and
    multiply with f32 accumulation, as the JAX package's XLA path does."""
    if _COLLECTOR is not None:
        _COLLECTOR.record(qt, x)
    out_dtype = out_dtype or x.dtype
    if qt.kind == "dense":
        w = qt.data["w"]
    else:
        from . import quant_matmul

        y = quant_matmul.matmul_packed(x, qt)
        if y is not None:
            return y.to(out_dtype)
        w = dequant(qt, dtype=x.dtype)
    y = torch.matmul(x.float(), w.float().t())
    return y.to(out_dtype)
