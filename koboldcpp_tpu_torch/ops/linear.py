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
        From a Q4_K file also sc (out, in/32) u8, the 6-bit sub-scales, and
        d (out, in/256) f32, the superblock scale: scale = bf16(d * sc)
        (K14 reads sc and d).
  q5_k: q4_k's qs2 / scale / min (and sc / d) for the low 4 bits, plus qh
        (out, in/8) u8, one bit per weight: bit b of byte j is the 5th bit
        of logical col 8j+b; w = q5*scale - min with q5 = nibble | bit << 4.
  q6_k: ql (out, in/2) u8 and qh (out, in/4) u8 in ggml's block order (element
        256s+128h+32j+l: low nibble of ql[128s+64h+32(j&1)+l] (high nibble
        for j>=2), bits 2j..2j+1 of qh[64s+32h+l]); scale (out, in/16) bf16;
        w = (q6-32)*scale.
  q8_0: q (out, in) int8 and scale (out, in/32) bf16; w = q*scale.
  q2_k: qs (out, in/4) u8, ggml's raw 2-bit stream (element 256s+128h+32j+l
        is bits 2j..2j+1 of qs[64s+32h+l]); scale / min (out, in/16) bf16 in
        logical group order; w = q2*scale - min.
  q3_k: q2_k's qs for the low 2 bits, plus hmask (out, in/8) u8, ggml's raw
        high-bit mask (bit 4h+j of hmask[32s+l] is the 3rd bit of element
        256s+128h+32j+l); scale (out, in/16) bf16, the signed 6-bit
        sub-scale times d; w = (q3-4)*scale with q3 = q2 | bit << 2.
  iq2p / iq3px / iq3ps / iq1p (the native IQ1-3 kinds): per-element codes
        decoded by arithmetic, no grid lookup. qs (out, in/4) u8 holds 2-bit
        codes in q2_k's stream order; iq3px / iq3ps add the code's 3rd bit
        in hmask (out, in/8) u8, q3_k's hmask order; iq2p / iq3px / iq3ps
        keep the sign bit in sg (out, in/8) u8, the same order. The value of
        code c is 8 + 17c + (c >> 1) in {8, 25, 43} (iq2p), 4 + 8c with 62
        at c = 7 (iq3px), 2c + 1 (iq3ps), c - 1 in {-1, 0, 1} (iq1p, no
        sign); scale (out, in/G) bf16 per group of G = 8, 16 or 32 columns
        in logical group order, and iq1p's min (out, in/G) bf16 = -(scale *
        delta); w = v * scale (- min).
Opt-in layouts, chosen at load as the JAX package chooses them (the
environment is read by `from_gguf`):
  q4_k_i8 (KCPP_Q4K_LAYOUT=i8, GGUF Q4_K): q (out, in) int8, the codes
        0..15 in logical order, and q4_k's scale / min; w = q*scale - min.
  q6_k_i8f (KCPP_KQ_LAYOUT=expanded, GGUF Q6_K): q6_k's fields plus q
        (out, in) int8, the signed values q6-32 in logical order;
        w = q*scale.
  q3_k_n4 / q2_k_n4 (KCPP_KQ_LAYOUT=expanded, GGUF Q3_K / Q2_K): q3_k's or
        q2_k's fields plus n4 (out, in/2) u8, the codes (q3 0..7, q2 0..3)
        as nibbles paired within each 32-column block: byte 16b+k holds col
        32b+k in the low nibble and col 32b+16+k in the high nibble (the
        JAX layout pairs cols c and c+in/2 of the whole row; the values are
        the same); w = (q3-4)*scale or q2*scale - min.
  The expanded kinds keep the dense kind's fields, as the JAX packs do:
  their T=1 matvec reads the expanded plane, every other T the dense one.
GGUF types map onto these kinds as the JAX package's `from_gguf` maps them:
Q2_K onto q2_k, Q3_K onto q3_k, Q4_0/Q4_1 onto q4_k, Q5_0/Q5_1 onto q5_k,
IQ2_XXS/IQ2_XS/IQ2_S onto iq2p, IQ3_XXS onto iq3px, IQ3_S onto iq3ps and
IQ1_S/IQ1_M onto iq1p (widths that are a multiple of 256), and
IQ4_NL/IQ4_XS/TQ1_0/TQ2_0 (and the IQ1-3 and block-32 types at other widths)
onto q8_0 by exact dequant and int8 requantization per 32 columns. The bf16
scale products are bit-identical to the JAX packers'.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from functools import partial
from typing import Any

import numpy as np
import torch

from ..gguf import quants as nq
from ..gguf.constants import GGMLType, QK_K


@dataclass
class QTensor:
    kind: str  # "dense" | "q2_k" ... "q8_0" | the IQ kinds | the opt-in kinds
    shape: tuple[int, ...]  # logical (out, in)
    data: dict[str, Any] = field(default_factory=dict)
    # a row-parallel shard's whole weight's in_f (0: the weight is whole):
    # the dispatch picks the activation variant on it, so that the shard's
    # group dots are the whole weight's
    whole_in_f: int = 0

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

def _f16(blocks: np.ndarray, at: int) -> np.ndarray:
    """The fp16 field at byte `at` of each block, as f32."""
    return blocks[..., at:at + 2].copy().view(np.float16).astype(np.float32)[
        ..., 0]


def _k_scales(blocks: np.ndarray, rows: int, nsb: int):
    """Q4_K/Q5_K superblocks -> per-32-col (scale, min) f32, logical order,
    and the raw factors of the scale: the 6-bit sub-scales sc (R, nsb*8)
    and the superblock d (R, nsb) f32, scale = d * sc."""
    d, dmin = _f16(blocks, 0), _f16(blocks, 2)
    sc, mn = nq._unpack_scale_min_k4(blocks[:, :, 4:16].reshape(-1, 12))
    return ((d.reshape(-1, 1) * sc).reshape(rows, nsb * 8),
            (dmin.reshape(-1, 1) * mn).reshape(rows, nsb * 8),
            sc.reshape(rows, nsb * 8), d)


def _q45_fields(q: np.ndarray, scales: np.ndarray, mins: np.ndarray,
                shape, device, hi_bits: np.ndarray | None = None,
                sc: np.ndarray | None = None,
                d: np.ndarray | None = None) -> QTensor:
    """Logical-order codes (R, C) (low 4 bits; the 5th in hi_bits, 0/1) and
    per-32-col scales / mins (w = q*scale - min) -> a q4_k or q5_k QTensor
    (the port of the JAX `_fields_4bit_planes`). A K-quant file also gives
    the scale's factors (sc, d), which K14 reads (the JAX `scp_lo` /
    `scp_hi` / `d_sbt`); the legacy block types have none."""
    rows, cols = shape
    qs = q.reshape(rows, cols // QK_K, QK_K)
    qs2 = ((qs[:, :, :128] & 0xF) | ((qs[:, :, 128:] & 0xF) << 4))
    data = {"qs2": _u8(qs2.reshape(rows, cols // 2), device),
            "scale": _bf16(scales.reshape(rows, cols // 32), device),
            "min": _bf16(mins.reshape(rows, cols // 32), device)}
    if sc is not None:
        data["sc"] = _u8(sc.reshape(rows, cols // 32), device)
        data["d"] = torch.from_numpy(np.array(
            d.reshape(rows, cols // QK_K), np.float32, order="C")).to(device)
    if hi_bits is None:
        return QTensor(kind="q4_k", shape=tuple(shape), data=data)
    data["qh"] = _u8(np.packbits(hi_bits.reshape(rows, cols).astype(np.uint8),
                                 axis=1, bitorder="little"), device)
    return QTensor(kind="q5_k", shape=tuple(shape), data=data)


def _kquant_nibbles(qs: np.ndarray, rows: int, nsb: int) -> np.ndarray:
    """Q4_K/Q5_K qs (R, nsb, 128) -> logical-order nibbles (R, nsb*256):
    ggml byte l of 64-group k holds cols 64k+l | 64k+32+l."""
    qs = qs.reshape(rows, nsb, 4, 32)
    return np.stack([qs & 0xF, qs >> 4], axis=3).reshape(rows, nsb * QK_K)


def pack_q4_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 144)
    scales, mins, sc, d = _k_scales(blocks, rows, nsb)
    return _q45_fields(_kquant_nibbles(blocks[:, :, 16:], rows, nsb), scales,
                       mins, shape, device, sc=sc, d=d)


def pack_q5_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q5_K (176-byte superblocks: d, dmin, 12 scale bytes, qh[32],
    qs[128]); qh byte l bit b is the 5th bit of col 32b+l of the superblock
    (dequantize_row_q5_K, ggml/src/ggml-quants.c)."""
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 176)
    scales, mins, sc, d = _k_scales(blocks, rows, nsb)
    qh = blocks[:, :, 16:48].reshape(rows, nsb, 1, 32)
    bits = (qh >> np.arange(8, dtype=np.uint8)[None, None, :, None]) & 1
    return _q45_fields(_kquant_nibbles(blocks[:, :, 48:], rows, nsb), scales,
                       mins, shape, device, hi_bits=bits, sc=sc, d=d)


def pack_q6_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 210)
    ql = blocks[:, :, :128].reshape(rows, nsb * 128)
    qh = blocks[:, :, 128:192].reshape(rows, nsb * 64)
    sc8 = blocks[:, :, 192:208].view(np.int8).astype(np.float32)
    d = _f16(blocks, 208)
    scales = (d[..., None] * sc8).reshape(rows, nsb * 16)  # per 16-col group
    return QTensor(kind="q6_k", shape=tuple(shape), data={
        "ql": _u8(ql, device),
        "qh": _u8(qh, device),
        "scale": _bf16(scales, device),
    })


def pack_q2_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q2_K (84-byte superblocks: scales[16], qs[64], fp16 d, fp16 dmin);
    sub-scale byte g of a superblock holds group g's scale (low nibble) and
    min (high nibble), each times d or dmin in f32, then rounded to bf16 as
    the JAX `pack_q2_k` rounds them (dequantize_row_q2_K,
    ggml/src/ggml-quants.c)."""
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 84)
    sc = blocks[:, :, :16]
    d, dmin = _f16(blocks, 80), _f16(blocks, 82)
    return QTensor(kind="q2_k", shape=tuple(shape), data={
        "qs": _u8(blocks[:, :, 16:80].reshape(rows, nsb * 64), device),
        "scale": _bf16((d[..., None] * (sc & 0xF)).reshape(rows, nsb * 16),
                       device),
        "min": _bf16((dmin[..., None] * (sc >> 4)).reshape(rows, nsb * 16),
                     device),
    })


def pack_q3_k(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q3_K (110-byte superblocks: hmask[32], qs[64], 12 bytes of 6-bit
    sub-scales, fp16 d); the scale is d * (sc - 32) in f32, rounded to bf16
    as the JAX `pack_q3_k` rounds it (dequantize_row_q3_K)."""
    rows, cols = shape
    nsb = cols // QK_K
    blocks = np.ascontiguousarray(raw).reshape(rows, nsb, 110)
    sc = nq._unpack_q3_scales(blocks[:, :, 96:108].reshape(-1, 12)).astype(
        np.float32).reshape(rows, nsb, 16) - 32.0
    return QTensor(kind="q3_k", shape=tuple(shape), data={
        "qs": _u8(blocks[:, :, 32:96].reshape(rows, nsb * 64), device),
        "hmask": _u8(blocks[:, :, :32].reshape(rows, nsb * 32), device),
        "scale": _bf16((_f16(blocks, 108)[..., None] * sc).reshape(
            rows, nsb * 16), device),
    })


def pack_q8_0(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q8_0 (34-byte blocks: fp16 d, 32 int8): int8 codes, d rounded to
    bf16 as the JAX `pack_q8_0` rounds it."""
    rows, cols = shape
    blocks = np.ascontiguousarray(raw).reshape(rows, cols // 32, 34)
    q = blocks[:, :, 2:].copy().view(np.int8).reshape(rows, cols)
    return QTensor(kind="q8_0", shape=tuple(shape), data={
        "q": torch.from_numpy(q).to(device),
        "scale": _bf16(_f16(blocks, 0), device),
    })


def _block32(raw: np.ndarray, shape, nbytes: int, nhead: int):
    """Legacy 32-col blocks -> (blocks, logical-order low nibbles (R, C)):
    qs byte j holds elem j in the low nibble and elem j+16 in the high."""
    rows, cols = shape
    blocks = np.ascontiguousarray(raw).reshape(rows, cols // 32, nbytes)
    qs = blocks[:, :, nhead:]
    return blocks, np.concatenate([qs & 0xF, qs >> 4], axis=2).reshape(
        rows, cols)


def _block32_hi_bits(blocks: np.ndarray, at: int, shape) -> np.ndarray:
    """The u32 qh at byte `at` of each Q5_0/Q5_1 block: bit j is the 5th
    bit of elem j -> (R, C) 0/1 in logical order."""
    qh = blocks[:, :, at:at + 4].copy().view(np.uint32)[..., 0]
    return ((qh[..., None] >> np.arange(32, dtype=np.uint32)) & 1).reshape(
        shape)


def pack_q4_0(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q4_0 (w = (q-8)d, ggml-common.h:144) as q4_k: scale d, min 8d."""
    blocks, q = _block32(raw, shape, 18, 2)
    d = _f16(blocks, 0)
    return _q45_fields(q, d, 8.0 * d, shape, device)


def pack_q4_1(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q4_1 (w = q*d + m) as q4_k: scale d, min -m."""
    blocks, q = _block32(raw, shape, 20, 4)
    return _q45_fields(q, _f16(blocks, 0), -_f16(blocks, 2), shape, device)


def pack_q5_0(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q5_0 (w = (q5-16)d) as q5_k: scale d, min 16d."""
    blocks, q = _block32(raw, shape, 22, 6)
    d = _f16(blocks, 0)
    return _q45_fields(q, d, 16.0 * d, shape, device,
                       hi_bits=_block32_hi_bits(blocks, 2, shape))


def pack_q5_1(raw: np.ndarray, shape: tuple[int, int],
              device="cpu") -> QTensor:
    """Q5_1 (w = q5*d + m) as q5_k: scale d, min -m."""
    blocks, q = _block32(raw, shape, 24, 8)
    return _q45_fields(q, _f16(blocks, 0), -_f16(blocks, 2), shape, device,
                       hi_bits=_block32_hi_bits(blocks, 4, shape))


def pack_q8_expand(raw: np.ndarray, shape: tuple[int, int], device="cpu",
                   ggml_type: GGMLType = GGMLType.IQ4_NL) -> QTensor:
    """Exact dequant (gguf/quants.py), then int8 requantization per 32
    columns with scale amax/127: the q8_0 kind serves IQ4_NL, IQ4_XS, TQ1_0,
    TQ2_0 and the legacy block-32 types at widths that are not a multiple
    of 256 (the JAX `pack_q8_expand`, in the same f32 numpy arithmetic)."""
    rows, cols = shape
    w = nq.dequantize(raw.reshape(rows, -1), ggml_type).reshape(rows, cols)
    g = w.reshape(rows, cols // 32, 32).astype(np.float32)
    scale = np.abs(g).max(axis=2) / 127.0
    inv = np.where(scale > 0, 1.0 / np.maximum(scale, 1e-30), 0.0)
    q = np.clip(np.round(g * inv[..., None]), -127, 127).astype(np.int8)
    return QTensor(kind="q8_0", shape=tuple(shape), data={
        "q": torch.from_numpy(q.reshape(rows, cols)).to(device),
        "scale": _bf16(scale, device),
    })


IQ_KINDS = ("iq2p", "iq3px", "iq3ps", "iq1p")
_IQ_NATIVE_KINDS = {
    GGMLType.IQ2_XXS: "iq2p", GGMLType.IQ2_XS: "iq2p", GGMLType.IQ2_S: "iq2p",
    GGMLType.IQ3_XXS: "iq3px", GGMLType.IQ3_S: "iq3ps",
    GGMLType.IQ1_S: "iq1p", GGMLType.IQ1_M: "iq1p",
}
# |grid value| -> the code its kind decodes by arithmetic (the JAX package's
# maps: a magnitude outside the alphabet, which no grid holds, maps to 0)
_IQ2_CODE = np.zeros(64, np.uint8)
_IQ2_CODE[[8, 25, 43]] = [0, 1, 2]
_IQ3X_CODE = np.zeros(64, np.uint8)
_IQ3X_CODE[[4, 12, 20, 28, 36, 44, 52, 62]] = np.arange(8)
_IQ3S_CODE = np.zeros(16, np.uint8)
_IQ3S_CODE[[1, 3, 5, 7, 9, 11, 13, 15]] = np.arange(8)


def _qs_stream(code: np.ndarray) -> np.ndarray:
    """(R, C) 2-bit codes -> (R, C/4) bytes in q2_k's stream order (element
    256s+128h+32j+l in bits 2j..2j+1 of byte 64s+32h+l)."""
    rows = code.shape[0]
    c = code.reshape(rows, -1, 4, 32).astype(np.uint8)  # (R, 2s+h, j, l)
    return (c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4)
            | (c[:, :, 3] << 6)).reshape(rows, -1)


def _hmask_stream(bits: np.ndarray) -> np.ndarray:
    """(R, C) 0/1 -> (R, C/8) bytes in q3_k's hmask order (the bit of
    element 256s+128h+32j+l is bit 4h+j of byte 32s+l)."""
    rows = bits.shape[0]
    b = bits.reshape(rows, -1, 8, 32).astype(np.uint8)  # (R, s, 4h+j, l)
    return (b << np.arange(8, dtype=np.uint8)[None, None, :, None]).sum(
        axis=2, dtype=np.uint8).reshape(rows, -1)


def pack_iq(raw: np.ndarray, shape: tuple[int, int], device="cpu",
            ggml_type: GGMLType = GGMLType.IQ2_XXS) -> QTensor:
    """IQ2_XXS/XS/S, IQ3_XXS/S, IQ1_S/M -> iq2p / iq3px / iq3ps / iq1p (the
    JAX `pack_iq_native` values, in the port's layout, see the module
    docstring): `iq_decompose` gives the signed grid values, f32 per-G
    scales and IQ1's delta; the scales round to bf16 as JAX rounds them,
    and iq1p's min is bf16(-(scale * delta)) of the f32 product."""
    rows, cols = shape
    v, scales, delta, G = nq.iq_decompose(raw.reshape(rows, -1), ggml_type)
    v = v.reshape(rows, cols).astype(np.int16)
    scales = scales.reshape(rows, cols // G)
    kind = _IQ_NATIVE_KINDS[ggml_type]
    mag = np.abs(v)
    code = (v + 1 if kind == "iq1p"
            else {"iq2p": _IQ2_CODE, "iq3px": _IQ3X_CODE,
                  "iq3ps": _IQ3S_CODE}[kind][mag]).astype(np.uint8)
    data = {"qs": _u8(_qs_stream(code & 3), device),
            "scale": _bf16(scales, device)}
    if kind in ("iq3px", "iq3ps"):
        data["hmask"] = _u8(_hmask_stream(code >> 2), device)
    if kind == "iq1p":
        data["min"] = _bf16(-(scales * delta.reshape(rows, cols // G)),
                            device)
    else:
        data["sg"] = _u8(_hmask_stream(v < 0), device)
    return QTensor(kind=kind, shape=tuple(shape), data=data)


# ---------------------------------------------------------------------------
# the opt-in layouts (KCPP_Q4K_LAYOUT=i8, KCPP_KQ_LAYOUT=expanded): each a
# relayout of the dense kind's QTensor, so a GGUF tensor and a synthetic one
# take the same path (the JAX `pack_q4_k_i8`, `pack_q6_k_i8f`,
# `pack_q3_k_n4`, `pack_q2_k_n4`)
# ---------------------------------------------------------------------------

EXPANDED = {"q6_k_i8f": "q6_k", "q3_k_n4": "q3_k", "q2_k_n4": "q2_k"}


def n4_pack(v: torch.Tensor) -> torch.Tensor:
    """(R, C) codes 0..15 -> (R, C/2) u8: byte 16b+k holds col 32b+k in the
    low nibble and col 32b+16+k in the high one."""
    p = v.to(torch.uint8).reshape(v.shape[0], -1, 2, 16)
    return (p[:, :, 0] | (p[:, :, 1] << 4)).reshape(v.shape[0], -1)


def n4_values(n4: torch.Tensor) -> torch.Tensor:
    """The inverse of n4_pack: (R, C/2) u8 -> (R, C) logical-order codes."""
    p = n4.reshape(n4.shape[0], -1, 16)
    return torch.cat([p & 0xF, p >> 4], dim=2).reshape(n4.shape[0], -1)


def to_q4_k_i8(qt: QTensor) -> QTensor:
    """q4_k -> q4_k_i8: the same codes as int8, the same scale and min."""
    d = qt.data
    return QTensor(kind="q4_k_i8", shape=qt.shape, data={
        "q": q4k_values(d["qs2"]).to(torch.int8),
        "scale": d["scale"], "min": d["min"]})


def to_expanded(qt: QTensor) -> QTensor:
    """q6_k -> q6_k_i8f, q3_k -> q3_k_n4, q2_k -> q2_k_n4: the dense fields
    plus the expanded plane of the same values."""
    d = dict(qt.data)
    if qt.kind == "q6_k":
        d["q"] = (q6k_values(d["ql"], d["qh"]) - 32).to(torch.int8)
        return QTensor(kind="q6_k_i8f", shape=qt.shape, data=d)
    d["n4"] = n4_pack(q3k_values(d["qs"], d["hmask"]) if qt.kind == "q3_k"
                      else q2k_values(d["qs"]))
    return QTensor(kind=f"{qt.kind}_n4", shape=qt.shape, data=d)


def _q4k_packer(raw, shape, device="cpu") -> QTensor:
    """GGUF Q4_K: q4_k, or q4_k_i8 under KCPP_Q4K_LAYOUT=i8."""
    qt = pack_q4_k(raw, shape, device)
    if os.environ.get("KCPP_Q4K_LAYOUT", "packed") == "i8":
        return to_q4_k_i8(qt)
    return qt


def _kq_packer(dense_fn):
    """GGUF Q6_K / Q3_K / Q2_K: the dense kind, or its expanded kind under
    KCPP_KQ_LAYOUT=expanded."""
    def pick(raw, shape, device="cpu") -> QTensor:
        qt = dense_fn(raw, shape, device)
        if os.environ.get("KCPP_KQ_LAYOUT", "dense") == "expanded":
            return to_expanded(qt)
        return qt
    return pick


_PACKERS = {GGMLType.Q8_0: pack_q8_0, GGMLType.Q2_K: _kq_packer(pack_q2_k),
            GGMLType.Q3_K: _kq_packer(pack_q3_k), GGMLType.Q4_K: _q4k_packer,
            GGMLType.Q5_K: pack_q5_k, GGMLType.Q6_K: _kq_packer(pack_q6_k),
            GGMLType.Q4_0: pack_q4_0, GGMLType.Q4_1: pack_q4_1,
            GGMLType.Q5_0: pack_q5_0, GGMLType.Q5_1: pack_q5_1}
for _t in (GGMLType.IQ4_NL, GGMLType.IQ4_XS, GGMLType.TQ1_0, GGMLType.TQ2_0):
    _PACKERS[_t] = partial(pack_q8_expand, ggml_type=_t)


def _iq_packer(raw, shape, device="cpu", ggml_type=GGMLType.IQ2_XXS):
    """IQ1 / IQ2 / IQ3: the native kinds (default), or the int8
    re-expansion to q8_0 under KCPP_IQ_NATIVE=0 (the JAX `_iq_packer`),
    served by K2.q8_0 / K3.q8_0; read at load."""
    if os.environ.get("KCPP_IQ_NATIVE", "1") == "1":
        return pack_iq(raw, shape, device, ggml_type)
    return pack_q8_expand(raw, shape, device, ggml_type)


for _t in _IQ_NATIVE_KINDS:
    _PACKERS[_t] = partial(_iq_packer, ggml_type=_t)
_32COL_TYPES = (GGMLType.Q8_0, GGMLType.IQ4_NL, GGMLType.IQ4_XS,
                GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ2_XXS,
                GGMLType.IQ2_XS, GGMLType.IQ2_S, GGMLType.IQ1_S,
                GGMLType.IQ1_M, GGMLType.TQ1_0, GGMLType.TQ2_0)
_BLOCK32_TYPES = (GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0, GGMLType.Q5_1)


def from_gguf(raw: np.ndarray, ggml_type: GGMLType, shape: tuple[int, ...],
              packed: bool = True, dtype=torch.bfloat16,
              device="cpu") -> QTensor:
    """Build a QTensor from GGUF raw bytes, as the JAX `from_gguf` does: 2-D
    weights of a packed type keep a packed layout (the IQ1-3 types natively
    at widths that are a multiple of 256 unless KCPP_IQ_NATIVE=0, and they and the block-32 types
    at other widths through `pack_q8_expand`; Q4_K as q4_k_i8 under
    KCPP_Q4K_LAYOUT=i8, Q6_K / Q3_K / Q2_K as their expanded kinds under
    KCPP_KQ_LAYOUT=expanded); f32 / f16 / bf16, 1-D tensors and
    packed=False become dense."""
    if packed and len(shape) == 2:
        cols = shape[1]
        need = 32 if ggml_type in _32COL_TYPES else QK_K
        if cols % need == 0:
            if ggml_type in _IQ_NATIVE_KINDS and cols % QK_K:
                return pack_q8_expand(raw, shape, device, ggml_type)
            if ggml_type in _PACKERS:
                return _PACKERS[ggml_type](raw, shape, device)
        elif ggml_type in _BLOCK32_TYPES and cols % 32 == 0:
            return pack_q8_expand(raw, shape, device, ggml_type)
    x = nq.dequantize(raw.reshape(-1, raw.shape[-1]), ggml_type).reshape(shape)
    return dense(x, dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# dequant (the port of the JAX package's XLA dequant path)
# ---------------------------------------------------------------------------

def q4k_values(qs2: torch.Tensor) -> torch.Tensor:
    """(R, in/2) plane-split bytes -> (R, in) logical-order nibbles (u8)."""
    qs = qs2.reshape(qs2.shape[0], -1, 128)
    return torch.cat([qs & 0xF, qs >> 4], dim=2).reshape(qs2.shape[0], -1)


def q5k_values(qs2: torch.Tensor, qh: torch.Tensor) -> torch.Tensor:
    """q5_k fields -> (R, in) logical-order 5-bit values 0..31 (u8)."""
    bits = (qh[:, :, None] >> torch.arange(8, dtype=torch.uint8,
                                           device=qh.device)) & 1
    return q4k_values(qs2) | (bits.reshape(qh.shape[0], -1) << 4)


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


def q2k_values(qs: torch.Tensor) -> torch.Tensor:
    """(R, in/4) ggml 2-bit stream -> (R, in) logical-order values 0..3
    (u8): byte 32h+l of a 64-byte superblock holds elements 128h+32j+l."""
    b = qs.reshape(qs.shape[0], -1, 1, 32)                # (R, nsb*2, ., l)
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8,
                          device=qs.device)[None, None, :, None]
    return ((b >> shifts) & 3).reshape(qs.shape[0], -1)  # (., 4 planes, l)


def hmask_bits(hmask: torch.Tensor) -> torch.Tensor:
    """(R, in/8) bytes in q3_k's hmask order -> (R, in) logical-order bits
    (u8): the bit of element 256s+128h+32j+l is bit 4h+j of hmask[32s+l]."""
    rows = hmask.shape[0]
    hm = hmask.reshape(rows, -1, 1, 1, 32)               # (R, nsb, h, j, l)
    bit = torch.arange(8, dtype=torch.uint8, device=hmask.device).reshape(
        1, 1, 2, 4, 1)
    return ((hm >> bit) & 1).reshape(rows, -1)


def q3k_values(qs: torch.Tensor, hmask: torch.Tensor) -> torch.Tensor:
    """q3_k fields -> (R, in) logical-order 3-bit values 0..7 (u8)."""
    return q2k_values(qs) | (hmask_bits(hmask) << 2)


def iq_values(qt: QTensor) -> torch.Tensor:
    """An iq2p / iq3px / iq3ps / iq1p QTensor -> (R, in) logical-order
    signed values (int32): the kind's alphabet value of each code, negated
    where its sign bit is set."""
    d = qt.data
    c = (q3k_values(d["qs"], d["hmask"]) if "hmask" in d
         else q2k_values(d["qs"])).int()
    if qt.kind == "iq1p":
        return c - 1
    v = (8 + 17 * c + (c >> 1) if qt.kind == "iq2p"
         else torch.where(c == 7, 62, 4 + 8 * c) if qt.kind == "iq3px"
         else 2 * c + 1)
    return v * (1 - 2 * hmask_bits(d["sg"]).int())


def iq_group(qt: QTensor) -> int:
    """The scale group G (8, 16 or 32 columns) of an IQ QTensor."""
    return qt.shape[1] // qt.data["scale"].shape[-1]  # stacked fields too


def dequant(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Unpack a QTensor to a dense (out, in) tensor (f32 math)."""
    rows, cols = qt.shape
    if qt.kind == "dense":
        return qt.data["w"].to(dtype)
    if qt.kind in ("q4_k", "q5_k"):
        q = (q4k_values(qt.data["qs2"]) if qt.kind == "q4_k"
             else q5k_values(qt.data["qs2"], qt.data["qh"]))
        q = q.float().reshape(rows, -1, 32)
        s = qt.data["scale"].float()[..., None]
        m = qt.data["min"].float()[..., None]
        return (q * s - m).reshape(rows, cols).to(dtype)
    if qt.kind == "q6_k":
        q = (q6k_values(qt.data["ql"], qt.data["qh"]) - 32).float()
        s = qt.data["scale"].float()[..., None]
        return (q.reshape(rows, -1, 16) * s).reshape(rows, cols).to(dtype)
    if qt.kind == "q8_0":
        q = qt.data["q"].float().reshape(rows, -1, 32)
        s = qt.data["scale"].float()[..., None]
        return (q * s).reshape(rows, cols).to(dtype)
    if qt.kind == "q2_k":
        q = q2k_values(qt.data["qs"]).float().reshape(rows, -1, 16)
        out = q * qt.data["scale"].float()[..., None] \
            - qt.data["min"].float()[..., None]
        return out.reshape(rows, cols).to(dtype)
    if qt.kind == "q3_k":
        q = q3k_values(qt.data["qs"], qt.data["hmask"]).float() - 4.0
        s = qt.data["scale"].float()[..., None]
        return (q.reshape(rows, -1, 16) * s).reshape(rows, cols).to(dtype)
    if qt.kind == "q4_k_i8":
        q = qt.data["q"].float().reshape(rows, -1, 32)
        s = qt.data["scale"].float()[..., None]
        m = qt.data["min"].float()[..., None]
        return (q * s - m).reshape(rows, cols).to(dtype)
    if qt.kind == "q6_k_i8f":
        q = qt.data["q"].float().reshape(rows, -1, 16)
        s = qt.data["scale"].float()[..., None]
        return (q * s).reshape(rows, cols).to(dtype)
    if qt.kind in ("q3_k_n4", "q2_k_n4"):
        q = n4_values(qt.data["n4"]).float()
        if qt.kind == "q3_k_n4":
            q = q - 4.0
        out = q.reshape(rows, -1, 16) * qt.data["scale"].float()[..., None]
        if "min" in qt.data:
            out = out - qt.data["min"].float()[..., None]
        return out.reshape(rows, cols).to(dtype)
    if qt.kind in IQ_KINDS:
        out = iq_values(qt).float().reshape(rows, -1, iq_group(qt)) \
            * qt.data["scale"].float()[..., None]
        if "min" in qt.data:
            out = out - qt.data["min"].float()[..., None]
        return out.reshape(rows, cols).to(dtype)
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


class LayerRef:
    """A (layer-stacked QTensor, layer index) pair: the scan decode path's
    weight (models/llama.py `_layer_view`). The stacked QTensor's fields
    carry a leading layer axis; its shape is the per-layer (out, in).
    `index` is the layer as a one-element int32 tensor on the weights'
    device, which the stacked kernels (K17a / K17b) read from device
    memory; `li` is the same layer as a host int, for `take()`."""
    __slots__ = ("qt", "li", "index")

    def __init__(self, qt: QTensor, li: int, index: torch.Tensor):
        self.qt = qt
        self.li = li
        self.index = index

    @property
    def kind(self):
        return self.qt.kind

    @property
    def shape(self):
        return self.qt.shape

    def take(self) -> QTensor:
        """This layer's QTensor, as views of the stacked fields (no
        copy)."""
        return QTensor(kind=self.qt.kind, shape=self.qt.shape,
                       data={n: a[self.li] for n, a in self.qt.data.items()},
                       whole_in_f=self.qt.whole_in_f)


def matmul(x: torch.Tensor, qt, out_dtype=None) -> torch.Tensor:
    """y = x @ W^T for any QTensor or LayerRef. x: (..., in) -> (..., out).
    Packed weights go to the kernels; shapes no kernel covers dequantize
    and multiply with f32 accumulation, as the JAX package's XLA path does.
    A LayerRef goes to the stacked kernels first (returning before the
    collector records it, as in JAX) and otherwise takes its layer."""
    if isinstance(qt, LayerRef):
        from . import quant_matmul

        y = quant_matmul.matmul_packed_stacked(x, qt.qt, qt.index)
        if y is not None:
            return y.to(out_dtype or x.dtype)
        qt = qt.take()
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
