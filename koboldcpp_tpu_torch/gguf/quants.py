"""Vectorized numpy (de)quantization for the GGUF quant-format zoo.

Independent TPU-first implementation of the ggml block formats
(layouts: ggml/src/ggml-common.h:144-419; semantics:
ggml/src/ggml-quants.c quantize_row_*_ref / dequantize_row_*).
Instead of scalar C loops, every format is described by static index tables
(element -> packed byte / shift / sub-block scale) built once at import time, so
(de)quantization is pure fancy-indexing over whole tensors.  Dequantization is
bit-exact vs. the reference (golden-tested in tests/test_quants_golden.py).

These numpy paths are the *reference* implementations; the serving hot path
keeps blocks packed in HBM and dequantizes inside Pallas kernels (ops/).
"""
from __future__ import annotations

import numpy as np

from .constants import GGMLType, GGML_BLOCK_SIZES, QK_K

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

GROUP_MAX_EPS = 1e-15


def _f16(x: np.ndarray) -> np.ndarray:
    """fp32 -> fp16 bits with IEEE round-to-nearest-even (ggml fp16 semantics)."""
    return x.astype(np.float16)


def _f16_to_f32(b: np.ndarray) -> np.ndarray:
    return b.view(np.float16).astype(np.float32) if b.dtype == np.uint8 else b.astype(np.float32)


def _nearest_int(x: np.ndarray) -> np.ndarray:
    # ggml's nearest_int() magic-constant trick implements round-half-to-even,
    # which is exactly np.rint.
    return np.rint(x).astype(np.int32)


def _rows(x: np.ndarray, blk: int) -> np.ndarray:
    """View (..., n) as (N, blk) float32 blocks."""
    n = x.shape[-1]
    if n % blk:
        raise ValueError(f"last dim {n} not divisible by block size {blk}")
    return np.ascontiguousarray(x, dtype=np.float32).reshape(-1, blk)


def _out_shape(shape: tuple[int, ...], t: GGMLType) -> tuple[int, ...]:
    blk, sz = GGML_BLOCK_SIZES[t]
    return shape[:-1] + (shape[-1] // blk * sz,)


# ---------------------------------------------------------------------------
# simple 32-element formats
# ---------------------------------------------------------------------------

def _q4_0_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(len(b)), idx]  # signed value of largest magnitude
    d = (mx / -8.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = np.minimum(np.trunc(b * inv[:, None] + np.float32(8.5)), 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    out = np.empty((len(b), 18), dtype=np.uint8)
    out[:, :2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:] = lo | (hi << 4)
    return out


def _q4_0_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    d = _f16_to_f32(blocks[:, :2].copy())[:, 0]
    qs = blocks[:, 2:]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int8) - 8
    return d[:, None] * q.astype(np.float32)


def _q4_1_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    mn, mx = b.min(axis=-1), b.max(axis=-1)
    d = ((mx - mn) / 15.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = np.minimum(np.trunc((b - mn[:, None]) * inv[:, None] + np.float32(0.5)), 15).astype(np.uint8)
    out = np.empty((len(b), 20), dtype=np.uint8)
    out[:, 0:2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:4] = _f16(mn.astype(np.float32))[:, None].view(np.uint8)
    out[:, 4:] = q[:, :16] | (q[:, 16:] << 4)
    return out


def _q4_1_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 20)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    m = _f16_to_f32(blocks[:, 2:4].copy())[:, 0]
    qs = blocks[:, 4:]
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.float32)
    return d[:, None] * q + m[:, None]


def _q5_0_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(len(b)), idx]
    d = (mx / -16.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = np.minimum(np.trunc(b * inv[:, None] + np.float32(16.5)), 31).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qh = np.zeros(len(b), dtype=np.uint32)
    for j in range(16):
        qh |= (lo[:, j] >> 4) << j
        qh |= (hi[:, j] >> 4) << (j + 16)
    out = np.empty((len(b), 22), dtype=np.uint8)
    out[:, 0:2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:6] = qh[:, None].view(np.uint8)
    out[:, 6:] = (lo & 0xF).astype(np.uint8) | ((hi & 0xF) << 4).astype(np.uint8)
    return out


def _q5_0_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 22)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qh = blocks[:, 2:6].copy().view(np.uint32)[:, 0]
    qs = blocks[:, 6:]
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.int32) | (bits.astype(np.int32) << 4)
    return d[:, None] * (q - 16).astype(np.float32)


def _q5_1_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    mn, mx = b.min(axis=-1), b.max(axis=-1)
    d = ((mx - mn) / 31.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = np.minimum(np.trunc((b - mn[:, None]) * inv[:, None] + np.float32(0.5)), 31).astype(np.uint32)
    lo, hi = q[:, :16], q[:, 16:]
    qh = np.zeros(len(b), dtype=np.uint32)
    for j in range(16):
        qh |= (lo[:, j] >> 4) << j
        qh |= (hi[:, j] >> 4) << (j + 16)
    out = np.empty((len(b), 24), dtype=np.uint8)
    out[:, 0:2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:4] = _f16(mn.astype(np.float32))[:, None].view(np.uint8)
    out[:, 4:8] = qh[:, None].view(np.uint8)
    out[:, 8:] = (lo & 0xF).astype(np.uint8) | ((hi & 0xF) << 4).astype(np.uint8)
    return out


def _q5_1_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 24)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    m = _f16_to_f32(blocks[:, 2:4].copy())[:, 0]
    qh = blocks[:, 4:8].copy().view(np.uint32)[:, 0]
    qs = blocks[:, 8:]
    bits = (qh[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    q = np.concatenate([qs & 0xF, qs >> 4], axis=1).astype(np.uint32) | (bits << 4)
    return d[:, None] * q.astype(np.float32) + m[:, None]


def _q8_0_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    amax = np.abs(b).max(axis=-1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    v = b * inv[:, None]
    # C roundf(): round half away from zero
    q = np.trunc(v + np.where(v >= 0, np.float32(0.5), np.float32(-0.5))).astype(np.int8)
    out = np.empty((len(b), 34), dtype=np.uint8)
    out[:, 0:2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:] = q.view(np.uint8)
    return out


def _q8_0_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 34)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return d[:, None] * q


# ---------------------------------------------------------------------------
# K-quant scale/min search (vectorized make_qkx2_quants / make_qx_quants)
# ---------------------------------------------------------------------------

def _make_qkx2(b: np.ndarray, w: np.ndarray, nmax: int, rmin: float, rdelta: float,
               nstep: int, use_mad: bool) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Weighted affine scale/min search over sub-blocks.

    b, w: (N, n) float32.  Returns (L uint8 (N, n), scale (N,), the_min (N,)).
    Mirrors ggml's make_qkx2_quants grid search semantics, vectorized over N.
    """
    b = b.astype(np.float32)
    w = w.astype(np.float32)
    raw_min = b.min(axis=-1)
    mx = b.max(axis=-1)
    mn = np.minimum(raw_min, 0.0).astype(np.float32)
    degenerate = mx == mn
    rng = np.where(degenerate, np.float32(1.0), mx - mn)  # avoid div0 on degenerate rows

    sum_w = w.sum(axis=-1)
    sum_x = (w * b).sum(axis=-1)

    iscale = np.float32(nmax) / rng
    scale = np.float32(1.0) / iscale
    L = np.clip(_nearest_int(iscale[:, None] * (b - mn[:, None])), 0, nmax)
    diff = scale[:, None] * L + mn[:, None] - b
    diff = np.abs(diff) if use_mad else diff * diff
    best_mad = (w * diff).sum(axis=-1)

    cur_min = mn.copy()
    for step in range(nstep + 1):
        # the reference MUTATES `min` when a candidate wins (make_qkx3_quants
        # `min = this_min`), so subsequent candidates' iscale AND rounding
        # reference the updated min — cur_min, not the initial mn. Missing
        # this cost ~1.5% weighted error on imatrix Q4_K (round-5 audit).
        rng_c = np.where(degenerate, np.float32(1.0), mx - cur_min)
        isc = (np.float32(rmin + rdelta * step + nmax)) / rng_c
        Laux = np.clip(_nearest_int(isc[:, None] * (b - cur_min[:, None])),
                       0, nmax)
        Lf = Laux.astype(np.float32)
        sum_l = (w * Lf).sum(axis=-1)
        sum_l2 = (w * Lf * Lf).sum(axis=-1)
        sum_xl = (w * Lf * b).sum(axis=-1)
        D = sum_w * sum_l2 - sum_l * sum_l
        with np.errstate(divide="ignore", invalid="ignore"):
            this_scale = (sum_w * sum_xl - sum_x * sum_l) / D
            this_min = (sum_l2 * sum_x - sum_l * sum_xl) / D
            alt_scale = sum_xl / sum_l2
        pos_min = this_min > 0
        this_min = np.where(pos_min, np.float32(0.0), this_min)
        this_scale = np.where(pos_min, alt_scale, this_scale)
        diff = this_scale[:, None] * Lf + this_min[:, None] - b
        diff = np.abs(diff) if use_mad else diff * diff
        mad = (w * diff).sum(axis=-1)
        upd = (D > 0) & (mad < best_mad)
        best_mad = np.where(upd, mad, best_mad)
        scale = np.where(upd, this_scale, scale)
        cur_min = np.where(upd, this_min, cur_min)
        L = np.where(upd[:, None], Laux, L)

    scale = np.where(degenerate, np.float32(0.0), scale)
    L = np.where(degenerate[:, None], 0, L)
    # degenerate row (all elements equal, value <= 0): the_min = -min; an
    # all-positive-equal row isn't degenerate since min clamps to 0 first.
    the_min = np.where(degenerate, -mn, -cur_min)
    return L.astype(np.uint8), scale.astype(np.float32), the_min.astype(np.float32)


def _make_qp(xs: np.ndarray, nmax: int, w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Weighted non-negative scale quantization (ggml make_qp_quants),
    vectorized over rows: grid search over 9 iscale candidates + 5 rounds of
    coordinate-descent refinement. xs, w: (N, n). Returns (L uint8, d (N,))."""
    xs = xs.astype(np.float32)
    w = w.astype(np.float32)
    mx = xs.max(axis=-1)
    zero = mx <= 0
    safe = np.where(zero, np.float32(1.0), mx)

    def mse_of(iscale):
        l = np.minimum(_nearest_int(iscale[:, None] * xs), nmax).astype(np.float32)
        diff = xs - (1.0 / iscale)[:, None] * l
        return l, (w * diff * diff).sum(axis=-1)

    iscale = np.float32(nmax) / safe
    _, best = mse_of(iscale)
    for is_ in range(-4, 5):
        if is_ == 0:
            continue
        cand = (np.float32(0.1) * is_ + nmax) / safe
        _, mse = mse_of(cand)
        upd = mse < best
        best = np.where(upd, mse, best)
        iscale = np.where(upd, cand, iscale)
    L = np.minimum(_nearest_int(iscale[:, None] * xs), nmax).astype(np.float32)
    sumlx = (w * xs * L).sum(axis=-1)
    suml2 = (w * L * L).sum(axis=-1)
    n = xs.shape[1]
    for _ in range(5):
        changed = np.zeros(len(xs), bool)
        for i in range(n):
            wi = w[:, i]
            xi = xs[:, i]
            li = L[:, i]
            slx = sumlx - wi * xi * li
            sl2 = suml2 - wi * li * li
            ok = (slx > 0) & (sl2 > 0)
            with np.errstate(divide="ignore", invalid="ignore"):
                new_l = np.minimum(_nearest_int(xi * sl2 / np.where(sl2 > 0, slx, 1)), nmax).astype(np.float32)
            upd = ok & (new_l != li) & ((slx + wi * xi * new_l) ** 2 * sl2
                                        > slx * slx * (sl2 + wi * new_l * new_l))
            nl = np.where(upd, new_l, li)
            sumlx = np.where(upd, slx + wi * xi * nl, sumlx)
            suml2 = np.where(upd, sl2 + wi * nl * nl, suml2)
            L[:, i] = nl
            changed |= upd
        if not changed.any():
            break
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(suml2 > 0, sumlx / suml2, np.float32(0.0))
    d = np.where(zero, np.float32(0.0), d)
    L = np.where(zero[:, None], 0, L)
    return L.astype(np.uint8), d.astype(np.float32)


def _make_qx(b: np.ndarray, nmax: int,
             qw: np.ndarray | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric scale search (ggml make_qx_quants, rmse_type=1), vectorized.

    qw: optional imatrix weights (N, n) replacing the rmse_type-1 x^2 weights
    (the reference passes quant_weights straight through).
    Returns (L int32 in [0, 2*nmax) with +nmax offset applied, scale (N,)).
    """
    b = b.astype(np.float32)
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(len(b)), idx]
    amax = np.abs(mx)
    zero = amax < GROUP_MAX_EPS
    safe_mx = np.where(zero, np.float32(1.0), mx)

    w = b * b if qw is None else qw.astype(np.float32)  # rmse_type == 1

    def trial(iscale):
        l = np.clip(_nearest_int(iscale[:, None] * b), -nmax, nmax - 1).astype(np.float32)
        sumlx = (w * b * l).sum(axis=-1)
        suml2 = (w * l * l).sum(axis=-1)
        return l, sumlx, suml2

    iscale0 = np.float32(-nmax) / safe_mx
    L, sumlx, suml2 = trial(iscale0)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, np.float32(0.0))
    best = scale * sumlx
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        isc = -(np.float32(nmax) + np.float32(0.1) * is_) / safe_mx
        Lt, slx, sl2 = trial(isc)
        upd = (sl2 > 0) & (slx * slx > best * sl2)
        with np.errstate(divide="ignore", invalid="ignore"):
            new_scale = slx / sl2
        scale = np.where(upd, new_scale, scale)
        best = np.where(upd, new_scale * slx, best)
        L = np.where(upd[:, None], Lt, L)

    L = np.where(zero[:, None], np.float32(-nmax), L) + nmax
    scale = np.where(zero, np.float32(0.0), scale)
    return L.astype(np.int32), scale.astype(np.float32)


def _make_q3(b: np.ndarray, nmax: int) -> tuple[np.ndarray, np.ndarray]:
    """ggml make_q3_quants(do_rmse=True): symmetric + coordinate-descent refine.

    Returns (L int32 with +nmax offset i.e. in [0, 2*nmax), scale (N,)).
    """
    b = b.astype(np.float32)
    n = b.shape[-1]
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(len(b)), idx]
    amax = np.abs(mx)
    zero = amax < GROUP_MAX_EPS
    safe_mx = np.where(zero, np.float32(1.0), mx)

    iscale = np.float32(-nmax) / safe_mx
    L = np.clip(_nearest_int(iscale[:, None] * b), -nmax, nmax - 1).astype(np.float32)
    w = b * b
    sumlx = (w * b * L).sum(axis=-1)
    suml2 = (w * L * L).sum(axis=-1)
    # 5 rounds of single-coordinate improvement, sequential over the n elements
    # (order matters: later elements see earlier updates, like the C loop).
    for _ in range(5):
        changed = np.zeros(len(b), dtype=bool)
        for i in range(n):
            wi, xi, li = w[:, i], b[:, i], L[:, i]
            slx = sumlx - wi * xi * li
            ok = slx > 0
            sl2 = suml2 - wi * li * li
            with np.errstate(divide="ignore", invalid="ignore"):
                cand = _nearest_int(np.where(ok, xi * sl2 / np.where(slx != 0, slx, 1), 0))
            cand = np.clip(cand, -nmax, nmax - 1).astype(np.float32)
            diff = cand != li
            slx2 = slx + wi * xi * cand
            sl22 = sl2 + wi * cand * cand
            upd = ok & diff & (sl22 > 0) & (slx2 * slx2 * suml2 > sumlx * sumlx * sl22)
            L[:, i] = np.where(upd, cand, li)
            sumlx = np.where(upd, slx2, sumlx)
            suml2 = np.where(upd, sl22, suml2)
            changed |= upd
        if not changed.any():
            break
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(suml2 != 0, sumlx / suml2, np.float32(0.0))
    scale = np.where(zero, np.float32(0.0), scale)
    L = np.where(zero[:, None], np.float32(-nmax), L) + nmax  # +nmax offset, like C
    return L.astype(np.int32), scale.astype(np.float32)


# ---------------------------------------------------------------------------
# K-quant static index tables: element position -> packed location
# ---------------------------------------------------------------------------

_E = np.arange(QK_K)

# Q2_K / Q3_K 2-bit stream: two 128-halves, 4 shift planes of 32 bytes
_Q2_BYTE = (32 * (_E // 128) + _E % 32).astype(np.int64)
_Q2_SHIFT = (2 * ((_E % 128) // 32)).astype(np.uint8)
_Q2_SUB = (_E // 16).astype(np.int64)  # 16 sub-blocks of 16

# Q3_K high bit: byte = e % 32, bit = e // 32
_Q3_HBYTE = (_E % 32).astype(np.int64)
_Q3_HBIT = (_E // 32).astype(np.uint8)

# Q4_K / Q5_K nibble stream: 4 groups of 64 (32 lo nibbles then 32 hi nibbles)
_Q4_BYTE = (32 * (_E // 64) + _E % 32).astype(np.int64)
_Q4_SHIFT = (4 * ((_E % 64) // 32)).astype(np.uint8)
_Q4_SUB = (_E // 32).astype(np.int64)  # 8 sub-blocks of 32

# Q5_K extra bit: byte = e % 32, bit = sub-block index
_Q5_HBYTE = (_E % 32).astype(np.int64)
_Q5_HBIT = (_E // 32).astype(np.uint8)

# Q6_K: per 128-half, 4 planes; ql nibbles interleave planes (0,2)->bytes l,
# (1,3)->bytes l+32; qh packs 2-bit planes of the same 32 bytes
_q6_h = _E // 128
_q6_j = (_E % 128) // 32
_q6_l = _E % 32
_Q6_LBYTE = (64 * _q6_h + 32 * (_q6_j % 2) + _q6_l).astype(np.int64)
_Q6_LSHIFT = (4 * (_q6_j // 2)).astype(np.uint8)
_Q6_HBYTE = (32 * _q6_h + _q6_l).astype(np.int64)
_Q6_HSHIFT = (2 * _q6_j).astype(np.uint8)
_Q6_SUB = (8 * _q6_h + 2 * _q6_j + (_E % 32) // 16).astype(np.int64)

# IQ4 nonlinear codebook
IQ4_NL_VALUES = np.array(
    [-127, -104, -83, -65, -49, -35, -22, -10, 1, 13, 25, 38, 53, 69, 89, 113],
    dtype=np.float32,
)

_E32 = np.arange(32)
_IQ4_BYTE = (_E32 % 16).astype(np.int64)
_IQ4_SHIFT = (4 * (_E32 // 16)).astype(np.uint8)

# IQ4_XS nibble stream: 8 sub-blocks of 32, each 16 bytes lo-then-hi nibbles
_IQ4XS_BYTE = (16 * (_E // 32) + _E % 16).astype(np.int64)
_IQ4XS_SHIFT = (4 * ((_E % 32) // 16)).astype(np.uint8)
_IQ4XS_SUB = (_E // 32).astype(np.int64)


def _unpack_scale_min_k4(scales: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unpack 8 (6-bit scale, 6-bit min) pairs from 12 bytes. scales: (N, 12)."""
    sc = np.empty((len(scales), 8), dtype=np.uint8)
    mn = np.empty((len(scales), 8), dtype=np.uint8)
    j = np.arange(4)
    sc[:, :4] = scales[:, :4] & 63
    mn[:, :4] = scales[:, 4:8] & 63
    sc[:, 4:] = (scales[:, 8:12] & 0xF) | ((scales[:, j] >> 6) << 4)
    mn[:, 4:] = (scales[:, 8:12] >> 4) | ((scales[:, 4 + j] >> 6) << 4)
    return sc, mn


def _pack_scale_min_k4(ls: np.ndarray, lm: np.ndarray) -> np.ndarray:
    """Inverse of _unpack_scale_min_k4. ls, lm: (N, 8) uint8 6-bit values."""
    out = np.zeros((len(ls), 12), dtype=np.uint8)
    out[:, :4] = ls[:, :4] & 63
    out[:, 4:8] = lm[:, :4] & 63
    out[:, :4] |= (ls[:, 4:] >> 4) << 6
    out[:, 4:8] |= (lm[:, 4:] >> 4) << 6
    out[:, 8:12] = (ls[:, 4:] & 0xF) | ((lm[:, 4:] & 0xF) << 4)
    return out


def _unpack_q3_scales(scales: np.ndarray) -> np.ndarray:
    """Unpack 16 6-bit scales from 12 bytes (Q3_K layout). Returns int32 (N, 16)."""
    lo = np.empty((len(scales), 16), dtype=np.uint8)
    lo[:, :8] = scales[:, :8] & 0xF
    lo[:, 8:] = scales[:, :8] >> 4
    j = np.arange(16)
    hi = (scales[:, 8 + (j % 4)] >> (2 * (j // 4))[None, :]) & 3
    return (lo | (hi << 4)).astype(np.int32)


def _pack_q3_scales(l6: np.ndarray) -> np.ndarray:
    """Pack 16 6-bit values into 12 bytes (Q3_K layout). l6: (N, 16) uint8."""
    out = np.zeros((len(l6), 12), dtype=np.uint8)
    out[:, :8] = (l6[:, :8] & 0xF) | ((l6[:, 8:] & 0xF) << 4)
    for jj in range(16):
        out[:, 8 + jj % 4] |= (l6[:, jj] >> 4) << (2 * (jj // 4))
    return out


# ---------------------------------------------------------------------------
# K-quant formats
# ---------------------------------------------------------------------------

def _q2_k_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    b = _rows(x, QK_K).reshape(-1, 16, 16)
    N = len(b)
    flat = b.reshape(-1, 16)
    if qw is not None:
        # quantize_row_q2_K_impl (ggml-quants.c:2172): weights =
        # qw*sqrt(sigma2+x^2), qkx3 grid, weighted-qp 4-bit scales
        sb = b.reshape(N, QK_K)
        sigma2 = (sb * sb).sum(axis=-1, dtype=np.float32) / QK_K
        qwf = _rows(qw.astype(np.float32), QK_K).reshape(-1, 16)
        w = qwf * np.sqrt(sigma2[:, None, None] + b * b).reshape(-1, 16)
        L0, scales, mins = _make_qkx2(flat, w, 3, -0.9, 0.05, 36, False)
        L0 = L0.reshape(N, 16, 16)
        scales = scales.reshape(N, 16)
        mins = mins.reshape(N, 16)
        sw = w.reshape(N, 16, 16).sum(axis=-1)
        ls_q, dq = _make_qp(scales, 15, sw)
        lm_q, mq = _make_qp(mins, 15, sw)
        d = _f16(dq)
        dmin = _f16(mq)
        packed_sc = (ls_q & 0xF) | (lm_q << 4)
        dd = d.astype(np.float32)[:, None] * (packed_sc & 0xF).astype(np.float32)
        dm = dmin.astype(np.float32)[:, None] * (packed_sc >> 4).astype(np.float32)
        with np.errstate(divide="ignore", invalid="ignore"):
            Lq = np.clip(_nearest_int((b + dm[:, :, None])
                                      / np.where(dd != 0, dd, 1)[:, :, None]), 0, 3)
        Lq = np.where((dd != 0)[:, :, None], Lq, L0).astype(np.uint8).reshape(N, QK_K)
        return _q2_k_pack(N, d, dmin, packed_sc, Lq)
    L0, scales, mins = _make_qkx2(flat, np.abs(flat), 3, -0.5, 0.1, 15, True)
    L0 = L0.reshape(N, 16, 16)
    scales = scales.reshape(N, 16)
    mins = mins.reshape(N, 16)

    max_scale = scales.max(axis=-1)
    max_min = mins.max(axis=-1)
    q4scale = np.float32(15.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ls = np.where(max_scale[:, None] > 0,
                      _nearest_int(q4scale / np.where(max_scale > 0, max_scale, 1)[:, None] * scales), 0)
        lm = np.where(max_min[:, None] > 0,
                      _nearest_int(q4scale / np.where(max_min > 0, max_min, 1)[:, None] * mins), 0)
    d = _f16(np.where(max_scale > 0, max_scale / q4scale, 0.0).astype(np.float32))
    dmin = _f16(np.where(max_min > 0, max_min / q4scale, 0.0).astype(np.float32))
    packed_sc = (ls.astype(np.uint8) & 0xF) | (lm.astype(np.uint8) << 4)

    # requantize against the fp16-rounded effective scales
    dd = d.astype(np.float32)[:, None] * (packed_sc & 0xF).astype(np.float32)
    dm = dmin.astype(np.float32)[:, None] * (packed_sc >> 4).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = np.clip(_nearest_int((b + dm[:, :, None]) / np.where(dd != 0, dd, 1)[:, :, None]), 0, 3)
    # sub-blocks whose effective scale is 0 keep the search L (reference skips
    # the requantize pass for them; decoded value is 0 either way)
    Lq = np.where((dd != 0)[:, :, None], Lq, L0).astype(np.uint8).reshape(N, QK_K)

    return _q2_k_pack(N, d, dmin, packed_sc, Lq)


def _q2_k_pack(N, d, dmin, packed_sc, Lq):
    qs = np.zeros((N, 64), dtype=np.uint8)
    np.bitwise_or.at(qs.T, _Q2_BYTE, (Lq << _Q2_SHIFT[None, :]).T)  # scatter by plane
    out = np.empty((N, 84), dtype=np.uint8)
    out[:, :16] = packed_sc
    out[:, 16:80] = qs
    out[:, 80:82] = d[:, None].view(np.uint8)
    out[:, 82:84] = dmin[:, None].view(np.uint8)
    return out


def _q2_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 84)
    sc = blocks[:, :16]
    qs = blocks[:, 16:80]
    d = _f16_to_f32(blocks[:, 80:82].copy())[:, 0]
    dmin = _f16_to_f32(blocks[:, 82:84].copy())[:, 0]
    q = (qs[:, _Q2_BYTE] >> _Q2_SHIFT[None, :]) & 3
    sub = sc[:, _Q2_SUB]
    return (d[:, None] * (sub & 0xF).astype(np.float32) * q.astype(np.float32)
            - dmin[:, None] * (sub >> 4).astype(np.float32))


def _q3_k_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, QK_K).reshape(-1, 16, 16)
    N = len(b)
    L0, scales = _make_q3(b.reshape(-1, 16), 4)
    L0 = L0.reshape(N, 16, 16)
    scales = scales.reshape(N, 16)

    amax_idx = np.argmax(np.abs(scales), axis=-1)
    max_scale = scales[np.arange(N), amax_idx]
    nonzero = max_scale != 0
    safe = np.where(nonzero, max_scale, 1)
    iscale = np.float32(-32.0) / safe
    l6 = (np.clip(_nearest_int(iscale[:, None] * scales), -32, 31) + 32).astype(np.uint8)
    l6 = np.where(nonzero[:, None], l6, 0)
    packed = _pack_q3_scales(l6)
    d = _f16(np.where(nonzero, np.float32(1.0) / iscale, 0.0).astype(np.float32))

    sc_eff = (_unpack_q3_scales(packed) - 32).astype(np.float32)
    dd = d.astype(np.float32)[:, None] * sc_eff
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = np.clip(_nearest_int(b / np.where(dd != 0, dd, 1)[:, :, None]), -4, 3) + 4
    # sub-blocks with zero effective scale keep the search L (reference behavior)
    Lq = np.where((dd != 0)[:, :, None], Lq, L0).astype(np.uint8).reshape(N, QK_K)
    hmask = np.zeros((N, 32), dtype=np.uint8)
    high = (Lq > 3).astype(np.uint8)
    np.bitwise_or.at(hmask.T, _Q3_HBYTE, (high << _Q3_HBIT[None, :]).T)
    Lq2 = np.where(Lq > 3, Lq - 4, Lq)
    qs = np.zeros((N, 64), dtype=np.uint8)
    np.bitwise_or.at(qs.T, _Q2_BYTE, (Lq2 << _Q2_SHIFT[None, :]).T)

    out = np.empty((N, 110), dtype=np.uint8)
    out[:, :32] = hmask
    out[:, 32:96] = qs
    out[:, 96:108] = packed
    out[:, 108:110] = d[:, None].view(np.uint8)
    return out


def _q3_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 110)
    hmask = blocks[:, :32]
    qs = blocks[:, 32:96]
    scales = _unpack_q3_scales(blocks[:, 96:108]) - 32
    d = _f16_to_f32(blocks[:, 108:110].copy())[:, 0]
    q = ((qs[:, _Q2_BYTE] >> _Q2_SHIFT[None, :]) & 3).astype(np.int32)
    hbit = (hmask[:, _Q3_HBYTE] >> _Q3_HBIT[None, :]) & 1
    q = q - np.where(hbit == 0, 4, 0)
    return d[:, None] * scales[:, _Q2_SUB].astype(np.float32) * q.astype(np.float32)


def _qk45_quantize(x: np.ndarray, nmax: int, rmin: float, rdelta: float,
                   nstep: int, qw: np.ndarray | None = None):
    """Shared Q4_K / Q5_K top half: per-32 sub-block affine search + 6-bit
    pack. With imatrix weights `qw` (same shape as the flattened rows) the
    search follows the reference's quantize_row_q4_K_impl
    (ggml-quants.c:2586): weights = qw*sqrt(sigma2 + x^2) with sigma2 =
    2*sum(x^2)/QK_K, qkx3 grid params, and weighted-qp 6-bit scale/min
    quantization instead of the max-based pack."""
    b = _rows(x, QK_K).reshape(-1, 8, 32)
    N = len(b)
    flat = b.reshape(-1, 32)
    if qw is not None:
        sb = b.reshape(N, QK_K)
        sigma2 = 2.0 * (sb * sb).sum(axis=-1, dtype=np.float32) / QK_K
        qwf = _rows(qw.astype(np.float32), QK_K).reshape(-1, 32)
        w = qwf * np.sqrt(sigma2[:, None, None]
                          + b * b).reshape(-1, 32).astype(np.float32)
        rmin, rdelta, nstep = -0.9, 0.05, 36  # make_qkx3 grid
    else:
        av = np.sqrt((flat * flat).sum(axis=-1, dtype=np.float32) / 32)
        w = av[:, None] + np.abs(flat)
    L0, scales, mins = _make_qkx2(flat, w, nmax, rmin, rdelta, nstep, False)
    L0 = L0.reshape(N, 8, 32)
    scales = scales.reshape(N, 8)
    mins = mins.reshape(N, 8)

    if qw is not None:
        sw = w.reshape(N, 8, 32).sum(axis=-1)
        ls, dq = _make_qp(scales, 63, sw)
        lm, mq = _make_qp(mins, 63, sw)
        packed = _pack_scale_min_k4(ls, lm)
        d = _f16(dq)
        dmin = _f16(mq)
    else:
        max_scale = scales.max(axis=-1)
        max_min = mins.max(axis=-1)
        inv_scale = np.where(max_scale > 0, np.float32(63.0) / np.where(max_scale > 0, max_scale, 1), 0)
        inv_min = np.where(max_min > 0, np.float32(63.0) / np.where(max_min > 0, max_min, 1), 0)
        ls = np.minimum(_nearest_int(inv_scale[:, None] * scales), 63).astype(np.uint8)
        lm = np.minimum(_nearest_int(inv_min[:, None] * mins), 63).astype(np.uint8)
        packed = _pack_scale_min_k4(ls, lm)
        d = _f16((max_scale / 63.0).astype(np.float32))
        dmin = _f16((max_min / 63.0).astype(np.float32))

    sc_eff, mn_eff = _unpack_scale_min_k4(packed)
    dd = d.astype(np.float32)[:, None] * sc_eff.astype(np.float32)
    dm = dmin.astype(np.float32)[:, None] * mn_eff.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = np.clip(_nearest_int((b + dm[:, :, None]) / np.where(dd != 0, dd, 1)[:, :, None]), 0, nmax)
    Lq = np.where((dd != 0)[:, :, None], Lq, L0).astype(np.uint8).reshape(N, QK_K)
    return N, d, dmin, packed, Lq


def _q4_k_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    N, d, dmin, packed, Lq = _qk45_quantize(x, 15, -1.0, 0.1, 20, qw=qw)
    g = Lq.reshape(N, 4, 2, 32)
    qs = (g[:, :, 0, :] | (g[:, :, 1, :] << 4)).reshape(N, 128)
    out = np.empty((N, 144), dtype=np.uint8)
    out[:, 0:2] = d[:, None].view(np.uint8)
    out[:, 2:4] = dmin[:, None].view(np.uint8)
    out[:, 4:16] = packed
    out[:, 16:] = qs
    return out


def _q4_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 144)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    dmin = _f16_to_f32(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _unpack_scale_min_k4(blocks[:, 4:16])
    qs = blocks[:, 16:]
    q = (qs[:, _Q4_BYTE] >> _Q4_SHIFT[None, :]) & 0xF
    return (d[:, None] * sc[:, _Q4_SUB].astype(np.float32) * q.astype(np.float32)
            - dmin[:, None] * mn[:, _Q4_SUB].astype(np.float32))


def _q5_k_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    N, d, dmin, packed, Lq = _qk45_quantize(x, 31, -0.5, 0.1, 15, qw=qw)
    qh = np.zeros((N, 32), dtype=np.uint8)
    high = (Lq > 15).astype(np.uint8)
    np.bitwise_or.at(qh.T, _Q5_HBYTE, (high << _Q5_HBIT[None, :]).T)
    Lq2 = np.where(Lq > 15, Lq - 16, Lq)
    g = Lq2.reshape(N, 4, 2, 32)
    qs = (g[:, :, 0, :] | (g[:, :, 1, :] << 4)).reshape(N, 128)
    out = np.empty((N, 176), dtype=np.uint8)
    out[:, 0:2] = d[:, None].view(np.uint8)
    out[:, 2:4] = dmin[:, None].view(np.uint8)
    out[:, 4:16] = packed
    out[:, 16:48] = qh
    out[:, 48:] = qs
    return out


def _q5_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 176)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    dmin = _f16_to_f32(blocks[:, 2:4].copy())[:, 0]
    sc, mn = _unpack_scale_min_k4(blocks[:, 4:16])
    qh = blocks[:, 16:48]
    qs = blocks[:, 48:]
    q = ((qs[:, _Q4_BYTE] >> _Q4_SHIFT[None, :]) & 0xF).astype(np.int32)
    hbit = ((qh[:, _Q5_HBYTE] >> _Q5_HBIT[None, :]) & 1).astype(np.int32)
    q = q + (hbit << 4)
    return (d[:, None] * sc[:, _Q4_SUB].astype(np.float32) * q.astype(np.float32)
            - dmin[:, None] * mn[:, _Q4_SUB].astype(np.float32))


def _q6_k_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    b = _rows(x, QK_K).reshape(-1, 16, 16)
    N = len(b)
    qw16 = (_rows(qw.astype(np.float32), QK_K).reshape(-1, 16)
            if qw is not None else None)
    L0, scales = _make_qx(b.reshape(-1, 16), 32, qw=qw16)
    L0 = L0.reshape(N, 16, 16)
    scales = scales.reshape(N, 16)

    amax_idx = np.argmax(np.abs(scales), axis=-1)
    max_scale = scales[np.arange(N), amax_idx]
    zero = np.abs(max_scale) < GROUP_MAX_EPS
    safe = np.where(zero, 1, max_scale)
    iscale = np.float32(-128.0) / safe
    d = _f16(np.where(zero, 0.0, np.float32(1.0) / iscale).astype(np.float32))
    sc8 = np.minimum(_nearest_int(iscale[:, None] * scales), 127).astype(np.int8)
    sc8 = np.where(zero[:, None], np.int8(0), sc8)

    dd = d.astype(np.float32)[:, None] * sc8.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        Lq = np.clip(_nearest_int(b / np.where(dd != 0, dd, 1)[:, :, None]), -32, 31) + 32
    # sub-blocks with zero effective scale keep the search L; a fully-zero
    # super-block is zeroed wholesale (reference memsets the block)
    Lq = np.where((dd != 0)[:, :, None], Lq, L0).astype(np.uint8).reshape(N, QK_K)
    Lq = np.where(zero[:, None], 0, Lq)

    ql = np.zeros((N, 128), dtype=np.uint8)
    qh = np.zeros((N, 64), dtype=np.uint8)
    np.bitwise_or.at(ql.T, _Q6_LBYTE, ((Lq & 0xF) << _Q6_LSHIFT[None, :]).T)
    np.bitwise_or.at(qh.T, _Q6_HBYTE, ((Lq >> 4) << _Q6_HSHIFT[None, :]).T)
    out = np.empty((N, 210), dtype=np.uint8)
    out[:, :128] = ql
    out[:, 128:192] = qh
    out[:, 192:208] = sc8.view(np.uint8)
    out[:, 208:210] = d[:, None].view(np.uint8)
    return out


def _q6_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 210)
    ql = blocks[:, :128]
    qh = blocks[:, 128:192]
    sc = blocks[:, 192:208].view(np.int8)
    d = _f16_to_f32(blocks[:, 208:210].copy())[:, 0]
    q = (((ql[:, _Q6_LBYTE] >> _Q6_LSHIFT[None, :]) & 0xF)
         | (((qh[:, _Q6_HBYTE] >> _Q6_HSHIFT[None, :]) & 3) << 4)).astype(np.int32) - 32
    return d[:, None] * sc[:, _Q6_SUB].astype(np.float32) * q.astype(np.float32)


def _q8_k_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, QK_K)
    N = len(b)
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(N), idx]
    zero = np.abs(mx) == 0
    iscale = np.float32(-127.0) / np.where(zero, 1, mx)
    q = np.minimum(_nearest_int(iscale[:, None] * b), 127).astype(np.int8)
    q = np.where(zero[:, None], np.int8(0), q)
    d = np.where(zero, 0, np.float32(1.0) / iscale).astype(np.float32)
    bsums = q.reshape(N, 16, 16).sum(axis=-1, dtype=np.int16)
    out = np.empty((N, 292), dtype=np.uint8)
    out[:, 0:4] = d[:, None].view(np.uint8)
    out[:, 4:260] = q.view(np.uint8)
    out[:, 260:292] = bsums.view(np.uint8).reshape(N, 32)
    return out


def _q8_k_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 292)
    d = blocks[:, 0:4].copy().view(np.float32)[:, 0]
    q = blocks[:, 4:260].view(np.int8).astype(np.float32)
    return d[:, None] * q


def _iq4_nl_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:]
    q = (qs[:, _IQ4_BYTE] >> _IQ4_SHIFT[None, :]) & 0xF
    return d[:, None] * IQ4_NL_VALUES[q]


def _iq4_nl_quantize(x: np.ndarray) -> np.ndarray:
    """IQ4_NL without imatrix: per-block scale search over the NL codebook."""
    b = _rows(x, 32)
    N = len(b)
    idx = np.argmax(np.abs(b), axis=-1)
    mx = b[np.arange(N), idx]
    zero = np.abs(mx) < GROUP_MAX_EPS
    safe = np.where(zero, 1, mx)
    w = b * b

    def best_index(v):  # nearest codebook entry, vectorized
        return np.abs(v[..., None] - IQ4_NL_VALUES[None, None, :]).argmin(axis=-1)

    d0 = safe / IQ4_NL_VALUES[0]  # map the extreme value onto the codebook edge
    best_scale = d0.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        L = best_index(b / best_scale[:, None])
    rec = IQ4_NL_VALUES[L] * best_scale[:, None]
    best_err = (w * (b - rec) ** 2).sum(axis=-1)
    for is_ in range(-9, 10):
        if is_ == 0:
            continue
        dt = (np.float32(1.0) + np.float32(0.02) * is_) * d0
        with np.errstate(divide="ignore", invalid="ignore"):
            Lt = best_index(b / dt[:, None])
        # refit scale to the chosen levels
        lv = IQ4_NL_VALUES[Lt]
        sumlx = (w * b * lv).sum(axis=-1)
        suml2 = (w * lv * lv).sum(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            dfit = np.where(suml2 > 0, sumlx / suml2, dt)
        rec = lv * dfit[:, None]
        err = (w * (b - rec) ** 2).sum(axis=-1)
        upd = err < best_err
        best_err = np.where(upd, err, best_err)
        best_scale = np.where(upd, dfit, best_scale)
        L = np.where(upd[:, None], Lt, L)
    best_scale = np.where(zero, 0, best_scale)
    L = np.where(zero[:, None], 8, L).astype(np.uint8)  # index of value 1 -> ~0
    out = np.empty((N, 18), dtype=np.uint8)
    out[:, 0:2] = _f16(best_scale.astype(np.float32))[:, None].view(np.uint8)
    lo = np.zeros((N, 16), dtype=np.uint8)
    np.bitwise_or.at(lo.T, _IQ4_BYTE, (L.astype(np.uint8) << _IQ4_SHIFT[None, :]).T)
    out[:, 2:] = lo
    return out


def _iq4_xs_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ4_XS quantizer (quantize_row_iq4_nl_impl with super_block_size=256,
    block_size=32, ntry=7; ggml/src/ggml-quants.c:15065-15165,
    15229): per-32 NL scale search, 6-bit sub-scales against a shared
    super-block d, final re-index.  Without imatrix weight=x^2; with imatrix
    weight = qw * sqrt(sigma2 + x^2), sigma2 = 2*sum(x^2)/256 per super-block
    (ggml-quants.c:15072-15085)."""
    b = _rows(x, QK_K)
    NB = len(b)
    sb = b.reshape(NB, 8, 32)  # sub-blocks
    if qw is None:
        w = sb * sb
    else:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(NB, 8, 32)
        sigma2 = np.float32(2.0) * (b * b).sum(axis=-1,
                                               dtype=np.float32) / QK_K
        w = qwb * np.sqrt(sigma2[:, None, None] + sb * sb)
    amax = np.abs(sb).max(axis=-1)
    arg = np.abs(sb).argmax(axis=-1)
    mx = np.take_along_axis(sb, arg[..., None], axis=-1)[..., 0]
    zero = amax < GROUP_MAX_EPS
    safe_mx = np.where(zero, 1, mx)

    def best_index(v):
        return np.abs(v[..., None] - IQ4_NL_VALUES[None, None, None, :]).argmin(axis=-1)

    def refit(idv):
        L = best_index(idv[..., None] * sb)
        lv = IQ4_NL_VALUES[L]
        sumqx = (w * lv * sb).sum(axis=-1)
        sumq2 = (w * lv * lv).sum(axis=-1)
        return L, sumqx, sumq2

    # initial pass: d = max/127 (= -max/values[0]), then refit
    d0 = safe_mx / np.float32(IQ4_NL_VALUES[0])
    d0 = -d0
    with np.errstate(divide="ignore", invalid="ignore"):
        _, sumqx, sumq2 = refit(np.float32(1.0) / d0)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(sumq2 > 0, sumqx / sumq2, d0)
    best = d * sumqx
    for itry in range(-7, 8):
        idv = (np.float32(itry) + np.float32(IQ4_NL_VALUES[0])) / safe_mx
        _, sumqx, sumq2 = refit(idv)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2)
        with np.errstate(divide="ignore", invalid="ignore"):
            d = np.where(upd, sumqx / sumq2, d)
        best = np.where(upd, d * sumqx, best)
    scales = np.where(zero, 0, d).astype(np.float32)  # (NB, 8)

    # 6-bit sub-scales vs shared super d
    amax_scale = np.abs(scales).max(axis=-1)
    arg_s = np.abs(scales).argmax(axis=-1)
    max_scale = np.take_along_axis(scales, arg_s[:, None], axis=-1)[:, 0]
    d_super = (-max_scale / np.float32(32.0)).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        id_super = np.where(d_super != 0, np.float32(1.0) / d_super, np.float32(0.0))
    ls = np.clip(_nearest_int(id_super[:, None] * scales), -32, 31)
    dl = d_super[:, None] * ls
    with np.errstate(divide="ignore", invalid="ignore"):
        idl = np.where(dl != 0, np.float32(1.0) / dl, np.float32(0.0))
    L = best_index(idl[..., None] * sb).astype(np.uint8)  # (NB, 8, 32)

    lsu = (ls + 32).astype(np.uint32)
    scales_l = (lsu[:, 0::2] & 0xF) | ((lsu[:, 1::2] & 0xF) << 4)  # (NB, 4)
    scales_h = ((lsu >> 4) << (2 * np.arange(8, dtype=np.uint32))[None, :]).sum(
        axis=-1).astype(np.uint16)
    qs = np.zeros((NB, 128), dtype=np.uint8)
    Lf = L.reshape(NB, QK_K)
    np.bitwise_or.at(qs.T, _IQ4XS_BYTE, (Lf << _IQ4XS_SHIFT[None, :]).T)
    out = np.empty((NB, 136), dtype=np.uint8)
    out[:, 0:2] = _f16(d_super)[:, None].view(np.uint8)
    out[:, 2:4] = scales_h[:, None].view(np.uint8)
    out[:, 4:8] = scales_l.astype(np.uint8)
    out[:, 8:] = qs
    return out


def _iq4_xs_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 136)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    scales_h = blocks[:, 2:4].copy().view(np.uint16)[:, 0].astype(np.uint32)
    scales_l = blocks[:, 4:8]
    qs = blocks[:, 8:]
    sb = np.arange(8)
    ls = (((scales_l[:, sb // 2] >> (4 * (sb % 2))[None, :]) & 0xF)
          | (((scales_h[:, None] >> (2 * sb)[None, :]) & 3) << 4)).astype(np.int32) - 32
    q = (qs[:, _IQ4XS_BYTE] >> _IQ4XS_SHIFT[None, :]) & 0xF
    return d[:, None] * ls[:, _IQ4XS_SUB].astype(np.float32) * IQ4_NL_VALUES[q]


# ---------------------------------------------------------------------------
# IQ codebook formats + ternary (grids: iq_grids.npz, see tools/gen_iq_grids.py)
# ---------------------------------------------------------------------------

_IQ_GRIDS: dict[str, np.ndarray] | None = None


def _iq_grids() -> dict[str, np.ndarray]:
    global _IQ_GRIDS
    if _IQ_GRIDS is None:
        import os

        path = os.path.join(os.path.dirname(__file__), "iq_grids.npz")
        _IQ_GRIDS = dict(np.load(path))
    return _IQ_GRIDS


def _signs_from_index(idx: np.ndarray) -> np.ndarray:
    """7-bit sign index -> (..., 8) of +-1 via the shared ksigns table."""
    ks = _iq_grids()["ksigns"]
    sbyte = ks[idx]  # (...,)
    bits = (sbyte[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    return np.where(bits == 1, np.float32(-1), np.float32(1))


def _iq2_xxs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq2_xxs"]
    blocks = raw.reshape(-1, 66)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    q16 = blocks[:, 2:].copy().view(np.uint16).reshape(N, 8, 4).astype(np.uint32)
    aux0 = q16[:, :, 0] | (q16[:, :, 1] << 16)  # grid indices, 4 bytes
    aux1 = q16[:, :, 2] | (q16[:, :, 3] << 16)  # signs + scale
    db = d[:, None] * (0.5 + (aux1 >> 28)).astype(np.float32) * 0.25  # (N, 8)
    gidx = np.stack([(aux0 >> (8 * l)) & 0xFF for l in range(4)], axis=2)  # (N,8,4)
    sidx = np.stack([(aux1 >> (7 * l)) & 127 for l in range(4)], axis=2)
    vals = g[gidx]  # (N, 8, 4, 8)
    signs = _signs_from_index(sidx)  # (N, 8, 4, 8)
    out = db[:, :, None, None] * vals * signs
    return out.reshape(N, QK_K).astype(np.float32)


def _iq2_xs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq2_xs"]
    blocks = raw.reshape(-1, 74)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    q16 = blocks[:, 2:66].copy().view(np.uint16).reshape(N, 8, 4)
    scales = blocks[:, 66:74]  # (N, 8) packed nibble pairs
    db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                   d[:, None] * (0.5 + (scales >> 4)) * 0.25], axis=2)  # (N,8,2)
    gidx = (q16 & 511).astype(np.int64)
    sidx = (q16 >> 9).astype(np.int64)
    vals = g[gidx]                       # (N, 8, 4, 8)
    signs = _signs_from_index(sidx)
    scale_l = db[:, :, np.arange(4) // 2]  # (N, 8, 4)
    out = scale_l[..., None] * vals * signs
    return out.reshape(N, QK_K).astype(np.float32)


def _iq2_s_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq2_s"]
    blocks = raw.reshape(-1, 82)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:34].reshape(N, 8, 4).astype(np.int64)       # low 8 bits
    signs = blocks[:, 34:66].reshape(N, 8, 4)                    # sign bytes
    qh = blocks[:, 66:74].astype(np.int64)                       # (N, 8)
    scales = blocks[:, 74:82]
    db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                   d[:, None] * (0.5 + (scales >> 4)) * 0.25], axis=2)
    shift = (8 - 2 * np.arange(4))
    gidx = qs | ((qh[:, :, None] << shift[None, None, :]) & 0x300)
    vals = g[gidx]  # (N, 8, 4, 8)
    bits = (signs[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    sgn = np.where(bits == 1, np.float32(-1), np.float32(1))
    scale_l = db[:, :, np.arange(4) // 2]
    out = scale_l[..., None] * vals * sgn
    return out.reshape(N, QK_K).astype(np.float32)


def _iq3_xxs_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq3_xxs"]
    blocks = raw.reshape(-1, 98)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:66].reshape(N, 8, 8).astype(np.int64)  # 8 grid bytes / 32
    aux = blocks[:, 66:98].copy().view(np.uint32).reshape(N, 8)
    db = d[:, None] * (0.5 + (aux >> 28)).astype(np.float32) * 0.5  # (N, 8)
    sidx = np.stack([(aux >> (7 * l)) & 127 for l in range(4)], axis=2)  # (N,8,4)
    signs = _signs_from_index(sidx)  # (N, 8, 4, 8)
    vals = g[qs].reshape(N, 8, 4, 8)  # pairs of 4-element grid rows
    out = db[:, :, None, None] * vals * signs
    return out.reshape(N, QK_K).astype(np.float32)


def _iq3_s_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq3_s"]
    blocks = raw.reshape(-1, 110)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:66].reshape(N, 8, 8).astype(np.int64)
    qh = blocks[:, 66:74].astype(np.int64)  # (N, 8) one byte per 32-group
    signs = blocks[:, 74:106].reshape(N, 8, 4)
    scales = blocks[:, 106:110]  # (N, 4) nibble pairs per 64
    db = np.stack([d[:, None] * (1 + 2 * (scales & 0xF)).astype(np.float32),
                   d[:, None] * (1 + 2 * (scales >> 4)).astype(np.float32)],
                  axis=2).reshape(N, 8)  # per-32 scale
    # high bit: qh bit (2l + pair) extends qs[2l + pair]
    k = np.arange(8)
    gidx = qs | (((qh[:, :, None] << (8 - k)[None, None, :]) & 256))
    vals = g[gidx].reshape(N, 8, 4, 8)
    bits = (signs[..., None] >> np.arange(8, dtype=np.uint8)) & 1
    sgn = np.where(bits == 1, np.float32(-1), np.float32(1))
    out = db[:, :, None, None] * vals * sgn
    return out.reshape(N, QK_K).astype(np.float32)


IQ1S_DELTA = np.float32(0.125)


def _iq1_s_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq1_s"]
    blocks = raw.reshape(-1, 50)
    N = len(blocks)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    qs = blocks[:, 2:34].reshape(N, 8, 4).astype(np.int64)
    qh = blocks[:, 34:50].copy().view(np.uint16).reshape(N, 8).astype(np.int64)
    dl = d[:, None] * (2 * ((qh >> 12) & 7) + 1).astype(np.float32)  # (N, 8)
    delta = np.where(qh & 0x8000, -IQ1S_DELTA, IQ1S_DELTA)  # (N, 8)
    l = np.arange(4)
    gidx = qs | (((qh[:, :, None] >> (3 * l)[None, None, :]) & 7) << 8)
    vals = g[gidx]  # (N, 8, 4, 8)
    out = dl[:, :, None, None] * (vals + delta[:, :, None, None])
    return out.reshape(N, QK_K).astype(np.float32)


def _iq1_m_dequantize(raw: np.ndarray) -> np.ndarray:
    g = _iq_grids()["grid_iq1_m"]
    blocks = raw.reshape(-1, 56)
    N = len(blocks)
    qs = blocks[:, 0:32].reshape(N, 8, 4).astype(np.int64)
    qh = blocks[:, 32:48].reshape(N, 8, 2).astype(np.int64)
    sc = blocks[:, 48:56].copy().view(np.uint16).reshape(N, 4).astype(np.uint32)
    scale_bits = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
                  | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000))
    d = scale_bits.astype(np.uint16)[:, None].view(np.float16).astype(np.float32)[:, 0]
    ib = np.arange(8)
    dl1 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2))) & 7) + 1).astype(np.float32)
    dl2 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 7) + 1).astype(np.float32)
    dl = np.stack([dl1, dl1, dl2, dl2], axis=2) * d[:, None, None]  # (N, 8, 4)
    idx = np.stack([
        qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700),
        qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700),
        qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700),
        qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700),
    ], axis=2)  # (N, 8, 4)
    dmask = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                      qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=2)
    delta = np.where(dmask != 0, -IQ1S_DELTA, IQ1S_DELTA)
    vals = g[idx]  # (N, 8, 4, 8)
    out = dl[..., None] * (vals + delta[..., None])
    return out.reshape(N, QK_K).astype(np.float32)


_IQ_QTABLES: dict = {}


def _iq_quant_tables(fmt: str):
    """Quantizer-space tables for a codebook grid: (q_grid (E, gs) of
    2l+1 values, L_grid (E, gs) ints, pattern_map) — the reference builds
    these at runtime in iq2xs_init_impl/iq3xs_init_impl
    (ggml/src/ggml-quants.c); we derive them from the
    dequant grids (iq_grids.npz)."""
    if fmt in _IQ_QTABLES:
        return _IQ_QTABLES[fmt]
    g = _iq_grids()
    if fmt in ("iq2_xxs", "iq2_xs", "iq2_s"):
        vals = g["grid_" + fmt].astype(np.int64)      # (E, 8) of {8,25,43}
        lmap = np.zeros(64, np.int64)
        lmap[[8, 25, 43]] = [0, 1, 2]
        L = lmap[vals]
        bits = 2
    elif fmt == "iq3_xxs":
        vals = g["grid_iq3_xxs"].astype(np.int64)     # (256, 4) of 4+8l (62)
        L = vals // 8                                  # 4->0 ... 62->7
        bits = 3
    elif fmt == "iq3_s":
        vals = g["grid_iq3_s"].astype(np.int64)       # (512, 4) of 2l+1
        L = (vals - 1) // 2
        bits = 3
    else:
        raise ValueError(fmt)
    E, gs = L.shape
    q = (2 * L + 1).astype(np.float32)
    pat = (L << (bits * np.arange(gs))[None, :]).sum(axis=1)
    pmap = np.full(1 << (bits * gs), -1, np.int64)
    pmap[pat] = np.arange(E)
    _IQ_QTABLES[fmt] = (q, L.astype(np.int64), pmap, bits)
    return _IQ_QTABLES[fmt]


def _iq_signs_parity(xb: np.ndarray, w: np.ndarray):
    """Per-8-group sign extraction with even-parity enforcement (the grids
    carry 7-bit sign indices; the 8th sign is the parity bit): flip the
    min-weight*x^2 element when the flip count is odd.  xb, w: (M, BS).
    Returns (xval (M, BS) magnitudes w/ parity flips, signs (M, BS//8))."""
    M, BS = xb.shape
    gx = xb.reshape(M, BS // 8, 8)
    gw = w.reshape(M, BS // 8, 8)
    sbits = gx < 0
    xval = np.abs(gx)
    crit = gw * gx * gx
    imin = crit.argmin(axis=-1)
    odd = (sbits.sum(axis=-1) % 2) == 1
    mi, gi = np.nonzero(odd)
    xval[mi, gi, imin[mi, gi]] *= -1.0
    sbits[mi, gi, imin[mi, gi]] ^= True
    signs = (sbits << np.arange(8)[None, None, :]).sum(axis=-1) & 127
    return xval.reshape(M, BS), signs.astype(np.uint32)


def _iq_grid_project(xval, waux, scale, Laux, fmt: str, mask=None):
    """Project rounded L-patterns onto the grid: on-grid patterns stay
    (reference kmap fast path); off-grid ones take the weighted nearest
    entry under the sqrt-weight metric — the role of the reference's
    precomputed neighbour lists (iq2_find_best_neighbour), computed here as
    a brute-force argmin over all E entries (chunked).  Returns (L, idx)."""
    q, L_grid, pmap, bits = _iq_quant_tables(fmt)
    E, gs = q.shape
    M, BS = xval.shape
    ng = BS // gs
    Lg = Laux.reshape(M * ng, gs)
    u = (Lg.astype(np.int64) << (bits * np.arange(gs))[None, :]).sum(axis=1)
    idx = pmap[u]                                       # (M*ng,)
    off = idx < 0
    if mask is not None:
        off &= np.repeat(mask, ng)
    if off.any():
        xg = xval.reshape(M * ng, gs)[off]
        wg = waux.reshape(M * ng, gs)[off]
        s = np.repeat(np.asarray(scale, np.float32), ng)[off]
        best = np.empty(len(xg), np.int64)
        q2 = (q * q).astype(np.float32)
        qf = q.astype(np.float32)
        if (s > 0).all():
            # s > 0 (every call site masks to positive scales): argmin over
            # s^2 t1 - 2 s t2 == argmin over s t1 - 2 t2, which fuses into
            # ONE sgemm  [s*w | -2*w*x] @ [q^2 | q]^T  — the three (K, E)
            # broadcast temporaries of the naive form were the whole cost
            # (memory-bound numpy: ~2.8 s/65K groups naive vs ~0.4 s fused)
            Qcat = np.concatenate([q2, qf], axis=1)     # (E, 2gs)
            A = np.empty((len(xg), 2 * gs), np.float32)
            A[:, :gs] = wg * s[:, None]
            A[:, gs:] = -2.0 * (wg * xg)
            for c0 in range(0, len(xg), 262144):
                sl = slice(c0, c0 + 262144)
                best[sl] = (A[sl] @ Qcat.T).argmin(axis=1)
        else:
            for c0 in range(0, len(xg), 65536):
                sl = slice(c0, c0 + 65536)
                t1 = wg[sl] @ q2.T                      # (K, E) sum w q^2
                t2 = (wg[sl] * xg[sl]) @ qf.T           # (K, E) sum w q x
                dist = (s[sl, None] ** 2) * t1 - 2 * s[sl, None] * t2
                best[sl] = dist.argmin(axis=1)
        idx = idx.copy()
        idx[off] = best
    L = np.where(idx[:, None] >= 0, L_grid[np.maximum(idx, 0)], Lg)
    return L.reshape(M, BS), idx.reshape(M, ng), (~off).reshape(M, ng)


def _iq_xxs_quantize(x: np.ndarray, qw: np.ndarray | None, fmt: str) -> np.ndarray:
    """Shared IQ2_XXS/IQ3_XXS quantizer (quantize_row_iq2_xxs_impl /
    quantize_row_iq3_xxs_impl, ggml/src/ggml-quants.c:13434,
    12xxx): per-32-block scale-candidate sweep with grid projection and
    weighted refit, 7-bit parity signs, 4-bit block scales against
    d = max_scale/31."""
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    M = N * 8
    xb = b.reshape(M, 32)
    if fmt == "iq2_xxs":
        kmax = 3
        sigma2 = (b * b).sum(axis=-1) / QK_K
        cand = [(2 * kmax - 1 + 0.1 * s) for s in range(-6, 7)]
        eps = GROUP_MAX_EPS
    else:
        kmax = 8
        sigma2 = 2.0 * (b * b).sum(axis=-1) / QK_K
        cand = [(2 * kmax - 1 + 0.2 * s) for s in range(-15, 16)]
        eps = np.float32(1e-8)  # GROUP_MAX_EPS_IQ3_XXS
    sig = np.repeat(sigma2, 8)[:, None]
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, 32)
        w = qwb * np.sqrt(sig + xb * xb)
    elif fmt == "iq2_xxs":
        # reference requires an imatrix for iq2_xxs; without one we keep
        # the sqrt weighting with unit importance
        w = np.sqrt(sig + xb * xb)
    else:
        w = xb * xb
    waux = np.sqrt(w)

    xval, signs = _iq_signs_parity(xb, w)
    mx = xval.max(axis=-1)
    live = mx >= eps

    if fmt == "iq2_xxs":
        _, d0 = _make_qp(xval, kmax + 1, w)
        eff_max = np.where(d0 * kmax > 0, d0 * kmax, 1.0)
        scale = d0.copy()
    else:
        eff_max = np.where(mx > 0, mx, 1.0)
        scale = mx / (2 * kmax - 1)
    best = np.zeros(M, np.float32)
    L = np.zeros((M, 32), np.int64)
    ongrid = np.ones((M, 32 // (8 if fmt == "iq2_xxs" else 4)), bool)
    for c in cand:
        idv = np.float32(c) / eff_max
        this_scale = 1.0 / idv
        Laux = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)),
                       0, kmax - 1)
        Laux, _, og = _iq_grid_project(xval, waux, this_scale, Laux, fmt,
                                       mask=live)
        qv = 2 * Laux + 1
        sumqx = (w * xval * qv).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        scale = np.where(upd, ns, scale)
        best = np.where(upd, ns * sumqx, best)
        L = np.where(upd[:, None], Laux, L)
        ongrid = np.where(upd[:, None], og, ongrid)

    # final re-projection with the winning scale
    pos = live & (scale > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        idv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    Lr = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)), 0, kmax - 1)
    if fmt == "iq2_xxs":
        remap = pos  # iq2 re-maps every group
    else:
        remap = pos & ~ongrid.all(axis=-1)  # iq3 re-maps off-grid only
    Lf = np.where(remap[:, None], Lr, L)
    Lf, idx, _ = _iq_grid_project(xval, waux, scale, Lf, fmt, mask=pos)
    if fmt == "iq3_xxs":
        ng = 8
        keep = (~remap)[:, None] & ongrid
        Lf = np.where(np.repeat(keep, 4, axis=1), L, Lf)
        # recompute idx for kept groups from their (on-grid) patterns
        q_, Lg_, pmap_, bits_ = _iq_quant_tables(fmt)
        u = (Lf.reshape(M * ng, 4).astype(np.int64)
             << (bits_ * np.arange(4))[None, :]).sum(axis=1)
        idx = pmap_[u].reshape(M, ng)
    qv = 2 * Lf + 1
    sumqx = (w * xval * qv).sum(axis=-1)
    sumq2 = (w * qv * qv).sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(remap & (sumq2 > 0), sumqx / sumq2, scale)
    neg = scale < 0
    scale = np.abs(scale)
    signs = np.where(neg[:, None], (~signs.astype(np.int64)) & 127, signs)
    scale = np.where(live, scale, 0.0)
    idx = np.maximum(idx, 0)

    # encode per super-block
    scale_b = scale.reshape(N, 8)
    max_scale = scale_b.max(axis=-1)
    d = max_scale / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 15).astype(np.uint32)
    sb = signs.reshape(N, 8, 4).astype(np.uint32)
    aux1 = (sb[:, :, 0] | (sb[:, :, 1] << 7) | (sb[:, :, 2] << 14)
            | (sb[:, :, 3] << 21) | (ls << 28))
    dead_sb = max_scale <= 0
    if fmt == "iq2_xxs":
        gi = idx.reshape(N, 8, 4).astype(np.uint32)
        aux0 = (gi[:, :, 0] | (gi[:, :, 1] << 8) | (gi[:, :, 2] << 16)
                | (gi[:, :, 3] << 24))
        aux0 = np.where(dead_sb[:, None], 0, aux0)
        aux1 = np.where(dead_sb[:, None], 0, aux1)
        out = np.empty((N, 66), np.uint8)
        out[:, 0:2] = _f16(np.where(dead_sb, 0.0, d).astype(np.float32)
                           )[:, None].view(np.uint8)
        q16 = np.empty((N, 8, 4), np.uint16)
        q16[:, :, 0] = aux0 & 0xFFFF
        q16[:, :, 1] = aux0 >> 16
        q16[:, :, 2] = aux1 & 0xFFFF
        q16[:, :, 3] = aux1 >> 16
        out[:, 2:] = q16.reshape(N, 32).view(np.uint8)
        return out
    # iq3_xxs: qs = 8 grid bytes per 32-block, then 8 aux32
    gi = idx.reshape(N, 64).astype(np.uint8)
    gi = np.where(dead_sb[:, None], 0, gi)
    aux1 = np.where(dead_sb[:, None], 0, aux1)
    out = np.empty((N, 98), np.uint8)
    out[:, 0:2] = _f16(np.where(dead_sb, 0.0, d * 1.0125)
                       .astype(np.float32))[:, None].view(np.uint8)
    out[:, 2:66] = gi
    out[:, 66:98] = aux1.astype(np.uint32).reshape(N, 8).view(np.uint8)
    return out


def _iq2_xxs_quantize(x, qw=None):
    return _iq_xxs_quantize(x, qw, "iq2_xxs")


def _iq2_s_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_S quantizer (quantize_row_iq2_s_impl): iq2_xs structure with the
    1024-entry grid and FULL 8-bit explicit signs (no parity constraint),
    0.25*sigma2+x^2 default weights, qh 2-bit high-index packing, and the
    reference's 0.9875 d fudge."""
    kmax = 3
    BS = 16
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    M = N * (QK_K // BS)
    xb = b.reshape(M, BS)
    sigma2 = np.repeat(2.0 * (b * b).sum(axis=-1) / QK_K, QK_K // BS)
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, BS)
        w = qwb * np.sqrt(sigma2[:, None] + xb * xb)
    else:
        w = 0.25 * sigma2[:, None] + xb * xb
    waux = np.sqrt(w)

    # full 8-bit signs, magnitudes (no parity flip)
    sbits = (xb.reshape(M, 2, 8) < 0)
    signs = (sbits << np.arange(8)[None, None, :]).sum(axis=-1).astype(np.int64)
    xval = np.abs(xb)
    mx = xval.max(axis=-1)
    live = mx >= np.float32(1e-8)  # GROUP_MAX_EPS_IQ2_S
    eff = np.where(mx > 0, mx, 1.0)
    scale = mx / (2 * kmax - 1)
    best = np.zeros(M, np.float32)
    L = np.zeros((M, BS), np.int64)
    ongrid = np.ones((M, 2), bool)
    for c in [(2 * kmax - 1 + 0.1 * s) for s in range(-9, 10)]:
        idv = np.float32(c) / eff
        Laux = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)),
                       0, kmax - 1)
        Laux, _, og = _iq_grid_project(xval, waux, 1.0 / idv, Laux,
                                       "iq2_s", mask=live)
        qv = 2 * Laux + 1
        sumqx = (w * xval * qv).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        scale = np.where(upd, ns, scale)
        best = np.where(upd, ns * sumqx, best)
        L = np.where(upd[:, None], Laux, L)
        ongrid = np.where(upd[:, None], og, ongrid)

    pos = live & (scale > 0)
    remap = pos & ~ongrid.all(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        idv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    Lr = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)), 0, kmax - 1)
    Lf = np.where(remap[:, None], Lr, L)
    Lf, idx, _ = _iq_grid_project(xval, waux, scale, Lf, "iq2_s", mask=pos)
    keep = (~remap)[:, None] & ongrid
    Lf = np.where(np.repeat(keep, 8, axis=1), L, Lf)
    q_, Lg_, pmap_, bits_ = _iq_quant_tables("iq2_s")
    u = (Lf.reshape(M * 2, 8).astype(np.int64)
         << (2 * np.arange(8))[None, :]).sum(axis=1)
    idx = pmap_[u].reshape(M, 2)
    qv = 2 * Lf + 1
    sumqx = (w * xval * qv).sum(axis=-1)
    sumq2 = (w * qv * qv).sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(remap & (sumq2 > 0), sumqx / sumq2, scale)
    neg = scale < 0
    scale = np.where(live, np.abs(scale), 0.0)
    signs = np.where(neg[:, None], (~signs) & 255, signs)
    idx = np.maximum(idx, 0)

    nb16 = QK_K // BS
    scale_b = scale.reshape(N, nb16)
    max_scale = scale_b.max(axis=-1)
    d = max_scale / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 15).astype(np.uint32)
    dead = max_scale <= 0
    dead_blk = ~live.reshape(N, nb16)
    idx8 = idx.reshape(N, nb16 * 2)               # (N, 32) 8-groups
    idx8 = np.where(np.repeat(dead_blk, 2, 1), 0, idx8)
    sg8 = signs.reshape(N, nb16 * 2)
    sg8 = np.where(np.repeat(dead_blk, 2, 1), 0, sg8)
    qs_lo = (idx8 & 255).astype(np.uint8)
    qh = np.zeros((N, 8), np.uint32)
    for i8 in range(32):
        qh[:, i8 // 4] |= (idx8[:, i8].astype(np.uint32) >> 8) << (2 * (i8 % 4))
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    qs_lo = np.where(dead[:, None], 0, qs_lo)
    qh = np.where(dead[:, None], 0, qh)
    sc = np.where(dead[:, None], 0, sc)
    sg8 = np.where(dead[:, None], 0, sg8)
    out = np.empty((N, 82), np.uint8)
    out[:, 0:2] = _f16(np.where(dead, 0.0, d * 0.9875)
                       .astype(np.float32))[:, None].view(np.uint8)
    out[:, 2:34] = qs_lo
    out[:, 34:66] = sg8.astype(np.uint8)
    out[:, 66:74] = qh.astype(np.uint8)
    out[:, 74:82] = sc
    return out


def _iq3_s_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ3_S quantizer (quantize_row_iq3_s_impl, block_size=32): 512-entry
    4-element grid, kMaxQ=8, full 8-bit explicit signs, is in [-9,9] x 0.2
    sweep, whole-block re-map when any group left the grid, nibble scales
    per 32-block pair with the reference's 1.033 d fudge."""
    kmax = 8
    BS = 32
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    M = N * (QK_K // BS)
    xb = b.reshape(M, BS)
    sigma2 = np.repeat(2.0 * (b * b).sum(axis=-1) / QK_K, QK_K // BS)
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, BS)
        w = qwb * np.sqrt(sigma2[:, None] + xb * xb)
    else:
        w = xb * xb
    waux = np.sqrt(w)

    sbits = (xb.reshape(M, 4, 8) < 0)
    signs = (sbits << np.arange(8)[None, None, :]).sum(axis=-1).astype(np.int64)
    xval = np.abs(xb)
    mx = xval.max(axis=-1)
    live = mx > 0
    eff = np.where(mx > 0, mx, 1.0)
    scale = mx / (2 * kmax - 1)
    best = np.zeros(M, np.float32)
    L = np.zeros((M, BS), np.int64)
    ongrid = np.zeros((M, 8), bool)   # reference inits false per block
    for c in [(2 * kmax - 1 + 0.2 * s) for s in range(-9, 10)]:
        idv = np.float32(c) / eff
        Laux = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)),
                       0, kmax - 1)
        Laux, _, og = _iq_grid_project(xval, waux, 1.0 / idv, Laux,
                                       "iq3_s", mask=live)
        qv = 2 * Laux + 1
        sumqx = (w * xval * qv).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        scale = np.where(upd, ns, scale)
        best = np.where(upd, ns * sumqx, best)
        L = np.where(upd[:, None], Laux, L)
        ongrid = np.where(upd[:, None], og, ongrid)

    # whole-block re-round + project when ANY group is off grid (the
    # reference's per-group skip is commented out in ggml-quants.c)
    pos = live & (scale > 0)
    remap = pos & ~ongrid.all(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        idv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    Lr = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)), 0, kmax - 1)
    Lf = np.where(remap[:, None], Lr, L)
    Lf, idx, _ = _iq_grid_project(xval, waux, scale, Lf, "iq3_s", mask=remap)
    q_, Lg_, pmap_, bits_ = _iq_quant_tables("iq3_s")
    u = (Lf.reshape(M * 8, 4).astype(np.int64)
         << (3 * np.arange(4))[None, :]).sum(axis=1)
    idx = pmap_[u].reshape(M, 8)
    qv = 2 * Lf + 1
    sumqx = (w * xval * qv).sum(axis=-1)
    sumq2 = (w * qv * qv).sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(remap & (sumq2 > 0), sumqx / sumq2, scale)
    neg = scale < 0
    scale = np.where(live, np.abs(scale), 0.0)
    signs = np.where(neg[:, None], (~signs) & 255, signs)
    idx = np.maximum(idx, 0)

    nb = QK_K // BS            # 8 32-blocks
    scale_b = scale.reshape(N, nb)
    max_scale = scale_b.max(axis=-1)
    d = max_scale / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 15).astype(np.uint32)
    dead = max_scale <= 0
    dead_blk = ~live.reshape(N, nb)
    idx_b = np.where(np.repeat(dead_blk, 8, 1), 0,
                     idx.reshape(N, nb * 8))     # (N, 64) 4-groups
    sg_b = np.where(np.repeat(dead_blk, 4, 1), 0,
                    signs.reshape(N, nb * 4))
    qs = (idx_b & 255).astype(np.uint8)
    qh = np.zeros((N, 8), np.uint32)
    for j in range(64):
        qh[:, j // 8] |= (idx_b[:, j].astype(np.uint32) >> 8) << (j % 8)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    qs = np.where(dead[:, None], 0, qs)
    qh = np.where(dead[:, None], 0, qh)
    sc = np.where(dead[:, None], 0, sc)
    sg_b = np.where(dead[:, None], 0, sg_b)
    out = np.empty((N, 110), np.uint8)
    out[:, 0:2] = _f16(np.where(dead, 0.0, d * 1.033)
                       .astype(np.float32))[:, None].view(np.uint8)
    out[:, 2:66] = qs
    out[:, 66:74] = qh.astype(np.uint8)
    out[:, 74:106] = sg_b.astype(np.uint8)
    out[:, 106:110] = sc
    return out


def _iq1_m_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ1_M quantizer (quantize_row_iq1_m_impl, block_size=16): exhaustive
    sorted 3-way split with FOUR delta variants (independent +-IQ1S_DELTA
    signs for each 8-group half), grid projection on the iq1 2048-entry
    grid, 3-bit block scales packed 4-per-u16 with the f16 super-scale's
    nibbles in the top bits, global weighted d refit, 1.1125 fudge."""
    BS = 16
    d5 = np.float32(IQ1S_DELTA)
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    nb = QK_K // BS            # 16 blocks per super-block
    M = N * nb
    xb = b.reshape(M, BS)
    sigma2 = np.repeat(2.0 * (b * b).sum(axis=-1) / QK_K, nb)
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, BS)
        w = qwb * np.sqrt(sigma2[:, None] + xb * xb)
    else:
        w = xb * xb
    mx = np.abs(xb).max(axis=-1)
    live = mx >= np.float32(1e-7)  # GROUP_MAX_EPS_IQ1_M

    order = np.argsort(xb, axis=-1, kind="stable")
    xs = np.take_along_axis(xb, order, axis=-1)
    ws = np.take_along_axis(w, order, axis=-1)
    half2 = (order >= BS // 2)     # sorted element came from the 2nd 8-group
    base = np.array([-1.0, 0.0, 1.0], np.float32)
    i1g, i2g = np.triu_indices(BS + 1)   # 153 (i1 <= i2) pairs

    best_score = np.full(M, -np.float32(1e-38))
    scale = mx.copy()
    bi1 = np.zeros(M, np.int64)
    bi2 = np.zeros(M, np.int64)
    bestk = np.zeros(M, np.int64)
    for k in range(4):   # 0:++ 1:+- 2:-+ 3:--  (first-half sign, second-half)
        s1 = 1.0 if k < 2 else -1.0
        s2 = 1.0 if k % 2 == 0 else -1.0
        sgn = np.where(half2, s2, s1).astype(np.float32)  # (M, BS) sorted
        # per-level prefix sums over the sorted order
        Sx = np.zeros((3, M, BS + 1), np.float32)
        S2 = np.zeros((3, M, BS + 1), np.float32)
        for lv in range(3):
            v = base[lv] + sgn * d5
            Sx[lv, :, 1:] = np.cumsum(ws * xs * v, axis=-1)
            S2[lv, :, 1:] = np.cumsum(ws * v * v, axis=-1)
        sumqx = (Sx[0][:, i1g] + (Sx[1][:, i2g] - Sx[1][:, i1g])
                 + (Sx[2][:, -1:] - Sx[2][:, i2g]))
        sumq2 = (S2[0][:, i1g] + (S2[1][:, i2g] - S2[1][:, i1g])
                 + (S2[2][:, -1:] - S2[2][:, i2g]))
        with np.errstate(divide="ignore", invalid="ignore"):
            sc_ = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        score = np.where(sumq2 > 0, sc_ * sumqx, -np.inf)
        j = score.argmax(axis=-1)
        sj = np.take_along_axis(score, j[:, None], 1)[:, 0]
        upd = sj > best_score
        best_score = np.where(upd, sj, best_score)
        scale = np.where(upd, np.take_along_axis(sc_, j[:, None], 1)[:, 0],
                         scale)
        bi1 = np.where(upd, i1g[j], bi1)
        bi2 = np.where(upd, i2g[j], bi2)
        bestk = np.where(upd, k, bestk)

    r = np.arange(BS)[None, :]
    Ls = (r >= bi1[:, None]).astype(np.int64) + (r >= bi2[:, None])
    L = np.zeros((M, BS), np.int64)
    np.put_along_axis(L, order, Ls, axis=-1)
    neg = scale < 0
    L = np.where(neg[:, None], 2 - L, L)
    scale = np.abs(scale)
    bestk = np.where(neg, 3 - bestk, bestk)
    L = np.where(live[:, None], L, 1)
    scale = np.where(live, scale, 0.0)

    # per-8-group delta sign from bestk (group 0: bit1, group 1: bit0)
    dl0 = np.where(bestk < 2, d5, -d5).astype(np.float32)          # (M,)
    dl1 = np.where(bestk % 2 == 0, d5, -d5).astype(np.float32)
    dl_g = np.stack([dl0, dl1], axis=1)                             # (M, 2)

    g, Lg, pmap = _iq1s_tables()
    Lgrp = L.reshape(M * 2, 8)
    u = (Lgrp << (2 * np.arange(8))[None, :]).sum(axis=1)
    idx = pmap[u]
    off = idx < 0
    if off.any():
        xg = xb.reshape(M * 2, 8)[off]
        wg8 = w.reshape(M * 2, 8)[off]
        sc8 = np.repeat(scale, 2)[off]
        dl8 = dl_g.reshape(M * 2)[off]
        idx = idx.copy()
        idx[off] = _iq1_grid_argmin(xg, wg8, sc8, dl8, g)
    idx = np.maximum(idx, 0).reshape(M, 2)
    had_off = off.reshape(M, 2).any(axis=-1)
    if had_off.any():
        qv = (g[idx] + dl_g[:, :, None]).reshape(M, BS)
        sumqx = (w * qv * xb).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where((sumqx > 0) & (sumq2 > 0), sumqx / sumq2, scale)
        scale = np.where(had_off, ns, scale)
    max_scale = scale.reshape(N, nb).max(axis=-1)

    # encode: qs byte per 8-group; qh nibble pair per block (high idx bits)
    # + delta-sign mask bits; 3-bit scales 4-per-u16; f16 d nibbles on top
    scale_b = scale.reshape(N, nb)
    shifts = bestk.reshape(N, nb)
    idx_b = idx.reshape(N, nb, 2)
    d = max_scale / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 7).astype(np.uint32)
    masks = np.array([0x00, 0x80, 0x08, 0x88], np.uint32)
    qh = (((idx_b[:, :, 0] >> 8) & 7) | (((idx_b[:, :, 1] >> 8) & 7) << 4)
          ).astype(np.uint32) | masks[shifts]
    qs = (idx_b & 255).astype(np.uint8).reshape(N, nb * 2)
    # global weighted d refit with quantized levels (reference tail)
    qv = (g[idx] + dl_g[:, :, None]).reshape(M, BS) \
        * np.repeat((2 * ls.reshape(-1) + 1).astype(np.float32), BS
                    ).reshape(M, BS)
    sumqx_f = (w * qv * xb).reshape(N, -1).sum(axis=-1)
    sumq2_f = (w * qv * qv).reshape(N, -1).sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        d = np.where(sumq2_f > 0, sumqx_f / sumq2_f, d)
    dead = max_scale <= 0
    d16 = _f16(np.where(dead, 0.0, d * 1.1125).astype(np.float32))
    du = d16.view(np.uint16).astype(np.uint32)
    sc4 = np.zeros((N, 4), np.uint32)
    for ib in range(nb):
        sc4[:, ib // 4] |= ls[:, ib] << (3 * (ib % 4))
    sc4[:, 0] |= (du & 0x000F) << 12
    sc4[:, 1] |= (du & 0x00F0) << 8
    sc4[:, 2] |= (du & 0x0F00) << 4
    sc4[:, 3] |= (du & 0xF000)
    qs = np.where(dead[:, None], 0, qs)
    qh = np.where(dead[:, None], 0, qh)
    sc4 = np.where(dead[:, None], 0, sc4)
    out = np.empty((N, 56), np.uint8)
    out[:, 0:32] = qs
    out[:, 32:48] = qh.astype(np.uint8)
    out[:, 48:56] = sc4.astype(np.uint16).view(np.uint8)
    return out


def _iq1s_tables():
    if "iq1_s" in _IQ_QTABLES:
        return _IQ_QTABLES["iq1_s"]
    g = _iq_grids()["grid_iq1_s"].astype(np.float32)   # (2048, 8) of -1/0/1
    L = (g + 1).astype(np.int64)                       # codes 0/1/2
    pat = (L << (2 * np.arange(8))[None, :]).sum(axis=1)
    pmap = np.full(1 << 16, -1, np.int64)
    pmap[pat] = np.arange(len(g))
    _IQ_QTABLES["iq1_s"] = (g, L, pmap)
    return _IQ_QTABLES["iq1_s"]


def _iq1_grid_argmin(xg, wg, s, dl, g):
    """Weighted nearest IQ1 grid entry, fused into ONE sgemm.

    argmin_e sum_j w_j (x_j - s*(g_ej + dl))^2: dropping the e-independent
    Sum w (x - s*dl)^2 term, score_e = s^2 [w @ (g^2)^T]_e
    - 2 s [(w*(x - s*dl)) @ g^T]_e — the naive rank-3 (K, E, 8) broadcast
    built ~2 GB of temporaries per 32K-group chunk and made IQ1 quantization
    hours-per-model (QUALITY.md r4 caveat)."""
    E, gs = g.shape
    Qcat = np.concatenate([g * g, g], axis=1).astype(np.float32).T  # (2gs, E)
    best = np.empty(len(xg), np.int64)
    A = np.empty((len(xg), 2 * gs), np.float32)
    A[:, :gs] = wg * (s * s)[:, None]
    A[:, gs:] = -2.0 * s[:, None] * (wg * (xg - (s * dl)[:, None]))
    for c0 in range(0, len(xg), 262144):
        sl = slice(c0, c0 + 262144)
        best[sl] = (A[sl] @ Qcat).argmin(axis=1)
    return best


def _iq1_s_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ1_S quantizer (quantize_row_iq1_s_impl, ggml/src/
    ggml-quants.c): per-32-block exhaustive sorted 3-way split over levels
    {-1,0,1} with the +-IQ1S_DELTA shift pair, 2048-entry grid projection
    (brute-force weighted nearest replaces the neighbour lists), weighted
    scale refit, 3-bit block scales with the reference's 1.125 fudge."""
    BS = 32
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    M = N * (QK_K // BS)
    xb = b.reshape(M, BS)
    sigma2 = np.repeat(2.0 * (b * b).sum(axis=-1) / QK_K, QK_K // BS)
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, BS)
    else:
        qwb = np.ones_like(xb)
    w = qwb * np.sqrt(sigma2[:, None] + xb * xb)

    mx = np.abs(xb).max(axis=-1)
    live = mx >= np.float32(1e-8)  # GROUP_MAX_EPS_IQ1_S

    # sorted prefix sums -> exhaustive (i1 <= i2) split search
    order = np.argsort(xb, axis=-1, kind="stable")
    xs = np.take_along_axis(xb, order, axis=-1)
    ws = np.take_along_axis(w, order, axis=-1)
    sumx = np.zeros((M, BS + 1), np.float32)
    sumw = np.zeros((M, BS + 1), np.float32)
    sumx[:, 1:] = np.cumsum(ws * xs, axis=-1)
    sumw[:, 1:] = np.cumsum(ws, axis=-1)
    i1g, i2g = np.triu_indices(BS + 1)  # all i1 <= i2 pairs (561)
    d = np.float32(IQ1S_DELTA)
    xp = np.array([-1 + d, d, 1 + d], np.float32)
    xm = np.array([-1 - d, -d, 1 - d], np.float32)
    s1 = sumx[:, i1g]
    s2 = sumx[:, i2g] - sumx[:, i1g]
    s3 = sumx[:, -1:] - sumx[:, i2g]
    w1 = sumw[:, i1g]
    w2 = sumw[:, i2g] - sumw[:, i1g]
    w3 = sumw[:, -1:] - sumw[:, i2g]
    best_score = np.full(M, -np.float32(1e-38))
    scale = mx.copy()
    bi1 = np.zeros(M, np.int64)
    bi2 = np.zeros(M, np.int64)
    shift = np.ones(M, np.int8)
    for xx, sh in ((xp, 1), (xm, -1)):
        sumqx = s1 * xx[0] + s2 * xx[1] + s3 * xx[2]
        sumq2 = w1 * xx[0] ** 2 + w2 * xx[1] ** 2 + w3 * xx[2] ** 2
        with np.errstate(divide="ignore", invalid="ignore"):
            sc = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        score = np.where(sumq2 > 0, sc * sumqx, -np.inf)
        j = score.argmax(axis=-1)
        sj = np.take_along_axis(score, j[:, None], 1)[:, 0]
        upd = sj > best_score
        best_score = np.where(upd, sj, best_score)
        scale = np.where(upd, np.take_along_axis(sc, j[:, None], 1)[:, 0],
                         scale)
        bi1 = np.where(upd, i1g[j], bi1)
        bi2 = np.where(upd, i2g[j], bi2)
        shift = np.where(upd, np.int8(sh), shift)

    # levels from the split (in sorted order), scattered back
    r = np.arange(BS)[None, :]
    Ls = (r >= bi1[:, None]).astype(np.int64) + (r >= bi2[:, None])
    L = np.zeros((M, BS), np.int64)
    np.put_along_axis(L, order, Ls, axis=-1)
    neg = scale < 0
    L = np.where(neg[:, None], 2 - L, L)
    scale = np.abs(scale)
    shift = np.where(neg, -shift, shift)
    L = np.where(live[:, None], L, 1)
    scale = np.where(live, scale, 0.0)

    # grid projection per 8-group
    g, Lg, pmap = _iq1s_tables()
    ng = BS // 8
    Lgrp = L.reshape(M * ng, 8)
    u = (Lgrp << (2 * np.arange(8))[None, :]).sum(axis=1)
    idx = pmap[u]
    off = idx < 0
    if off.any():
        xg = xb.reshape(M * ng, 8)[off]
        wg8 = w.reshape(M * ng, 8)[off]
        sc = np.repeat(scale, ng)[off]
        dl = np.repeat(shift.astype(np.float32) * d, ng)[off]
        # q for entry e = grid + shift*delta; dist = sum w (xb - scale*q)^2
        idx = idx.copy()
        idx[off] = _iq1_grid_argmin(xg, wg8, sc, dl, g)
    idx = np.maximum(idx, 0).reshape(M, ng)
    # refit scale for blocks with any off-grid group (reference semantics)
    had_off = off.reshape(M, ng).any(axis=-1)
    if had_off.any():
        qv = (g[idx] + (shift.astype(np.float32) * d)[:, None, None]
              ).reshape(M, BS)
        sumqx = (w * qv * xb).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where((sumqx > 0) & (sumq2 > 0), sumqx / sumq2, scale)
        scale = np.where(had_off, ns, scale)

    # encode
    nb32 = QK_K // BS
    scale_b = scale.reshape(N, nb32)
    shift_b = shift.reshape(N, nb32)
    idx_b = idx.reshape(N, nb32, ng)
    max_scale = scale_b.max(axis=-1)
    dd = max_scale / 15.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(dd > 0, 1.0 / np.where(dd > 0, dd, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 7).astype(np.uint32)
    ls = ls | np.where(shift_b == -1, 8, 0).astype(np.uint32)
    qh = ((idx_b >> 8).astype(np.uint32)
          << (3 * np.arange(ng))[None, None, :]).sum(axis=-1)
    qh = qh | (ls << 12)
    dead = max_scale <= 0
    qh = np.where(dead[:, None], 0, qh).astype(np.uint16)
    qs = np.where(dead[:, None, None], 0, idx_b & 255).astype(np.uint8)
    out = np.empty((N, 50), np.uint8)
    out[:, 0:2] = _f16(np.where(dead, 0.0, dd * 1.125)
                       .astype(np.float32))[:, None].view(np.uint8)
    out[:, 2:34] = qs.reshape(N, 32)
    out[:, 34:50] = qh.reshape(N, 8).view(np.uint8)
    return out


def _iq3_xxs_quantize(x, qw=None):
    return _iq_xxs_quantize(x, qw, "iq3_xxs")


def _iq2_xs_quantize(x: np.ndarray, qw: np.ndarray | None = None) -> np.ndarray:
    """IQ2_XS quantizer (quantize_row_iq2_xs_impl): per-16-element blocks
    (two 8-groups onto the 512-entry grid), is∈[-9,9] scale sweep with
    on-grid tracking, off-grid-only final remap, 4-bit nibble scales per
    block pair against d = max_scale/31."""
    kmax = 3
    BS = 16
    b = _rows(x, QK_K).astype(np.float32)
    N = len(b)
    M = N * (QK_K // BS)
    xb = b.reshape(M, BS)
    sigma2 = np.repeat((b * b).sum(axis=-1) / QK_K, QK_K // BS)
    if qw is not None:
        qwb = _rows(np.asarray(qw, np.float32), QK_K).reshape(M, BS)
        w = qwb * np.sqrt(sigma2[:, None] + xb * xb)
    else:
        w = np.sqrt(sigma2[:, None] + xb * xb)
    waux = np.sqrt(w)

    xval, signs = _iq_signs_parity(xb, w)   # signs (M, 2)
    mx = xval.max(axis=-1)
    live = mx >= GROUP_MAX_EPS
    eff = np.where(mx > 0, mx, 1.0)
    scale = mx / (2 * kmax - 1)
    best = np.zeros(M, np.float32)
    L = np.zeros((M, BS), np.int64)
    ongrid = np.ones((M, 2), bool)
    for c in [(2 * kmax - 1 + 0.1 * s) for s in range(-9, 10)]:
        idv = np.float32(c) / eff
        Laux = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)),
                       0, kmax - 1)
        Laux, _, og = _iq_grid_project(xval, waux, 1.0 / idv, Laux,
                                       "iq2_xs", mask=live)
        qv = 2 * Laux + 1
        sumqx = (w * xval * qv).sum(axis=-1)
        sumq2 = (w * qv * qv).sum(axis=-1)
        upd = (sumq2 > 0) & (sumqx * sumqx > best * sumq2) & live
        with np.errstate(divide="ignore", invalid="ignore"):
            ns = np.where(sumq2 > 0, sumqx / sumq2, 0.0)
        scale = np.where(upd, ns, scale)
        best = np.where(upd, ns * sumqx, best)
        L = np.where(upd[:, None], Laux, L)
        ongrid = np.where(upd[:, None], og, ongrid)

    pos = live & (scale > 0)
    remap = pos & ~ongrid.all(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        idv = np.where(scale > 0, 1.0 / np.where(scale > 0, scale, 1.0), 0.0)
    Lr = np.clip(_nearest_int(0.5 * (idv[:, None] * xval - 1.0)), 0, kmax - 1)
    Lf = np.where(remap[:, None], Lr, L)
    Lf, idx, _ = _iq_grid_project(xval, waux, scale, Lf, "iq2_xs", mask=pos)
    # keep the sweep's L/idx for fully-on-grid blocks
    keep = (~remap)[:, None] & ongrid
    Lf = np.where(np.repeat(keep, 8, axis=1), L, Lf)
    q_, Lg_, pmap_, bits_ = _iq_quant_tables("iq2_xs")
    u = (Lf.reshape(M * 2, 8).astype(np.int64)
         << (2 * np.arange(8))[None, :]).sum(axis=1)
    idx = pmap_[u].reshape(M, 2)
    qv = 2 * Lf + 1
    sumqx = (w * xval * qv).sum(axis=-1)
    sumq2 = (w * qv * qv).sum(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        scale = np.where(remap & (sumq2 > 0), sumqx / sumq2, scale)
    neg = scale < 0
    scale = np.where(live, np.abs(scale), 0.0)
    signs = np.where(neg[:, None], (~signs.astype(np.int64)) & 127, signs)
    idx = np.maximum(idx, 0)

    # encode: u16 per 8-group = grid_index | signs << 9; nibble scales
    nb16 = QK_K // BS
    scale_b = scale.reshape(N, nb16)
    max_scale = scale_b.max(axis=-1)
    d = max_scale / 31.0
    with np.errstate(divide="ignore", invalid="ignore"):
        idd = np.where(d > 0, 1.0 / np.where(d > 0, d, 1.0), 0.0)
    ls = np.clip(_nearest_int(0.5 * (idd[:, None] * scale_b - 1.0)),
                 0, 15).astype(np.uint32)
    dead = max_scale <= 0
    q16 = (idx.astype(np.uint32)
           | (signs.reshape(N * nb16, 2).astype(np.uint32) << 9))
    q16 = np.where(dead[:, None].repeat(nb16, 1).reshape(-1, 1), 0, q16)
    sc = (ls[:, 0::2] | (ls[:, 1::2] << 4)).astype(np.uint8)
    sc = np.where(dead[:, None], 0, sc)
    out = np.empty((N, 74), np.uint8)
    out[:, 0:2] = _f16(np.where(dead, 0.0, d).astype(np.float32)
                       )[:, None].view(np.uint8)
    out[:, 2:66] = q16.astype(np.uint16).reshape(N, 32).view(np.uint8)
    out[:, 66:74] = sc
    return out


def iq_decompose(raw: np.ndarray, t) -> tuple:
    """Decompose raw IQ blocks into (v, scales, delta, G):

    - v: (N, 256) int8 SIGNED grid values (sign applied) — the full alphabet
      of every IQ1/IQ2/IQ3 grid fits int8 ({±8,±25,±43}, {±1..±15},
      {±4..±62}, {-1,0,1}), so w = scale * v (+ scale*delta for IQ1) exactly.
    - scales: (N, 256//G) float32 per-G-group scales.
    - delta: (N, 256//G) float32 per-group IQ1 offsets (None otherwise);
      w = s*(v + delta) for IQ1.
    - G: group size (8/16/32).

    This is the basis of the native low-bit serving layouts (pack_iq_native):
    the codebook grids become per-element codes + sign bits decodable with
    pure arithmetic in a Pallas kernel — no in-kernel LUT gather needed.
    Reference layouts: ggml/src/ggml-common.h:336-419."""
    from .constants import GGMLType as T

    g = _iq_grids()
    if t == T.IQ2_XXS:
        blocks = raw.reshape(-1, 66)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        q16 = blocks[:, 2:].copy().view(np.uint16).reshape(N, 8, 4).astype(np.uint32)
        aux0 = q16[:, :, 0] | (q16[:, :, 1] << 16)
        aux1 = q16[:, :, 2] | (q16[:, :, 3] << 16)
        db = d[:, None] * (0.5 + (aux1 >> 28)).astype(np.float32) * 0.25
        gidx = np.stack([(aux0 >> (8 * l)) & 0xFF for l in range(4)], axis=2)
        sidx = np.stack([(aux1 >> (7 * l)) & 127 for l in range(4)], axis=2)
        v = g["grid_iq2_xxs"][gidx] * _signs_from_index(sidx)
        return (v.reshape(N, QK_K).astype(np.int8), db.astype(np.float32),
                None, 32)
    if t == T.IQ2_XS:
        blocks = raw.reshape(-1, 74)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        q16 = blocks[:, 2:66].copy().view(np.uint16).reshape(N, 8, 4)
        scales = blocks[:, 66:74]
        db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                       d[:, None] * (0.5 + (scales >> 4)) * 0.25], axis=2)
        gidx = (q16 & 511).astype(np.int64)
        sidx = (q16 >> 9).astype(np.int64)
        v = g["grid_iq2_xs"][gidx] * _signs_from_index(sidx)
        return (v.reshape(N, QK_K).astype(np.int8),
                db.reshape(N, 16).astype(np.float32), None, 16)
    if t == T.IQ2_S:
        blocks = raw.reshape(-1, 82)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        qs = blocks[:, 2:34].reshape(N, 8, 4).astype(np.int64)
        signs = blocks[:, 34:66].reshape(N, 8, 4)
        qh = blocks[:, 66:74].astype(np.int64)
        scales = blocks[:, 74:82]
        db = np.stack([d[:, None] * (0.5 + (scales & 0xF)) * 0.25,
                       d[:, None] * (0.5 + (scales >> 4)) * 0.25], axis=2)
        shift = (8 - 2 * np.arange(4))
        gidx = qs | ((qh[:, :, None] << shift[None, None, :]) & 0x300)
        bits = (signs[..., None] >> np.arange(8, dtype=np.uint8)) & 1
        sgn = np.where(bits == 1, np.float32(-1), np.float32(1))
        v = g["grid_iq2_s"][gidx] * sgn
        return (v.reshape(N, QK_K).astype(np.int8),
                db.reshape(N, 16).astype(np.float32), None, 16)
    if t == T.IQ3_XXS:
        blocks = raw.reshape(-1, 98)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        qs = blocks[:, 2:66].reshape(N, 8, 8).astype(np.int64)
        aux = blocks[:, 66:98].copy().view(np.uint32).reshape(N, 8)
        db = d[:, None] * (0.5 + (aux >> 28)).astype(np.float32) * 0.5
        sidx = np.stack([(aux >> (7 * l)) & 127 for l in range(4)], axis=2)
        v = (g["grid_iq3_xxs"][qs].reshape(N, 8, 4, 8)
             * _signs_from_index(sidx))
        return (v.reshape(N, QK_K).astype(np.int8), db.astype(np.float32),
                None, 32)
    if t == T.IQ3_S:
        blocks = raw.reshape(-1, 110)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        qs = blocks[:, 2:66].reshape(N, 8, 8).astype(np.int64)
        qh = blocks[:, 66:74].astype(np.int64)
        signs = blocks[:, 74:106].reshape(N, 8, 4)
        scales = blocks[:, 106:110]
        db = np.stack([d[:, None] * (1 + 2 * (scales & 0xF)).astype(np.float32),
                       d[:, None] * (1 + 2 * (scales >> 4)).astype(np.float32)],
                      axis=2).reshape(N, 8)
        k = np.arange(8)
        gidx = qs | (((qh[:, :, None] << (8 - k)[None, None, :]) & 256))
        bits = (signs[..., None] >> np.arange(8, dtype=np.uint8)) & 1
        sgn = np.where(bits == 1, np.float32(-1), np.float32(1))
        v = g["grid_iq3_s"][gidx].reshape(N, 8, 4, 8) * sgn
        return (v.reshape(N, QK_K).astype(np.int8), db.astype(np.float32),
                None, 32)
    if t == T.IQ1_S:
        blocks = raw.reshape(-1, 50)
        N = len(blocks)
        d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
        qs = blocks[:, 2:34].reshape(N, 8, 4).astype(np.int64)
        qh = blocks[:, 34:50].copy().view(np.uint16).reshape(N, 8).astype(np.int64)
        dl = d[:, None] * (2 * ((qh >> 12) & 7) + 1).astype(np.float32)
        delta = np.where(qh & 0x8000, -IQ1S_DELTA, IQ1S_DELTA)
        l = np.arange(4)
        gidx = qs | (((qh[:, :, None] >> (3 * l)[None, None, :]) & 7) << 8)
        v = g["grid_iq1_s"][gidx]
        return (v.reshape(N, QK_K).astype(np.int8), dl.astype(np.float32),
                delta.astype(np.float32), 32)
    if t == T.IQ1_M:
        blocks = raw.reshape(-1, 56)
        N = len(blocks)
        qs = blocks[:, 0:32].reshape(N, 8, 4).astype(np.int64)
        qh = blocks[:, 32:48].reshape(N, 8, 2).astype(np.int64)
        sc = blocks[:, 48:56].copy().view(np.uint16).reshape(N, 4).astype(np.uint32)
        scale_bits = ((sc[:, 0] >> 12) | ((sc[:, 1] >> 8) & 0x00F0)
                      | ((sc[:, 2] >> 4) & 0x0F00) | (sc[:, 3] & 0xF000))
        d = scale_bits.astype(np.uint16)[:, None].view(np.float16).astype(np.float32)[:, 0]
        ib = np.arange(8)
        dl1 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2))) & 7) + 1).astype(np.float32)
        dl2 = (2 * ((sc[:, ib // 2] >> (6 * (ib % 2) + 3)) & 7) + 1).astype(np.float32)
        dl = np.stack([dl1, dl1, dl2, dl2], axis=2) * d[:, None, None]  # (N,8,4)
        idx = np.stack([
            qs[:, :, 0] | ((qh[:, :, 0] << 8) & 0x700),
            qs[:, :, 1] | ((qh[:, :, 0] << 4) & 0x700),
            qs[:, :, 2] | ((qh[:, :, 1] << 8) & 0x700),
            qs[:, :, 3] | ((qh[:, :, 1] << 4) & 0x700),
        ], axis=2)  # (N, 8, 4) — per-8-element sub-blocks
        dmask = np.stack([qh[:, :, 0] & 0x08, qh[:, :, 0] & 0x80,
                          qh[:, :, 1] & 0x08, qh[:, :, 1] & 0x80], axis=2)
        delta = np.where(dmask != 0, -IQ1S_DELTA, IQ1S_DELTA)  # (N, 8, 4)
        v = g["grid_iq1_m"][idx]
        return (v.reshape(N, QK_K).astype(np.int8),
                dl.reshape(N, 32).astype(np.float32),
                delta.reshape(N, 32).astype(np.float32), 8)
    raise NotImplementedError(f"iq_decompose {t}")


def _tq1_0_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 54)
    N = len(blocks)
    qs = blocks[:, 0:48]
    qh = blocks[:, 48:52]
    d = _f16_to_f32(blocks[:, 52:54].copy())[:, 0]
    pow3 = np.array([1, 3, 9, 27, 81], dtype=np.uint16)

    def tern(bytes_, npow):  # (..., M) x pow planes -> (..., npow, M)
        q = bytes_[..., None, :].astype(np.uint16) * pow3[:npow, None]
        return ((((q & 0xFF) * 3) >> 8).astype(np.int8) - 1).astype(np.float32)

    parts = [
        tern(qs[:, 0:32], 5).reshape(N, 160),
        tern(qs[:, 32:48], 5).reshape(N, 80),
        tern(qh, 4).reshape(N, 16),
    ]
    q = np.concatenate(parts, axis=1)
    return d[:, None] * q


def _tq2_0_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 66)
    N = len(blocks)
    qs = blocks[:, 0:64].reshape(N, 2, 32)
    d = _f16_to_f32(blocks[:, 64:66].copy())[:, 0]
    planes = np.stack([(qs >> (2 * l)) & 3 for l in range(4)], axis=2)  # (N,2,4,32)
    q = planes.reshape(N, QK_K).astype(np.int8) - 1
    return d[:, None] * q.astype(np.float32)


def _roundaway(v: np.ndarray) -> np.ndarray:
    """Round half away from zero (gguf-py np_roundf semantics)."""
    return np.trunc(v + np.where(v >= 0, np.float32(0.5), np.float32(-0.5)))


def _tq1_0_quantize(x: np.ndarray) -> np.ndarray:
    """Ternary 1.69 bpw: 5 trits per byte base-3 packed, MSB-first digits
    (quantize_row_tq1_0, ggml/src/ggml-quants.c; layout
    ggml-common.h block_tq1_0)."""
    b = _rows(x, QK_K)
    N = len(b)
    d = np.abs(b).max(axis=-1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = (_roundaway(b * inv[:, None]).astype(np.int8) + 1).astype(np.uint16)  # 0..2
    w5 = np.array([81, 27, 9, 3, 1], dtype=np.uint16)
    q0 = (q[:, :160].reshape(N, 5, 32) * w5[None, :, None]).sum(axis=1)
    q1 = (q[:, 160:240].reshape(N, 5, 16) * w5[None, :, None]).sum(axis=1)
    qh = (q[:, 240:].reshape(N, 4, 4) * w5[None, :4, None]).sum(axis=1)
    packed = np.concatenate([q0, q1, qh], axis=1).astype(np.uint32)
    packed = ((packed * 256 + 242) // 243).astype(np.uint8)
    out = np.empty((N, 54), dtype=np.uint8)
    out[:, :52] = packed
    out[:, 52:54] = _f16(d)[:, None].view(np.uint8)
    return out


def _tq2_0_quantize(x: np.ndarray) -> np.ndarray:
    """Ternary 2.06 bpw: 4 trits per byte in 2-bit fields (quantize_row_tq2_0)."""
    b = _rows(x, QK_K)
    N = len(b)
    d = np.abs(b).max(axis=-1).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    q = (_roundaway(b * inv[:, None]).astype(np.int8) + 1).astype(np.uint8)  # 0..2
    q = q.reshape(N, 2, 4, 32) << np.array([0, 2, 4, 6], dtype=np.uint8)[None, None, :, None]
    qs = np.bitwise_or.reduce(q, axis=2).reshape(N, 64)
    out = np.empty((N, 66), dtype=np.uint8)
    out[:, :64] = qs
    out[:, 64:66] = _f16(d)[:, None].view(np.uint8)
    return out


def _q8_1_quantize(x: np.ndarray) -> np.ndarray:
    b = _rows(x, 32)
    amax = np.abs(b).max(axis=-1)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d != 0, np.float32(1.0) / d, np.float32(0.0))
    v = b * inv[:, None]
    q = np.trunc(v + np.where(v >= 0, np.float32(0.5), np.float32(-0.5))).astype(np.int8)
    s = d * q.sum(axis=-1, dtype=np.float32)
    out = np.empty((len(b), 36), dtype=np.uint8)
    out[:, 0:2] = _f16(d)[:, None].view(np.uint8)
    out[:, 2:4] = _f16(s)[:, None].view(np.uint8)
    out[:, 4:] = q.view(np.uint8)
    return out


def _q8_1_dequantize(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 36)
    d = _f16_to_f32(blocks[:, 0:2].copy())[:, 0]
    q = blocks[:, 4:].view(np.int8).astype(np.float32)
    return d[:, None] * q


# ---------------------------------------------------------------------------
# plain float formats
# ---------------------------------------------------------------------------

def _f32_quantize(x):
    return np.ascontiguousarray(x, dtype=np.float32).view(np.uint8)


def _f32_dequantize(raw):
    return np.ascontiguousarray(raw).view(np.float32)


def _f16_quantize(x):
    return np.ascontiguousarray(x, dtype=np.float32).astype(np.float16).view(np.uint8)


def _f16_dequantize(raw):
    return np.ascontiguousarray(raw).view(np.float16).astype(np.float32)


def _bf16_quantize(x):
    f = np.ascontiguousarray(x, dtype=np.float32)
    bits = f.view(np.uint32)
    # round-to-nearest-even on the mantissa cut
    rounded = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16
    nan = (bits & 0x7FFFFFFF) > 0x7F800000
    rounded = np.where(nan, (bits >> 16) | 0x40, rounded)
    return rounded.astype(np.uint16).view(np.uint8)


def _bf16_dequantize(raw):
    bits = np.ascontiguousarray(raw).view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

_QUANTIZERS = {
    GGMLType.F32: _f32_quantize,
    GGMLType.F16: _f16_quantize,
    GGMLType.BF16: _bf16_quantize,
    GGMLType.Q4_0: _q4_0_quantize,
    GGMLType.Q4_1: _q4_1_quantize,
    GGMLType.Q5_0: _q5_0_quantize,
    GGMLType.Q5_1: _q5_1_quantize,
    GGMLType.Q8_0: _q8_0_quantize,
    GGMLType.Q2_K: _q2_k_quantize,
    GGMLType.Q3_K: _q3_k_quantize,
    GGMLType.Q4_K: _q4_k_quantize,
    GGMLType.Q5_K: _q5_k_quantize,
    GGMLType.Q6_K: _q6_k_quantize,
    GGMLType.Q8_K: _q8_k_quantize,
    GGMLType.Q8_1: _q8_1_quantize,
    GGMLType.IQ4_NL: _iq4_nl_quantize,
    GGMLType.IQ4_XS: _iq4_xs_quantize,
    GGMLType.IQ2_XXS: _iq2_xxs_quantize,
    GGMLType.IQ2_XS: _iq2_xs_quantize,
    GGMLType.IQ2_S: _iq2_s_quantize,
    GGMLType.IQ3_XXS: _iq3_xxs_quantize,
    GGMLType.IQ3_S: _iq3_s_quantize,
    GGMLType.IQ1_S: _iq1_s_quantize,
    GGMLType.IQ1_M: _iq1_m_quantize,
    GGMLType.TQ1_0: _tq1_0_quantize,
    GGMLType.TQ2_0: _tq2_0_quantize,
}

# formats with a weighted (imatrix) search variant
_IMATRIX_QUANTIZERS = {
    GGMLType.Q2_K: _q2_k_quantize,
    GGMLType.Q4_K: _q4_k_quantize,
    GGMLType.Q5_K: _q5_k_quantize,
    GGMLType.Q6_K: _q6_k_quantize,
    GGMLType.IQ4_XS: _iq4_xs_quantize,
    GGMLType.IQ2_XXS: _iq2_xxs_quantize,
    GGMLType.IQ2_XS: _iq2_xs_quantize,
    GGMLType.IQ2_S: _iq2_s_quantize,
    GGMLType.IQ3_XXS: _iq3_xxs_quantize,
    GGMLType.IQ3_S: _iq3_s_quantize,
    GGMLType.IQ1_S: _iq1_s_quantize,
    GGMLType.IQ1_M: _iq1_m_quantize,
}

_DEQUANTIZERS = {
    GGMLType.F32: _f32_dequantize,
    GGMLType.F16: _f16_dequantize,
    GGMLType.BF16: _bf16_dequantize,
    GGMLType.Q4_0: _q4_0_dequantize,
    GGMLType.Q4_1: _q4_1_dequantize,
    GGMLType.Q5_0: _q5_0_dequantize,
    GGMLType.Q5_1: _q5_1_dequantize,
    GGMLType.Q8_0: _q8_0_dequantize,
    GGMLType.Q2_K: _q2_k_dequantize,
    GGMLType.Q3_K: _q3_k_dequantize,
    GGMLType.Q4_K: _q4_k_dequantize,
    GGMLType.Q5_K: _q5_k_dequantize,
    GGMLType.Q6_K: _q6_k_dequantize,
    GGMLType.Q8_K: _q8_k_dequantize,
    GGMLType.IQ4_NL: _iq4_nl_dequantize,
    GGMLType.IQ4_XS: _iq4_xs_dequantize,
    GGMLType.IQ2_XXS: _iq2_xxs_dequantize,
    GGMLType.IQ2_XS: _iq2_xs_dequantize,
    GGMLType.IQ2_S: _iq2_s_dequantize,
    GGMLType.IQ3_XXS: _iq3_xxs_dequantize,
    GGMLType.IQ3_S: _iq3_s_dequantize,
    GGMLType.IQ1_S: _iq1_s_dequantize,
    GGMLType.IQ1_M: _iq1_m_dequantize,
    GGMLType.TQ1_0: _tq1_0_dequantize,
    GGMLType.TQ2_0: _tq2_0_dequantize,
    GGMLType.Q8_1: _q8_1_dequantize,
}


def supported_quant_types() -> list[GGMLType]:
    return sorted(_DEQUANTIZERS, key=int)


def quantize(x: np.ndarray, t: GGMLType,
             quant_weights: np.ndarray | None = None) -> np.ndarray:
    """Quantize float array (..., n) -> raw uint8 (..., row_bytes).

    quant_weights: optional per-column importance weights (imatrix — the
    activation second moments collected by tools/imatrix.py; reference
    counterpart llama_model_quantize_internal + quantize_row_*_impl
    quant_weights, src/llama.cpp:18326 / ggml-quants.c). Shape (n,) or
    broadcastable to x."""
    t = GGMLType(t)
    if t not in _QUANTIZERS:
        raise NotImplementedError(f"quantize {t.name}")
    shape = x.shape
    x = np.asarray(x)
    if quant_weights is not None and t in _IMATRIX_QUANTIZERS:
        qw = np.broadcast_to(np.asarray(quant_weights, np.float32),
                             x.shape).reshape(x.shape)
        out = _IMATRIX_QUANTIZERS[t](x, qw)
    else:
        if quant_weights is not None:
            import warnings

            warnings.warn(
                f"imatrix provided but {t.name} has no weighted search "
                "variant — falling back to the unweighted x^2 search",
                stacklevel=2)
        out = _QUANTIZERS[t](x)
    return np.ascontiguousarray(out).reshape(_out_shape(shape, t))


def dequantize(raw: np.ndarray, t: GGMLType, dtype=np.float32) -> np.ndarray:
    """Dequantize raw uint8 (..., row_bytes) -> float (..., n)."""
    t = GGMLType(t)
    if t not in _DEQUANTIZERS:
        raise NotImplementedError(f"dequantize {t.name}")
    blk, sz = GGML_BLOCK_SIZES[t]
    raw = np.ascontiguousarray(raw)
    shape = raw.shape
    if shape[-1] % sz:
        raise ValueError(f"row bytes {shape[-1]} not divisible by {t.name} block bytes {sz}")
    flat = raw.reshape(-1, shape[-1])
    out = _DEQUANTIZERS[t](flat.reshape(-1, sz)).reshape(flat.shape[0], -1)
    return out.reshape(shape[:-1] + (shape[-1] // sz * blk,)).astype(dtype, copy=False)
