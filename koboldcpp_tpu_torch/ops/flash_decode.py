"""Batched flash decode over the fused (B, S, Hkv*D) slot cache (K5).

`decode_attention_batched` is the port of the JAX package's function of the
same name (ops/flash_decode.py, body `_bkernel`). For a CUDA tensor it
launches csrc/flash_decode.cu; for a CPU tensor it runs the plain PyTorch
version beside it. Either way this step's K/V row is written into the
cache IN PLACE at each sequence's position (nothing is written where
pos < 0 or pos >= S), and the same cache tensors are returned.
"""
from __future__ import annotations

import torch

from . import _build

ROWS_PER_SPLIT = 256  # history rows per block of the sequence-split kernel


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def decode_attention_plain(q, k_new, v_new, k_layer, v_layer, positions,
                           n_heads: int, n_kv_heads: int, scale: float,
                           softcap: float = 0.0) -> torch.Tensor:
    """Plain version: softmax over the history rows < pos (every row when
    pos < 0, all S when pos >= S) plus the self term from k_new/v_new;
    scores bf16 q . bf16 k in f32, p cast to bf16 before p . V.
    Returns out (B, H, D) f32 and writes the cache rows."""
    B, S, KD = k_layer.shape
    Hkv = n_kv_heads
    D = KD // Hkv
    G = n_heads // Hkv
    qf = q.to(torch.bfloat16).float().reshape(B, Hkv, G, D)
    kn = k_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
    vn = v_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
    k = k_layer.float().reshape(B, S, Hkv, D)
    v = v_layer.float().reshape(B, S, Hkv, D)
    pos = positions.to(torch.int64).reshape(B)
    scores = _softcap(torch.einsum("bhgd,bshd->bhgs", qf, k) * scale, softcap)
    n_hist = torch.where(pos < 0, S, torch.clamp(pos, max=S))
    hist = torch.arange(S, device=pos.device)[None, :] < n_hist[:, None]
    scores = torch.where(hist[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    s_self = _softcap(torch.einsum("bhgd,bhd->bhg", qf, kn) * scale, softcap)
    m = torch.maximum(scores.amax(dim=-1), s_self)
    p = torch.exp(scores - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1) + p_self
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(torch.bfloat16).float(), v)
    acc = acc + p_self[..., None] * vn[:, :, None, :]
    out = (acc / l[..., None]).reshape(B, n_heads, D)
    _write_rows(k_layer, v_layer, k_new, v_new, pos)
    return out


def _write_rows(k_layer, v_layer, k_new, v_new, pos) -> None:
    """In-place row write at pos per sequence, dropping pos outside [0, S)
    without a host sync (each sequence writes one distinct row)."""
    B, S, KD = k_layer.shape
    valid = (pos >= 0) & (pos < S)
    idx = torch.where(valid, pos, torch.zeros_like(pos))
    b = torch.arange(B, device=pos.device)
    for cache, new in ((k_layer, k_new), (v_layer, v_new)):
        new = new.reshape(B, KD).to(cache.dtype)
        cache[b, idx] = torch.where(valid[:, None], new, cache[b, idx])


def decode_attention_batched(q, k_new, v_new, k_layer, v_layer, positions,
                             n_heads: int, n_kv_heads: int, scale: float,
                             softcap: float = 0.0):
    """q: (B, H, D) post-rope; k_new/v_new: (B, Hkv, D) this step's post-rope
    K/V (not yet in the cache); k_layer/v_layer: (B, S, Hkv*D) bf16 fused
    cache buffers; positions: (B,) int. Returns (out (B, H, D) f32,
    k_layer, v_layer) with the caches updated in place."""
    if not q.is_cuda:
        out = decode_attention_plain(q, k_new, v_new, k_layer, v_layer,
                                     positions, n_heads, n_kv_heads, scale,
                                     softcap)
        return out, k_layer, v_layer
    B, S, KD = k_layer.shape
    D = KD // n_kv_heads
    G = n_heads // n_kv_heads
    check_kernel_shape(n_heads, n_kv_heads, D)
    if (k_layer.dtype != torch.bfloat16 or v_layer.dtype != torch.bfloat16
            or not (k_layer.is_contiguous() and v_layer.is_contiguous())):
        raise ValueError("K5 takes contiguous bf16 caches")
    if any(t.device != q.device
           for t in (k_new, v_new, k_layer, v_layer, positions)):
        raise ValueError(f"K5 takes every operand on {q.device}")
    lib = _build.load("flash_decode", {
        "k5_flash_decode": [_build.P] * 9 + [_build.I] * 7
        + [_build.F, _build.F, _build.P]})
    dev = q.device
    qb = q.to(torch.bfloat16).contiguous()
    kn = k_new.to(torch.bfloat16).contiguous()
    vn = v_new.to(torch.bfloat16).contiguous()
    pos = positions.to(torch.int32).contiguous()
    nsplit = max(1, -(-S // ROWS_PER_SPLIT))
    out = torch.empty((B, n_heads, D), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B * n_kv_heads, nsplit, G * D),
                           dtype=torch.float32, device=dev)
    part_ml = torch.empty((B * n_kv_heads, nsplit, G, 2),
                          dtype=torch.float32, device=dev)
    _build.check(lib, lib.k5_flash_decode(
        qb.data_ptr(), kn.data_ptr(), vn.data_ptr(), k_layer.data_ptr(),
        v_layer.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), B, S, n_heads, n_kv_heads,
        D, nsplit, ROWS_PER_SPLIT, float(scale), float(softcap),
        _build.stream_ptr()), "K5")
    _build.launches["K5"] += 1
    return out, k_layer, v_layer


def supported_batched(T: int, Hkv: int, D: int) -> bool:
    return T == 1 and (Hkv * D) % 128 == 0


def check_kernel_shape(n_heads: int, n_kv_heads: int, head_dim: int) -> None:
    """Raise NotImplementedError for the head shapes csrc/flash_decode.cu is
    not built for: head_dim 64 or 128, at most 16 query heads per kv head
    and G * head_dim <= 1024."""
    G = n_heads // n_kv_heads
    if head_dim not in (64, 128) or G > 16 or G * head_dim > 1024:
        raise NotImplementedError(
            f"K5 (flash decode) is not ported for head_dim {head_dim} with "
            f"{G} query heads per kv head (head_dim 64 or 128, at most 16 "
            "heads per kv head, G * head_dim <= 1024)")
