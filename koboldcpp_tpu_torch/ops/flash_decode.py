"""Batched flash decode over the fused (B, S, Hkv*D) slot cache (K5) and
over a paged (NP*P, Hkv*D) pool through a (B, MP) page table (K8).

`decode_attention_batched` and `decode_attention_paged` are the ports of the
JAX package's functions of the same names (ops/flash_decode.py, bodies
`_bkernel` and `_pkernel`). For a CUDA tensor each launches
csrc/flash_decode.cu; for a CPU tensor it runs the plain PyTorch version
beside it. Either way this step's K/V row is written into the cache IN
PLACE at each sequence's position (nothing is written where pos < 0 or
pos >= S, S = MP * P when paged), and the same cache tensors are returned.
"""
from __future__ import annotations

import torch

from . import _build

ROWS_PER_SPLIT = 256  # history rows per block of the sequence-split kernel


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def _attend_plain(q, k_new, v_new, k, v, n_hist, n_heads: int,
                  n_kv_heads: int, scale: float, softcap: float):
    """Softmax over the history rows < n_hist of k/v (B, S, Hkv*D) plus the
    self term from k_new/v_new; scores bf16 q . bf16 k in f32, p cast to
    bf16 before p . V. Returns out (B, H, D) f32."""
    B, S, KD = k.shape
    Hkv = n_kv_heads
    D = KD // Hkv
    G = n_heads // Hkv
    qf = q.to(torch.bfloat16).float().reshape(B, Hkv, G, D)
    kn = k_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
    vn = v_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
    kf = k.float().reshape(B, S, Hkv, D)
    vf = v.float().reshape(B, S, Hkv, D)
    scores = _softcap(torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale, softcap)
    hist = torch.arange(S, device=k.device)[None, :] < n_hist[:, None]
    scores = torch.where(hist[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    s_self = _softcap(torch.einsum("bhgd,bhd->bhg", qf, kn) * scale, softcap)
    m = torch.maximum(scores.amax(dim=-1), s_self)
    p = torch.exp(scores - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1) + p_self
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(torch.bfloat16).float(), vf)
    acc = acc + p_self[..., None] * vn[:, :, None, :]
    return (acc / l[..., None]).reshape(B, n_heads, D)


def decode_attention_plain(q, k_new, v_new, k_layer, v_layer, positions,
                           n_heads: int, n_kv_heads: int, scale: float,
                           softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K5: softmax over the history rows < pos (every row
    when pos < 0, all S when pos >= S) plus the self term. Returns out
    (B, H, D) f32 and writes the cache rows."""
    S = k_layer.shape[1]
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.where(pos < 0, S, torch.clamp(pos, max=S))
    out = _attend_plain(q, k_new, v_new, k_layer, v_layer, n_hist, n_heads,
                        n_kv_heads, scale, softcap)
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


def _page_rows(page_table: torch.Tensor, page_size: int,
               n_pages: int) -> torch.Tensor:
    """(B, MP) page table -> (B, MP*P) pool row of each history row (table
    entries clamped to the pool, as the TPU kernel's index map does)."""
    tab = torch.clamp(page_table.to(torch.int64), 0, n_pages - 1)
    offs = torch.arange(page_size, device=tab.device)
    return (tab[:, :, None] * page_size + offs).reshape(tab.shape[0], -1)


def decode_attention_paged_plain(q, k_new, v_new, k_pool, v_pool, page_table,
                                 positions, n_heads: int, n_kv_heads: int,
                                 page_size: int, scale: float,
                                 softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K8: K5's function over the rows the page table maps
    (row r of sequence b at pool row tab[b, r // P] * P + r % P), S = MP*P.
    A dead slot (pos < 0) takes the overshoot path: every page is read,
    nothing is written. Returns out (B, H, D) f32 and writes the pool rows."""
    MP = page_table.shape[1]
    S = MP * page_size
    rows = _page_rows(page_table, page_size, k_pool.shape[0] // page_size)
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.clamp(torch.where(pos >= 0, pos, S), max=S)
    out = _attend_plain(q, k_new, v_new, k_pool[rows], v_pool[rows], n_hist,
                        n_heads, n_kv_heads, scale, softcap)
    valid = (pos >= 0) & (pos < S)
    b_idx = torch.nonzero(valid).flatten()
    r = rows[b_idx, pos[b_idx]]
    KD = k_pool.shape[1]
    k_pool[r] = k_new.reshape(-1, KD)[b_idx].to(k_pool.dtype)
    v_pool[r] = v_new.reshape(-1, KD)[b_idx].to(v_pool.dtype)
    return out


def decode_attention_paged(q, k_new, v_new, k_pool, v_pool, page_table,
                           positions, n_heads: int, n_kv_heads: int,
                           page_size: int, scale: float, softcap: float = 0.0):
    """q: (B, H, D) post-rope; k_new/v_new: (B, Hkv, D); k_pool/v_pool:
    (NP*P, Hkv*D) bf16 fused page pools; page_table: (B, MP) int; positions:
    (B,) int. Returns (out (B, H, D) f32, k_pool, v_pool) with the pools
    updated in place."""
    if not q.is_cuda:
        out = decode_attention_paged_plain(q, k_new, v_new, k_pool, v_pool,
                                           page_table, positions, n_heads,
                                           n_kv_heads, page_size, scale,
                                           softcap)
        return out, k_pool, v_pool
    B, MP = page_table.shape
    NPP, KD = k_pool.shape
    D = KD // n_kv_heads
    G = n_heads // n_kv_heads
    check_kernel_shape(n_heads, n_kv_heads, D, "K8")
    if (k_pool.dtype != torch.bfloat16 or v_pool.dtype != torch.bfloat16
            or not (k_pool.is_contiguous() and v_pool.is_contiguous())
            or NPP % page_size):
        raise ValueError("K8 takes contiguous bf16 pools of whole pages")
    if any(t.device != q.device for t in (k_new, v_new, k_pool, v_pool,
                                          page_table, positions)):
        raise ValueError(f"K8 takes every operand on {q.device}")
    lib = _build.load("flash_decode", {
        "k8_flash_decode_paged": [_build.P] * 10 + [_build.I] * 9
        + [_build.F, _build.F, _build.P]})
    dev = q.device
    qb = q.to(torch.bfloat16).contiguous()
    kn = k_new.to(torch.bfloat16).contiguous()
    vn = v_new.to(torch.bfloat16).contiguous()
    tab = page_table.to(torch.int32).contiguous()
    pos = positions.to(torch.int32).contiguous()
    nsplit = max(1, -(-(MP * page_size) // ROWS_PER_SPLIT))
    out = torch.empty((B, n_heads, D), dtype=torch.float32, device=dev)
    part_acc = torch.empty((B * n_kv_heads, nsplit, G * D),
                           dtype=torch.float32, device=dev)
    part_ml = torch.empty((B * n_kv_heads, nsplit, G, 2),
                          dtype=torch.float32, device=dev)
    _build.check(lib, lib.k8_flash_decode_paged(
        qb.data_ptr(), kn.data_ptr(), vn.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), tab.data_ptr(), pos.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), B, MP, page_size,
        NPP // page_size, n_heads, n_kv_heads, D, nsplit, ROWS_PER_SPLIT,
        float(scale), float(softcap), _build.stream_ptr()), "K8")
    _build.launches["K8"] += 1
    return out, k_pool, v_pool


def supported_batched(T: int, Hkv: int, D: int) -> bool:
    return T == 1 and (Hkv * D) % 128 == 0


def check_kernel_shape(n_heads: int, n_kv_heads: int, head_dim: int,
                       kernel: str = "K5") -> None:
    """Raise NotImplementedError for the head shapes csrc/flash_decode.cu
    (K5, K8) is not built for: head_dim 64 or 128, at most 16 query heads
    per kv head and G * head_dim <= 1024."""
    G = n_heads // n_kv_heads
    if head_dim not in (64, 128) or G > 16 or G * head_dim > 1024:
        raise NotImplementedError(
            f"{kernel} (flash decode) is not ported for head_dim {head_dim} "
            f"with {G} query heads per kv head (head_dim 64 or 128, at most "
            "16 heads per kv head, G * head_dim <= 1024)")
