"""Paged KV pools (bf16, Q8, Q4) and their host-side page allocator.

Port of koboldcpp_tpu/kv/paged.py: a per-layer pool of FUSED row tensors,
page p owning rows [p*P, (p+1)*P), and an int32 page table per slot. That is
the block shape the paged flash-decode kernels (K8 bf16, K9 Q8, K10 Q4)
address through the table. Pools:
  - bf16: (NP*P, H_kv*D);
  - Q8 (`--quantkv 1`): (NP*P, H_kv*D) int8 + (NP*P, H_kv) bf16 scales,
    amax/127 per (row, head);
  - Q4 (`--quantkv 2 --paged`): (NP*P, H_kv*D/2) uint8 with PLANE-SPLIT
    nibbles (byte i of a head's D/2 bytes holds element i in the low nibble
    and element i+D/2 in the high one, as value + 8) + the same scales,
    amax/7.
The values and scales are the JAX pool's; its layouts are not: the JAX pool
keeps its scales as transposed (NP*HS, P) page tiles and switches to column
pools at P % 128 == 0, both for the TPU's DMA, while the port keeps plain
rows at every page size. Unlike the JAX pool, this one is updated IN PLACE:
`write` scatters into the existing tensors and returns the same cache
object.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .cache import _dequant, _q4_codes, _q8 as _quantize_q8


@dataclass
class PagedKVCache:
    k: list  # L x (NP*P, H_kv*D) bf16 | int8 (bits 8) | (NP*P, H_kv*D/2) u8
    v: list
    page_size: int
    heads: int  # n_kv_heads
    quantized: bool = False
    bits: int = 8  # when quantized: 8 (int8 rows) or 4 (plane-split nibbles)
    k_scale: list = field(default_factory=list)  # L x (NP*P, H_kv) bf16
    v_scale: list = field(default_factory=list)

    @property
    def n_layers(self) -> int:
        return len(self.k)

    @property
    def n_pages(self) -> int:
        return self.k[0].shape[0] // self.page_size


def init_paged_cache(n_layers: int, n_pages: int, page_size: int,
                     n_kv_heads: int, head_dim: int,
                     quantized: bool | int | str = False,
                     device="cpu") -> PagedKVCache:
    """quantized: False = bf16; True/1/8/"q8" = int8 + per-(row, head)
    scales; 4/"q4" = plane-split packed nibbles (the levels of
    kv/cache.py `init_cache`)."""
    def zeros(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=device)
                for _ in range(n_layers)]

    rows = n_pages * page_size
    kd = n_kv_heads * head_dim
    if quantized:
        bits = 4 if quantized in (4, "q4") else 8
        shape = (rows, kd // 2 if bits == 4 else kd)
        vdt = torch.uint8 if bits == 4 else torch.int8
        return PagedKVCache(
            k=zeros(shape, vdt), v=zeros(shape, vdt), page_size=page_size,
            heads=n_kv_heads, quantized=True, bits=bits,
            k_scale=zeros((rows, n_kv_heads), torch.bfloat16),
            v_scale=zeros((rows, n_kv_heads), torch.bfloat16))
    return PagedKVCache(k=zeros((rows, kd), torch.bfloat16),
                        v=zeros((rows, kd), torch.bfloat16),
                        page_size=page_size, heads=n_kv_heads)


def _quantize_q4(x: torch.Tensor):
    """(..., D) -> plane-split packed (..., D//2) uint8 + (...,) bf16 scale
    amax / 7: byte i packs (elem i) | (elem i+D//2 << 4), values clipped to
    [-8, 7] and stored + 8 (JAX kv/paged.py `_quantize_q4`)."""
    q, scale = _q4_codes(x)
    D = x.shape[-1]
    return (q[..., :D // 2] | (q[..., D // 2:] << 4)).to(torch.uint8), scale


def _q4_planes(packed: torch.Tensor) -> torch.Tensor:
    """Plane-split packed (..., D//2) uint8 -> signed int32 values (..., D)."""
    p = packed.to(torch.int32)
    return torch.cat([(p & 0xF) - 8, (p >> 4) - 8], dim=-1)


def _dequantize_q4(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of _quantize_q4: (..., D//2) u8 + (...,) -> (..., D) bf16."""
    return _dequant(_q4_planes(packed), scale)


def write(cache: PagedKVCache, layer: int, page_table: torch.Tensor,
          positions: torch.Tensor, k_new: torch.Tensor,
          v_new: torch.Tensor) -> PagedKVCache:
    """Scatter k/v (B, T, H, D) at (B, T) positions via the (B, MP) page
    table, in place (quantized first for a quantized pool). Negative
    positions drop; a position past the table lands in its last page, as in
    the JAX pool."""
    P = cache.page_size
    MP = page_table.shape[1]
    pos = positions.to(torch.int64)
    page_idx = torch.clamp(torch.div(pos, P, rounding_mode="floor"), 0, MP - 1)
    gpage = torch.gather(page_table.to(torch.int64), 1, page_idx)
    valid = (pos >= 0) & (gpage >= 0)
    b_idx, t_idx = torch.nonzero(valid, as_tuple=True)
    rows = (gpage * P + torch.remainder(pos, P))[b_idx, t_idx]
    if cache.quantized:
        quant = _quantize_q4 if cache.bits == 4 else _quantize_q8
        for vals, scales, new in ((cache.k, cache.k_scale, k_new),
                                  (cache.v, cache.v_scale, v_new)):
            q, s = quant(new[b_idx, t_idx])  # (N, H, D[/2]), (N, H)
            vals[layer][rows] = q.flatten(1)
            scales[layer][rows] = s
        return cache
    B, T = k_new.shape[:2]
    kl, vl = cache.k[layer], cache.v[layer]
    kl[rows] = k_new.reshape(B, T, -1)[b_idx, t_idx].to(kl.dtype)
    vl[rows] = v_new.reshape(B, T, -1)[b_idx, t_idx].to(vl.dtype)
    return cache


def gather(cache: PagedKVCache, layer: int,
           page_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot K/V through the page table: (B, MP*P, H, D) bf16 each
    (dequantized when the pool is quantized)."""
    P = cache.page_size
    B, MP = page_table.shape
    tab = torch.clamp(page_table.to(torch.int64), 0, cache.n_pages - 1)
    rows = (tab[:, :, None] * P
            + torch.arange(P, device=tab.device)).reshape(B, MP * P)
    H = cache.heads
    k = cache.k[layer][rows].reshape(B, MP * P, H, -1)
    v = cache.v[layer][rows].reshape(B, MP * P, H, -1)
    if not cache.quantized:
        return k, v
    ks, vs = cache.k_scale[layer][rows], cache.v_scale[layer][rows]
    if cache.bits == 4:
        return _dequantize_q4(k, ks), _dequantize_q4(v, vs)
    return _dequant(k, ks), _dequant(v, vs)


class PageAllocator:
    """Host-side free-list allocator mapping slots to page lists.

    Counterpart of llama_kv_cache find_slot/seq_rm bookkeeping
    (src/llama.cpp:3656,3967), page-granular."""

    def __init__(self, n_pages: int, page_size: int, max_pages_per_slot: int):
        self.n_pages = n_pages
        self.page_size = page_size
        self.max_pages = max_pages_per_slot
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.slot_pages: dict[int, list[int]] = {}

    def ensure(self, slot: int, n_tokens: int) -> list[int]:
        """Grow slot's page list to cover n_tokens; returns the page list."""
        pages = self.slot_pages.setdefault(slot, [])
        need = -(-n_tokens // self.page_size)
        if need > self.max_pages:
            raise MemoryError(f"slot {slot}: {n_tokens} tokens exceed "
                              f"{self.max_pages} pages")
        while len(pages) < need:
            if not self.free:
                raise MemoryError("KV page pool exhausted")
            pages.append(self.free.pop())
        return pages

    def trim(self, slot: int, n_tokens: int):
        """Release pages beyond n_tokens (context rewind / truncation)."""
        pages = self.slot_pages.get(slot, [])
        keep = -(-n_tokens // self.page_size) if n_tokens > 0 else 0
        while len(pages) > keep:
            self.free.append(pages.pop())

    def release(self, slot: int):
        self.trim(slot, 0)
        self.slot_pages.pop(slot, None)

    def table(self, slot: int) -> np.ndarray:
        """Padded int32 page-table row for this slot (unused entries -> 0,
        masked out by position bounds at attention time)."""
        row = np.zeros(self.max_pages, dtype=np.int32)
        pages = self.slot_pages.get(slot, [])
        row[:len(pages)] = pages
        return row

    @property
    def n_free(self) -> int:
        return len(self.free)
