"""Paged KV pool (bf16) and its host-side page allocator.

Port of koboldcpp_tpu/kv/paged.py for the bf16 pool: a per-layer pool of
FUSED (NP*P, H_kv*D) tensors, page p owning rows [p*P, (p+1)*P), and an
int32 page table per slot. That is the block shape the paged flash-decode
kernel (K8) addresses through the table. Unlike the JAX pool, this one is
updated IN PLACE: `write` scatters into the existing tensors and returns
the same cache object. The quantized Q8/Q4 pools (--quantkv, kernels K9-K11)
are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class PagedKVCache:
    k: list  # L x (NP*P, H_kv*D) bf16
    v: list
    page_size: int
    heads: int  # n_kv_heads

    @property
    def n_layers(self) -> int:
        return len(self.k)

    @property
    def n_pages(self) -> int:
        return self.k[0].shape[0] // self.page_size


def init_paged_cache(n_layers: int, n_pages: int, page_size: int,
                     n_kv_heads: int, head_dim: int, quantized: bool = False,
                     device="cpu") -> PagedKVCache:
    if quantized:
        raise NotImplementedError(
            "quantized paged KV pools (--quantkv; kernels K9, K10, K11) are "
            "not ported yet")
    shape = (n_pages * page_size, n_kv_heads * head_dim)
    return PagedKVCache(
        k=[torch.zeros(shape, dtype=torch.bfloat16, device=device)
           for _ in range(n_layers)],
        v=[torch.zeros(shape, dtype=torch.bfloat16, device=device)
           for _ in range(n_layers)],
        page_size=page_size, heads=n_kv_heads)


def write(cache: PagedKVCache, layer: int, page_table: torch.Tensor,
          positions: torch.Tensor, k_new: torch.Tensor,
          v_new: torch.Tensor) -> PagedKVCache:
    """Scatter k/v (B, T, H, D) at (B, T) positions via the (B, MP) page
    table, in place. Negative positions drop; a position past the table
    lands in its last page, as in the JAX pool."""
    P = cache.page_size
    MP = page_table.shape[1]
    pos = positions.to(torch.int64)
    page_idx = torch.clamp(torch.div(pos, P, rounding_mode="floor"), 0, MP - 1)
    gpage = torch.gather(page_table.to(torch.int64), 1, page_idx)
    valid = (pos >= 0) & (gpage >= 0)
    b_idx, t_idx = torch.nonzero(valid, as_tuple=True)
    rows = (gpage * P + torch.remainder(pos, P))[b_idx, t_idx]
    B, T = k_new.shape[:2]
    kl, vl = cache.k[layer], cache.v[layer]
    kl[rows] = k_new.reshape(B, T, -1)[b_idx, t_idx].to(kl.dtype)
    vl[rows] = v_new.reshape(B, T, -1)[b_idx, t_idx].to(vl.dtype)
    return cache


def gather(cache: PagedKVCache, layer: int,
           page_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot K/V through the page table: (B, MP*P, H, D) bf16 each."""
    P = cache.page_size
    B, MP = page_table.shape
    tab = torch.clamp(page_table.to(torch.int64), 0, cache.n_pages - 1)
    rows = (tab[:, :, None] * P
            + torch.arange(P, device=tab.device)).reshape(B, MP * P)
    k, v = cache.k[layer][rows], cache.v[layer][rows]
    H = cache.heads
    return (k.reshape(B, MP * P, H, -1), v.reshape(B, MP * P, H, -1))


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
