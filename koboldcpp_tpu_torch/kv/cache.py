"""KV cache (contiguous, slot == absolute position).

Layout: per-layer lists of FUSED (B, S, H_kv*D) bf16 tensors — the layout of
the JAX package's KVCache with `heads` set, which the flash-decode kernel
(K5) reads and writes directly. Unlike the JAX cache, this one is updated
IN PLACE: `write` scatters into the existing tensors and returns the same
cache object. The Q8/Q4 caches (--quantkv, kernel K6) come in a later
slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    k: list  # L x (B, S, H_kv*D)
    v: list
    heads: int  # n_kv_heads

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]


def init_cache(n_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu") -> KVCache:
    shape = (batch, max_seq, n_kv_heads * head_dim)
    return KVCache(k=[torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(n_layers)],
                   v=[torch.zeros(shape, dtype=dtype, device=device)
                      for _ in range(n_layers)],
                   heads=n_kv_heads)


def write(cache: KVCache, layer: int, positions: torch.Tensor,
          k_new: torch.Tensor, v_new: torch.Tensor) -> KVCache:
    """Scatter k/v (B, T, H_kv, D) into slots given by positions (B, T), in
    place. Out-of-range positions (e.g. -1 padding) are dropped."""
    kl, vl = cache.k[layer], cache.v[layer]
    B, T = k_new.shape[:2]
    S = kl.shape[1]
    valid = (positions >= 0) & (positions < S)
    b_idx, t_idx = torch.nonzero(valid, as_tuple=True)
    p_idx = positions[b_idx, t_idx].long()
    kl[b_idx, p_idx] = k_new.reshape(B, T, -1)[b_idx, t_idx].to(kl.dtype)
    vl[b_idx, p_idx] = v_new.reshape(B, T, -1)[b_idx, t_idx].to(vl.dtype)
    return cache


def read(cache: KVCache, layer: int):
    """Layer view as (B, S, H, D)."""
    kl, vl = cache.k[layer], cache.v[layer]
    B, S, KD = kl.shape
    return (kl.view(B, S, cache.heads, KD // cache.heads),
            vl.view(B, S, cache.heads, KD // cache.heads))
