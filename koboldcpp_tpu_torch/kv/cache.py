"""KV cache (contiguous, slot == absolute position).

Layout: per-layer lists of FUSED (B, S, H_kv*D) tensors — the layout of the
JAX package's KVCache / QuantKVCache with `heads` set, which the
flash-decode kernels read and write directly: bf16 (K5), or quantized
(`--quantkv`): Q8 int8 values with one bf16 scale per (slot, head) (K6), or
Q4 packed nibbles with the same scales (no kernel: `read` dequantizes, as
the JAX XLA path does). The scan decode path's pooled layout
(`init_pool_cache`) holds every layer in one (L*B, S, H_kv*D) tensor per
side, row l*B + b for layer l and sequence b, which K17c reads and writes
a layer's window of; `unpool_cache` gives the per-layer layout as views of
it. Unlike the JAX caches, these are updated IN PLACE:
`write` scatters into the existing tensors and returns the same cache
object. Quantized bytes and scales equal the JAX functions' bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class KVCache:
    # L x (B, S, H_kv*D); or pooled, one (L*B, S, H_kv*D) tensor; or
    # stacked (`stack_cache`), one (L, B, S, H_kv, D) tensor
    k: list | torch.Tensor
    v: list | torch.Tensor
    heads: int  # n_kv_heads

    @property
    def max_seq(self) -> int:
        if isinstance(self.k, torch.Tensor):  # pooled (3-D) or stacked (5-D)
            return self.k.shape[1 if self.k.dim() == 3 else 2]
        return self.k[0].shape[1]


@dataclass
class QuantKVCache:
    """Quantized KV (--quantkv; the reference's type_k/type_v Q8_0/Q4_0,
    gpttype_adapter.cpp:1958-1959): bits=8 -> int8 values + a bf16 scale per
    (slot, head) row; bits=4 -> two values per uint8 byte, element 2i in the
    low nibble and 2i+1 in the high one, stored as value + 8."""

    k: list  # L x (B, S, H_kv*D) int8 | (B, S, H_kv*D//2) uint8 (bits 4)
    v: list
    k_scale: list  # L x (B, S, H_kv) bf16
    v_scale: list
    heads: int
    bits: int = 8

    @property
    def max_seq(self) -> int:
        return self.k[0].shape[1]


def init_cache(n_layers: int, batch: int, max_seq: int, n_kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, device="cpu",
               quantized: bool | int = False):
    """quantized: False/0 = `dtype`; True/1/8 = Q8 (int8 + per-row scale);
    4 = Q4_0-equivalent packed nibbles (--quantkv 2)."""
    def zeros(shape, dt):
        return [torch.zeros(shape, dtype=dt, device=device)
                for _ in range(n_layers)]

    kd = n_kv_heads * head_dim
    if quantized:
        bits = 4 if quantized == 4 else 8
        shape = (batch, max_seq, kd // 2 if bits == 4 else kd)
        vdt = torch.uint8 if bits == 4 else torch.int8
        sshape = (batch, max_seq, n_kv_heads)
        return QuantKVCache(k=zeros(shape, vdt), v=zeros(shape, vdt),
                            k_scale=zeros(sshape, torch.bfloat16),
                            v_scale=zeros(sshape, torch.bfloat16),
                            heads=n_kv_heads, bits=bits)
    shape = (batch, max_seq, kd)
    return KVCache(k=zeros(shape, dtype), v=zeros(shape, dtype),
                   heads=n_kv_heads)


def init_pool_cache(n_layers: int, batch: int, max_seq: int, n_kv_heads: int,
                    head_dim: int, dtype=torch.bfloat16,
                    device="cpu") -> KVCache:
    """The scan decode path's pooled layout: every layer's cache in one
    (L*B, S, H_kv*D) tensor per side, row l*B + b for layer l and sequence
    b (the JAX `init_pool_cache`)."""
    shape = (n_layers * batch, max_seq, n_kv_heads * head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   heads=n_kv_heads)


def is_pooled(cache) -> bool:
    return (isinstance(cache, KVCache) and isinstance(cache.k, torch.Tensor)
            and cache.k.dim() == 3)


def stack_cache(cache: KVCache) -> KVCache:
    """Per-layer cache -> stacked (L, B, S, H, D) tensors (a copy); a
    stacked or pooled cache is returned as it is."""
    if isinstance(cache.k, torch.Tensor):
        return cache
    def st(ts):
        return torch.stack([t.view(*t.shape[:2], cache.heads, -1)
                            for t in ts])
    return KVCache(k=st(cache.k), v=st(cache.v), heads=cache.heads)


def unstack_cache(cache: KVCache) -> KVCache:
    """Stacked (L, B, S, H, D) cache -> per-layer fused (B, S, H*D) views."""
    if not isinstance(cache.k, torch.Tensor) or is_pooled(cache):
        return cache
    return KVCache(k=[t.flatten(2) for t in cache.k],
                   v=[t.flatten(2) for t in cache.v], heads=cache.heads)


def pool_cache(cache: KVCache) -> KVCache:
    """Per-layer (or stacked) cache -> the pooled layout (one copy)."""
    if is_pooled(cache):
        return cache
    st = stack_cache(cache)
    L, B, S, H, D = st.k.shape
    return KVCache(k=st.k.reshape(L * B, S, H * D),
                   v=st.v.reshape(L * B, S, H * D), heads=H)


def unpool_cache(cache: KVCache, n_layers: int) -> KVCache:
    """Pooled layout -> per-layer fused (B, S, H*D) caches that are views of
    the pool's rows [l*B, (l+1)*B): writes through them land in the pool,
    and each view is contiguous, as the T=1 kernels require."""
    B = cache.k.shape[0] // n_layers
    return KVCache(k=[cache.k[l * B:(l + 1) * B] for l in range(n_layers)],
                   v=[cache.v[l * B:(l + 1) * B] for l in range(n_layers)],
                   heads=cache.heads)


def rows(cache, i: int):
    """Sequence i of the cache as a one-sequence cache of views: writes
    through it land in `cache`."""
    if isinstance(cache, QuantKVCache):
        return QuantKVCache(k=[t[i:i + 1] for t in cache.k],
                            v=[t[i:i + 1] for t in cache.v],
                            k_scale=[t[i:i + 1] for t in cache.k_scale],
                            v_scale=[t[i:i + 1] for t in cache.v_scale],
                            heads=cache.heads, bits=cache.bits)
    return KVCache(k=[t[i:i + 1] for t in cache.k],
                   v=[t[i:i + 1] for t in cache.v], heads=cache.heads)


def _scale_inv(x: torch.Tensor, qmax: float):
    """Per-row amax / qmax scale over the last axis, and its f32 inverse (0
    where the row is all zeros): (x f32, scale f32, inv f32). Both are true
    IEEE divisions by tensors: divided by a Python number, a CUDA tensor is
    multiplied by the number's reciprocal instead, which rounds otherwise
    now and then and would move a code off the kernels' and JAX's."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = amax / torch.full_like(amax, qmax)
    inv = torch.where(scale > 0, torch.ones_like(scale) / scale,
                      torch.zeros_like(scale))
    return xf, scale, inv


def _q8(x: torch.Tensor):
    """(..., D) -> int8 values round(x / scale) + (...,) bf16 scale
    amax / 127 (JAX kv/cache.py `_q8`)."""
    xf, scale, inv = _scale_inv(x, 127.0)
    q = torch.round(xf * inv[..., None]).to(torch.int8)
    return q, scale.to(torch.bfloat16)


def _q4_codes(x: torch.Tensor):
    """(..., D) -> int32 codes clip(round(x / scale), -8, 7) + 8 and the
    (...,) bf16 scale amax / 7 (Q4_0 semantics)."""
    xf, scale, inv = _scale_inv(x, 7.0)
    q = torch.clamp(torch.round(xf * inv[..., None]), -8, 7).to(torch.int32)
    return q + 8, scale.to(torch.bfloat16)


def _q4(x: torch.Tensor):
    """(..., D) -> interleaved packed (..., D//2) uint8 (element 2i low
    nibble, 2i+1 high) + (...,) bf16 scale (JAX kv/cache.py `_q4`)."""
    q, scale = _q4_codes(x)
    packed = q[..., 0::2] | (q[..., 1::2] << 4)
    return packed.to(torch.uint8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Signed integer values (..., D) times the (...,) scale, in f32, rounded
    once to bf16."""
    return (q.float() * scale.float()[..., None]).to(torch.bfloat16)


def _q4_unpack(packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of _q4: packed (..., D//2) uint8 + scale (...,) -> (..., D)
    bf16."""
    p = packed.to(torch.int32)
    q = torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=-1)
    return _dequant(q.reshape(*p.shape[:-1], p.shape[-1] * 2), scale)


def write(cache, layer: int, positions: torch.Tensor,
          k_new: torch.Tensor, v_new: torch.Tensor):
    """Scatter k/v (B, T, H_kv, D) into slots given by positions (B, T), in
    place (quantized first for a QuantKVCache). Out-of-range positions (e.g.
    -1 padding) are dropped."""
    B, T = k_new.shape[:2]
    S = cache.k[layer].shape[1]
    valid = (positions >= 0) & (positions < S)
    b_idx, t_idx = torch.nonzero(valid, as_tuple=True)
    p_idx = positions[b_idx, t_idx].long()
    if isinstance(cache, QuantKVCache):
        quant = _q4 if cache.bits == 4 else _q8
        for vals, scales, new in ((cache.k, cache.k_scale, k_new),
                                  (cache.v, cache.v_scale, v_new)):
            q, s = quant(new[b_idx, t_idx])  # (N, H, D[/2]), (N, H)
            vals[layer][b_idx, p_idx] = q.flatten(1)
            scales[layer][b_idx, p_idx] = s
        return cache
    kl, vl = cache.k[layer], cache.v[layer]
    kl[b_idx, p_idx] = k_new.reshape(B, T, -1)[b_idx, t_idx].to(kl.dtype)
    vl[b_idx, p_idx] = v_new.reshape(B, T, -1)[b_idx, t_idx].to(vl.dtype)
    return cache


def read(cache, layer: int):
    """Layer view as (B, S, H, D) (dequantized to bf16 when quantized)."""
    kl, vl = cache.k[layer], cache.v[layer]
    B, S = kl.shape[:2]
    H = cache.heads
    if isinstance(cache, QuantKVCache):
        kq, vq = kl.view(B, S, H, -1), vl.view(B, S, H, -1)
        ks, vs = cache.k_scale[layer], cache.v_scale[layer]
        if cache.bits == 4:
            return _q4_unpack(kq, ks), _q4_unpack(vq, vs)
        return _dequant(kq, ks), _dequant(vq, vs)
    return kl.view(B, S, H, -1), vl.view(B, S, H, -1)
