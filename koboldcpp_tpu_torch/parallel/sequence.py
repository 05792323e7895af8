"""Sequence-parallel (SP) serving: ring-attention prefill and a
distributed flash decode over a sequence-sharded KV cache.

Port of koboldcpp_tpu/parallel/sequence.py. The KV cache's sequence axis
shards over the mesh's `sp` axis, so no rank holds more than S / n rows.
Prefill: each rank computes its T / n token block through every layer,
attention is ring attention (parallel/ring_attention.py), and each
layer's K / V rows are gathered and each rank keeps its own row range.
Decode: every rank computes the single token, the rank that owns its
position writes the row, each rank attends over its own rows, and the
partial (max, sum, numerator) triples merge by a max and two sums over
the axis (the online-softmax merge across ranks). The layers are
models/llama.py's (`embed`, `layers_body`, `head`); the ring's blocks and
the decode partials are torch einsums, as the JAX ones are XLA einsums.
"""
from __future__ import annotations

import torch

from ..kv.cache import KVCache
from ..models import llama
from . import comm
from .ring_attention import _NEG, ring_attention_local


def shard_cache_sp(cache: KVCache, mesh, axis: str = "sp") -> KVCache:
    """A whole per-layer fused (B, S, KD) cache -> this rank's rows
    [i * S / n, (i + 1) * S / n) of every layer."""
    g = mesh.group(axis)
    S = cache.k[0].shape[1]
    if S % g.size:
        raise ValueError(f"--seqparallel {g.size} must divide the context "
                         f"size {S}")
    n_loc = S // g.size
    sl = slice(g.index * n_loc, (g.index + 1) * n_loc)
    return KVCache(k=[x[:, sl].contiguous() for x in cache.k],
                   v=[x[:, sl].contiguous() for x in cache.v],
                   heads=cache.heads)


def check_sp_supported(cfg) -> None:
    """NotImplementedError where the JAX SP body computes another function
    than `forward` (it masks causally only and caps no score)."""
    why = ("a sliding window" if cfg.sliding_window else
           "ALiBi" if cfg.use_alibi else
           "an attention softcap" if cfg.attn_logit_softcap else None)
    if why:
        raise NotImplementedError(f"sequence parallelism does not take {why}")


def sp_forward(params: dict, cfg, tokens: torch.Tensor,
               positions: torch.Tensor, cache: KVCache, mesh,
               axis: str = "sp", last_only: bool = True, last_index=None):
    """Llama-family forward with the sequence sharded over `axis`.

    tokens / positions: (B, T), whole on every rank. T > 1 is the
    ring-attention PREFILL (T divisible by the axis size; positions the
    range [0, T): a fresh context); T == 1 the distributed DECODE step.
    cache: this rank's rows (`shard_cache_sp`), updated in place.
    last_index: the last real row of an end-padded prompt (default T - 1).
    Returns (logits (B, 1 or T, V) f32, the same on every rank; cache)."""
    check_sp_supported(cfg)
    g = mesh.group(axis)
    n, idx = g.size, g.index
    B, T = tokens.shape
    S_loc = cache.k[0].shape[1]
    row0 = idx * S_loc
    KD = cache.k[0].shape[2]
    dev = tokens.device
    decode = T == 1
    if decode:
        tok, pos = tokens, positions
    else:
        if T % n:
            raise ValueError(f"an SP prefill of {T} rows does not divide "
                             f"over {n}")
        Tl = T // n
        tok = tokens[:, idx * Tl:(idx + 1) * Tl]
        pos = positions[:, idx * Tl:(idx + 1) * Tl]

    def attend(li, q, k, v, scale, local):
        kl, vl = cache.k[li], cache.v[li]
        if decode:
            # masked owner write: local row pos - row0 on its owner only
            loc = pos[:, 0] - row0
            own = (loc >= 0) & (loc < S_loc)
            b_idx = torch.nonzero(own).flatten()
            if b_idx.numel():
                r = loc[b_idx]
                kl[b_idx, r] = k[b_idx, 0].reshape(-1, KD).to(kl.dtype)
                vl[b_idx, r] = v[b_idx, 0].reshape(-1, KD).to(vl.dtype)
            Hq, Hkv = q.shape[2], k.shape[2]
            D = q.shape[3]
            kk = torch.repeat_interleave(kl.view(B, S_loc, Hkv, D),
                                         Hq // Hkv, dim=2)
            vv = torch.repeat_interleave(vl.view(B, S_loc, Hkv, D),
                                         Hq // Hkv, dim=2)
            slot = row0 + torch.arange(S_loc, device=dev)
            mask = slot[None, :] <= pos[:, 0][:, None]  # (B, S_loc)
            s = torch.einsum("bhd,bshd->bhs", q[:, 0].float(),
                             kk.float()) * scale
            s = torch.where(mask[:, None, :], s, torch.full_like(s, _NEG))
            m_loc = s.amax(dim=-1)
            p = torch.exp(s - m_loc[..., None])
            l_loc = p.sum(dim=-1)
            o_loc = torch.einsum("bhs,bshd->bhd", p, vv.float())
            m = comm.all_reduce(m_loc.clone(), g, "max")
            corr = torch.exp(m_loc - m)
            l_tot = comm.all_reduce(corr * l_loc, g)
            o = comm.all_reduce(corr[..., None] * o_loc, g)
            return (o / torch.clamp(l_tot[..., None], min=1e-30))[:, None]
        out = ring_attention_local(q, k, v, g, scale)
        # the T-sharded rows into the S-sharded cache: gather every block,
        # keep rows [row0, row0 + S_loc)
        kg = comm.all_gather(k.reshape(B, -1, KD), g, dim=1)
        vg = comm.all_gather(v.reshape(B, -1, KD), g, dim=1)
        take = min(max(kg.shape[1] - row0, 0), S_loc)
        if take:
            kl[:, :take] = kg[:, row0:row0 + take].to(kl.dtype)
            vl[:, :take] = vg[:, row0:row0 + take].to(vl.dtype)
        return out

    x = llama.embed(params, cfg, tok, pos)
    x = llama.layers_body(params, cfg, x, pos, attend)
    if last_only and not decode:
        # the last REAL row's activation from the rank that holds it
        li = T - 1 if last_index is None else int(last_index)
        Tl = T // n
        sel = x[:, li % Tl:li % Tl + 1]
        x = comm.all_reduce(sel.clone() if idx == li // Tl
                            else torch.zeros_like(sel), g)
    return llama.head(params, cfg, x), cache
