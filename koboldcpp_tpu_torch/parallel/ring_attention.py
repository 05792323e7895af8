"""Ring attention: causal attention with the sequence sharded over a group.

Port of koboldcpp_tpu/parallel/ring_attention.py. Each rank keeps its
block of Q and passes its K / V block one hop around the ring per step
(`comm.ppermute`), accumulating the softmax online (running max and
denominator); after n steps every Q block has attended to the whole
sequence with no rank holding more than T / n keys. The local block
products are plain torch einsums, as the JAX ones are XLA einsums outside
any Pallas kernel.
"""
from __future__ import annotations

import torch

from . import comm

_NEG = -1e30  # finite "-inf": fully masked blocks decay to exp(_NEG - m) == 0


def _block_attn(q, k, mask, scale):
    """One Q block x K block of scores with an explicit mask. q: (B, T, H,
    D), k: (B, S, H, D), mask: (T, S) -> (B, H, T, S) f32."""
    s = torch.einsum("bthd,bshd->bhts", q, k) * scale
    return torch.where(mask[None, None], s, torch.full_like(s, _NEG))


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: comm.Group,
                         scale: float | None = None) -> torch.Tensor:
    """Causal self-attention over this rank's sequence block (block i of n
    in group order, the ranks' blocks contiguous and equal): q (B, Tl, H,
    D), k / v (B, Tl, Hkv, D). Returns this block's output (B, Tl, H, D)
    in q's dtype."""
    B, Tl, H, D = q.shape
    Hkv = k.shape[2]
    if scale is None:
        scale = D ** -0.5
    if Hkv != H:  # GQA: expand kv heads to query heads
        k = torch.repeat_interleave(k, H // Hkv, dim=2)
        v = torch.repeat_interleave(v, H // Hkv, dim=2)
    n, idx = group.size, group.index
    dev = q.device
    q_pos = idx * Tl + torch.arange(Tl, device=dev)
    o = torch.zeros(B, H, Tl, D, dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tl), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros(B, H, Tl, dtype=torch.float32, device=dev)
    perm = [(i, (i + 1) % n) for i in range(n)]
    qf = q.float()
    for s_i in range(n):
        kv_idx = (idx - s_i) % n
        k_pos = kv_idx * Tl + torch.arange(Tl, device=dev)
        s = _block_attn(qf, k.float(), q_pos[:, None] >= k_pos[None, :],
                        scale)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        o = o * corr[..., None] + torch.einsum("bhts,bshd->bhtd", p,
                                               v.float())
        m = m_new
        if s_i != n - 1:  # K / V one hop around the ring
            k = comm.ppermute(k, group, perm)
            v = comm.ppermute(v, group, perm)
    o = o / torch.clamp(l[..., None], min=1e-30)
    return o.transpose(1, 2).to(q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mesh, axis: str = "sp",
                   scale: float | None = None) -> torch.Tensor:
    """The JAX `ring_attention` on this rank's sequence shard: q (B, Tl,
    H, D), k / v (B, Tl, Hkv, D), the rank's block along `axis` of a
    sequence T = n * Tl. Returns the rank's block of the output."""
    return ring_attention_local(q, k, v, mesh.group(axis), scale)


def sp_attention_sharded(q, k, v, mesh, axis: str = "sp", scale=None):
    """Whole (B, T, ...) q / k / v on every rank: each takes its sequence
    block, runs the ring, and the blocks are gathered back, so every rank
    returns the whole (B, T, H, D) output (the JAX function's global
    array). T must divide by the axis size."""
    g = mesh.group(axis)
    T = q.shape[1]
    if T % g.size:
        raise ValueError(f"sequence {T} does not divide over {g.size}")
    Tl = T // g.size
    sl = slice(g.index * Tl, (g.index + 1) * Tl)
    out = ring_attention_local(q[:, sl], k[:, sl], v[:, sl], g, scale)
    return comm.all_gather(out, g, dim=1)
