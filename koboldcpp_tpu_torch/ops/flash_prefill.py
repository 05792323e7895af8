"""Causal flash prefill over a chunk that starts at position 0 (K4).

`flash_prefill_attention` is the port of the JAX package's function of the
same name (models/llama.py), which calls JAX's library Pallas TPU
`flash_attention` with causal masking and segment ids that keep the pad rows
(position < 0) apart from the real ones. For a CUDA tensor it launches
csrc/flash_prefill.cu; for a CPU tensor it runs the plain PyTorch version
beside it. The chunk is the whole context so far, so no cache is read.
"""
from __future__ import annotations

import torch

from . import _build

HEAD_DIMS = (64, 128, 256)  # the head shapes K4 is built for
TILE = 64  # query / key rows per tile of the kernel


def supported(head_dim: int) -> bool:
    """The head shapes the JAX engine turns flash prefill on for
    (engine.py:312), which K4 is built for."""
    return head_dim in HEAD_DIMS


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        positions: torch.Tensor, scale: float) -> torch.Tensor:
    """Plain version of K4: row i sees row j iff j <= i and both are real or
    both padding; f32 scores and softmax, p cast to v's dtype before p . V.
    GQA by head group. Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    idx = torch.arange(T, device=q.device)
    seg = positions < 0
    mask = ((idx[None, :] <= idx[:, None])[None]
            & (seg[:, :, None] == seg[:, None, :]))  # (B, T, T)
    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, torch.finfo(torch.float32).min))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def flash_prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            positions: torch.Tensor,
                            scale: float) -> torch.Tensor:
    """q: (B, T, H, D); k/v: (B, T, Hkv, D) post-rope, the chunk's own rows;
    positions: (B, T), < 0 on padding rows. Returns (B, T, H, D) in q's
    dtype (bf16 on the card)."""
    if not q.is_cuda:
        return flash_prefill_plain(q, k, v, positions, scale)
    B, T, H, D = q.shape
    Hkv = k.shape[2]
    if not supported(D) or H % Hkv or T % TILE:
        raise NotImplementedError(
            f"K4 (flash prefill) is not built for head_dim {D}, {H} heads "
            f"over {Hkv} kv heads, {T} rows (head_dim 64, 128 or 256; rows "
            f"a multiple of {TILE})")
    if any(t.device != q.device for t in (k, v, positions)):
        raise ValueError(f"K4 takes every operand on {q.device}")
    lib = _build.load("flash_prefill", {
        "k4_flash_prefill": [_build.P] * 5 + [_build.I] * 5
        + [_build.F, _build.P]})
    qb = q.to(torch.bfloat16).contiguous()
    kb = k.to(torch.bfloat16).contiguous()
    vb = v.to(torch.bfloat16).contiguous()
    pos = positions.to(torch.int32).contiguous()
    out = torch.empty((B, T, H, D), dtype=torch.bfloat16, device=q.device)
    _build.check(lib, lib.k4_flash_prefill(
        qb.data_ptr(), kb.data_ptr(), vb.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, T, H, Hkv, D, float(scale), _build.stream_ptr()),
        "K4")
    _build.launches["K4"] += 1
    return out
