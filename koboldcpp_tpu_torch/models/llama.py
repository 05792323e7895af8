"""Llama-family forward pass in PyTorch (llama / mistral / qwen2-style
decoder-only transformers: GQA, optional q/k/v and output biases, fused
wqkv / w_gateup projections, silu-gated FFN, attention and final-logit
softcaps).

Port of koboldcpp_tpu/models/llama.py `forward` for the branches a llama /
mistral / qwen2 Q4_K_M model takes. Single-token decode runs attention
through the flash-decode kernel (K5), which also writes the new K/V row;
longer chunks write the cache and run the plain `attention` below, which is
what the JAX engine runs on the CPU and for every chunk past position 0.
Every other branch of the JAX forward raises NotImplementedError when the
config or params ask for it.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kv.cache import KVCache, read as kv_read, write as kv_write
from ..ops import flash_decode, linear
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope, rope_frequencies, yarn_attn_scale
from .config import ModelConfig

Params = dict[str, Any]

_FREQS: dict = {}  # (rope settings, device) -> freqs, built once per device


def _freqs(cfg: ModelConfig, device) -> torch.Tensor:
    key = (cfg.rope_dim, cfg.rope_theta, cfg.rope_scaling_type,
           cfg.rope_scaling_factor, cfg.rope_orig_ctx, str(device))
    f = _FREQS.get(key)
    if f is None:
        f = _FREQS[key] = rope_frequencies(cfg, device)
    return f


def _norm(x: torch.Tensor, store: Params, key: str,
          cfg: ModelConfig) -> torch.Tensor:
    if cfg.norm_type == "layer":
        return layer_norm(x, store[key], store.get(key + "_bias"),
                          cfg.rms_norm_eps)
    return rms_norm(x, store[key], cfg.rms_norm_eps)


def _softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap and cap > 0:
        return cap * torch.tanh(x / cap)
    return x


# layer keys of JAX-forward branches this slice does not serve
_UNSUPPORTED_LAYER_KEYS = {
    "attn_q_norm": "QK-norm", "ffn_gate_inp": "MoE",
    "ffn_norm_exps": "arctic residual MoE", "attn_sub_norm": "bitnet",
    "ffn_sub_norm": "bitnet", "wq_scale": "bitnet", "wo_scale": "bitnet",
    "ffn_down_scale": "bitnet", "b_gate": "jais gated-FFN biases",
}


def check_supported(params: Params, cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for configs/params that need a branch of the
    JAX forward this slice has not ported, or (on a CUDA `device`) a head
    shape that K5, the T=1 attention kernel, is not built for."""
    if (torch.device(device or "cpu").type == "cuda"
            and flash_decode.supported_batched(1, cfg.n_kv_heads,
                                               cfg.head_dim)):
        flash_decode.check_kernel_shape(cfg.n_heads, cfg.n_kv_heads,
                                        cfg.head_dim)
    ex = cfg.extras or {}
    why = None
    if cfg.use_alibi:
        why = "ALiBi"
    elif cfg.sliding_window:
        why = "sliding-window attention"
    elif cfg.parallel_residual or ex.get("plamo_parallel"):
        why = "parallel residual"
    elif ex.get("swin_norm"):
        why = "swin norm"
    elif ex.get("head_counts") or ex.get("kv_head_counts"):
        why = "per-layer head counts (openelm)"
    elif cfg.learned_pos or "tok_norm" in params:
        why = "learned positions / embedding norm"
    elif cfg.clamp_kqv > 0:
        why = "clamp_kqv"
    elif not cfg.ffn_gated or cfg.act != "silu":
        why = f"FFN activation {cfg.act!r} (gated={cfg.ffn_gated})"
    elif not cfg.use_rope:
        why = "rope-less attention"
    else:
        for layer in params["layers"]:
            hit = next((v for k, v in _UNSUPPORTED_LAYER_KEYS.items()
                        if k in layer), None)
            if hit:
                why = hit
                break
    if why:
        raise NotImplementedError(f"{why} is not ported to the PyTorch "
                                  "forward yet")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float,
              softcap: float = 0.0) -> torch.Tensor:
    """q: (B, T, H, D); k/v: (B, S, Hkv, D); mask: (B, T, S) bool. GQA via
    head-group reshape; f32 scores and softmax, p cast to v's dtype before
    p . V. Returns (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    scores = _softcap(scores, softcap)
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, neg))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _ffn(x: torch.Tensor, layer: Params) -> torch.Tensor:
    if "w_gateup" in layer:  # fused gate+up (one kernel launch)
        gu = linear.matmul(x, layer["w_gateup"])
        F = gu.shape[-1] // 2
        gate, up = gu[..., :F], gu[..., F:]
    else:
        gate = linear.matmul(x, layer["w_gate"])
        up = linear.matmul(x, layer["w_up"])
    if "b_up" in layer:
        up = up + layer["b_up"].to(up.dtype)
    act = torch.nn.functional.silu(gate.float()).to(x.dtype) * up
    down = linear.matmul(act, layer["w_down"])
    if "b_down" in layer:
        down = down + layer["b_down"].to(down.dtype)
    return down


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            last_only: bool = False,
            last_index: torch.Tensor | None = None,
            input_embeds: torch.Tensor | None = None,
            embed_mask: torch.Tensor | None = None
            ) -> tuple[torch.Tensor, KVCache]:
    """tokens, positions: (B, T) int. Returns (logits f32, cache); the cache
    is updated in place. Slot s is visible to the query at position p iff
    s <= p (the slot == position invariant)."""
    if input_embeds is not None or embed_mask is not None:
        raise NotImplementedError("the multimodal embedding splice is not "
                                  "ported yet")
    B, T = tokens.shape
    S = cache.max_seq
    dev = tokens.device
    freqs = _freqs(cfg, dev)
    scale = (cfg.attn_scale if cfg.attn_scale > 0
             else cfg.head_dim ** -0.5) * yarn_attn_scale(cfg)

    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    if cfg.embedding_scale:
        x = x * torch.tensor(cfg.embedding_scale, dtype=x.dtype, device=dev)

    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim
    use_flash_dec = T == 1 and flash_decode.supported_batched(
        1, cfg.n_kv_heads, cfg.head_dim)
    mask = None
    if not use_flash_dec:
        slot_ids = torch.arange(S, device=dev)
        mask = slot_ids[None, None, :] <= positions[:, :, None]  # (B, T, S)
    res_s = cfg.residual_scale or 1.0
    for li, layer in enumerate(params["layers"]):
        h = _norm(x, layer, "attn_norm", cfg)
        if "wqkv" in layer:  # fused projection (one kernel launch)
            qkv = linear.matmul(h, layer["wqkv"])
            if "bqkv" in layer:
                qkv = qkv + layer["bqkv"].to(qkv.dtype)
            q = qkv[..., :qdim]
            k = qkv[..., qdim:qdim + kvdim]
            v = qkv[..., qdim + kvdim:]
        else:
            q = linear.matmul(h, layer["wq"])
            k = linear.matmul(h, layer["wk"])
            v = linear.matmul(h, layer["wv"])
        if "bq" in layer:
            q = q + layer["bq"].to(q.dtype)
            k = k + layer["bk"].to(k.dtype)
            v = v + layer["bv"].to(v.dtype)
        q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
        k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, positions, freqs, cfg.rope_type, cfg.rope_dim)
        k = apply_rope(k, positions, freqs, cfg.rope_type, cfg.rope_dim)

        if use_flash_dec:
            # single-token decode: K5 reads the history rows below each
            # position and writes this step's K/V row into the cache
            out, _, _ = flash_decode.decode_attention_batched(
                q[:, 0], k[:, 0], v[:, 0], cache.k[li], cache.v[li],
                positions[:, 0], cfg.n_heads, cfg.n_kv_heads, scale,
                cfg.attn_logit_softcap)
            attn_out = out[:, None].to(x.dtype)
        else:
            kv_write(cache, li, positions, k, v)
            ck, cv = kv_read(cache, li)
            attn_out = attention(q, ck, cv, mask, scale,
                                 cfg.attn_logit_softcap)
        attn_out = attn_out.reshape(B, T, qdim)
        attn_out = linear.matmul(attn_out, layer["wo"])
        if "bo" in layer:
            attn_out = attn_out + layer["bo"].to(attn_out.dtype)
        if "attn_post_norm" in layer:
            attn_out = rms_norm(attn_out, layer["attn_post_norm"],
                                cfg.rms_norm_eps)
        x = x + res_s * attn_out
        ffn_out = _ffn(_norm(x, layer, "ffn_norm", cfg), layer)
        if "ffn_post_norm" in layer:
            ffn_out = rms_norm(ffn_out, layer["ffn_post_norm"],
                               cfg.rms_norm_eps)
        x = x + res_s * ffn_out

    if last_index is not None:
        x = x[torch.arange(B, device=dev), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = _norm(x, params, "output_norm", cfg)
    logits = linear.matmul(x, params["output"], out_dtype=torch.float32)
    if "output_bias" in params:
        logits = logits + params["output_bias"]
    if cfg.logit_scale:
        logits = logits * cfg.logit_scale
    logits = _softcap(logits, cfg.final_logit_softcap)
    return logits, cache
