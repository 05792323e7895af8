"""BERT-family encoders (embedding models) in PyTorch.

Port of koboldcpp_tpu/models/bert.py (the reference's build_bert), all
three branches:
  - bert:         LN(token + learned position + token type) embeddings;
                  biased q / k / v; exact-gelu FFN
  - nomic-bert:   NEOX rope in place of positions; a fused unbiased wqkv;
                  gated-silu FFN
  - jina-bert-v2: symmetric ALiBi (-slope |i - j|); optional QK
                  LayerNorm; gated tanh-gelu FFN with a down bias; the
                  optional attn_norm_2 re-adding the layer input
Post-norm encoder: x = LN(x + attn(x)), then x = LN(x + ffn(x)). `pool`
takes the mean over the valid rows or the first (CLS) row.

The projections go through `linear.matmul` (K3 / K13 at the T >= 9 of a
bucketed text, K7 / K1 for shorter ones where the kind has them). Under
tensor parallelism (params["tp"], parallel/sharding.py) a rank holds its
heads and FFN columns: jina's QK layer norm takes its statistics over
every rank's heads, ALiBi the rank's slopes, and the wo / w_down
products (with bo / b_down on rank 0) are summed over tp before each
post-norm, so every rank pools the same vector. The
bidirectional attention is plain torch ops (f32 scores, the masked
softmax, p cast to V's dtype before p . V), as the JAX module's einsums:
no Pallas kernel there, no finished kernel here.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..ops import linear
from ..ops.norms import layer_norm
from ..ops.rope import apply_rope, rope_frequencies
from ..parallel.sharding import matmul, reduce
from .config import ModelConfig
from .loader import tensor_readers
from .llama import _GELU_TANH, local_alibi_slopes

Params = dict[str, Any]



def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float = 1.0,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """q (B, T, H, D), k / v (B, S, H, D), mask (B, T, S): f32 scores
    times `scale` plus `bias` (B, H, T, S), the masked softmax, p in V's
    dtype -> (B, T, H, D) f32."""
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float())
    if scale != 1.0:
        scores = scores * scale
    if bias is not None:
        scores = scores + bias
    scores = torch.where(mask[:, None], scores, torch.full_like(
        scores, torch.finfo(torch.float32).min))
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bshd->bthd", p.to(v.dtype).float(), v.float())


def _norm(tp, li: int, x: torch.Tensor, layer: Params, key: str,
          eps: float, D: int) -> torch.Tensor:
    """jina's QK layer norm over the flat projection: under tensor
    parallelism over every rank's heads (layer li's `HeadShard`)."""
    if tp is None:
        return layer_norm(x, layer[key], layer.get(key + "_bias"), eps)
    hs = tp.heads[li]
    n = (hs.n_q if key == "attn_q_norm" else hs.n_kv) * D
    return tp.layer_norm(x, layer[key], layer.get(key + "_bias"), eps, n)


def forward_embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """tokens, positions (B, S); position < 0 marks padding. Returns the
    final hidden states (B, S, C) f32 (the caller pools)."""
    B, S = tokens.shape
    dev = tokens.device
    valid = positions >= 0
    eps = cfg.rms_norm_eps
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    if "pos_embd" in params:  # bert's learned positions
        x = x + params["pos_embd"][torch.clamp(positions, min=0)].to(x.dtype)
    if "token_types" in params:  # one segment: token type 0
        x = x + params["token_types"][0][None, None, :].to(x.dtype)
    x = layer_norm(x, params["tok_norm"], params.get("tok_norm_bias"), eps)

    mask = valid[:, None, :] & valid[:, :, None]  # (B, S, S)
    H, D = cfg.n_heads, cfg.head_dim
    tp = params.get("tp")
    alibi = None
    if cfg.use_alibi:  # jina: -slope |i - j|
        dist = -torch.abs(positions[:, None, :] - positions[:, :, None]
                          ).float()
        alibi = (local_alibi_slopes(cfg, H, dev)[None, :, None, None]
                 * dist[:, None])
    freqs = rope_frequencies(cfg, dev) if cfg.use_rope else None
    pos = torch.clamp(positions, min=0)
    for li, layer in enumerate(params["layers"]):
        if "wqkv" in layer:  # nomic's fused projection, no biases
            qkv = matmul(x, layer["wqkv"])
            q, k, v = qkv[..., :H * D], qkv[..., H * D:2 * H * D], \
                qkv[..., 2 * H * D:]
        else:
            q = matmul(x, layer["wq"]) + layer["bq"].to(x.dtype)
            k = matmul(x, layer["wk"]) + layer["bk"].to(x.dtype)
            v = matmul(x, layer["wv"]) + layer["bv"].to(x.dtype)
        if "attn_q_norm" in layer:  # jina's full-width QK LayerNorm
            q = _norm(tp, li, q, layer, "attn_q_norm", eps, D)
            k = _norm(tp, li, k, layer, "attn_k_norm", eps, D)
        q, k, v = (t.reshape(B, S, H, D) for t in (q, k, v))
        if freqs is not None:
            q = apply_rope(q, pos, freqs, cfg.rope_type, cfg.rope_dim)
            k = apply_rope(k, pos, freqs, cfg.rope_type, cfg.rope_dim)
        attn = attention(q, k, v, mask, D ** -0.5, alibi)
        attn = matmul(attn.reshape(B, S, H * D).to(x.dtype), layer["wo"])
        if "bo" in layer:
            attn = attn + layer["bo"].to(x.dtype)
        attn = reduce(params, attn)
        h = layer_norm(x + attn, layer["attn_out_norm"],
                       layer.get("attn_out_norm_bias"), eps)
        if "attn_norm_2" in layer:  # jina's "mixed" layers re-add the input
            h = layer_norm(h + x, layer["attn_norm_2"],
                           layer.get("attn_norm_2_bias"), eps)
        x = h

        if "w_gate" in layer:  # nomic (silu) / jina (tanh-gelu), gated
            gate = matmul(x, layer["w_gate"])
            up = matmul(x, layer["w_up"])
            actf = F.silu if cfg.act == "silu" else _GELU_TANH
            act = actf(gate.float()).to(x.dtype) * up
        else:
            up = matmul(x, layer["w_up"]) + layer["b_up"].to(x.dtype)
            act = F.gelu(up.float()).to(x.dtype)
        down = matmul(act, layer["w_down"])
        if "b_down" in layer:
            down = down + layer["b_down"].to(x.dtype)
        down = reduce(params, down)
        x = layer_norm(x + down, layer["layer_out_norm"],
                       layer.get("layer_out_norm_bias"), eps)
    return x.float()


def pool(hidden: torch.Tensor, positions: torch.Tensor,
         mode: str) -> torch.Tensor:
    """hidden (B, S, C) -> (B, C). mode: "cls" (row 0), else the mean over
    the valid rows."""
    if mode == "cls":
        return hidden[:, 0]
    valid = (positions >= 0).float()
    s = torch.einsum("bsc,bs->bc", hidden, valid)
    return s / torch.clamp(valid.sum(dim=1, keepdim=True), min=1.0)


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params`: projections packed where their type packs,
    the embedding dense, positions / token types / norms / biases f32."""
    qt, dense = tensor_readers(reader, packed, dtype, device)
    names = set(reader.tensors)
    params: Params = {
        "tok_embd": qt("token_embd.weight", pack=False),
        "tok_norm": dense("token_embd_norm.weight"),
        "tok_norm_bias": dense("token_embd_norm.bias"),
        "layers": [],
    }
    if "position_embd.weight" in names:
        params["pos_embd"] = dense("position_embd.weight")
    if "token_types.weight" in names:
        params["token_types"] = dense("token_types.weight")
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: Params = {
            "wo": qt(p + "attn_output.weight"),
            "attn_out_norm": dense(p + "attn_output_norm.weight"),
            "attn_out_norm_bias": dense(p + "attn_output_norm.bias"),
            "w_up": qt(p + "ffn_up.weight"),
            "w_down": qt(p + "ffn_down.weight"),
            "layer_out_norm": dense(p + "layer_output_norm.weight"),
            "layer_out_norm_bias": dense(p + "layer_output_norm.bias"),
        }
        if p + "attn_qkv.weight" in names:  # nomic's fused projection
            layer["wqkv"] = qt(p + "attn_qkv.weight")
        else:
            for w in "qkv":
                layer[f"w{w}"] = qt(p + f"attn_{w}.weight")
                layer[f"b{w}"] = dense(p + f"attn_{w}.bias")
        for key, tname in (("bo", "attn_output.bias"),
                           ("b_up", "ffn_up.bias"),
                           ("b_down", "ffn_down.bias"),
                           ("attn_q_norm", "attn_q_norm.weight"),
                           ("attn_q_norm_bias", "attn_q_norm.bias"),
                           ("attn_k_norm", "attn_k_norm.weight"),
                           ("attn_k_norm_bias", "attn_k_norm.bias"),
                           ("attn_norm_2", "attn_norm_2.weight"),
                           ("attn_norm_2_bias", "attn_norm_2.bias")):
            if p + tname in names:
                layer[key] = dense(p + tname)
        if p + "ffn_gate.weight" in names:
            layer["w_gate"] = qt(p + "ffn_gate.weight")
        params["layers"].append(layer)
    return params
