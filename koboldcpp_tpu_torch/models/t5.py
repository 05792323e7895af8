"""T5 encoder-decoder forward pass in PyTorch.

Port of koboldcpp_tpu/models/t5.py (the reference's build_t5_encoder /
build_t5_decoder and llama_relative_position_bucket):
- no attention scaling;
- a learned relative-position bucket bias (max distance 128), layer 0's
  table shared by the layers without one: bidirectional buckets in the
  encoder, causal ones in the decoder, none on the cross-attention;
- RMS norms, a ReLU FFN, or gated tanh-gelu where ffn_gate exists
  (flan-T5);
- the decoder's self-attention cache is slot == position; the cross K / V
  are projected once a request from the encoder output (`prepare_cross`).

The decoder writes only the rows with position >= 0 into its cache (the
JAX forward scatters with mode="drop", which wraps a padding row's
position -1 to the last slot; see ROADMAP.md) and attends over the slots
up to the chunk's last position (the masked rest weigh exactly 0). The
projections go through `linear.matmul` (the decoder's one-row step on K1
/ K2; the encoder's bucketed prompt, T >= 16, on K3 / K13); the attention
is plain torch ops, as the JAX module's einsums. flan-T5's 32128-row head
fails the dispatch's multiple-of-256 rule, as in JAX, and takes the
dequant path. Under tensor parallelism only the head shards (its vocab
rows, gathered), as the JAX `shard_params` shards only `output` here.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F

from ..ops import linear
from ..ops.norms import rms_norm
from ..parallel.sharding import head_logits
from .bert import attention
from .config import ModelConfig
from .deepseek2 import cache_rows
from .llama import _GELU_TANH
from .loader import tensor_readers

Params = dict[str, Any]

T5_MAX_DISTANCE = 128  # hardcoded in the reference



@dataclass
class T5Cache:
    self_k: torch.Tensor   # (L, B, S, H, D) the decoder's self-attention
    self_v: torch.Tensor
    cross_k: torch.Tensor  # (L, B, Senc, H, D) the projected encoder output
    cross_v: torch.Tensor
    enc_valid: torch.Tensor  # (B, Senc) bool

    @property
    def max_seq(self) -> int:
        return self.self_k.shape[2]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int,
               dtype=torch.float32, device="cpu") -> T5Cache:
    """A zeroed cache (f32, as the JAX engine builds it)."""
    def z(S):
        return torch.zeros((cfg.n_layers, batch, S, cfg.n_kv_heads,
                            cfg.head_dim), dtype=dtype, device=device)

    return T5Cache(self_k=z(max_seq), self_v=z(max_seq), cross_k=z(enc_seq),
                   cross_v=z(enc_seq),
                   enc_valid=torch.zeros((batch, enc_seq), dtype=torch.bool,
                                         device=device))


def relative_buckets(rel_pos: torch.Tensor, n_buckets: int,
                     bidirectional: bool) -> torch.Tensor:
    """rel_pos = key position - query position -> bucket index."""
    nb = n_buckets // 2 if bidirectional else n_buckets
    max_exact = nb // 2
    if bidirectional:
        base = torch.where(rel_pos > 0, nb, 0)
        rel = torch.abs(rel_pos)
    else:
        base = torch.zeros_like(rel_pos)
        rel = -torch.clamp(rel_pos, max=0)
    large = max_exact + (
        torch.log(torch.clamp(rel, min=1).float() / max_exact)
        * (nb - max_exact) / math.log(T5_MAX_DISTANCE / max_exact)
    ).to(torch.int32)
    large = torch.clamp(large, max=nb - 1)
    return base + torch.where(rel < max_exact, rel, large)


def _bias(tables: dict, rel_b: torch.Tensor,
          buckets: torch.Tensor) -> torch.Tensor:
    """(B, H, T, S) f32 bias of a (n_buckets, H) table at (B, T, S)
    buckets, gathered once per table."""
    key = id(rel_b)
    if key not in tables:
        tables[key] = rel_b.float()[buckets].permute(0, 3, 1, 2)
    return tables[key]


def _proj_qkv(x, layer, cfg, B, T):
    q = linear.matmul(x, layer["attn_q"]).reshape(B, T, cfg.n_heads,
                                                  cfg.head_dim)
    k = linear.matmul(x, layer["attn_k"]).reshape(B, T, cfg.n_kv_heads,
                                                  cfg.head_dim)
    v = linear.matmul(x, layer["attn_v"]).reshape(B, T, cfg.n_kv_heads,
                                                  cfg.head_dim)
    return q, k, v


def _ffn(x: torch.Tensor, layer: Params) -> torch.Tensor:
    if "ffn_gate" in layer:  # flan: gelu-gated
        g = _GELU_TANH(linear.matmul(x, layer["ffn_gate"]).float()
                       ).to(x.dtype)
        return linear.matmul(g * linear.matmul(x, layer["ffn_up"]),
                             layer["ffn_down"])
    u = torch.relu(linear.matmul(x, layer["ffn_up"]).float())
    return linear.matmul(u.to(x.dtype), layer["ffn_down"])


def encode(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """The encoder. tokens, positions (B, S); position < 0 marks padding.
    Returns the normalized encoder states (B, S, C) in the activations'
    dtype."""
    B, S = tokens.shape
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    valid = positions >= 0
    mask = valid[:, None, :] & valid[:, :, None]  # (B, S, S)
    pos = torch.clamp(positions, min=0)
    buckets = relative_buckets(pos[:, None, :] - pos[:, :, None],
                               cfg.extras["rel_buckets"], True)
    tables: dict = {}
    enc = params["enc_layers"]
    rel_b0 = enc[0]["attn_rel_b"]
    for layer in enc:
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _proj_qkv(h, layer, cfg, B, S)
        bias = _bias(tables, layer.get("attn_rel_b", rel_b0), buckets)
        attn = attention(q, k, v, mask, bias=bias).to(q.dtype)
        x = x + linear.matmul(attn.reshape(B, S, -1), layer["attn_o"])
        h = rms_norm(x, layer["ffn_norm"], cfg.rms_norm_eps)
        x = x + _ffn(h, layer)
    return rms_norm(x, params["enc_output_norm"], cfg.rms_norm_eps)


def prepare_cross(params: Params, cfg: ModelConfig, enc_out: torch.Tensor,
                  enc_valid: torch.Tensor, cache: T5Cache) -> T5Cache:
    """Project the encoder states to every decoder layer's cross K / V,
    once a request. Returns the cache with them and enc_valid."""
    B, S, _ = enc_out.shape
    ck, cv = [], []
    for layer in params["dec_layers"]:
        ck.append(linear.matmul(enc_out, layer["cross_attn_k"]).reshape(
            B, S, cfg.n_kv_heads, cfg.head_dim).to(cache.cross_k.dtype))
        cv.append(linear.matmul(enc_out, layer["cross_attn_v"]).reshape(
            B, S, cfg.n_kv_heads, cfg.head_dim).to(cache.cross_v.dtype))
    return T5Cache(self_k=cache.self_k, self_v=cache.self_v,
                   cross_k=torch.stack(ck), cross_v=torch.stack(cv),
                   enc_valid=enc_valid)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: T5Cache,
            last_only: bool = False,
            last_index: torch.Tensor | None = None):
    """The decoder over the cached cross K / V. tokens, positions (B, T);
    rows with position < 0 write nothing; slot s is visible to the query
    at position p iff s <= p. The self-attention cache is updated in
    place. Returns (logits f32, cache)."""
    B, T = tokens.shape
    dev = tokens.device
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    rows, mask = cache_rows(positions, cache.max_seq)
    n = mask.shape[-1]
    b_idx, t_idx, p_idx = rows
    cross_mask = cache.enc_valid[:, None, :].expand(B, T, -1)
    pos = torch.clamp(positions, min=0)
    buckets = relative_buckets(
        torch.arange(n, device=dev)[None, None, :] - pos[:, :, None],
        cfg.extras["rel_buckets"], False)
    tables: dict = {}
    dec = params["dec_layers"]
    rel_b0 = dec[0]["attn_rel_b"]
    for li, layer in enumerate(dec):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _proj_qkv(h, layer, cfg, B, T)
        kl, vl = cache.self_k[li], cache.self_v[li]
        kl[b_idx, p_idx] = k[b_idx, t_idx].to(kl.dtype)
        vl[b_idx, p_idx] = v[b_idx, t_idx].to(vl.dtype)
        bias = _bias(tables, layer.get("attn_rel_b", rel_b0), buckets)
        attn = attention(q, kl[:, :n], vl[:, :n], mask, bias=bias).to(q.dtype)
        x = x + linear.matmul(attn.reshape(B, T, -1), layer["attn_o"])

        h = rms_norm(x, layer["cross_attn_norm"], cfg.rms_norm_eps)
        cq = linear.matmul(h, layer["cross_attn_q"]).reshape(
            B, T, cfg.n_heads, cfg.head_dim)
        cattn = attention(cq, cache.cross_k[li], cache.cross_v[li],
                          cross_mask).to(cq.dtype)
        x = x + linear.matmul(cattn.reshape(B, T, -1), layer["cross_attn_o"])

        h = rms_norm(x, layer["ffn_norm"], cfg.rms_norm_eps)
        x = x + _ffn(h, layer)

    if last_index is not None:
        x = x[torch.arange(B, device=dev), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["output_norm"], cfg.rms_norm_eps)
    logits = head_logits(params, x)  # vocab rows gathered under tp
    return logits, cache


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params` for t5 and t5encoder (enc.blk.* / dec.blk.*;
    a t5encoder file has no decoder layers)."""
    qt, dense = tensor_readers(reader, packed, dtype, device)
    names = set(reader.tensors)
    tok_embd = qt("token_embd.weight", pack=False)
    params: Params = {
        "tok_embd": tok_embd,
        "enc_output_norm": dense("enc.output_norm.weight"),
        "output": qt("output.weight") if "output.weight" in names
        else tok_embd,
        "enc_layers": [], "dec_layers": [],
    }
    if "dec.output_norm.weight" in names:
        params["output_norm"] = dense("dec.output_norm.weight")

    def block(p: str, keys: tuple[str, ...]) -> Params:
        layer = {k: (dense if k.endswith("norm") else qt)(p + k + ".weight")
                 for k in keys}
        if p + "attn_rel_b.weight" in names:
            layer["attn_rel_b"] = dense(p + "attn_rel_b.weight")
        if p + "ffn_gate.weight" in names:
            layer["ffn_gate"] = qt(p + "ffn_gate.weight")
        return layer

    attn = ("attn_norm", "attn_q", "attn_k", "attn_v", "attn_o")
    ffn = ("ffn_norm", "ffn_up", "ffn_down")
    cross = ("cross_attn_norm", "cross_attn_q", "cross_attn_k",
             "cross_attn_v", "cross_attn_o")
    for i in range(cfg.n_layers):
        params["enc_layers"].append(block(f"enc.blk.{i}.", attn + ffn))
    for i in range(cfg.n_layers):
        p = f"dec.blk.{i}."
        if p + "attn_norm.weight" not in names:  # t5encoder: no decoder
            break
        params["dec_layers"].append(block(p, attn + cross + ffn))
    return params
