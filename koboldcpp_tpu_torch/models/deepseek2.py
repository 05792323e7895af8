"""DeepSeek-V2 / MiniCPM3 (MLA, multi-head latent attention) forward pass in
PyTorch.

Port of koboldcpp_tpu/models/deepseek2.py:
- Q through an optional LoRA bottleneck (wq_a -> RMS norm -> wq_b; "lite"
  models have a plain wq);
- per head, Q / K split into a position-free part (the first dims) and a
  roped part (the last `rope_dim`); the roped K is one head shared by all
  (broadcast over the heads);
- K / V decompressed from a rank-`kv_lora_rank` latent (wkv_a_mqa -> RMS
  norm -> wkv_b) and written whole into the cache, as the JAX module does
  (the latent-cache "absorb" form is later work in both packages);
- DeepSeek's YaRN pre-scaling (`_scales`);
- dense lead layers, then MoE layers: a softmax router, top-k not
  renormalized, scaled by `expert_weights_scale`, plus an always-on shared
  expert with no gate (`_moe`);
- minicpm3's embedding, residual and logit scales from the config.

Under tensor parallelism (params["tp"], parallel/sharding.py) a rank holds
its heads (wq or wq_b, wkv_b, its part of the MLA cache) and FFN columns,
and the routed experts of its range; wo, w_down and the shared expert's
down projection are summed over tp and the routed experts' combine over
the expert axis (one all_reduce where that axis is tp), the head's vocab
rows gathered.

The projections go through `linear.matmul`, so the packed weights reach the
port's kernels (K1 / K2 at T = 1, K3 above), and the expert products are
models/llama.py's `_moe_gather` (torch.mm, as the JAX einsums lie outside
any Pallas kernel). Attention is plain torch ops (f32 scores, the masked
softmax, p cast to the activations' dtype before p . V), as the JAX module
computes it with einsums: no port kernel takes K and V rows of unequal
widths, and JAX has none here either. It runs over the cache rows up to the
chunk's last position only: past it every slot is masked for every row,
and a masked slot's softmax weight is exactly 0, so the result is the JAX
module's over all S slots.
"""
from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..kv.cache import KVCache
from ..ops import linear
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope
from ..parallel.sharding import head_logits, matmul, reduce
from . import llama
from .config import ModelConfig

Params = dict[str, Any]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               dtype=torch.bfloat16, device="cpu") -> KVCache:
    """The MLA cache, stacked as the JAX one: k (L, B, S, H, qk_nope +
    qk_rope) and v (L, B, S, H, v_head_dim) on `device`."""
    shape = (cfg.n_layers, batch, max_seq, cfg.n_heads)
    return KVCache(
        k=torch.zeros(shape + (cfg.head_dim,), dtype=dtype, device=device),
        v=torch.zeros(shape + (cfg.extras["v_head_dim"],), dtype=dtype,
                      device=device),
        heads=cfg.n_heads)


def _scales(cfg: ModelConfig) -> tuple[float, float]:
    """(kq_scale, the rope's attention factor) with DeepSeek's YaRN
    pre-scaling: mscale = attn_factor (1 + yarn_log_mul ln factor),
    kq_scale = mscale^2 / sqrt(dk), the rope run with 1 / (1 + 0.1 ln
    factor)."""
    dk = cfg.head_dim
    if cfg.rope_scaling_type == "yarn" and cfg.rope_scaling_factor != 1.0:
        log_inv_fs = math.log(cfg.rope_scaling_factor)  # ln(1/freq_scale)
        mscale = cfg.rope_attn_factor * (
            1.0 + cfg.extras.get("yarn_log_mul", 0.1) * log_inv_fs)
        return mscale * mscale / math.sqrt(dk), 1.0 / (1.0 + 0.1 * log_inv_fs)
    return 1.0 / math.sqrt(dk), 1.0


def _moe(x: torch.Tensor, layer: Params, cfg: ModelConfig,
         tp=None) -> torch.Tensor:
    """The JAX `_moe`: a router product cast to f32, softmax, top-k (not
    renormalized; llama's `_top_k`, a tie to the lower index) scaled by
    `expert_weights_scale`, the silu experts, plus the shared expert with
    no gate. The experts run grouped by expert (`_moe_gather` without
    `every_expert`: each chosen expert's weights read in place, one host
    read of the group bounds a layer) at every T: this architecture decodes
    in the host loop, and on the H100 a step of this form took less device
    time than every expert's (PERF.md §6). tp: the TensorShard of a
    sharded layer (the rank's experts and shared-expert columns)."""
    B, T, C = x.shape
    xt = x.reshape(-1, C)
    router = linear.matmul(xt, layer["ffn_gate_inp"]).float()
    topw, topi = llama._top_k(torch.softmax(router, dim=-1),
                              cfg.n_experts_used)
    topw = topw * cfg.extras.get("expert_weights_scale", 1.0)
    shard = tp is not None and tp.experts is not None
    out = llama._moe_gather(xt, topi, topw, layer["ffn_gate_exps"].data["w"],
                            layer["ffn_up_exps"].data["w"],
                            layer["ffn_down_exps"].data["w"], F.silu,
                            every_expert=False,
                            e0=tp.experts[0] if shard else 0,
                            n_experts=tp.n_experts if shard else 0)
    sg = F.silu(matmul(xt, layer["ffn_gate_shexp"]).float())
    su = matmul(xt, layer["ffn_up_shexp"]).float()
    sd = matmul((sg * su).to(xt.dtype), layer["ffn_down_shexp"]).float()
    if shard and tp.expert_group is tp.group:  # dense-EP: one sum over tp
        y = tp.reduce(out + sd)
    else:
        if shard:  # the combine over ep
            out = tp.reduce_experts(out)
        if tp is not None and tp.group.size > 1:  # the shared expert's
            sd = tp.reduce(sd)
        y = out + sd
    return y.reshape(B, T, C).to(x.dtype)


def _attention(layer: Params, cfg: ModelConfig, h: torch.Tensor,
               positions: torch.Tensor, kl: torch.Tensor, vl: torch.Tensor,
               rows: tuple, mask: torch.Tensor) -> torch.Tensor:
    """One layer's MLA attention on the normed input h (B, T, C): Q (through
    the q-LoRA bottleneck where the layer has one), the latent K / V and
    the shared roped K head, this chunk's rows written into the layer's
    cache kl (B, S, H, dk) / vl (B, S, H, dv) at rows = (b, t, position) of
    the rows with position >= 0, then the masked f32 attention over the
    first mask.shape[-1] slots and `wo`. Returns (B, T, C)."""
    B, T = h.shape[:2]
    H, dk, d_rope = cfg.n_heads, cfg.head_dim, cfg.rope_dim
    dv = cfg.extras["v_head_dim"]
    d_nope = dk - d_rope
    n = mask.shape[-1]
    freqs = llama._freqs(cfg, h.device)
    kq_scale, rope_factor = _scales(cfg)
    eps = cfg.rms_norm_eps
    if "wq_a" in layer:
        q = linear.matmul(h, layer["wq_a"])
        q = matmul(rms_norm(q, layer["q_a_norm"], eps), layer["wq_b"])
    else:
        q = matmul(h, layer["wq"])
    q = q.reshape(B, T, H, dk)
    q_nope, q_pe = q[..., :d_nope], q[..., d_nope:]

    kv_pe = linear.matmul(h, layer["wkv_a_mqa"])  # (B, T, rank + d_rope)
    rank = kv_pe.shape[-1] - d_rope
    kv_c = rms_norm(kv_pe[..., :rank], layer["kv_a_norm"], eps)
    k_pe = kv_pe[..., rank:].reshape(B, T, 1, d_rope)
    kv = matmul(kv_c, layer["wkv_b"]).reshape(B, T, H, d_nope + dv)
    k_nope, v = kv[..., :d_nope], kv[..., d_nope:]

    q_pe = apply_rope(q_pe, positions, freqs, cfg.rope_type, d_rope,
                      mscale=rope_factor)
    k_pe = apply_rope(k_pe, positions, freqs, cfg.rope_type, d_rope,
                      mscale=rope_factor)
    qh = torch.cat([q_nope, q_pe], dim=-1)
    kh = torch.cat([k_nope, k_pe.expand(B, T, H, d_rope)], dim=-1)

    b_idx, t_idx, p_idx = rows
    kl[b_idx, p_idx] = kh[b_idx, t_idx].to(kl.dtype)
    vl[b_idx, p_idx] = v[b_idx, t_idx].to(vl.dtype)

    scores = torch.einsum("bthd,bshd->bhts", qh.float(),
                          kl[:, :n].float()) * kq_scale
    scores = torch.where(mask[:, None], scores,
                         torch.full_like(scores, torch.finfo(torch.float32).min))
    p = torch.softmax(scores, dim=-1)
    attn = torch.einsum("bhts,bshd->bthd", p.to(h.dtype).float(),
                        vl[:, :n].float())
    return matmul(attn.reshape(B, T, H * dv).to(h.dtype), layer["wo"])


def cache_rows(positions: torch.Tensor, S: int):
    """(rows, mask) of a chunk over an S-slot cache: the (b, t, position)
    indices of the rows with 0 <= position < S, which write the cache (one
    host read), and the (B, T, n) causal mask over the n slots up to the
    chunk's last position, the only ones any row can see."""
    valid = (positions >= 0) & (positions < S)
    b_idx, t_idx = torch.nonzero(valid, as_tuple=True)
    rows = (b_idx, t_idx, positions[b_idx, t_idx].long())
    n = int(positions.max().clamp(0, S - 1)) + 1
    mask = (torch.arange(n, device=positions.device)[None, None, :]
            <= positions[:, :, None])
    return rows, mask


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: KVCache,
            last_only: bool = False,
            last_index: torch.Tensor | None = None):
    """tokens, positions: (B, T) int; cache: `init_cache`'s, updated in
    place. Returns (logits f32, cache). Rows with position < 0 (a chunk's
    padding) write nothing. Slot s is visible to the query at position p
    iff s <= p."""
    B = tokens.shape[0]
    dev = tokens.device
    eps = cfg.rms_norm_eps
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    if cfg.embedding_scale:  # minicpm3
        x = x * torch.tensor(cfg.embedding_scale, dtype=x.dtype, device=dev)
    res_s = cfg.residual_scale or 1.0
    rows, mask = cache_rows(positions, cache.max_seq)
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], eps)
        x = x + res_s * reduce(params, _attention(
            layer, cfg, h, positions, cache.k[li], cache.v[li], rows, mask))
        h = rms_norm(x, layer["ffn_norm"], eps)
        if "ffn_gate_inp" in layer:
            x = x + res_s * _moe(h, layer, cfg, params.get("tp"))
        else:
            g = F.silu(matmul(h, layer["w_gate"]).float()).to(h.dtype)
            u = matmul(h, layer["w_up"])
            x = x + res_s * reduce(params, matmul(g * u, layer["w_down"]))

    if last_index is not None:
        x = x[torch.arange(B, device=dev), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["output_norm"], eps)
    logits = head_logits(params, x)
    if cfg.logit_scale:  # minicpm3: 256 / n_embd
        logits = logits * cfg.logit_scale
    return logits, cache


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params`: 2-D weights packed where their type packs
    (`linear.from_gguf`), the embedding and the 3-D expert stacks dense in
    the load dtype, norms f32."""
    def qt(name, pack=packed):
        info = reader.tensors[name]
        return linear.from_gguf(reader.tensor_raw(name), info.ggml_type,
                                info.shape, packed=pack, dtype=dtype,
                                device=device)

    def dense(name):
        return torch.from_numpy(np.array(reader.tensor_data(name),
                                         np.float32)).to(device)

    names = set(reader.tensors)
    tok_embd = qt("token_embd.weight", pack=False)
    params: Params = {
        "tok_embd": tok_embd,
        "output_norm": dense("output_norm.weight"),
        "output": qt("output.weight") if "output.weight" in names
        else tok_embd,
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {
            "attn_norm": dense(p + "attn_norm.weight"),
            "wkv_a_mqa": qt(p + "attn_kv_a_mqa.weight"),
            "kv_a_norm": dense(p + "attn_kv_a_norm.weight"),
            "wkv_b": qt(p + "attn_kv_b.weight"),
            "wo": qt(p + "attn_output.weight"),
            "ffn_norm": dense(p + "ffn_norm.weight"),
        }
        if p + "attn_q_a.weight" in names:
            layer["wq_a"] = qt(p + "attn_q_a.weight")
            layer["q_a_norm"] = dense(p + "attn_q_a_norm.weight")
            layer["wq_b"] = qt(p + "attn_q_b.weight")
        else:
            layer["wq"] = qt(p + "attn_q.weight")
        if p + "ffn_gate_inp.weight" in names:
            layer["ffn_gate_inp"] = qt(p + "ffn_gate_inp.weight")
            for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                layer[key] = qt(p + key + ".weight", pack=False)
            for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp"):
                layer[key] = qt(p + key + ".weight")
        else:
            layer["w_gate"] = qt(p + "ffn_gate.weight")
            layer["w_up"] = qt(p + "ffn_up.weight")
            layer["w_down"] = qt(p + "ffn_down.weight")
        params["layers"].append(layer)
    return params
