"""Llama-family forward pass in PyTorch (llama / mistral / qwen2-style
decoder-only transformers: GQA, optional q/k/v and output biases, fused
wqkv / w_gateup projections, silu-gated FFN, attention and final-logit
softcaps). Under KCPP_FFN_FUSED=1 a q4_k FFN of at most 8 tokens runs as
one launch (K15, ops/ffn_fused.py), as in the JAX `_ffn`.

Port of koboldcpp_tpu/models/llama.py `forward`, `forward_paged` and the
layer-stacked scan decode path (`stack_layers`, `forward_stacked`) for the
branches a llama / mistral / qwen2 Q4_K_M model takes. Single-token decode
runs attention through a flash-decode kernel that also writes the new K/V
row: K5 over the bf16 slot cache, K6 over the Q8 one, K8 / K9 / K10 over
the bf16 / Q8 / Q4 paged pool. A prefill chunk from position 0 with
`flash_prefill` set writes the cache and runs K4 over the chunk's own rows.
Other chunks write the cache and run the plain `attention` below over the
whole (dequantized, or gathered) cache, which is what the JAX engine runs on
the CPU, past position 0, and over the Q4 slot cache, which has no kernel.
`forward_stacked` runs the same layers over `stack_layers` params (each
weight field with a leading layer axis). A single-token step over a pooled
cache (kv/cache.py `init_pool_cache`) takes each layer's packed weights as
`LayerRef`s through the stacked matvecs K17a (q4_k / q5_k) and K17b (q6_k,
q8_0, q2_k, q3_k, IQ) and its attention through K17c, the pooled-row flash
decode; every other step takes each layer's weights as views through the
regular kernels and the plain `attention`. K16 (`flash_decode.decode_
attention`, the read-only single-sequence decode) lies on no path of the
JAX package, and of the port neither. Every other branch of the JAX forward
raises NotImplementedError when the config or params ask for it.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kv import paged
from ..kv.cache import (QuantKVCache, is_pooled, read as kv_read,
                        unpool_cache, write as kv_write)
from ..ops import flash_decode, linear
from ..ops.ffn_fused import ffn_fused
from ..ops.flash_prefill import flash_prefill_attention
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
    shape that the T=1 attention kernels (K5, K6, K8-K10) are not built
    for. K4 is built for head_dim 64, 128 and 256, the shapes the JAX engine
    turns flash prefill on for; the engine leaves it off for any other."""
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
        for layer in params.get("layers") or [params["layers_stacked"]]:
            hit = next((v for k, v in _UNSUPPORTED_LAYER_KEYS.items()
                        if k in layer), None)
            if hit:
                why = hit
                break
    if why:
        raise NotImplementedError(f"{why} is not ported to the PyTorch "
                                  "forward yet")


# layer keys under which the JAX `_ffn` keeps the composed FFN (the silu
# activation is the only one this forward serves)
_FFN_UNFUSED_KEYS = ("b_gate", "b_up", "b_down", "ffn_sub_norm",
                     "ffn_down_scale")


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
        if not any(k in layer for k in _FFN_UNFUSED_KEYS):
            # KCPP_FFN_FUSED=1, T <= 8: the whole FFN as one launch (K15)
            y = ffn_fused(x, layer["w_gateup"], layer["w_down"])
            if y is not None:
                return y
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
            positions: torch.Tensor, cache,
            last_only: bool = False,
            last_index: torch.Tensor | None = None,
            input_embeds: torch.Tensor | None = None,
            embed_mask: torch.Tensor | None = None,
            flash_prefill: bool = False):
    """tokens, positions: (B, T) int; cache: a KVCache or QuantKVCache
    (kv/cache.py). Returns (logits f32, cache); the cache is updated in
    place. Slot s is visible to the query at position p iff s <= p (the slot
    == position invariant). flash_prefill: the chunk is the whole context
    so far (prefill from position 0, padding rows at the end with position
    -1), so attention runs over its own rows through K4."""
    if input_embeds is not None or embed_mask is not None:
        raise NotImplementedError("the multimodal embedding splice is not "
                                  "ported yet")
    T = tokens.shape[1]
    quant = isinstance(cache, QuantKVCache)
    softcap = cfg.attn_logit_softcap
    if flash_prefill and not softcap:
        def attend(li, q, k, v, scale):
            # prefill from position 0: the chunk is the entire context
            kv_write(cache, li, positions, k, v)
            return flash_prefill_attention(q, k, v, positions, scale)
    elif (T == 1 and not (quant and cache.bits == 4)
          and flash_decode.supported_batched(1, cfg.n_kv_heads, cfg.head_dim)):
        def attend(li, q, k, v, scale):
            # single-token decode: K5 (K6 over the Q8 cache) reads the
            # history rows below each position and writes this step's K/V
            # row into the cache
            if quant:
                out = flash_decode.decode_attention_batched_q8(
                    q[:, 0], k[:, 0], v[:, 0], cache.k[li], cache.v[li],
                    cache.k_scale[li], cache.v_scale[li], positions[:, 0],
                    cfg.n_heads, cfg.n_kv_heads, scale, softcap)[0]
            else:
                out = flash_decode.decode_attention_batched(
                    q[:, 0], k[:, 0], v[:, 0], cache.k[li], cache.v[li],
                    positions[:, 0], cfg.n_heads, cfg.n_kv_heads, scale,
                    softcap)[0]
            return out[:, None]
    else:
        mask = _causal_mask(positions, cache.max_seq)

        def attend(li, q, k, v, scale):
            kv_write(cache, li, positions, k, v)
            ck, cv = kv_read(cache, li)
            return attention(q, ck, cv, mask, scale, softcap)
    return _run(params, cfg, tokens, positions, attend, last_only,
                last_index), cache


def forward_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, pcache: paged.PagedKVCache,
                  page_table: torch.Tensor, last_only: bool = False
                  ) -> tuple[torch.Tensor, paged.PagedKVCache]:
    """forward() over a paged pool (kv/paged.py: bf16, Q8 or Q4), updated
    in place: virtual slot index == absolute position, row r of sequence b
    at pool row page_table[b, r // P] * P + r % P. tokens/positions: (B, T);
    page_table: (B, MP) int. T=1 goes through K8 (K9 over a Q8 pool, K10
    over a Q4 one); longer chunks write through the table, gather the pages
    and run `attention`."""
    T = tokens.shape[1]
    P = pcache.page_size
    softcap = cfg.attn_logit_softcap
    if T == 1 and flash_decode.supported_batched(1, cfg.n_kv_heads,
                                                 cfg.head_dim):
        def attend(li, q, k, v, scale):
            args = (cfg.n_heads, cfg.n_kv_heads, P, scale, softcap)
            if not pcache.quantized:
                out = flash_decode.decode_attention_paged(
                    q[:, 0], k[:, 0], v[:, 0], pcache.k[li], pcache.v[li],
                    page_table, positions[:, 0], *args)[0]
            else:
                kern = (flash_decode.decode_attention_paged_q4
                        if pcache.bits == 4
                        else flash_decode.decode_attention_paged_q8)
                out = kern(q[:, 0], k[:, 0], v[:, 0], pcache.k[li],
                           pcache.v[li], pcache.k_scale[li],
                           pcache.v_scale[li], page_table, positions[:, 0],
                           *args)[0]
            return out[:, None]
    else:
        mask = _causal_mask(positions, page_table.shape[1] * P)

        def attend(li, q, k, v, scale):
            paged.write(pcache, li, page_table, positions, k, v)
            ck, cv = paged.gather(pcache, li, page_table)
            return attention(q, ck, cv, mask, scale, softcap)
    return _run(params, cfg, tokens, positions, attend, last_only), pcache


def _causal_mask(positions: torch.Tensor, S: int) -> torch.Tensor:
    slot_ids = torch.arange(S, device=positions.device)
    return slot_ids[None, None, :] <= positions[:, :, None]  # (B, T, S)


def _run(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
         positions: torch.Tensor, attend, last_only: bool = False,
         last_index: torch.Tensor | None = None,
         layers=None) -> torch.Tensor:
    """The layer stack around `attend(li, q, k, v, scale)`, which writes
    this chunk's K/V and returns the attention output (B, T, H, D).
    layers: the per-layer params (default params["layers"])."""
    B, T = tokens.shape
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
    res_s = cfg.residual_scale or 1.0
    for li, layer in enumerate(params["layers"] if layers is None
                               else layers):
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

        attn_out = attend(li, q, k, v, scale).to(x.dtype).reshape(B, T, qdim)
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
    return _softcap(logits, cfg.final_logit_softcap)


# ---------------------------------------------------------------------------
# the layer-stacked scan decode path
# ---------------------------------------------------------------------------

def stack_layers(params: Params) -> Params:
    """Stack homogeneous per-layer params field by field into leading-axis
    tensors (the JAX `stack_layers`): the result has "layers_stacked" and
    no "layers". Returns the input unchanged when the layers differ in
    keys, in a QTensor's kind or shape, or in any field's shape (a Q4_K_M
    file, whose layers mix q4_k and q6_k, does not stack)."""
    layers = params["layers"]
    if not layers:
        return params
    keys = set(layers[0])
    if any(set(layer) != keys for layer in layers):
        return params

    def stack_field(k):
        vals = [layer[k] for layer in layers]
        if isinstance(vals[0], linear.QTensor):
            if len({(v.kind, tuple(v.shape)) for v in vals}) != 1 or any(
                    set(v.data) != set(vals[0].data) for v in vals):
                return None
            data = {}
            for name in vals[0].data:
                arrs = [v.data[name] for v in vals]
                if len({a.shape for a in arrs}) != 1:
                    return None
                data[name] = torch.stack(arrs)
            return linear.QTensor(kind=vals[0].kind, shape=vals[0].shape,
                                  data=data)
        if len({v.shape for v in vals}) != 1:
            return None
        return torch.stack(vals)

    stacked = {}
    for k in keys:
        s = stack_field(k)
        if s is None:
            return params
        stacked[k] = s
    out = dict(params)
    out.pop("layers")
    out["layers_stacked"] = stacked
    return out


def _take_layer(stacked: Params, li: int) -> Params:
    """Layer li of stacked params, as views (no copy)."""
    return {k: (linear.QTensor(kind=v.kind, shape=v.shape,
                               data={n: a[li] for n, a in v.data.items()})
                if isinstance(v, linear.QTensor) else v[li])
            for k, v in stacked.items()}


def _layer_view(stacked: Params, li: int, index: torch.Tensor) -> Params:
    """Layer li for the pooled decode step: packed QTensors become
    LayerRefs (the stacked kernels K17a / K17b read layer `index`, a
    one-element int32 tensor on the card, from the whole stacked fields);
    dense weights, norms and biases are views."""
    out = _take_layer(stacked, li)
    for k, v in stacked.items():
        if isinstance(v, linear.QTensor) and v.kind != "dense":
            out[k] = linear.LayerRef(v, li, index)
    return out


_LAYER_IDS: dict = {}  # (n_layers, device) -> arange(n_layers) int32


def _layer_ids(n_layers: int, device) -> torch.Tensor:
    """The layer indices 0..L-1 as an int32 tensor on `device`, built once:
    the stacked kernels take layer li as its one-element view [li:li+1],
    read on the card (so a captured step could point at a device
    counter), never as a host number."""
    key = (n_layers, str(device))
    ids = _LAYER_IDS.get(key)
    if ids is None:
        ids = _LAYER_IDS[key] = torch.arange(n_layers, dtype=torch.int32,
                                             device=device)
    return ids


def check_stacked_supported(params: Params, cfg: ModelConfig, cache,
                            device=None) -> None:
    """`check_supported`, and NotImplementedError where the JAX
    `forward_stacked` would compute another function than `forward`: it
    has no fused-qkv or output bias, no residual scale and RMS norms only,
    and its pooled path takes a bf16 KVCache, not a quantized one."""
    check_supported(params, cfg, device)
    stacked = params["layers_stacked"]
    why = None
    if isinstance(cache, QuantKVCache):
        why = "a quantized KV cache"
    elif "bqkv" in stacked or "bo" in stacked:
        why = "a qkv / output projection bias (bqkv / bo)"
    elif cfg.residual_scale and cfg.residual_scale != 1.0:
        why = "residual_scale"
    elif cfg.norm_type == "layer":
        why = "layer norm"
    if why:
        raise NotImplementedError(f"forward_stacked does not take {why} "
                                  "(the JAX forward_stacked drops it)")


def forward_stacked(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                    positions: torch.Tensor, cache,
                    last_only: bool = False):
    """forward() over stack_layers() params (the JAX `forward_stacked`).
    tokens, positions: (B, T) int; cache: a per-layer KVCache or a pooled
    one (`init_pool_cache`), updated in place and returned.

    A pooled cache at T == 1 (no sliding window, no ALiBi, a fused KV width
    the flash decode takes) runs each layer on `_layer_view` weights: the
    packed projections through K17a / K17b, attention through K17c at row
    base li*B, which also writes the step's K/V row. Every other call runs
    each layer on `_take_layer` views through the regular kernels (K3 / K13
    at T > 1, K1 / K2 / K12 at T == 1), writes the cache (a pooled one
    through `unpool_cache` views) and attends with the plain `attention`
    over it, never K4 or K5, as the JAX scan body does. KCPP_SCAN_UNROLL,
    the JAX scan's unroll factor, schedules XLA and does not change the
    function; the port loops over the layers and does not read it."""
    check_stacked_supported(params, cfg, cache, tokens.device)
    B, T = tokens.shape
    stacked = params["layers_stacked"]
    L = stacked["attn_norm"].shape[0]
    softcap = cfg.attn_logit_softcap
    if (is_pooled(cache) and T == 1 and not cfg.sliding_window
            and not cfg.use_alibi
            and flash_decode.supported_batched(1, cfg.n_kv_heads,
                                               cfg.head_dim)):
        ids = _layer_ids(L, tokens.device)

        def attend(li, q, k, v, scale):
            out = flash_decode.decode_attention_rows(
                q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, positions[:, 0],
                ids[li:li + 1], cfg.n_heads, cfg.n_kv_heads, scale,
                softcap)[0]
            return out[:, None]

        layers = (_layer_view(stacked, li, ids[li:li + 1]) for li in range(L))
    else:
        per_layer = unpool_cache(cache, L) if is_pooled(cache) else cache
        mask = _causal_mask(positions, cache.max_seq)

        def attend(li, q, k, v, scale):
            kv_write(per_layer, li, positions, k, v)
            ck, cv = kv_read(per_layer, li)
            return attention(q, ck, cv, mask, scale, softcap)

        layers = (_take_layer(stacked, li) for li in range(L))
    return _run(params, cfg, tokens, positions, attend, last_only,
                layers=layers), cache
