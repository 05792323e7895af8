"""Llama-family forward pass in PyTorch: the dense decoder-only
transformers of the JAX `forward` (llama / mistral / qwen2 / gemma /
gemma2 / phi2 / gpt2 / gpt-neox / gpt-j / falcon / starcoder(2) / mpt /
bloom / olmo / nemotron / command-r / chameleon / openelm / plamo /
bitnet / jais and their twins): GQA and MQA, RMS or layer norms with
biases, q/k/v, output and FFN biases, fused wqkv / w_gateup projections,
gated (silu, gelu) and non-gated (gelu, exact gelu, relu²) FFNs, parallel
residual, learned positions and the embedding layer norm, rope-less
attention, ALiBi, clamp_kqv, QK-norm (flat RMS, chameleon's per-head layer
norm, openelm's per-head RMS norm), gemma2's sandwich norms and sliding
window with its layer pattern, attention and final-logit softcaps,
chameleon's swin norm (the norm after each branch), openelm's per-layer
head counts (the narrower layers' K / V padded up to the cache's heads),
plamo's one norm feeding both branches, bitnet's sub-norms and
per-projection scale scalars. Under KCPP_FFN_FUSED=1 a q4_k silu FFN of at
most 8 tokens runs as one launch (K15, ops/ffn_fused.py), as in the JAX
`_ffn`.

Port of koboldcpp_tpu/models/llama.py `forward`, `forward_paged` and the
layer-stacked scan decode path (`stack_layers`, `forward_stacked`). The
attention kernels take a layer where the JAX forward sends it to one:
single-token decode of a global (not sliding-window) layer without ALiBi
runs a flash-decode kernel that also writes the new K/V row (K5 over the
bf16 slot cache, K6 over the Q8 one, K8 / K9 / K10 over the bf16 / Q8 / Q4
paged pool); a prefill chunk from position 0 with `flash_prefill` set
writes the cache and runs K4 over the chunk's own rows on such a layer
when there is no attention softcap. Every other layer writes the cache
and runs the plain `attention` below over the whole (dequantized, or
gathered) cache under that layer's mask and ALiBi bias: the JAX package
has no kernel there either, and its engine runs the same on the CPU, past
position 0 and over the Q4 slot cache. `forward_paged` shares the layer
body, so it computes the JAX `forward` for every admitted architecture
(the JAX `forward_paged` drops some of its branches).
`forward_stacked` runs the same layers over `stack_layers` params (each
weight field with a leading layer axis). A single-token step over a pooled
cache (kv/cache.py `init_pool_cache`) without a sliding window takes each
layer's packed weights as `LayerRef`s through the stacked matvecs K17a
(q4_k / q5_k) and K17b (q6_k, q8_0, q2_k, q3_k, IQ) and its attention
through K17c, the pooled-row flash decode; every other step takes each
layer's weights as views through the regular kernels and the plain
`attention`. It raises NotImplementedError wherever the JAX scan body
computes another function than `forward`. K16 (`flash_decode.decode_
attention`, the read-only single-sequence decode) lies on no path of the
JAX package, and of the port neither.

Sparse MoE layers (mixtral, qwen2moe with its shared expert, olmoe,
granitemoe, dbrx, grok, and arctic's residual MoE branch) run `_moe_ffn`
over the dense expert stacks: a softmax router, a stable top-k and the
gather form by default, the dense-EP form under `cfg.moe_dense_ep` and the
sorted-EP form (ops/moe.py) under `cfg.moe_sorted_ep`, as in the JAX
`_moe_ffn`; the expert products are torch.matmul, as the JAX ones are
einsums outside any Pallas kernel.

Under tensor / expert parallelism the params are one rank's shard
(parallel/sharding.py) and carry a TensorShard as params["tp"]: the rank
computes its heads and FFN columns, sums the row-parallel `wo` / `w_down`
products over tp, gathers the vocab-sharded head's logits, runs a weight
the shard kept whole through its own product (`_matmul`), and picks the
flash-decode kernel on the whole model's kv heads, as JAX does. The
stages `embed`, `layers_body` and `head` are also the pipeline's and the
sequence-parallel forward's (parallel/pipeline.py, sequence.py).
"""
from __future__ import annotations

import math
import os
from functools import partial
from typing import Any

import torch
import torch.nn.functional as F

from ..kv import paged
from ..kv.cache import (QuantKVCache, is_pooled, read as kv_read,
                        unpool_cache, write as kv_write)
from ..ops import flash_decode, linear, moe
from ..ops.ffn_fused import ffn_fused
from ..ops.flash_prefill import flash_prefill_attention
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope, rope_frequencies, yarn_attn_scale
from ..parallel.sharding import matmul as _matmul
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


def _head_counts(cfg: ModelConfig, li: int) -> tuple[int, int]:
    """Layer li's (query heads, kv heads): openelm's per-layer counts, or
    the config's."""
    ex = cfg.extras or {}
    hc, kvc = ex.get("head_counts"), ex.get("kv_head_counts")
    return (hc[li] if hc else cfg.n_heads,
            kvc[li] if kvc else cfg.n_kv_heads)


def _decode_kv_heads(params: Params, cfg: ModelConfig) -> int:
    """The kv heads the flash-decode dispatch is decided on: the whole
    model's under tensor parallelism (JAX decides on the global shape;
    the kernel then runs on the rank's heads), else the config's."""
    tp = params.get("tp")
    return tp.n_kv_heads if tp is not None else cfg.n_kv_heads


def flash_decode_note() -> str | None:
    """The launcher's startup line under KCPP_FLASH_DECODE other than "1",
    else None. There the JAX forward attends a decode step over its cache
    with XLA ops in place of its flash-decode kernel: the same function,
    which the port's K5 family serves as before."""
    v = os.environ.get("KCPP_FLASH_DECODE", "1")
    if v == "1":
        return None
    return (f"KCPP_FLASH_DECODE={v}: the JAX package's XLA decode attention "
            "is the flash-decode kernel's function; the port's K5 (flash "
            "decode) serves it")


def check_supported(params: Params, cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError, on a CUDA `device`, for a head shape that
    the T=1 attention kernels (K5, K6, K8-K10) are not built for: each
    layer's query heads over the cache's kv heads, on the layers that reach
    them (openelm's narrower layers, with fewer kv heads, do not); under
    tensor parallelism the rank's heads, where the whole model's shape
    sends it to the kernels. K4 is built for head_dim 64, 128 and 256, the
    shapes the JAX engine turns flash prefill on for; the engine leaves it
    off for any other."""
    if (torch.device(device or "cpu").type == "cuda"
            and flash_decode.supported_batched(
                1, _decode_kv_heads(params, cfg), cfg.head_dim)):
        heads = {nh for nh, nkv in (_head_counts(cfg, li)
                                    for li in range(cfg.n_layers))
                 if nkv == cfg.n_kv_heads}
        for nh in sorted(heads):
            flash_decode.check_kernel_shape(nh, cfg.n_kv_heads, cfg.head_dim)


# layer keys under which the JAX `_ffn` keeps the composed FFN
_FFN_UNFUSED_KEYS = ("b_gate", "b_up", "b_down", "ffn_sub_norm",
                     "ffn_down_scale")

# the JAX `_ffn` activation table: any other name is tanh-gelu
_ACTS = {"silu": F.silu, "gelu_exact": F.gelu,
         "relu2": lambda v: torch.square(torch.relu(v))}
_GELU_TANH = partial(F.gelu, approximate="tanh")


def alibi_slopes(n_heads: int, bias_max: float = 8.0,
                 device="cpu") -> torch.Tensor:
    """Per-head ALiBi slopes (f32), the JAX `alibi_slopes`: 2^-(i * max /
    n2) for i = 1..n2, n2 the power of two at or above n_heads; with other
    head counts the odd then even entries, cut to n_heads."""
    n2 = 2 ** math.ceil(math.log2(n_heads))
    base = torch.arange(1, n2 + 1, dtype=torch.float32) * (bias_max / n2)
    slopes = 1.0 / torch.exp2(base)
    if n2 != n_heads:
        slopes = torch.cat([slopes[1::2], slopes[::2]])[:n_heads]
    return slopes.to(device)


def local_alibi_slopes(cfg: ModelConfig, nh: int, device) -> torch.Tensor:
    """The slopes of nh query heads: all of the model's, or under tensor
    parallelism the rank's (cfg.extras["alibi_heads"]: the model's head
    count and the rank's first head, parallel/sharding.py
    `local_config`)."""
    n, h0 = (cfg.extras or {}).get("alibi_heads", (nh, 0))
    return alibi_slopes(n, cfg.alibi_bias_max, device)[h0:h0 + nh]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor, scale: float, softcap: float = 0.0,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, T, H, D); k/v: (B, S, Hkv, D); mask: (B, T, S) bool; bias: an
    optional additive (B, H, T, S) f32 scores bias (ALiBi), added after the
    softcap as in the JAX `attention`. GQA via head-group reshape; f32
    scores and softmax, p cast to v's dtype before p . V. Returns
    (B, T, H, D) in q's dtype."""
    B, T, H, D = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k.float()) * scale
    scores = _softcap(scores, softcap)
    if bias is not None:
        scores = scores + bias.reshape(B, Hkv, G, T, S)
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask[:, None, None, :, :], scores,
                         torch.full_like(scores, neg))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", p.to(v.dtype).float(), v.float())
    return out.reshape(B, T, H, D).to(q.dtype)


def _causal_mask(positions: torch.Tensor, S: int,
                 window: int = 0) -> torch.Tensor:
    """(B, T, S) bool: slot s is visible to the query at position p iff s
    <= p, and with a sliding window also s > p - window."""
    slot_ids = torch.arange(S, device=positions.device)[None, None, :]
    mask = slot_ids <= positions[:, :, None]
    if window:
        mask = mask & (slot_ids > positions[:, :, None] - window)
    return mask


class _PlainAttention:
    """The plain `attention` of one forward over S cache slots: the causal
    and the sliding-window masks and the ALiBi bias (per query-head count:
    openelm's layers differ), each built on first use and shared by the
    layers."""

    def __init__(self, cfg: ModelConfig, positions: torch.Tensor, S: int):
        self.cfg, self.positions, self.S = cfg, positions, S
        self._masks: dict = {}
        self._bias: dict = {}

    def __call__(self, q, ck, cv, scale: float, local: bool):
        cfg = self.cfg
        mask = self._masks.get(local)
        if mask is None:
            mask = self._masks[local] = _causal_mask(
                self.positions, self.S, cfg.sliding_window if local else 0)
        bias = None
        if cfg.use_alibi:
            nh = q.shape[2]
            bias = self._bias.get(nh)
            if bias is None:
                # slope * (k_pos - q_pos), (B, H, T, S)
                pos = self.positions
                dist = (torch.arange(self.S, device=pos.device)[None, None, :]
                        - pos[:, :, None]).float()
                bias = self._bias[nh] = (
                    local_alibi_slopes(cfg, nh, pos.device)[None, :, None,
                                                            None]
                    * dist[:, None, :, :])
        return attention(q, ck, cv, mask, scale, cfg.attn_logit_softcap,
                         bias)


def _pad_kv(cfg: ModelConfig, k: torch.Tensor, v: torch.Tensor):
    """openelm's narrower layers: K / V padded with zero heads up to the
    cache's n_kv_heads (the JAX forward's write; the pad heads are never
    read). Other layers: k, v as they are."""
    pad = cfg.n_kv_heads - k.shape[2]
    if not pad:
        return k, v
    z = k.new_zeros(*k.shape[:2], pad, k.shape[3])
    return torch.cat([k, z], dim=2), torch.cat([v, z.to(v.dtype)], dim=2)


def _scaled(y: torch.Tensor, layer: Params, key: str) -> torch.Tensor:
    """bitnet's per-projection scalar weight scale, where the layer has
    one (the JAX `_scaled`)."""
    s = layer.get(key)
    return y if s is None else y * s.to(y.dtype)


def _ffn(x: torch.Tensor, layer: Params, act: str = "silu",
         gated: bool = True, eps: float = 1e-5, tp=None,
         li: int = 0) -> torch.Tensor:
    """The JAX `_ffn`: up -> act -> down with `b_up` / `b_down` where not
    gated; else act(gate) * up -> down with `b_gate` / `b_up` / `b_down`,
    bitnet's scales on the unfused projections and its `ffn_sub_norm`
    (RMS, eps) before down. The activation runs in f32 on the gate (or up)
    and is cast back to x's dtype. K15 takes only a silu FFN with none of
    the biases, sub-norm or scales. tp: the TensorShard of a sharded
    layer li (the sub-norm's statistics over the FFN's whole width)."""
    actf = _ACTS.get(act, _GELU_TANH)
    if not gated:  # gpt2 / neox style
        up = _matmul(x, layer["w_up"])
        if "b_up" in layer:
            up = up + layer["b_up"].to(up.dtype)
        down = _matmul(actf(up.float()).to(x.dtype), layer["w_down"])
        if "b_down" in layer:
            down = down + layer["b_down"].to(down.dtype)
        return down
    if "w_gateup" in layer:  # fused gate+up (one kernel launch)
        if act == "silu" and not any(k in layer for k in _FFN_UNFUSED_KEYS):
            # KCPP_FFN_FUSED=1, T <= 8: the whole FFN as one launch (K15)
            y = ffn_fused(x, layer["w_gateup"], layer["w_down"])
            if y is not None:
                return y
        gu = _matmul(x, layer["w_gateup"])
        F_ = gu.shape[-1] // 2
        gate, up = gu[..., :F_], gu[..., F_:]
    else:
        gate = _scaled(_matmul(x, layer["w_gate"]), layer,
                       "ffn_gate_scale")
        up = _scaled(_matmul(x, layer["w_up"]), layer, "ffn_up_scale")
    if "b_gate" in layer:
        gate = gate + layer["b_gate"].to(gate.dtype)
    if "b_up" in layer:
        up = up + layer["b_up"].to(up.dtype)
    a = actf(gate.float()).to(x.dtype) * up
    if "ffn_sub_norm" in layer:  # bitnet: RMS between activation and down
        a = (rms_norm(a, layer["ffn_sub_norm"], eps) if tp is None
             else tp.rms_norm(a, layer["ffn_sub_norm"], eps, tp.ffn[li]))
    down = _scaled(_matmul(a, layer["w_down"]), layer, "ffn_down_scale")
    if "b_down" in layer:
        down = down + layer["b_down"].to(down.dtype)
    return down


def _top_k(w: torch.Tensor, k: int):
    """The k largest of the last axis, largest first, a tie going to the
    lower index (jax.lax.top_k's order; torch.topk promises none on CUDA):
    a stable descending sort keeps equal values in index order."""
    vals, idx = torch.sort(w, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe_gather(xt, topi, topw, wg, wu, wd, act,
                every_expert: bool, e0: int = 0,
                n_experts: int = 0) -> torch.Tensor:
    """The JAX gather form (each row through its own k experts, the outputs
    summed over k by topw) without its per-row copy of the expert weights
    (`wg[topi]`, ~120 GB a projection for a 512-row chunk at Mixtral's
    widths). With `every_expert` (the dense-EP form, and the gather form's
    single-token step, which must stay free of host syncs) every expert
    runs over every row, combined by a dense (N, E) weight matrix that is
    zero for the unselected pairs: each expert read once, E / k times the
    chosen experts' bytes (copying the chosen experts out with
    `index_select` took 1.6 ms a Mixtral layer on the H100 against this
    form's 1.0). Otherwise the assignments are grouped by expert
    (`moe.expert_order`, the sort the sorted-EP form's dispatch uses, its
    bounds read on the host) and each expert runs one product over its
    rows. Under expert parallelism wg / wu / wd hold the n_experts' experts
    from e0 on, the other experts' rows add nothing here and the caller
    sums the ranks' shares."""
    N, C = xt.shape
    k = topi.shape[1]
    E_loc = wg.shape[0]
    E = n_experts or E_loc
    if every_expert:
        dense_w = torch.zeros(N, E, device=xt.device).scatter_(1, topi, topw)
        d = moe.expert_products(xt[None].expand(E_loc, N, C), wg, wu, wd, act)
        return torch.einsum("enc,ne->nc", d, dense_w[:, e0:e0 + E_loc])
    order, starts = moe.expert_order(topi.reshape(-1), E)
    xs = xt[order // k]
    # under expert parallelism the other experts' rows stay zero
    ys = (torch.empty if E_loc == E else torch.zeros)(N * k, C,
                                                      device=xt.device)
    starts = starts.tolist()
    for e in range(e0, e0 + E_loc):
        a, b = starts[e], starts[e + 1]
        if b > a:
            ys[a:b] = moe.expert_products(xs[a:b], wg[e - e0], wu[e - e0],
                                          wd[e - e0], act)
    d = torch.empty_like(ys)
    d[order] = ys
    return (d.reshape(N, k, C) * topw[..., None]).sum(dim=1)


def _moe_ffn(x: torch.Tensor, layer: Params, cfg: ModelConfig,
             tp=None) -> torch.Tensor:
    """The JAX `_moe_ffn`: a router product cast to f32, softmax, top-k
    (renormalized under `cfg.moe_norm_topk`: mixtral, granitemoe, dbrx,
    grok, arctic; not qwen2moe or olmoe), a gated FFN per selected expert
    with silu (tanh-gelu for grok), and qwen2moe's shared expert scaled by
    a sigmoid gate. Forms: gather (default) and dense-EP
    (`cfg.moe_dense_ep`: every expert over every token), both
    `_moe_gather`, and sorted-EP (`cfg.moe_sorted_ep`: ops/moe.py
    `moe_ffn_ep`). Under expert parallelism (`tp`, a TensorShard with an
    expert range) each rank runs its experts and the shares are summed
    over the expert axis before the shared expert adds in."""
    B, T, C = x.shape
    act = (_GELU_TANH if (cfg.extras or {}).get("moe_act", "silu") == "gelu"
           else F.silu)
    xt = x.reshape(-1, C)
    router = linear.matmul(xt, layer["ffn_gate_inp"]).float()  # (N, E)
    topw, topi = _top_k(torch.softmax(router, dim=-1), cfg.n_experts_used)
    if cfg.moe_norm_topk:
        topw = topw / topw.sum(dim=-1, keepdim=True)
    wg = layer["ffn_gate_exps"].data["w"]  # (E, F, C)
    wu = layer["ffn_up_exps"].data["w"]
    wd = layer["ffn_down_exps"].data["w"]  # (E, C, F)
    shard = tp is not None and tp.experts is not None
    e0, n_exp = (tp.experts[0], tp.n_experts) if shard else (0, 0)
    if cfg.moe_sorted_ep:
        out = moe.moe_ffn_ep(xt, topi, topw, wg, wu, wd, act,
                             capacity_factor=cfg.moe_capacity_factor,
                             experts=(e0, n_exp) if shard else None)
    else:
        # dense-EP, and the gather form's single-token step, run every
        # expert over every token
        out = _moe_gather(xt, topi, topw, wg, wu, wd, act,
                          every_expert=cfg.moe_dense_ep or T == 1, e0=e0,
                          n_experts=n_exp)
    if shard:  # the combine: every rank's experts
        out = tp.reduce_experts(out)
    if "ffn_up_shexp" in layer:  # qwen2moe's shared expert, sigmoid-gated
        sg = F.silu(linear.matmul(xt, layer["ffn_gate_shexp"]).float())
        su = linear.matmul(xt, layer["ffn_up_shexp"]).float()
        sd = linear.matmul((sg * su).to(xt.dtype), layer["ffn_down_shexp"])
        gate = torch.sigmoid(
            linear.matmul(xt, layer["ffn_gate_inp_shexp"]).float())
        out = out + sd.float() * gate
    return out.reshape(B, T, C).to(x.dtype)


def _is_local(cfg: ModelConfig, li: int) -> bool:
    """A sliding-window layer (gemma2: the even ones, pattern 2)."""
    pattern = cfg.sliding_window_pattern
    return bool(cfg.sliding_window) and (pattern == 0 or li % pattern == 0)


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
    == position invariant), and on a sliding-window layer iff also s > p -
    window. flash_prefill: the chunk is the whole context so far (prefill
    from position 0, padding rows at the end with position -1), so a
    global layer without ALiBi or softcap runs K4 over its own rows.
    input_embeds (B, T, C), embed_mask (B, T) bool: the rows where the mask
    holds take input_embeds (cast to the activations' dtype) in place of
    the token embeddings (the LLaVA image splice, after the embedding
    scale, the learned positions and tok_norm, as in JAX)."""
    T = tokens.shape[1]
    quant = isinstance(cache, QuantKVCache)
    softcap = cfg.attn_logit_softcap
    plain = _PlainAttention(cfg, positions, cache.max_seq)
    # the JAX forward's conditions, less the per-layer `local`
    prefill = flash_prefill and not softcap and not cfg.use_alibi
    decode = (T == 1 and not cfg.use_alibi and not (quant and cache.bits == 4)
              and flash_decode.supported_batched(
                  1, _decode_kv_heads(params, cfg), cfg.head_dim))

    def attend(li, q, k, v, scale, local):
        nh, nkv = q.shape[2], k.shape[2]
        if prefill and not local:
            # prefill from position 0: the chunk is the entire context
            kv_write(cache, li, positions, *_pad_kv(cfg, k, v))
            return flash_prefill_attention(q, k, v, positions, scale)
        if decode and not local and nkv == cfg.n_kv_heads:
            # single-token decode: K5 (K6 over the Q8 cache) reads the
            # history rows below each position and writes this step's K/V
            # row into the cache
            if quant:
                out = flash_decode.decode_attention_batched_q8(
                    q[:, 0], k[:, 0], v[:, 0], cache.k[li], cache.v[li],
                    cache.k_scale[li], cache.v_scale[li], positions[:, 0],
                    nh, nkv, scale, softcap)[0]
            else:
                out = flash_decode.decode_attention_batched(
                    q[:, 0], k[:, 0], v[:, 0], cache.k[li], cache.v[li],
                    positions[:, 0], nh, nkv, scale, softcap)[0]
            return out[:, None]
        kv_write(cache, li, positions, *_pad_kv(cfg, k, v))
        ck, cv = kv_read(cache, li)
        return plain(q, ck[:, :, :nkv], cv[:, :, :nkv], scale, local)
    return _run(params, cfg, tokens, positions, attend, last_only,
                last_index, splice=(input_embeds, embed_mask)), cache


def forward_paged(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  positions: torch.Tensor, pcache: paged.PagedKVCache,
                  page_table: torch.Tensor, last_only: bool = False,
                  input_embeds: torch.Tensor | None = None,
                  embed_mask: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, paged.PagedKVCache]:
    """forward() over a paged pool (kv/paged.py: bf16, Q8 or Q4), updated
    in place: virtual slot index == absolute position, row r of sequence b
    at pool row page_table[b, r // P] * P + r % P. tokens/positions: (B, T);
    page_table: (B, MP) int. T=1 on a global layer without ALiBi goes
    through K8 (K9 over a Q8 pool, K10 over a Q4 one); every other layer
    writes through the table, gathers the pages and runs `attention`.
    input_embeds / embed_mask: forward's image splice (the JAX
    `forward_paged` has none, so its paged batched engine drops a
    request's image: ROADMAP §3)."""
    T = tokens.shape[1]
    P = pcache.page_size
    softcap = cfg.attn_logit_softcap
    plain = _PlainAttention(cfg, positions, page_table.shape[1] * P)
    decode = (T == 1 and not cfg.use_alibi
              and flash_decode.supported_batched(
                  1, _decode_kv_heads(params, cfg), cfg.head_dim))

    def attend(li, q, k, v, scale, local):
        nh, nkv = q.shape[2], k.shape[2]
        if decode and not local and nkv == cfg.n_kv_heads:
            args = (nh, nkv, P, scale, softcap)
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
        paged.write(pcache, li, page_table, positions, *_pad_kv(cfg, k, v))
        ck, cv = paged.gather(pcache, li, page_table)
        return plain(q, ck[:, :, :nkv], cv[:, :, :nkv], scale, local)
    return _run(params, cfg, tokens, positions, attend, last_only,
                splice=(input_embeds, embed_mask)), pcache


def _run(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
         positions: torch.Tensor, attend, last_only: bool = False,
         last_index: torch.Tensor | None = None,
         layers=None, splice=(None, None)) -> torch.Tensor:
    """The layer stack around `attend(li, q, k, v, scale, local)`, which
    writes this chunk's K/V and returns the attention output (B, T, H, D);
    `local` marks a sliding-window layer; q carries the layer's query heads
    and k / v its kv heads (openelm's differ by layer). The branches and
    their order are the JAX `forward`'s. layers: the per-layer params
    (default params["layers"]). splice: (input_embeds, embed_mask), the
    rows that take precomputed embeddings, or (None, None). The three
    stages (`embed`, `layers_body`, `head`) are also the parallel forms'
    pieces (parallel/pipeline.py, parallel/sequence.py)."""
    x = embed(params, cfg, tokens, positions, splice)
    x = layers_body(params, cfg, x, positions, attend, layers)
    return head(params, cfg, x, last_only, last_index)


def embed(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
          positions: torch.Tensor, splice=(None, None)) -> torch.Tensor:
    """The token embeddings (B, T, C) with the embedding scale, learned
    positions, bloom's embedding norm and the image splice."""
    dev = tokens.device
    eps = cfg.rms_norm_eps
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    if cfg.embedding_scale:
        x = x * torch.tensor(cfg.embedding_scale, dtype=x.dtype, device=dev)
    if cfg.learned_pos and "pos_embd" in params:
        # past the table the JAX gather clamps the index; so does this
        pe = params["pos_embd"]
        x = x + pe[positions.clamp(0, pe.shape[0] - 1)].to(x.dtype)
    if "tok_norm" in params:  # bloom's embedding layer norm
        x = layer_norm(x, params["tok_norm"], params.get("tok_norm_bias"), eps)
    input_embeds, embed_mask = splice
    if input_embeds is not None:
        # the multimodal splice: rows with embed_mask take the precomputed
        # embeddings (LLaVA image patches; the reference splices them by
        # sentinel segments, gpttype_adapter.cpp:3406-3475)
        x = torch.where(embed_mask[:, :, None], input_embeds.to(x.dtype), x)
    return x


def layers_body(params: Params, cfg: ModelConfig, x: torch.Tensor,
                positions: torch.Tensor, attend, layers=None) -> torch.Tensor:
    """The decoder layers over activations x (B, T, C) at `positions`
    (`_run`'s `attend` and `layers`); under tensor parallelism
    (params["tp"]) the row-parallel products are summed over tp."""
    B, T = x.shape[:2]
    freqs = _freqs(cfg, x.device) if cfg.use_rope else None
    scale = (cfg.attn_scale if cfg.attn_scale > 0
             else cfg.head_dim ** -0.5) * yarn_attn_scale(cfg)
    eps = cfg.rms_norm_eps
    tp = params.get("tp")  # parallel/sharding.py TensorShard, or None
    D = cfg.head_dim
    res_s = cfg.residual_scale or 1.0
    ex = cfg.extras or {}
    per_head_qk = bool(ex.get("qk_norm_per_head"))
    head_rms = bool(ex.get("qk_head_rms"))  # openelm: (D,) RMS per head
    swin = bool(ex.get("swin_norm"))  # chameleon: the norm after a branch
    for li, layer in enumerate(params["layers"] if layers is None
                               else layers):
        x0 = x  # the layer input (arctic's residual MoE branch reads it)
        nh, nkv = _head_counts(cfg, li)
        qdim, kvdim = nh * D, nkv * D
        h = x if swin else _norm(x, layer, "attn_norm", cfg)
        if "wqkv" in layer:  # fused projection (one kernel launch; openelm:
            # head-major [q heads | k heads | v heads], the same slices)
            qkv = _matmul(h, layer["wqkv"])
            if "bqkv" in layer:
                qkv = qkv + layer["bqkv"].to(qkv.dtype)
            q = qkv[..., :qdim]
            k = qkv[..., qdim:qdim + kvdim]
            v = qkv[..., qdim + kvdim:]
        else:
            q = _scaled(_matmul(h, layer["wq"]), layer, "wq_scale")
            k = _scaled(_matmul(h, layer["wk"]), layer, "wk_scale")
            v = _scaled(_matmul(h, layer["wv"]), layer, "wv_scale")
        if "bq" in layer:
            q = q + layer["bq"].to(q.dtype)
            k = k + layer["bk"].to(k.dtype)
            v = v + layer["bv"].to(v.dtype)
        if cfg.clamp_kqv > 0:  # mpt clip_qkv
            c = cfg.clamp_kqv
            q, k, v = (t.clamp(-c, c) for t in (q, k, v))
        if "attn_q_norm" in layer and not (per_head_qk or head_rms):
            # QK RMS norm over the flat projection (under tensor
            # parallelism over every rank's heads, each kv head once)
            if tp is None:
                q = rms_norm(q, layer["attn_q_norm"], eps)
                k = rms_norm(k, layer["attn_k_norm"], eps)
            else:
                hs = tp.heads[li]
                q = tp.rms_norm(q, layer["attn_q_norm"], eps, hs.n_q * D)
                k = tp.rms_norm(k, layer["attn_k_norm"], eps, hs.n_kv * D,
                                hs.copies)
        q = q.reshape(B, T, nh, D)
        k = k.reshape(B, T, nkv, D)
        v = v.reshape(B, T, nkv, D)
        if "attn_q_norm" in layer and head_rms:
            q = rms_norm(q, layer["attn_q_norm"], eps)
            k = rms_norm(k, layer["attn_k_norm"], eps)
        if "attn_q_norm" in layer and per_head_qk:
            # chameleon: per-head layer norm with (H, D) affine
            q = layer_norm(q, layer["attn_q_norm"],
                           layer.get("attn_q_norm_bias"), eps)
            k = layer_norm(k, layer["attn_k_norm"],
                           layer.get("attn_k_norm_bias"), eps)
        if cfg.use_rope:
            q = apply_rope(q, positions, freqs, cfg.rope_type, cfg.rope_dim)
            k = apply_rope(k, positions, freqs, cfg.rope_type, cfg.rope_dim)

        attn_out = attend(li, q, k, v, scale, _is_local(cfg, li))
        attn_out = attn_out.to(x.dtype).reshape(B, T, qdim)
        if "attn_sub_norm" in layer:  # bitnet: RMS between attention and wo
            attn_out = (rms_norm(attn_out, layer["attn_sub_norm"], eps)
                        if tp is None else tp.rms_norm(
                            attn_out, layer["attn_sub_norm"], eps,
                            tp.heads[li].n_q * D))
        attn_out = _matmul(attn_out, layer["wo"])
        if tp is not None:  # row-parallel wo: the sum over tp
            attn_out = tp.reduce(attn_out)
        attn_out = _scaled(attn_out, layer, "wo_scale")
        if "bo" in layer:
            attn_out = attn_out + layer["bo"].to(attn_out.dtype)
        if "attn_post_norm" in layer:  # gemma2 sandwich norm, grok
            attn_out = rms_norm(attn_out, layer["attn_post_norm"], eps)
        if swin:
            attn_out = _norm(attn_out, layer, "attn_norm", cfg)
        if ex.get("plamo_parallel"):  # plamo: the FFN reads attn_norm's h
            ffn_in = h
            x = x + res_s * attn_out
        elif cfg.parallel_residual:  # neox / gptj: both branches read x
            ffn_in = _norm(x, layer, "ffn_norm", cfg)
            x = x + res_s * attn_out
        else:
            x = x + res_s * attn_out
            ffn_in = x if swin else _norm(x, layer, "ffn_norm", cfg)
        if "ffn_gate_inp" in layer and "ffn_norm_exps" not in layer:
            ffn_out = _moe_ffn(ffn_in, layer, cfg, tp)
        else:
            ffn_out = _ffn(ffn_in, layer, cfg.act, cfg.ffn_gated, eps, tp, li)
            if tp is not None:  # row-parallel w_down (b_down on rank 0)
                ffn_out = tp.reduce(ffn_out)
        if "ffn_post_norm" in layer:  # gemma2 sandwich norm, grok
            ffn_out = rms_norm(ffn_out, layer["ffn_post_norm"], eps)
        if swin:
            ffn_out = _norm(ffn_out, layer, "ffn_norm", cfg)
        x = x + res_s * ffn_out
        if "ffn_norm_exps" in layer:
            # arctic: a residual MoE branch on the layer input, added after
            # the dense FFN's residual
            x = x + _moe_ffn(rms_norm(x0, layer["ffn_norm_exps"], eps),
                             layer, cfg, tp)
    return x


def head(params: Params, cfg: ModelConfig, x: torch.Tensor,
         last_only: bool = False,
         last_index: torch.Tensor | None = None) -> torch.Tensor:
    """Logits f32 of x (B, T, C): of the row `last_index` of each sequence,
    the last row (last_only) or every row; the final norm, the head (its
    vocab shards gathered under tensor parallelism), the output bias, the
    logit scale and the final softcap."""
    B = x.shape[0]
    tp = params.get("tp")
    if last_index is not None:
        x = x[torch.arange(B, device=x.device), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = _norm(x, params, "output_norm", cfg)
    logits = _matmul(x, params["output"], out_dtype=torch.float32)
    if tp is not None:  # the vocab-sharded head: every rank's rows
        logits = tp.gather_vocab(logits)
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
                                  data=data, whole_in_f=vals[0].whole_in_f)
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
                               data={n: a[li] for n, a in v.data.items()},
                               whole_in_f=v.whole_in_f)
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
    """`check_supported`, and NotImplementedError, naming the branch,
    wherever the JAX `forward_stacked` would compute another function than
    `forward`: its scan body has no fused-qkv or output bias, no residual
    scale, RMS norms only, a gated FFN only, no parallel residual, ALiBi,
    learned positions or embedding norm, clamp_kqv or QK-norm, no MoE
    layer, and rotates every K; its pooled path takes a bf16 KVCache, not a quantized one. It
    does take the sliding window with its layer pattern, the sandwich
    norms and the FFN's activation. Of the later branches it drops
    chameleon's swin norm (it norms before each branch), openelm's
    per-layer heads (such layers do not stack), plamo's shared norm (it
    reads an `ffn_norm` plamo lacks) and bitnet's attention sub-norm and
    q / k / v / o scales; jais is refused by its layer norm and biases."""
    check_supported(params, cfg, device)
    ex = cfg.extras or {}
    stacked = params.get("layers_stacked", {})
    why = None
    if ex.get("swin_norm"):
        why = "swin norm"
    elif ex.get("head_counts"):
        why = "openelm's per-layer head counts"
    elif ex.get("plamo_parallel"):
        why = "plamo's shared-norm parallel branch"
    elif ex.get("bitnet"):
        why = "bitnet's sub-norms and projection scales"
    elif isinstance(cache, QuantKVCache):
        why = "a quantized KV cache"
    elif "bqkv" in stacked or "bo" in stacked:
        why = "a qkv / output projection bias (bqkv / bo)"
    elif cfg.residual_scale and cfg.residual_scale != 1.0:
        why = "residual_scale"
    elif cfg.norm_type == "layer":
        why = "layer norm"
    elif not cfg.ffn_gated:
        why = "a non-gated FFN"
    elif cfg.parallel_residual:
        why = "parallel residual"
    elif cfg.use_alibi:
        why = "ALiBi"
    elif (cfg.learned_pos and "pos_embd" in params) or "tok_norm" in params:
        why = "learned positions / the embedding norm"
    elif cfg.clamp_kqv > 0:
        why = "clamp_kqv"
    elif "attn_q_norm" in stacked:
        why = "QK-norm"
    elif not cfg.use_rope:
        why = "rope-less attention (it rotates every K)"
    elif "ffn_gate_inp" in stacked:
        why = "MoE (its scan body runs the dense FFN only)"
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
    the flash decode takes: the JAX `use_rows_kernel`) runs each layer on
    `_layer_view` weights: the packed projections through K17a / K17b,
    attention through K17c at row base li*B, which also writes the step's
    K/V row. Every other call runs each layer on `_take_layer` views
    through the regular kernels (K3 / K13 at T > 1, K1 / K2 / K12 at T ==
    1), writes the cache (a pooled one through `unpool_cache` views) and
    attends with the plain `attention` over it under the layer's mask
    (the sliding window on its local layers), never K4 or K5, as the JAX
    scan body does. KCPP_SCAN_UNROLL,
    the JAX scan's unroll factor, schedules XLA and does not change the
    function; the port loops over the layers and does not read it."""
    check_stacked_supported(params, cfg, cache, tokens.device)
    B, T = tokens.shape
    stacked = params["layers_stacked"]
    L = stacked["attn_norm"].shape[0]
    softcap = cfg.attn_logit_softcap
    if (is_pooled(cache) and T == 1 and not cfg.sliding_window
            and not cfg.use_alibi
            and flash_decode.supported_batched(
                1, _decode_kv_heads(params, cfg), cfg.head_dim)):
        ids = _layer_ids(L, tokens.device)

        def attend(li, q, k, v, scale, local):
            out = flash_decode.decode_attention_rows(
                q[:, 0], k[:, 0], v[:, 0], cache.k, cache.v, positions[:, 0],
                ids[li:li + 1], cfg.n_heads, cfg.n_kv_heads, scale,
                softcap)[0]
            return out[:, None]

        layers = (_layer_view(stacked, li, ids[li:li + 1]) for li in range(L))
    else:
        per_layer = unpool_cache(cache, L) if is_pooled(cache) else cache
        plain = _PlainAttention(cfg, positions, cache.max_seq)

        def attend(li, q, k, v, scale, local):
            kv_write(per_layer, li, positions, k, v)
            ck, cv = kv_read(per_layer, li)
            return plain(q, ck, cv, scale, local)

        layers = (_take_layer(stacked, li) for li in range(L))
    return _run(params, cfg, tokens, positions, attend, last_only,
                layers=layers), cache
