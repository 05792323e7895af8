"""Synthetic model builders for benches and smoke runs (no weights on disk).

Port of koboldcpp_tpu/models/synthetic.py: packed QTensors are built
directly from seeded random bytes + small scales, drawing the same field
values from the same numpy seed as the JAX package's makers (q8_0: scales
/ 8, see rand_q8_0; q3_k: scales / 2, see rand_q3k), minus the TPU-only sidecar fields and in the port's
logical layouts; q5_k, which the JAX package has no maker for, packs random
GGUF blocks, and the IQ kinds (iq2p, iq3px, iq3ps, iq1p; no JAX maker
either) draw codes, signs and scales straight into the port's layout (see
rand_iq). The opt-in kinds (q4_k_i8, q6_k_i8f, q3_k_n4, q2_k_n4) are the
relayouts of the q4_k / q6_k / q3_k / q2_k draws (ops/linear.py
`to_q4_k_i8`, `to_expanded`), as a GGUF file loads under
KCPP_Q4K_LAYOUT=i8 or KCPP_KQ_LAYOUT=expanded: the expanded kinds keep
the dense fields. Byte-layout-identical
to GGUF-loaded weights, so kernels see the real memory traffic.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import QK_K
from ..ops.linear import (QTensor, _bf16, _u8, dense, pack_q5_k,
                          to_expanded, to_q4_k_i8)
from .config import ModelConfig

TINYLLAMA_1_1B = ModelConfig(
    arch="llama", name="tinyllama-1.1b-synthetic",
    vocab_size=32000, hidden_size=2048, n_layers=22, n_heads=32, n_kv_heads=4,
    head_dim=64, intermediate_size=5632, max_position_embeddings=2048,
    rope_theta=10000.0, rope_dim=64,
)


def _rand_dense(rng, shape, device, scale=0.02,
                dtype=torch.bfloat16) -> QTensor:
    return dense((rng.standard_normal(shape) * scale).astype(np.float32),
                 dtype=dtype, device=device)


def rand_q4k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """Synthetic Q4_K with the real scale structure (d per superblock x
    6-bit integer sub-scales), kept as the raw sc / d fields K14 reads
    beside the bf16 scale (the JAX `_rand_q4k` draws, in the same
    order)."""
    nsb = in_f // QK_K
    qs2 = rng.integers(0, 256, size=(out_f, in_f // 2), dtype=np.uint8)
    d = (rng.random((out_f, nsb), dtype=np.float32) * 6.3e-5)
    dmin = (rng.random((out_f, nsb), dtype=np.float32) * 6.3e-5)
    sc = rng.integers(0, 64, size=(out_f, nsb, 8)).astype(np.int32)
    mn6 = rng.integers(0, 64, size=(out_f, nsb, 8)).astype(np.int32)
    scale = (d[:, :, None] * sc).reshape(out_f, nsb * 8).astype(np.float32)
    mn = (dmin[:, :, None] * mn6).reshape(out_f, nsb * 8).astype(np.float32)
    return QTensor(kind="q4_k", shape=(out_f, in_f), data={
        "qs2": _u8(qs2, device),
        "scale": _bf16(scale, device),
        "min": _bf16(mn, device),
        "sc": _u8(sc.reshape(out_f, nsb * 8), device),
        "d": torch.from_numpy(d).to(device),
    })


def rand_q4k_centered(rng, out_f: int, in_f: int,
                      device="cpu") -> QTensor:
    """rand_q4k with each sub-block's min term at its grid's midpoint (7.5
    scale steps, on the 6-bit grid of a dmin of 8 d): zero-mean weights, as
    a Q4_K quantizer writes them for a zero-mean tensor. rand_q4k's
    independent min leaves every weight a mean as large as its spread; a
    model of them attends by each key's hidden-state mean, so sharply that
    near-ties between keys turn rounding into other hidden states."""
    qt = rand_q4k(rng, out_f, in_f, device)
    d = qt.data["d"]
    sc = qt.data["sc"].float().reshape(*d.shape, 8)
    mn = d[:, :, None] * 8 * torch.round(sc * 15 / 16)
    qt.data["min"] = mn.reshape(out_f, -1).to(torch.bfloat16)
    return qt


def rand_q6k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    nsb = in_f // QK_K
    ql = rng.integers(0, 256, size=(out_f, nsb * 128), dtype=np.uint8)
    qh = rng.integers(0, 256, size=(out_f, nsb * 64), dtype=np.uint8)
    scale = (rng.random((out_f, nsb * 16), dtype=np.float32)
             * 0.002).astype(np.float32)
    return QTensor(kind="q6_k", shape=(out_f, in_f), data={
        "ql": _u8(ql, device),
        "qh": _u8(qh, device),
        "scale": _bf16(scale, device),
    })


def rand_q8_0(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """The JAX `_rand_q8_0` draws (the same numpy calls in the same order),
    with the scales divided by 8 (exact). The JAX maker's weights have
    std ~0.085, a gain near 4 per projection at hidden 2048: a 22-layer
    model of them turns any rounding difference (flash against plain
    attention for a re-evaluated token) into other greedy tokens. /8 gives
    std ~0.011, the spread of the q4_k maker's weights."""
    scale = (rng.random((out_f, in_f // 32), dtype=np.float32) * 0.002
             ).astype(np.float32) / 8
    q = rng.integers(-127, 128, size=(out_f, in_f), dtype=np.int8)
    return QTensor(kind="q8_0", shape=(out_f, in_f), data={
        "q": torch.from_numpy(q).to(device),
        "scale": _bf16(scale, device),
    })


def rand_q5k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """Seeded random GGUF Q5_K superblocks (176 bytes per 256 weights:
    finite fp16 d and dmin, random 6-bit scales, 5th bits and nibbles),
    packed through `pack_q5_k`. The JAX package has no q5_k maker."""
    nsb = in_f // QK_K
    raw = rng.integers(0, 256, size=(out_f, nsb, 176), dtype=np.uint8)
    d = (rng.random((out_f, nsb, 2), dtype=np.float32) * 3.2e-5)
    raw[:, :, 0:4] = d.astype(np.float16).view(np.uint8).reshape(
        out_f, nsb, 4)
    return pack_q5_k(raw, (out_f, in_f), device)


def plane_major_to_logical(plane_major: np.ndarray) -> np.ndarray:
    """(R, nsb*16) per-16 values indexed [j | S, h, t] (the JAX makers'
    plane-major order) -> logical group order 16S + 8h + 2j + t."""
    rows = plane_major.shape[0]
    return plane_major.reshape(rows, 4, -1, 2, 2).transpose(
        0, 2, 3, 1, 4).reshape(rows, -1)


def rand_q2k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """The JAX `_rand_q2k` draws (the same numpy calls in the same order):
    scales and mins uniform in [0, 0.02) per 16 columns, random 2-bit
    codes; weights of rms ~0.017 and mean ~+0.005."""
    nsb = in_f // QK_K
    scale_p = (rng.random((out_f, nsb * 16), dtype=np.float32) * 0.02
               ).astype(np.float32)
    min_p = (rng.random((out_f, nsb * 16), dtype=np.float32) * 0.02
             ).astype(np.float32)
    qs = rng.integers(0, 256, size=(out_f, in_f // 4), dtype=np.uint8)
    return QTensor(kind="q2_k", shape=(out_f, in_f), data={
        "qs": _u8(qs, device),
        "scale": _bf16(plane_major_to_logical(scale_p), device),
        "min": _bf16(plane_major_to_logical(min_p), device),
    })


def rand_q3k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """The JAX `_rand_q3k` draws (the same numpy calls in the same order):
    signed scales per 16 columns, random 2-bit codes and 3rd bits (the JAX
    `hm2` nibbles, here ggml's hmask bytes), with the scales divided by 2
    (exact): uniform in [-0.01, 0.01). The JAX maker's weights have std
    ~0.027, a gain near 1.2 per projection at hidden 2048: on the 22-layer
    model the flash-against-plain attention difference of a fast-forwarded
    token turned into other greedy tokens two bf16 steps apart. /2 gives
    std ~0.013, near the q4_k maker's spread."""
    nsb = in_f // QK_K
    scale_p = ((rng.random((out_f, nsb * 16), dtype=np.float32) - 0.5)
               * 0.04).astype(np.float32) / 2
    qs = rng.integers(0, 256, size=(out_f, in_f // 4), dtype=np.uint8)
    hm2 = rng.integers(0, 16, size=(out_f, in_f // 4), dtype=np.uint8
                       ).reshape(out_f, nsb, 2, 32)
    return QTensor(kind="q3_k", shape=(out_f, in_f), data={
        "qs": _u8(qs, device),
        "hmask": _u8((hm2[:, :, 0] | (hm2[:, :, 1] << 4)).reshape(
            out_f, nsb * 32), device),
        "scale": _bf16(plane_major_to_logical(scale_p), device),
    })


# the largest per-group scale of each IQ kind's maker: weights of rms ~0.006
# with scales uniform in [0, max) (see rand_iq)
_IQ_SCALE_MAX = {"iq2p": 3.75e-4, "iq3px": 2.8e-4, "iq3ps": 1.125e-3,
                 "iq1p": 0.0145}
# byte -> the same byte with each 2-bit code 3 (outside the iq2p / iq1p
# alphabets) replaced by 1
_NO_CODE3 = np.array([sum((1 if (b >> s) & 3 == 3 else (b >> s) & 3) << s
                          for s in (0, 2, 4, 6)) for b in range(256)],
                     np.uint8)


def rand_iq(rng, out_f: int, in_f: int, device="cpu", kind: str = "iq2p",
            group: int = 32) -> QTensor:
    """A synthetic IQ QTensor (iq2p / iq3px / iq3ps / iq1p, scale group G =
    group: 32 as IQ2_XXS, IQ3_XXS/S and IQ1_S; 16 as IQ2_XS/S; 8 as IQ1_M),
    drawn straight into the port's layout: random code bytes (iq2p and iq1p
    codes 3 -> 1, so codes 0/1/2 come 1/4, 1/2, 1/4), random 3rd-bit and
    sign bytes, bf16 scales uniform in [0, _IQ_SCALE_MAX[kind]) and, for
    iq1p, a delta of +-0.125 per group (min = -(scale * delta)). The
    spread: value rms ~28.1 (iq2p), ~37.3 (iq3px), ~9.2 (iq3ps), ~0.72
    (iq1p, with its delta) times the scale rms max/sqrt(3) gives weights
    of rms ~0.006, half the q4_k maker's rms: at rms ~0.012 the
    22-layer 1.1B in iq2p turned the flash-against-plain
    attention difference of a fast-forwarded token into other greedy
    tokens three bf16 steps apart (logits 2.33 / 2.38, step 23 of 64), as
    the JAX q8_0 and q3_k draws did before rand_q8_0 and rand_q3k cut
    their scales.
    The JAX package has no IQ maker; running `iq_decompose` over ~1 B
    weights would take minutes."""
    ng = in_f // group
    scale = (rng.random((out_f, ng), dtype=np.float32)
             * np.float32(_IQ_SCALE_MAX[kind]))
    qs = rng.integers(0, 256, size=(out_f, in_f // 4), dtype=np.uint8)
    data = {"qs": _u8(_NO_CODE3[qs] if kind in ("iq2p", "iq1p") else qs,
                      device),
            "scale": _bf16(scale, device)}
    if kind in ("iq3px", "iq3ps"):
        data["hmask"] = _u8(rng.integers(0, 256, size=(out_f, in_f // 8),
                                         dtype=np.uint8), device)
    if kind == "iq1p":
        delta = np.where(rng.random((out_f, ng)) < 0.5, np.float32(-0.125),
                         np.float32(0.125))
        data["min"] = _bf16(-(scale * delta), device)
    else:
        data["sg"] = _u8(rng.integers(0, 256, size=(out_f, in_f // 8),
                                      dtype=np.uint8), device)
    return QTensor(kind=kind, shape=(out_f, in_f), data=data)


_MAKERS = {"q2_k": rand_q2k, "q3_k": rand_q3k, "q4_k": rand_q4k,
           "q5_k": rand_q5k, "q6_k": rand_q6k, "q8_0": rand_q8_0,
           **{k: partial(rand_iq, kind=k)
              for k in ("iq2p", "iq3px", "iq3ps", "iq1p")},
           "q4_k_i8": lambda *a: to_q4_k_i8(rand_q4k(*a)),
           "q6_k_i8f": lambda *a: to_expanded(rand_q6k(*a)),
           "q3_k_n4": lambda *a: to_expanded(rand_q3k(*a)),
           "q2_k_n4": lambda *a: to_expanded(rand_q2k(*a))}


# archs whose converted files carry q/k/v, output and FFN biases (the q/k/v
# ones as one fused `bqkv` where the file's projection is pre-fused), those
# with layer-norm biases, and those with an output (lm_head) bias too
_BIASED_ARCHS = {"phi2", "gpt2", "starcoder", "gptneox", "starcoder2",
                 "codeshell", "bloom"}
_FUSED_BIAS_ARCHS = {"gpt2", "starcoder", "gptneox", "codeshell", "bloom"}
_NORM_BIAS_ARCHS = _BIASED_ARCHS | {"gptj", "falcon", "stablelm", "orion"}
_OUTPUT_BIAS_ARCHS = {"phi2"}
# archs whose files have no output.weight: the head is the embedding
_TIED_ARCHS = {"gemma", "gemma2", "mpt", "command-r"}


def synthetic_params(cfg: ModelConfig, kind: str = "q4_k", seed: int = 0,
                     device=None) -> dict:
    """A full params dict with synthetic weights on `device` (default
    cuda), with the tensors the GGUF loader gives for `cfg`: RMS or layer
    norms (with biases, `_NORM_BIAS_ARCHS`), gemma2's post-norms, q/k/v (or
    fused qkv), output and FFN biases and phi2's output bias
    (`_BIASED_ARCHS`, `_FUSED_BIAS_ARCHS`, `_OUTPUT_BIAS_ARCHS`), a
    gateless `w_up` for a non-gated FFN, learned positions, bloom's
    embedding norm, and the embedding as the head (a dense matmul) where a
    converted file has no output.weight (`_TIED_ARCHS`, or
    cfg.tie_word_embeddings), and for a MoE config (cfg.n_experts) the
    router and the dense expert stacks in place of the FFN (`_moe_layer`).
    kind: "dense" | "q2_k" | "q3_k" | "q4_k" | "q5_k" | "q6_k" | "q8_0" |
    "iq2p" | "iq3px" | "iq3ps" | "iq1p" (G = 32) | "q4_k_i8" | "q6_k_i8f" |
    "q3_k_n4" | "q2_k_n4" for the big matmul weights, or "q4_k_m": q4_k
    (zero-mean: `rand_q4k_centered`) with q6_k v projections and head,
    unfused, as a Q4_K_M file's attention loads (embeddings, norms and
    biases stay dense, as the GGUF loader keeps them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    C, F = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim
    norm_bias = cfg.norm_type == "layer" and cfg.arch in _NORM_BIAS_ARCHS
    biased = cfg.arch in _BIASED_ARCHS

    def big(out_f, in_f, q4_k_m_kind="q4_k"):
        if kind == "dense" or in_f % QK_K or out_f % 8:
            return _rand_dense(rng, (out_f, in_f), dev)
        if kind == "q4_k_m":
            return (rand_q4k_centered if q4_k_m_kind == "q4_k"
                    else _MAKERS[q4_k_m_kind])(rng, out_f, in_f, dev)
        return _MAKERS[kind](rng, out_f, in_f, dev)

    def vec(n, around=0.0, s=0.01):
        return torch.from_numpy(
            around + rng.standard_normal(n).astype(np.float32) * s).to(dev)

    def norm():
        return vec(C, 1.0)

    # a llama config draws exactly what it drew before the other branches
    # came: tok_embd, output_norm, output, then per layer attn_norm, wo,
    # ffn_norm, w_down and the projections; every other tensor is drawn
    # after those of its scope
    tied = cfg.tie_word_embeddings or cfg.arch in _TIED_ARCHS
    params: dict = {
        "tok_embd": _rand_dense(rng, (cfg.vocab_size, C), dev),
        "output_norm": norm(),
        "layers": [],
    }
    params["output"] = (params["tok_embd"] if tied
                        else big(cfg.vocab_size, C, "q6_k"))
    if norm_bias:
        params["output_norm_bias"] = vec(C)
    if cfg.arch in _OUTPUT_BIAS_ARCHS and not tied:
        params["output_bias"] = vec(cfg.vocab_size)
    if cfg.learned_pos:
        params["pos_embd"] = vec((cfg.max_position_embeddings, C), s=0.02)
    if cfg.arch == "bloom":
        params["tok_norm"] = norm()
        params["tok_norm_bias"] = vec(C)
    # match the loader's fused-projection layout (a Q4_K_M file's q4_k
    # q / k and q6_k v do not fuse)
    fused = kind not in ("dense", "q4_k_m")
    moe = cfg.n_experts > 0
    for li in range(cfg.n_layers):
        layer = {
            "attn_norm": norm(),
            "wo": big(C, qdim),
            "ffn_norm": norm(),
        }
        if not moe:
            layer["w_down"] = big(C, F)
        if fused:
            layer["wqkv"] = big(qdim + 2 * kvdim, C)
        else:
            layer.update(wq=big(qdim, C), wk=big(kvdim, C),
                         wv=big(kvdim, C, "q6_k"))
        if moe:
            layer.update(_moe_layer(cfg, rng, seed, li, dev))
        elif not cfg.ffn_gated:
            layer["w_up"] = big(F, C)
        elif fused:
            layer["w_gateup"] = big(2 * F, C)
        else:
            layer.update(w_gate=big(F, C), w_up=big(F, C))
        if norm_bias:
            layer.update(attn_norm_bias=vec(C), ffn_norm_bias=vec(C))
        if cfg.post_norms:
            layer.update(attn_post_norm=norm(), ffn_post_norm=norm())
        if biased and cfg.arch in _FUSED_BIAS_ARCHS:
            layer["bqkv"] = vec(qdim + 2 * kvdim)
        elif biased:
            layer.update(bq=vec(qdim), bk=vec(kvdim), bv=vec(kvdim))
        if biased:
            layer.update(bo=vec(C), b_up=vec(F), b_down=vec(C))
        params["layers"].append(layer)
    return params


def _moe_layer(cfg: ModelConfig, rng, seed: int, li: int, dev) -> dict:
    """A MoE layer's tensors as the loader gives them for a Mixtral-style
    file: the router `ffn_gate_inp` (E, C), dense f32 from `rng`, and the
    expert stacks `ffn_gate_exps` / `ffn_up_exps` (E, F, C) and
    `ffn_down_exps` (E, C, F), dense bf16 normals of std 0.012 (the q4_k
    maker's spread) drawn on `dev` by a torch.Generator seeded from (seed,
    li): a Mixtral-8x7B layer's 2.8 GB of experts is made on the card in
    milliseconds, where numpy would take minutes."""
    C, E = cfg.hidden_size, cfg.n_experts
    Fe = cfg.expert_ffn_size or cfg.intermediate_size
    gen = torch.Generator(device=dev).manual_seed(seed * 1000 + li)

    def stack(*shape):
        w = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.bfloat16)
        return dense(w.mul_(0.012), device=dev)

    return {"ffn_gate_inp": _rand_dense(rng, (E, C), dev,
                                        dtype=torch.float32),
            "ffn_gate_exps": stack(E, Fe, C), "ffn_up_exps": stack(E, Fe, C),
            "ffn_down_exps": stack(E, C, Fe)}


def _placeholder_tokenizer(vocab_size: int):
    """A vocabulary of `tok{i}` pieces (the JAX bench's served-model
    tokenizer)."""
    from ..tokenizers import Tokenizer
    from ..tokenizers.vocab import vocab_from_metadata

    md = {"tokenizer.ggml.model": "gpt2",
          "tokenizer.ggml.tokens": [f"tok{i}" for i in range(vocab_size)],
          "tokenizer.ggml.token_type": np.full(vocab_size, 1, np.int32),
          "tokenizer.ggml.bos_token_id": np.uint32(1),
          "tokenizer.ggml.eos_token_id": np.uint32(2),
          "tokenizer.ggml.add_bos_token": False}
    return Tokenizer(vocab_from_metadata(md))


def synthetic_model(cfg: ModelConfig, kind: str = "q4_k", seed: int = 0,
                    device=None):
    """A servable Model: synthetic_params plus a placeholder vocabulary of
    `tok{i}` pieces (the JAX bench's served-model tokenizer)."""
    from .loader import Model

    dev = resolve_device(device)
    return Model(cfg, synthetic_params(cfg, kind, seed, dev),
                 _placeholder_tokenizer(cfg.vocab_size), dev)


# DeepSeek-V2-Lite's GGUF keys (deepseek-ai/DeepSeek-V2-Lite config.json:
# hidden 2048, 27 layers, 16 heads, no q-LoRA, kv_lora_rank 512, qk_nope
# 128 + qk_rope 64, v_head 128, first_k_dense_replace 1 at intermediate
# 10944, 64 routed experts of 1408 with top-6 not renormalized and
# routed_scaling_factor 1.0, 2 shared experts, YaRN factor 40 over 4096
# with mscale_all_dim 0.707, rope theta 10000, vocab 102400)
DEEPSEEK_V2_LITE_MD = {
    "general.architecture": "deepseek2", "deepseek2.vocab_size": 102400,
    "deepseek2.context_length": 163840, "deepseek2.embedding_length": 2048,
    "deepseek2.block_count": 27, "deepseek2.feed_forward_length": 10944,
    "deepseek2.expert_feed_forward_length": 1408,
    "deepseek2.attention.head_count": 16,
    "deepseek2.attention.head_count_kv": 16,
    "deepseek2.attention.key_length": 192,
    "deepseek2.attention.value_length": 128,
    "deepseek2.attention.kv_lora_rank": 512,
    "deepseek2.attention.layer_norm_rms_epsilon": 1e-6,
    "deepseek2.rope.freq_base": 10000.0,
    "deepseek2.rope.dimension_count": 64,
    "deepseek2.rope.scaling.type": "yarn",
    "deepseek2.rope.scaling.factor": 40.0,
    "deepseek2.rope.scaling.original_context_length": 4096,
    "deepseek2.rope.scaling.yarn_log_multiplier": 0.0707,
    "deepseek2.leading_dense_block_count": 1,
    "deepseek2.expert_count": 64, "deepseek2.expert_used_count": 6,
    "deepseek2.expert_shared_count": 2,
    "deepseek2.expert_weights_scale": 1.0,
}


def synthetic_deepseek2_model(md: dict, seed: int = 0, device=None):
    """A servable DeepSeek-V2 Model from GGUF keys (`config_from_metadata`;
    kv_lora_rank and the shared-expert count from their keys, which the
    config does not keep), with the tensors models/deepseek2.py's
    `load_params` gives: zero-mean q4_k (`rand_q4k_centered`) wq (or wq_a /
    wq_b with an attention.q_lora_rank key), wkv_a_mqa, wkv_b, wo, the dense
    lead layers' w_gate / w_up and the shared experts; the lead layers'
    w_down as q8_0 where its in_f is not a multiple of 256 (the type
    tools/quantize.py's Q4_K_M recipe writes for such a row, which
    `from_gguf` packs as q8_0), q4_k otherwise; a q6_k head, a bf16
    embedding, f32 norms and router, and the routed experts' dense bf16
    stacks made on the device (`_moe_layer`)."""
    from .config import config_from_metadata
    from .loader import Model

    dev = resolve_device(device)
    arch = md["general.architecture"]
    cfg = config_from_metadata(md)
    rank = int(md[f"{arch}.attention.kv_lora_rank"])
    q_rank = int(md.get(f"{arch}.attention.q_lora_rank", 0) or 0)
    n_shared = int(md.get(f"{arch}.expert_shared_count", 0) or 0)
    rng = np.random.default_rng(seed)
    C, H, dk = cfg.hidden_size, cfg.n_heads, cfg.head_dim
    dv = cfg.extras["v_head_dim"]
    d_nope = dk - cfg.rope_dim
    lead = cfg.extras.get("dense_lead", 0)

    def q4(out_f, in_f):
        return rand_q4k_centered(rng, out_f, in_f, dev)

    def norm(n):
        return torch.from_numpy(
            1.0 + rng.standard_normal(n).astype(np.float32) * 0.01).to(dev)

    params: dict = {
        "tok_embd": _rand_dense(rng, (cfg.vocab_size, C), dev),
        "output_norm": norm(C),
        "output": rand_q6k(rng, cfg.vocab_size, C, dev),
        "layers": [],
    }
    for li in range(cfg.n_layers):
        layer = {"attn_norm": norm(C), "ffn_norm": norm(C),
                 "wkv_a_mqa": q4(rank + cfg.rope_dim, C),
                 "kv_a_norm": norm(rank),
                 "wkv_b": q4(H * (d_nope + dv), rank),
                 "wo": q4(C, H * dv)}
        if q_rank:
            layer.update(wq_a=q4(q_rank, C), q_a_norm=norm(q_rank),
                         wq_b=q4(H * dk, q_rank))
        else:
            layer["wq"] = q4(H * dk, C)
        if li < lead:
            F_ = cfg.intermediate_size
            down = rand_q8_0 if F_ % QK_K else rand_q4k_centered
            layer.update(w_gate=q4(F_, C), w_up=q4(F_, C),
                         w_down=down(rng, C, F_, dev))
        else:
            Fs = cfg.expert_ffn_size * n_shared
            layer.update(_moe_layer(cfg, rng, seed, li, dev))
            layer.update(ffn_gate_shexp=q4(Fs, C), ffn_up_shexp=q4(Fs, C),
                         ffn_down_shexp=q4(C, Fs))
        params["layers"].append(layer)
    return Model(cfg, params, _placeholder_tokenizer(cfg.vocab_size), dev)


# The published widths of the recurrent, embedding and encoder-decoder
# models, as their GGUF keys (`synthetic_text_model` builds each at full
# width and depth):
# state-spaces/mamba-1.4b config.json: d_model 2048, n_layer 48, vocab
# 50280 (padded to a multiple of 8: 50280), d_inner 2 x 2048, d_state 16,
# d_conv 4, dt_rank ceil(2048 / 16) = 128, tied embeddings
MAMBA_1_4B_MD = {
    "general.architecture": "mamba", "mamba.vocab_size": 50280,
    "mamba.context_length": 1048576, "mamba.embedding_length": 2048,
    "mamba.block_count": 48, "mamba.feed_forward_length": 0,
    "mamba.attention.head_count": 0,
    "mamba.attention.layer_norm_rms_epsilon": 1e-5,
    "mamba.ssm.conv_kernel": 4, "mamba.ssm.inner_size": 4096,
    "mamba.ssm.state_size": 16, "mamba.ssm.time_step_rank": 128,
}
# RWKV/v6-Finch-1B6-HF config.json: hidden_size 2048, num_hidden_layers 24,
# head_size 64, intermediate_size 7168 (int(2048 * 3.5) // 32 * 32),
# vocab_size 65536, rescale_every 6, time-mix lerp rank 32 and decay
# rank 64 (RWKV-LM's TIME_MIX_EXTRA_DIM / TIME_DECAY_EXTRA_DIM at this width)
RWKV6_FINCH_1B6_MD = {
    "general.architecture": "rwkv6", "rwkv6.vocab_size": 65536,
    "rwkv6.context_length": 1048576, "rwkv6.embedding_length": 2048,
    "rwkv6.block_count": 24, "rwkv6.feed_forward_length": 7168,
    "rwkv6.wkv.head_size": 64, "rwkv6.rescale_every_n_layers": 6,
    "rwkv6.attention.layer_norm_epsilon": 1e-5,
    "rwkv6.time_mix_extra_dim": 32, "rwkv6.time_decay_extra_dim": 64,
}
# BlinkDL/rwkv-4-pile-1b5 (RWKV-4-Pile-1B5-20220903-8040.pth): n_embd 2048,
# n_layer 24, ffn 4 x 2048, vocab 50277; the keys gguf/legacy.py's
# LegacyRwkvReader gives such a .bin
RWKV4_PILE_1B5_MD = {
    "general.architecture": "rwkv4", "rwkv4.vocab_size": 50277,
    "rwkv4.context_length": 16384, "rwkv4.embedding_length": 2048,
    "rwkv4.block_count": 24, "rwkv4.feed_forward_length": 8192,
    "rwkv4.attention.head_count": 1, "rwkv4.attention.head_count_kv": 1,
    "rwkv4.attention.layer_norm_epsilon": 1e-5,
}
# nomic-ai/nomic-embed-text-v1.5 config.json: n_embd 768, n_layer 12,
# n_head 12, n_inner 3072 (SwiGLU), rotary_emb_base 1000 (NEOX rope),
# vocab 30528, layer_norm_epsilon 1e-12, mean pooling, n_positions 2048
NOMIC_EMBED_V1_5_MD = {
    "general.architecture": "nomic-bert", "nomic-bert.vocab_size": 30528,
    "nomic-bert.context_length": 2048, "nomic-bert.embedding_length": 768,
    "nomic-bert.block_count": 12, "nomic-bert.feed_forward_length": 3072,
    "nomic-bert.attention.head_count": 12,
    "nomic-bert.attention.head_count_kv": 12,
    "nomic-bert.attention.layer_norm_epsilon": 1e-12,
    "nomic-bert.rope.freq_base": 1000.0, "nomic-bert.pooling_type": 1,
}
# google/flan-t5-base config.json: d_model 768, num_layers 12 (and 12
# decoder layers), num_heads 12, d_kv 64, d_ff 2048 with
# feed_forward_proj "gated-gelu", relative_attention_num_buckets 32,
# vocab 32128, layer_norm_epsilon 1e-6, decoder_start_token_id 0, an
# untied lm_head
FLAN_T5_BASE_MD = {
    "general.architecture": "t5", "t5.vocab_size": 32128,
    "t5.context_length": 512, "t5.embedding_length": 768,
    "t5.block_count": 12, "t5.feed_forward_length": 2048,
    "t5.attention.head_count": 12, "t5.attention.head_count_kv": 12,
    "t5.attention.key_length": 64, "t5.attention.value_length": 64,
    "t5.attention.layer_norm_rms_epsilon": 1e-6,
    "t5.attention.relative_buckets_count": 32,
    "t5.decoder_start_token_id": 0,
}


def _ratios(li: int, n_layers: int) -> tuple[float, float]:
    """RWKV-LM's per-layer init ratios: (ratio_0_to_1, ratio_1_to_almost0)."""
    r0 = li / max(n_layers - 1, 1)
    return r0, 1.0 - li / n_layers


def _f32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)


def synthetic_text_model(md: dict, seed: int = 0, device=None):
    """A servable Model of a recurrent, embedding or encoder-decoder
    architecture from GGUF keys (`config_from_metadata`), with the tensors
    its module's `load_params` gives a Q4_K_M file: zero-mean q4_k
    projections (`rand_q4k_centered`; q8_0 where in_f is not a multiple of
    256, and every projection of RWKV-4, the type of its q8_0 .bin; dense
    bf16 where in_f is not a multiple of 32), a q6_k
    head where the model has its own, a bf16 embedding, and the
    per-channel parameters of the published initialisations, so that the
    states neither overflow nor vanish:
    - mamba: A = -(1..d_state) per channel (A_log = log(1..N)), the dt
      bias the inverse softplus of dt drawn log-uniform in [1e-3, 1e-1],
      D = 1, a conv of std 1 / sqrt(d_conv); tied head;
    - rwkv6: RWKV-LM's lerp ratios, the decay ramp -6 + 5 (i / (C-1))^(0.7
      + 1.3 r0), `time_faaaa`, ln_x ((1 + l) / L)^0.7, small w1 / w2 /
      decay_w1 / decay_w2;
    - rwkv4: time_decay -exp(-5 + 8 (i / (C-1))^(0.7 + 1.3 r0)) (the file
      keeps -exp(w)), time_first log 0.3 + a zigzag, the mix ratios;
    - nomic-bert: layer norms near 1, token types, fused wqkv, SwiGLU;
    - t5: RMS norms near 1, layer 0's relative-bias table (N(0, 0.1)) in
      both stacks, gated-gelu FFNs, an untied q6_k head."""
    from .config import config_from_metadata
    from .loader import Model

    dev = resolve_device(device)
    arch = md["general.architecture"]
    cfg = config_from_metadata(md)
    rng = np.random.default_rng(seed)
    C, L, V = cfg.hidden_size, cfg.n_layers, cfg.vocab_size

    def proj(out_f, in_f):
        if in_f % 32:  # no block type fits: F16 in a quantized file
            return _rand_dense(rng, (out_f, in_f), dev)
        if arch == "rwkv4" or in_f % QK_K:
            return rand_q8_0(rng, out_f, in_f, dev)
        return rand_q4k_centered(rng, out_f, in_f, dev)

    def near_one(n, s=0.01):
        return _f32(1.0 + rng.standard_normal(n) * s, dev)

    def small(*shape, s=0.01):
        return _f32(rng.standard_normal(shape) * s, dev)

    tok_embd = _rand_dense(rng, (V, C), dev)
    i = np.arange(C, dtype=np.float64)
    if arch == "mamba":
        d_in, N, K = cfg.ssm_d_inner, cfg.ssm_d_state, cfg.ssm_d_conv
        R = cfg.ssm_dt_rank
        params = {"tok_embd": tok_embd, "output_norm": near_one(C),
                  "output": tok_embd, "layers": []}
        for _ in range(L):
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), d_in))
            params["layers"].append({
                "attn_norm": near_one(C), "ssm_in": proj(2 * d_in, C),
                "ssm_conv1d": small(d_in, K, s=K ** -0.5),
                "ssm_conv1d_b": small(d_in),
                "ssm_x": proj(R + 2 * N, d_in), "ssm_dt": proj(d_in, R),
                "ssm_dt_b": _f32(dt + np.log(-np.expm1(-dt)), dev),
                "ssm_a": _f32(-np.tile(np.arange(1, N + 1), (d_in, 1)), dev),
                "ssm_d": _f32(np.ones(d_in), dev),
                "ssm_out": proj(C, d_in)})
    elif arch in ("rwkv6", "rwkv4"):
        F_ = cfg.intermediate_size
        params = {"tok_embd": tok_embd, "tok_norm": near_one(C),
                  "tok_norm_b": small(C), "output_norm": near_one(C),
                  "output_norm_b": small(C),
                  "output": (proj(V, C) if arch == "rwkv4"
                             else rand_q6k(rng, V, C, dev)),
                  "layers": []}
        for li in range(L):
            r0, r1 = _ratios(li, L)
            ddd = i / C
            zig = (i + 1) % 3 - 1
            if arch == "rwkv6":
                E = int(md["rwkv6.time_mix_extra_dim"])
                E2 = int(md["rwkv6.time_decay_extra_dim"])
                H, D = cfg.n_heads, cfg.head_dim
                layer = {"attn_norm": near_one(C), "attn_norm_b": small(C),
                         "attn_norm_2": near_one(C),
                         "attn_norm_2_b": small(C)}
                for g, pw in zip("xwkvrg", (1.0, 1.0, 1.0, 1.0, 0.5, 0.5)):
                    layer[f"lerp_{g}"] = _f32(1.0 - ddd ** (pw * r1), dev)
                decay = -6 + 5 * (i / (C - 1)) ** (0.7 + 1.3 * r0)
                first = r0 * (1 - i / (C - 1)) + zig * 0.1
                layer.update({
                    "w1": proj(5 * E, C),
                    "w2": _f32(rng.uniform(-1e-2, 1e-2, (5, C, E)), dev),
                    "first": _f32(first.reshape(H, D), dev),
                    "decay": _f32(decay, dev),
                    "decay_w1": proj(E2, C), "decay_w2": proj(C, E2),
                    "wk": proj(C, C), "wv": proj(C, C), "wr": proj(C, C),
                    "wg": proj(C, C), "wo": proj(C, C),
                    "ln_x": _f32(np.full(C, ((1 + li) / L) ** 0.7), dev),
                    "ln_x_b": small(C),
                    "c_lerp_k": _f32(1.0 - ddd ** r1, dev),
                    "c_lerp_r": _f32(1.0 - ddd ** r1, dev),
                    "ck": proj(F_, C), "cr": proj(C, C), "cv": proj(C, F_)})
            else:
                decay = -5 + 8 * (i / (C - 1)) ** (0.7 + 1.3 * r0)
                layer = {"ln1": near_one(C), "ln1_b": small(C),
                         "ln2": near_one(C), "ln2_b": small(C),
                         "tm_k": _f32(ddd ** r1, dev),
                         "tm_v": _f32(ddd ** r1 + 0.3 * r0, dev),
                         "tm_r": _f32(ddd ** (0.5 * r1), dev),
                         "first": _f32(np.log(0.3) + zig * 0.5, dev),
                         "decay": _f32(-np.exp(decay), dev),
                         "wk": proj(C, C), "wv": proj(C, C),
                         "wr": proj(C, C), "wo": proj(C, C),
                         "cm_k": _f32(ddd ** r1, dev),
                         "cm_r": _f32(ddd ** r1, dev),
                         "ck": proj(F_, C), "cr": proj(C, C),
                         "cv": proj(C, F_)}
            params["layers"].append(layer)
    elif arch == "nomic-bert":
        F_ = cfg.intermediate_size
        params = {"tok_embd": tok_embd, "token_types": small(2, C),
                  "tok_norm": near_one(C), "tok_norm_bias": small(C),
                  "layers": []}
        for _ in range(L):
            params["layers"].append({
                "wqkv": proj(3 * C, C), "wo": proj(C, C),
                "attn_out_norm": near_one(C), "attn_out_norm_bias": small(C),
                "w_gate": proj(F_, C), "w_up": proj(F_, C),
                "w_down": proj(C, F_), "layer_out_norm": near_one(C),
                "layer_out_norm_bias": small(C)})
    elif arch == "t5":
        F_, HD = cfg.intermediate_size, cfg.n_heads * cfg.head_dim
        nb = cfg.extras["rel_buckets"]
        params = {"tok_embd": tok_embd, "enc_output_norm": near_one(C),
                  "output_norm": near_one(C),
                  "output": rand_q6k(rng, V, C, dev),
                  "enc_layers": [], "dec_layers": []}

        def block(cross: bool, first: bool) -> dict:
            layer = {"attn_norm": near_one(C), "attn_q": proj(HD, C),
                     "attn_k": proj(HD, C), "attn_v": proj(HD, C),
                     "attn_o": proj(C, HD), "ffn_norm": near_one(C),
                     "ffn_gate": proj(F_, C), "ffn_up": proj(F_, C),
                     "ffn_down": proj(C, F_)}
            if cross:
                layer.update(cross_attn_norm=near_one(C),
                             cross_attn_q=proj(HD, C),
                             cross_attn_k=proj(HD, C),
                             cross_attn_v=proj(HD, C),
                             cross_attn_o=proj(C, HD))
            if first:
                layer["attn_rel_b"] = small(nb, cfg.n_heads, s=0.1)
            return layer

        for li in range(L):
            params["enc_layers"].append(block(False, li == 0))
        for li in range(L):
            params["dec_layers"].append(block(True, li == 0))
    else:
        raise ValueError(f"no synthetic model of {arch!r}")
    return Model(cfg, params, _placeholder_tokenizer(V), dev)


# ---------------------------------------------------------------------------
# the vision and speech inputs' published widths, drawn on the device
# ---------------------------------------------------------------------------

# LLaVA-1.5-7B's language model: LLaMA-2-7B's widths (meta-llama/Llama-2-7b
# config.json; lmsys/vicuna-7b-v1.5, which LLaVA-1.5-7B tunes, has the same:
# vocab 32000, hidden 4096, 32 layers, 32 heads of 128 over 32 kv heads,
# ffn 11008, context 4096); the JAX package's `LLAMA2_7B`
LLAMA2_7B = ModelConfig(
    arch="llama", name="llama2-7b-synthetic",
    vocab_size=32000, hidden_size=4096, n_layers=32, n_heads=32, n_kv_heads=32,
    head_dim=128, intermediate_size=11008, max_position_embeddings=4096,
    rope_dim=128,
)


def _q4k_centered_on(gen, out_f: int, in_f: int, dev) -> QTensor:
    """rand_q4k_centered's fields (the same distributions) drawn on `dev`
    by the torch.Generator `gen`."""
    nsb = in_f // QK_K

    def ints(hi, *shape, dtype=torch.uint8):
        return torch.randint(0, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    qs2 = ints(256, out_f, in_f // 2)
    d = torch.rand((out_f, nsb), generator=gen, device=dev) * 6.3e-5
    sc = ints(64, out_f, nsb, 8)
    scf = sc.float()
    return QTensor(kind="q4_k", shape=(out_f, in_f), data={
        "qs2": qs2,
        "scale": (d[:, :, None] * scf).reshape(out_f, -1).to(torch.bfloat16),
        "min": (d[:, :, None] * 8 * torch.round(scf * 15 / 16)).reshape(
            out_f, -1).to(torch.bfloat16),
        "sc": sc.reshape(out_f, -1),
        "d": d,
    })


def _q6k_on(gen, out_f: int, in_f: int, dev) -> QTensor:
    """rand_q6k's fields drawn on `dev` by `gen`."""
    nsb = in_f // QK_K

    def ints(*shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.uint8)

    return QTensor(kind="q6_k", shape=(out_f, in_f), data={
        "ql": ints(out_f, nsb * 128), "qh": ints(out_f, nsb * 64),
        "scale": (torch.rand((out_f, nsb * 16), generator=gen, device=dev)
                  * 0.002).to(torch.bfloat16)})


def synthetic_q4_k_m_on_device(cfg: ModelConfig, seed: int = 0,
                               device=None):
    """A servable llama-architecture Model with synthetic_params' "q4_k_m"
    tensors (zero-mean q4_k q / k / o and FFN, q6_k v and head, a bf16
    embedding of std 0.02, norms near 1), every tensor drawn on the device
    by a torch.Generator seeded from `seed`: a 7B's 3.9 GB in under a
    second, where the numpy makers take tens of seconds."""
    from .loader import Model

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C, F = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim

    def norm():
        return 1.0 + 0.01 * torch.randn(C, generator=gen, device=dev)

    params = {"tok_embd": dense(0.02 * torch.randn(
        (cfg.vocab_size, C), generator=gen, device=dev,
        dtype=torch.bfloat16), device=dev),
        "output_norm": norm(), "output": _q6k_on(gen, cfg.vocab_size, C, dev),
        "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "attn_norm": norm(), "wo": _q4k_centered_on(gen, C, qdim, dev),
            "ffn_norm": norm(), "w_down": _q4k_centered_on(gen, C, F, dev),
            "wq": _q4k_centered_on(gen, qdim, C, dev),
            "wk": _q4k_centered_on(gen, kvdim, C, dev),
            "wv": _q6k_on(gen, kvdim, C, dev),
            "w_gate": _q4k_centered_on(gen, F, C, dev),
            "w_up": _q4k_centered_on(gen, F, C, dev)})
    return Model(cfg, params, _placeholder_tokenizer(cfg.vocab_size), dev)


def _normal_on(gen, dev, *shape, s=0.02, mean=0.0) -> torch.Tensor:
    return mean + s * torch.randn(shape, generator=gen, device=dev)


def synthetic_clip(cfg=None, llm_hidden: int = 4096, seed: int = 0,
                   device=None):
    """A ClipModel (models/clip.py) with mmproj-named f32 tensors drawn on
    the device: default CLIP ViT-L/14-336 (openai/clip-vit-large-patch14-336:
    image 336, patch 14, hidden 1024, 24 layers, 16 heads, ffn 4096) with
    LLaVA-1.5's mlp2x_gelu projector to `llm_hidden` (liuhaotian/llava-v1.5-7b:
    mm.0 1024 -> 4096, mm.2 4096 -> 4096). Weights N(0, 0.02), layer norms
    near (1, 0), biases N(0, 0.01)."""
    from .clip import ClipModel, ClipVisionConfig

    cfg = cfg or ClipVisionConfig(projection_dim=llm_hidden)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    C, F_, P = cfg.hidden_size, cfg.intermediate_size, cfg.patch_size

    def w(*shape):
        return _normal_on(gen, dev, *shape)

    def b(n):
        return _normal_on(gen, dev, n, s=0.01)

    p = {"v.patch_embd.weight": w(C, 3, P, P), "v.class_embd": w(C),
         "v.position_embd.weight": w(cfg.n_patches + 1, C),
         "v.pre_ln.weight": _normal_on(gen, dev, C, s=0.01, mean=1.0),
         "v.pre_ln.bias": b(C)}
    for i in range(cfg.n_layers):
        pre = f"v.blk.{i}."
        for ln in ("ln1", "ln2"):
            p[pre + ln + ".weight"] = _normal_on(gen, dev, C, s=0.01, mean=1.0)
            p[pre + ln + ".bias"] = b(C)
        for name, o, i_ in (("attn_q", C, C), ("attn_k", C, C),
                            ("attn_v", C, C), ("attn_out", C, C),
                            ("ffn_up", F_, C), ("ffn_down", C, F_)):
            p[pre + name + ".weight"] = w(o, i_)
            p[pre + name + ".bias"] = b(o)
    p.update({"mm.0.weight": w(llm_hidden, C), "mm.0.bias": b(llm_hidden),
              "mm.2.weight": w(llm_hidden, llm_hidden),
              "mm.2.bias": b(llm_hidden)})
    return ClipModel(cfg, p, dev)


def _sinusoids(length: int, channels: int) -> np.ndarray:
    """Whisper's encoder position table (openai/whisper model.py
    `sinusoids`, max_timescale 10000)."""
    inc = np.log(10000) / (channels // 2 - 1)
    inv = np.exp(-inc * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def synthetic_whisper(cfg=None, ffn: int = 3072, seed: int = 0,
                      device=None):
    """A WhisperModel (models/whisper.py) with the GGUF container's f32
    tensors drawn on the device: default whisper-small (openai/whisper-small:
    80 mels, d_model 768, 12 + 12 layers of 12 heads, ffn 3072, audio
    context 1500, text context 448, vocab 51865 with the multilingual
    special ids). Weights N(0, 0.02) (the convolutions too), layer norms
    near (1, 0), biases N(0, 0.01), the encoder's positions sinusoids, no
    tokenizer (text is the token ids)."""
    from .whisper import WhisperConfig, WhisperModel

    cfg = cfg or WhisperConfig(d_model=768, enc_layers=12, enc_heads=12,
                               dec_layers=12, dec_heads=12)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    D = cfg.d_model

    def w(*shape):
        return _normal_on(gen, dev, *shape)

    def b(n):
        return _normal_on(gen, dev, n, s=0.01)

    def ln(name):
        return {name + ".weight": _normal_on(gen, dev, D, s=0.01, mean=1.0),
                name + ".bias": b(D)}

    def attn(pre):
        out = ln(pre + "_ln")
        for n in ("q", "k", "v", "out"):
            out[f"{pre}.{n}.weight"] = w(D, D)
            if n != "k":  # whisper's key projection has no bias
                out[f"{pre}.{n}.bias"] = b(D)
        return out

    def ffn_block(pre):
        return {**ln(pre + "_ln"), pre + ".fc1.weight": w(ffn, D),
                pre + ".fc1.bias": b(ffn), pre + ".fc2.weight": w(D, ffn),
                pre + ".fc2.bias": b(D)}

    p = {"enc.conv1.weight": w(D, cfg.n_mels, 3), "enc.conv1.bias": b(D),
         "enc.conv2.weight": w(D, D, 3), "enc.conv2.bias": b(D),
         "enc.pos": torch.from_numpy(_sinusoids(cfg.n_audio_ctx, D)).to(dev),
         **ln("enc.ln"), "dec.tok_embd": w(cfg.vocab_size, D),
         "dec.pos": _normal_on(gen, dev, cfg.n_text_ctx, D, s=0.01),
         **ln("dec.ln")}
    for i in range(cfg.enc_layers):
        p.update(attn(f"enc.{i}.attn"))
        p.update(ffn_block(f"enc.{i}.ffn"))
    for i in range(cfg.dec_layers):
        p.update(attn(f"dec.{i}.attn"))
        p.update(attn(f"dec.{i}.cross"))
        p.update(ffn_block(f"dec.{i}.ffn"))
    return WhisperModel(cfg, p, None, dev)


# stable-diffusion-xl-base-1.0's widths (its diffusers unet / text_encoder /
# text_encoder_2 / vae config.json): UNet 320 x (1, 2, 4) with transformer
# depth (0, 2, 10) in heads of 64 and linear projections, the
# add_embedding of the pooled bigG output plus six 256-wide time ids;
# CLIP-L (12 x 768) beside OpenCLIP-bigG (32 x 1280, 20 heads, projection
# 1280); the VAE as SD 1.5's
SDXL_BASE = dict(
    channel_mult=(1, 2, 4), attn_levels=(1, 2), transformer_depth=(0, 2, 10),
    attn_head_dim=64, linear_proj=True, context_dim=2048,
    add_embed_dim=1280 + 6 * 256, pooled_dim=1280, text2_dim=1280,
    text2_layers=32, text2_heads=20)


def synthetic_sd(cfg=None, seed: int = 0, device=None, scale: float = 0.02):
    """An SDModel (models/sd.py) with f32 tensors drawn on the device by a
    seeded torch.Generator in `init_random_sd_params`' layout (weights
    N(0, scale), norms (1, 0), biases 0): default SD 1.5's widths
    (`SDConfig`'s defaults: runwayml/stable-diffusion-v1-5's UNet 320 x (1,
    2, 4, 4), 8 heads, context 768; CLIP ViT-L/14's text tower; the VAE at
    128 x (1, 2, 4, 4); ~1.07 G parameters, 4.3 GB), or
    `SDConfig(**SDXL_BASE)` (~3.5 G, 14 GB). No tokenizer: every prompt
    encodes as the JAX pipeline's token-free one."""
    from .sd import SDConfig, SDModel, _sd_layout

    cfg = cfg or SDConfig()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = _sd_layout(cfg, {}, lambda shape: _normal_on(gen, dev, *shape,
                                                          s=scale), dev)
    return SDModel(cfg, params, None, dev)
