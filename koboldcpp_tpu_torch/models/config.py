"""Model hyperparameters from GGUF metadata.

Counterpart of llama.cpp's llama_hparams load (reference:
src/llama.cpp llm_load_hparams); keys per gguf-py constants.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from ..gguf.constants import Keys


def _get(md: Mapping[str, Any], key: str, arch: str, default=None):
    v = md.get(key.format(arch=arch), default)
    try:
        return v.item()  # numpy scalar
    except (AttributeError, ValueError):
        return v


def _int_max(v, default: int) -> int:
    """Scalar int, or max over a per-layer array (openelm head counts)."""
    if v is None:
        return default
    a = np.atleast_1d(np.asarray(v))
    return int(a.max())


@dataclass
class ModelConfig:
    arch: str = "llama"
    name: str = ""
    vocab_size: int = 32000
    hidden_size: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    head_dim: int = 128
    intermediate_size: int = 11008
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_dim: int = 128
    rope_type: str = "norm"  # "norm" (adjacent pairs) | "neox" (split halves)
    rope_scaling_type: str = "none"  # none|linear|yarn
    rope_scaling_factor: float = 1.0
    rope_orig_ctx: int = 0
    rope_attn_factor: float = 1.0
    # MoE
    n_experts: int = 0
    n_experts_used: int = 0
    expert_ffn_size: int = 0
    # logit softcapping (gemma2)
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    logit_scale: float = 0.0  # command-r/granite: multiply final logits when > 0
    residual_scale: float = 0.0  # granite: scale residual branch adds when > 0
    sliding_window: int = 0
    sliding_window_pattern: int = 0  # gemma2: every Nth layer is global
    tie_word_embeddings: bool = False
    # arch shape knobs (single parameterized builder, like llama.cpp's
    # per-arch build_* functions collapsed into flags)
    act: str = "silu"  # silu | gelu
    post_norms: bool = False  # gemma2 sandwich norms
    attn_scale: float = 0.0  # override for head_dim**-0.5 when > 0
    embedding_scale: float = 0.0  # gemma: hidden**0.5
    norm_type: str = "rms"  # rms | layer (gpt2/neox)
    use_rope: bool = True
    use_alibi: bool = False  # mpt: ALiBi attention bias instead of rope
    alibi_bias_max: float = 8.0
    clamp_kqv: float = 0.0  # mpt: clamp qkv activations to +-this when > 0
    learned_pos: bool = False  # gpt2 absolute position embeddings
    parallel_residual: bool = False  # neox/gptj: x + attn(ln1 x) + mlp(ln2 x)
    ffn_gated: bool = True  # False: plain up->act->down (gpt2/neox)
    moe_dense_ep: bool = False  # dense all-experts MoE (expert-parallel shardable)
    moe_sorted_ep: bool = False  # sort-based routed EP dispatch (ops/moe.py)
    # per-expert bucket multiplier for routed EP; None/<=0 = DROPLESS
    # (capacity = n_tokens — exact mul_mat_id parity under any skew, the
    # serving default; finite factors trade silent drops for smaller
    # all-to-all buffers)
    moe_capacity_factor: float | None = None
    moe_norm_topk: bool = True  # renormalize top-k router weights (mixtral yes, qwen2moe no)
    # SSM (mamba) hparams ({arch}.ssm.* keys)
    ssm_d_conv: int = 0
    ssm_d_inner: int = 0
    ssm_d_state: int = 0
    ssm_dt_rank: int = 0
    ssm_dt_b_c_rms: bool = False
    extras: dict = field(default_factory=dict)

    @property
    def kv_groups(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def is_encoder_decoder(self) -> bool:
        return self.arch == "t5"

    @property
    def is_embedding(self) -> bool:
        """Encoder-only embedding archs (served via the embeddings
        endpoints, not the generation loop)."""
        return self.arch in ("bert", "t5encoder", "nomic-bert", "jina-bert-v2")

    @property
    def is_recurrent(self) -> bool:
        """Stateful (non-attention-cache) archs; mirrors llama.cpp's
        recurrent flag (src/llama.cpp:2775)."""
        return self.arch in ("mamba", "rwkv6", "rwkv4")


# archs whose GGUF weights expect NEOX-style (split-half) rope
# (llama_rope_type, src/llama.cpp:19687-19745)
_NEOX_ROPE_ARCHS = {
    "falcon", "gptneox", "qwen", "qwen2", "qwen2moe", "phi2", "phi3", "stablelm",
    "gemma", "gemma2", "starcoder2", "olmo", "olmoe", "minicpm3", "deepseek2",
    "dbrx", "nemotron", "exaone", "codeshell", "openelm", "grok", "bitnet",
    "nomic-bert",
}


def config_from_metadata(md: Mapping[str, Any]) -> ModelConfig:
    arch = str(md.get(Keys.General.ARCHITECTURE, "llama"))
    hidden = int(_get(md, Keys.EMBEDDING_LENGTH, arch, 4096))
    n_heads = _int_max(_get(md, Keys.HEAD_COUNT, arch, None), 32)
    head_dim = int(_get(md, Keys.KEY_LENGTH, arch, hidden // max(n_heads, 1)) or hidden // n_heads)
    n_layers = int(_get(md, Keys.BLOCK_COUNT, arch, 32))
    tokens = md.get(Keys.Tokenizer.TOKENS)
    vocab = int(_get(md, Keys.VOCAB_SIZE, arch, len(tokens) if tokens is not None else 32000))
    rope_dim = int(_get(md, Keys.ROPE_DIMENSION_COUNT, arch, head_dim) or head_dim)
    scaling = _get(md, Keys.ROPE_SCALING_TYPE, arch, "none") or "none"
    extras: dict = {}
    if arch in ("gemma", "gemma2"):
        extras = dict(act="gelu", post_norms=(arch == "gemma2"),
                      embedding_scale=float(hidden) ** 0.5,
                      sliding_window_pattern=2 if arch == "gemma2" else 0)
    elif arch in ("gpt2", "starcoder"):
        extras = dict(norm_type="layer", use_rope=False, learned_pos=True,
                      ffn_gated=False, act="gelu")
    elif arch == "gptneox":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu",
                      parallel_residual=bool(md.get(
                          "gptneox.use_parallel_residual", True)))
    elif arch == "gptj":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu",
                      parallel_residual=True)
    elif arch == "falcon":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu",
                      parallel_residual=True)
    elif arch == "stablelm":
        extras = dict(norm_type="layer")  # layernorm + partial rotary + silu-gated FFN
    elif arch == "phi2":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu",
                      parallel_residual=True)
    elif arch == "olmo":
        extras = dict(norm_type="layer")  # non-parametric LN (identity affine)
    elif arch in ("granite", "granitemoe"):
        ls = float(_get(md, "{arch}.logit_scale", arch, 0.0) or 0.0)
        extras = dict(
            embedding_scale=float(_get(md, "{arch}.embedding_scale", arch, 0.0) or 0.0),
            attn_scale=float(_get(md, "{arch}.attention.scale", arch, 0.0) or 0.0),
            residual_scale=float(_get(md, "{arch}.residual_scale", arch, 0.0) or 0.0),
            logit_scale=1.0 / ls if ls else 0.0)  # llama.cpp divides by it
    elif arch == "dbrx":
        extras = dict(norm_type="layer",
                      clamp_kqv=float(_get(
                          md, "{arch}.attention.clamp_kqv", arch, 0.0) or 0.0))
    elif arch in ("qwen2moe", "olmoe"):
        extras = dict(moe_norm_topk=False)
    elif arch == "starcoder2":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu")
    elif arch == "bloom":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu_exact",
                      use_rope=False, use_alibi=True)
    elif arch == "chameleon":
        extras = dict(extras={
            "qk_norm_per_head": True,
            "swin_norm": bool(_get(md, "{arch}.swin_norm", arch, False))})
    elif arch == "minicpm":
        # build_minicpm hardcodes scale_embd=12, scale_depth=1.4 (residual
        # scaled by 1.4/sqrt(n_layer)), logits scaled by 256/n_embd
        # (src/llama.cpp build_minicpm)
        extras = dict(embedding_scale=12.0,
                      residual_scale=1.4 / (n_layers ** 0.5),
                      logit_scale=256.0 / hidden)
    elif arch == "orion":
        extras = dict(norm_type="layer")  # LN with biases + gated silu
    elif arch == "bert":
        extras = dict(norm_type="layer", use_rope=False, ffn_gated=False,
                      act="gelu_exact",
                      extras={"pooling": int(_get(
                          md, "{arch}.pooling_type", arch, 1) or 1)})
    elif arch == "t5encoder":
        extras = dict(
            use_rope=False,
            extras={"rel_buckets": int(_get(
                md, "{arch}.attention.relative_buckets_count", arch, 32) or 32),
                "pooling": int(_get(md, "{arch}.pooling_type", arch, 1) or 1)})
    elif arch == "nemotron":
        extras = dict(norm_type="layer", ffn_gated=False, act="relu2")
    elif arch == "command-r":
        extras = dict(norm_type="layer", parallel_residual=True,
                      logit_scale=float(_get(
                          md, "{arch}.logit_scale", arch, 0.0) or 0.0))
    elif arch == "mamba":
        extras = dict(
            use_rope=False,
            ssm_d_conv=int(_get(md, Keys.SSM.CONV_KERNEL, arch, 4) or 4),
            ssm_d_inner=int(_get(md, Keys.SSM.INNER_SIZE, arch, 2 * hidden)
                            or 2 * hidden),
            ssm_d_state=int(_get(md, Keys.SSM.STATE_SIZE, arch, 16) or 16),
            ssm_dt_rank=int(_get(md, Keys.SSM.TIME_STEP_RANK, arch,
                                 -(hidden // -16)) or -(hidden // -16)),
            ssm_dt_b_c_rms=bool(_get(md, Keys.SSM.DT_B_C_RMS, arch, False)))
    elif arch == "deepseek2":
        extras = dict(extras={
            "v_head_dim": int(_get(md, "{arch}.attention.value_length", arch,
                                   hidden // max(n_heads, 1)) or 0),
            "expert_weights_scale": float(_get(
                md, "{arch}.expert_weights_scale", arch, 1.0) or 1.0),
            "yarn_log_mul": float(_get(
                md, "{arch}.rope.scaling.yarn_log_multiplier", arch, 0.1)
                or 0.1),
            "dense_lead": int(_get(
                md, "{arch}.leading_dense_block_count", arch, 0) or 0)})
    elif arch == "minicpm3":
        extras = dict(
            embedding_scale=12.0,
            residual_scale=1.4 / (n_layers ** 0.5),
            logit_scale=256.0 / hidden,
            extras={"v_head_dim": int(_get(md, "{arch}.attention.value_length",
                                           arch, hidden // max(n_heads, 1))
                                      or 0)})
    elif arch == "t5":
        extras = dict(
            use_rope=False,
            extras={"rel_buckets": int(_get(
                md, "{arch}.attention.relative_buckets_count", arch, 32) or 32),
                "decoder_start": int(_get(
                    md, "{arch}.decoder_start_token_id", arch, 0) or 0)})
    elif arch == "rwkv6":
        head_size = int(_get(md, Keys.WKV.HEAD_SIZE, arch, 64) or 64)
        n_heads = hidden // head_size
        head_dim = head_size
        extras = dict(
            norm_type="layer", use_rope=False,
            extras={"rescale_every": int(_get(
                md, "{arch}.rescale_every_n_layers", arch, 0) or 0)})
    elif arch == "refact":
        # build_refact (src/llama.cpp:11345): rms + gated silu
        # like llama but NO rope; ALiBi max bias hardcoded 8.0 (:5623)
        extras = dict(use_rope=False, use_alibi=True)
    elif arch == "plamo":
        # build_plamo (:12657): single attn_norm feeds BOTH attention and FFN;
        # layer out = x + attn_out + ffn_out (no second norm)
        extras = dict(extras={"plamo_parallel": True})
    elif arch == "codeshell":
        # build_codeshell (:12866): starcoder-style LN+bias / non-gated gelu
        # FFN with biases, but NEOX rope instead of learned positions
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu")
    elif arch == "grok":
        # build_grok (:10958): embd x78.38367176906169, kq_scale 1.0, GELU MoE,
        # rms post-norms on attention and MoE outputs, logits x(1/sqrt(3))
        extras = dict(embedding_scale=78.38367176906169, attn_scale=1.0,
                      logit_scale=0.5773502691896257,
                      extras={"moe_act": "gelu"})
    elif arch == "jais":
        # build_jais (:15507): LN+bias, fused wqkv, ALiBi (metadata max bias),
        # gated-silu FFN with biases on gate/up/down, kq_scale = 1/head_dim
        hd = int(_get(md, Keys.KEY_LENGTH, arch, hidden // max(n_heads, 1))
                 or hidden // n_heads)
        extras = dict(norm_type="layer", use_rope=False, use_alibi=True,
                      attn_scale=1.0 / hd,
                      alibi_bias_max=float(_get(
                          md, "{arch}.attention.max_alibi_bias", arch, 8.0) or 8.0))
    elif arch == "bitnet":
        # build_bitnet (:15020): optional scalar weight-scales per projection,
        # rms sub-norms before wo and before ffn_down, tied lm head
        extras = dict(extras={"bitnet": True})
    elif arch == "openelm":
        # build_openelm (:14393): per-layer head counts, head-major fused
        # wqkv, per-head-dim QK RMSNorm, NEOX rope, tied lm head
        hc = md.get(Keys.HEAD_COUNT.format(arch=arch))
        kvc = md.get(Keys.HEAD_COUNT_KV.format(arch=arch))
        hc = [int(x) for x in np.atleast_1d(np.asarray(hc))]
        kvc = [int(x) for x in np.atleast_1d(np.asarray(kvc))]
        n_heads = max(hc)
        extras = dict(extras={"head_counts": hc, "kv_head_counts": kvc,
                              "qk_head_rms": True})
    elif arch == "nomic-bert":
        # build_bert NOMIC_BERT branch (:11507): post-norm encoder with NEOX
        # rope (no learned positions), fused unbias wqkv, gated-silu FFN
        extras = dict(norm_type="layer", ffn_gated=True, act="silu",
                      extras={"pooling": int(_get(
                          md, "{arch}.pooling_type", arch, 1) or 1)})
    elif arch == "jina-bert-v2":
        # build_bert JINA_BERT_V2 branch: post-norm encoder, ALiBi (8.0,
        # :5652), gated-gelu FFN with down bias, optional QK LayerNorm
        extras = dict(norm_type="layer", use_rope=False, use_alibi=True,
                      ffn_gated=True, act="gelu",
                      extras={"pooling": int(_get(
                          md, "{arch}.pooling_type", arch, 1) or 1)})
    elif arch == "mpt":
        extras = dict(norm_type="layer", ffn_gated=False, act="gelu_exact",
                      use_rope=False, use_alibi=True,
                      alibi_bias_max=float(_get(
                          md, "{arch}.attention.max_alibi_bias", arch, 8.0) or 8.0),
                      clamp_kqv=float(_get(
                          md, "{arch}.attention.clamp_kqv", arch, 0.0) or 0.0))
    return ModelConfig(
        arch=arch,
        name=str(md.get(Keys.General.NAME, "")),
        vocab_size=vocab,
        hidden_size=hidden,
        n_layers=n_layers,
        n_heads=n_heads,
        n_kv_heads=_int_max(_get(md, Keys.HEAD_COUNT_KV, arch, None), n_heads),
        head_dim=head_dim,
        intermediate_size=_int_max(
            _get(md, Keys.FEED_FORWARD_LENGTH, arch, None), 11008),
        max_position_embeddings=int(_get(md, Keys.CONTEXT_LENGTH, arch, 4096)),
        rms_norm_eps=float(_get(md, Keys.LAYERNORM_RMS_EPS, arch,
                                _get(md, Keys.LAYERNORM_EPS, arch, 1e-5))),
        rope_theta=float(_get(md, Keys.ROPE_FREQ_BASE, arch, 10000.0)),
        rope_dim=rope_dim,
        rope_type="neox" if arch in _NEOX_ROPE_ARCHS else "norm",
        rope_scaling_type=str(scaling),
        rope_scaling_factor=float(_get(md, Keys.ROPE_SCALING_FACTOR, arch, 1.0) or 1.0),
        rope_orig_ctx=int(_get(md, Keys.ROPE_SCALING_ORIG_CTX, arch, 0) or 0),
        rope_attn_factor=float(_get(md, Keys.ROPE_SCALING_ATTN_FACTOR, arch, 1.0) or 1.0),
        n_experts=int(_get(md, Keys.EXPERT_COUNT, arch, 0) or 0),
        n_experts_used=int(_get(md, Keys.EXPERT_USED_COUNT, arch, 0) or 0),
        expert_ffn_size=int(_get(md, Keys.EXPERT_FFN_LENGTH, arch, 0) or 0),
        attn_logit_softcap=float(_get(md, Keys.ATTN_LOGIT_SOFTCAP, arch, 0.0) or 0.0),
        final_logit_softcap=float(_get(md, Keys.FINAL_LOGIT_SOFTCAP, arch, 0.0) or 0.0),
        sliding_window=int(_get(md, Keys.SLIDING_WINDOW, arch, 0) or 0),
        **extras,
    )
