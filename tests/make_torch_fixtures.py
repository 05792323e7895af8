"""Generate tests/fixtures/portgguf/: the Q2_K, Q3_K_M, IQ2_XS, IQ3_XXS and
IQ1_M tiny fixtures of the PyTorch port's tests and the JAX package's
logits on them.

Every GGUF file is a re-quantization of tests/fixtures/refgguf/tiny-f16.gguf
by the in-repo quantizer (no importance matrix; byte-identical from run to
run), e.g.

    python tools/quantize.py tests/fixtures/refgguf/tiny-f16.gguf \
        tests/fixtures/portgguf/tiny-q2_k.gguf q2_k

(FILES lists the formats). The IQ files mix types as the quantizer's
recipes do: tiny-iq2_xs holds IQ2_XS and Q2_K tensors, tiny-iq3_xxs
IQ3_XXS, IQ3_S (token_embd too), IQ2_S and Q3_K, tiny-iq1_m IQ1_M, IQ2_XXS
and Q2_K; every output is Q5_K.

The architecture fixtures (archs.json: tiny-gemma2-q4_k_m,
tiny-phi2-q4_k_m, tiny-mpt-q4_k_m) are tiny transformers models (2 layers,
hidden 256, head_dim 64, vocab 512, random weights from a seed, no
download) converted by tools/convert_hf.py with the toy byte-fallback
tokenizer of tests/test_model_forward.py and quantized by the same tool to
Q4_K_M: Gemma-2 with a sliding window of 4 (so the 12 tokens pass it) and
softcaps 50 / 30, Phi-2 (layer norms with biases, every projection and
the head biased, partial rotary, parallel residual, non-gated gelu), MPT
(ALiBi, clamp_kqv 0.5, exact gelu, tied head).

The MoE fixtures (moe.json: tiny-mixtral-q4_k_m, tiny-qwen2moe-q4_k_m,
tiny-grok-q4_k_m) are made the same way at the same widths, with 8
experts of 256: a transformers Mixtral (top-2, renormalized) and Qwen2-MoE
(top-4 not renormalized, a shared expert of 512 with its sigmoid gate),
and a hand-written f32 Grok file (the tensors of tests/test_archs_r2.py's
grok case: tanh-gelu experts, RMS post-norms on both branches, the
embedding and logit scales of its config). The quantizer keeps the
expert stacks 3-D (q4_k, the down stack q6_k on layer 1) and quantizes the
router to q4_k.

The late fixtures (late.json: tiny-{deepseek2,minicpm3,chameleon_swin,
openelm,bitnet,jais,plamo}-q4_k_m) are made the same way at hidden 256:
a transformers DeepSeek-V2 "lite" model (no q-LoRA; kv_lora_rank 256, 4
heads of 64 + 32 roped dims, v_head_dim 64, a dense lead layer, then 8
experts of 256 with top-2 scaled by 1.5 and one shared expert), MiniCPM3
(the same converter with q_lora_rank 256 and every layer dense, written
under the minicpm3 architecture as tests/test_deepseek2.py writes it),
Chameleon with swin norm, and hand-written f32 files of openelm (heads 4
and 2 over kv heads 2 and 1 by layer, FFN widths 512 and 256), bitnet
(sub-norms and scale scalars), jais (ALiBi, biases) and plamo, each with
the tensors of tests/test_archs_r2.py's case at these widths.

The text fixtures (text.json: tiny-mamba-q4_k_m, tiny-rwkv6-q4_k_m,
tiny-rwkv4-q8_0.bin with the vocab sidecar rwkv_vocab.embd,
tiny-nomic-bert-q4_k_m, tiny-t5-q4_k_m) are the recurrent, embedding and
encoder-decoder models at hidden 256, 2 layers, vocab 512: a transformers
Mamba (d_inner 512, d_state 16, dt_rank 16, tied head; initializer_range
0.02, most transformers models' default: at Mamba's own 0.1 the tied
head's logits spread 4x wider, and one bf16 rounding step of a projection
moved a logit by 0.036, past the fixture tolerance), an RWKV6 state
dict with RWKV-LM's initialisations (4 heads of 64, FFN 512, lerp rank
32, decay rank 64; `rwkv6_state`) through tools/convert_hf.py, a
transformers RWKV-4 written as a q8_0 legacy .bin by tools/convert_rwkv.py
beside a byte-level vocab sidecar, a hand-written f32 nomic-bert (4 heads
of 64, NEOX rope, SwiGLU 512, mean pooling; `bert_family_tensors`) and a
transformers flan-style T5 (4 heads of 64, gated-gelu FFN 512, 32
buckets; initializer_factor 0.2: at 1.0 its logits have a std of 16 and
its hidden states reach 4, where one bf16 step of a projection's output
is 0.03 and moved a logit by 0.75, past the fixture tolerance); the GGUFs
quantized by tools/quantize.py to Q4_K_M. Their JAX
numbers: the generators' logits over the 12 tokens, nomic-bert's final
hidden states (`bert.forward_embed`, embed-jax-nomic-bert.npy) and T5's
decoder logits over [decoder start] + the first 11 tokens with the 12
tokens through the encoder.

The logits are the JAX package's `forward` (packed weights, f32 cache and
activations, on the CPU; models/deepseek2.py's for deepseek2 / minicpm3)
over the refgguf manifest's 12 tokens. They are the JAX package's own
numbers, not reference-runtime goldens.

Run from the repository root when the fixtures need regenerating (--archs:
the architecture fixtures only; --moe: the MoE fixtures only; --late: the
late fixtures only; --text: the text fixtures only):

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py [--archs | --moe | --late | --text]
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tests", "fixtures", "refgguf")
OUT = os.path.join(ROOT, "tests", "fixtures", "portgguf")
FILES = {"q2_k": "tiny-q2_k.gguf", "q3_k_m": "tiny-q3_k_m.gguf",
         "iq2_xs": "tiny-iq2_xs.gguf", "iq3_xxs": "tiny-iq3_xxs.gguf",
         "iq1_m": "tiny-iq1_m.gguf"}
ARCH_FILES = {"gemma2": "tiny-gemma2-q4_k_m.gguf",
              "phi2": "tiny-phi2-q4_k_m.gguf",
              "mpt": "tiny-mpt-q4_k_m.gguf"}
ARCH_SEED = {"gemma2": 41, "phi2": 42, "mpt": 43}
MOE_FILES = {"mixtral": "tiny-mixtral-q4_k_m.gguf",
             "qwen2moe": "tiny-qwen2moe-q4_k_m.gguf",
             "grok": "tiny-grok-q4_k_m.gguf"}
MOE_SEED = {"mixtral": 44, "qwen2moe": 45, "grok": 46}
LATE_SEED = {"deepseek2": 47, "minicpm3": 48, "chameleon_swin": 49,
             "openelm": 50, "bitnet": 51, "jais": 52, "plamo": 53}
LATE_FILES = {a: f"tiny-{a}-q4_k_m.gguf" for a in LATE_SEED}
TEXT_SEED = {"mamba": 54, "rwkv6": 55, "rwkv4": 56, "nomic-bert": 57,
             "t5": 58}
TEXT_FILES = {a: f"tiny-{a}-q4_k_m.gguf" for a in TEXT_SEED}
TEXT_FILES["rwkv4"] = "tiny-rwkv4-q8_0.bin"


def jax_logits(path: str, tokens: list[int]) -> np.ndarray:
    """The JAX forward's f32 logits (T, vocab) for tokens at positions 0..
    (models/deepseek2.py's for a deepseek2 / minicpm3 file)."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from koboldcpp_tpu.kv.cache import init_cache
    from koboldcpp_tpu.models import deepseek2, llama
    from koboldcpp_tpu.models.loader import load_model

    m = load_model(path, packed=True, dtype=jnp.float32)
    if m.cfg.arch in ("deepseek2", "minicpm3"):
        mod = deepseek2
        cache = deepseek2.init_cache(m.cfg, 1, 64, dtype=jnp.float32)
    else:
        mod = llama
        cache = init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                           m.cfg.head_dim, dtype=jnp.float32)
    toks = jnp.asarray([tokens], jnp.int32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    fwd = jax.jit(lambda p, t, s, c: mod.forward(p, m.cfg, t, s, c))
    logits, _ = fwd(m.params, toks, pos, cache)
    return np.asarray(logits, np.float32)[0]


def late_f32(arch: str, path: str) -> None:
    """The late fixture model of `arch` (hidden 256, 2 layers), as an f32
    GGUF."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    import transformers as tf
    from convert_hf import (convert_chameleon_state_dict,
                            convert_deepseek2_state_dict)

    from tests.test_model_forward import tiny_tokenizer_md

    md = tiny_tokenizer_md(512)
    torch.manual_seed(LATE_SEED[arch])
    if arch in ("deepseek2", "minicpm3"):
        cfg = tf.DeepseekV2Config(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            moe_intermediate_size=256, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4,
            qk_nope_head_dim=64, qk_rope_head_dim=32, v_head_dim=64,
            q_lora_rank=256 if arch == "minicpm3" else None,
            kv_lora_rank=256, n_routed_experts=8, num_experts_per_tok=2,
            n_shared_experts=1, routed_scaling_factor=1.5,
            first_k_dense_replace=2 if arch == "minicpm3" else 1,
            topk_method="greedy", n_group=1, topk_group=1,
            norm_topk_prob=False, max_position_embeddings=128,
            tie_word_embeddings=False, head_dim=32)
        model = tf.DeepseekV2ForCausalLM(cfg).eval().float()
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        if arch == "deepseek2":
            convert_deepseek2_state_dict(state, cfg, path, tokenizer_md=md)
        else:
            ds2 = path + ".ds2"
            convert_deepseek2_state_dict(state, cfg, ds2, tokenizer_md=md)
            _rename_arch(ds2, path, "deepseek2", "minicpm3")
            os.remove(ds2)
        return
    if arch == "chameleon_swin":
        vq = dict(embed_dim=32, num_embeddings=16, latent_channels=32,
                  base_channels=32, channel_multiplier=[1], num_res_blocks=1,
                  resolution=16, attn_resolutions=[])
        cfg = tf.ChameleonConfig(
            vocab_size=512, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=128,
            swin_norm=True, vq_config=vq, vocabulary_map={"<image>": 1},
            tie_word_embeddings=False)
        model = tf.ChameleonForConditionalGeneration(cfg).eval().float()
        state = {k: v.numpy() for k, v in model.state_dict().items()
                 if not k.startswith("model.vqmodel")}
        convert_chameleon_state_dict(state, cfg, path, tokenizer_md=md)
        return
    _late_hand_written(arch, path, md)


def _rename_arch(src: str, dst: str, old: str, new: str) -> None:
    """The file `src` under architecture `new` (its `old.*` keys renamed),
    every tensor copied as f32."""
    from koboldcpp_tpu.gguf import GGMLType, GGUFReader, GGUFWriter

    with GGUFReader(src) as r:
        w = GGUFWriter(dst, architecture=new)
        for k, v in r.metadata.items():
            if k.startswith(old + "."):
                w.add(new + "." + k.split(".", 1)[1], v)
            elif k != "general.architecture":
                w.add(k, v)
        for name in r.tensors:
            w.add_tensor(name, r.tensor_data(name), GGMLType.F32)
        w.write()


def _late_hand_written(arch: str, path: str, md: dict) -> None:
    """openelm, bitnet, jais or plamo: test_archs_r2.py's tensors of the
    case at hidden 256 (4 heads of 64 over 2 kv heads, FFN 512; openelm per
    layer), drawn from numpy seed LATE_SEED[arch]."""
    from koboldcpp_tpu.gguf import GGMLType, GGUFWriter

    V, C, H, KV, D, F, L = 512, 256, 4, 2, 64, 512, 2
    rng = np.random.default_rng(LATE_SEED[arch])

    def w2(out, inp, s=0.05):
        return (rng.standard_normal((out, inp)) * s).astype(np.float32)

    def w1(n, around_one=False):
        v = (rng.standard_normal(n) * 0.1).astype(np.float32)
        return v + 1.0 if around_one else v

    def scale():
        return np.array([1.0 + 0.2 * rng.standard_normal()], np.float32)

    t = {"token_embd.weight": w2(V, C, 0.02),
         "output_norm.weight": w1(C, True)}
    if arch == "jais":
        t["output_norm.bias"] = w1(C)
    if arch in ("jais", "plamo"):
        t["output.weight"] = w2(V, C, 0.02)
    heads, kv_heads, ffs = [4, 2], [2, 1], [512, 256]
    for i in range(L):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = w1(C, True)
        if arch == "openelm":
            nh, nkv, ff = heads[i], kv_heads[i], ffs[i]
            t[p + "attn_qkv.weight"] = w2((nh + 2 * nkv) * D, C)
            t[p + "attn_q_norm.weight"] = w1(D, True)
            t[p + "attn_k_norm.weight"] = w1(D, True)
            t[p + "attn_output.weight"] = w2(C, nh * D)
            t[p + "ffn_norm.weight"] = w1(C, True)
            t[p + "ffn_gate.weight"] = w2(ff, C)
            t[p + "ffn_up.weight"] = w2(ff, C)
            t[p + "ffn_down.weight"] = w2(C, ff)
            continue
        if arch == "jais":
            t[p + "attn_norm.bias"] = w1(C)
            t[p + "attn_qkv.weight"] = w2((H + 2 * KV) * D, C)
            t[p + "attn_qkv.bias"] = w1((H + 2 * KV) * D)
            t[p + "attn_output.weight"] = w2(C, H * D)
            t[p + "attn_output.bias"] = w1(C)
            t[p + "ffn_norm.weight"] = w1(C, True)
            t[p + "ffn_norm.bias"] = w1(C)
            for nm in ("ffn_gate", "ffn_up"):
                t[p + nm + ".weight"] = w2(F, C)
                t[p + nm + ".bias"] = w1(F)
            t[p + "ffn_down.weight"] = w2(C, F)
            t[p + "ffn_down.bias"] = w1(C)
            continue
        if arch == "bitnet":
            t[p + "attn_sub_norm.weight"] = w1(H * D, True)
        t[p + "attn_q.weight"] = w2(H * D, C)
        t[p + "attn_k.weight"] = w2(KV * D, C)
        t[p + "attn_v.weight"] = w2(KV * D, C)
        t[p + "attn_output.weight"] = w2(C, H * D)
        if arch == "bitnet":
            for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
                t[p + nm + ".scale"] = scale()
            t[p + "ffn_norm.weight"] = w1(C, True)
            t[p + "ffn_sub_norm.weight"] = w1(F, True)
        t[p + "ffn_gate.weight"] = w2(F, C)
        t[p + "ffn_up.weight"] = w2(F, C)
        t[p + "ffn_down.weight"] = w2(C, F)
        if arch == "bitnet":
            for nm in ("ffn_gate", "ffn_up", "ffn_down"):
                t[p + nm + ".scale"] = scale()
    keys = {"context_length": np.uint32(128), "embedding_length": np.uint32(C),
            "block_count": np.uint32(L), "feed_forward_length": np.uint32(F),
            "attention.head_count": np.uint32(H),
            "attention.head_count_kv": np.uint32(KV),
            "attention.key_length": np.uint32(D),
            "attention.value_length": np.uint32(D),
            "rope.freq_base": np.float32(10000.0),
            "rope.dimension_count": np.uint32(D),
            "vocab_size": np.uint32(V)}
    eps = ("attention.layer_norm_epsilon" if arch == "jais"
           else "attention.layer_norm_rms_epsilon")
    keys[eps] = np.float32(1e-5)
    if arch == "jais":
        keys["attention.max_alibi_bias"] = np.float32(8.0)
    if arch == "openelm":
        keys["attention.head_count"] = np.array(heads, np.uint32)
        keys["attention.head_count_kv"] = np.array(kv_heads, np.uint32)
        keys["feed_forward_length"] = np.array(ffs, np.uint32)
    w = GGUFWriter(path, architecture=arch)
    for k, v in {**{f"{arch}.{k}": v for k, v in keys.items()},
                 **md}.items():
        w.add(k, v)
    for name, arr in t.items():
        w.add_tensor(name, arr, GGMLType.F32)
    w.write()


def _quantize_per_layer_heads(src: str, dst: str) -> None:
    """tools/quantize.py's q4_k_m over a file whose head counts are per-layer
    arrays (openelm), which its type picker reads as one number: the picker
    gets the largest count, as config_from_metadata takes it; the types and
    blocks are otherwise the tool's."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from quantize import TYPE_MAP, TypePicker

    from koboldcpp_tpu.gguf import GGUFReader, GGUFWriter, quants

    target = TYPE_MAP["q4_k_m"]
    with GGUFReader(src) as r:
        md = {k: (int(np.max(v)) if k.endswith(("head_count",
                                                "head_count_kv"))
                  else v) for k, v in r.metadata.items()}
        picker = TypePicker(target, md)
        w = GGUFWriter(dst)
        for k, v in r.metadata.items():
            if k != "general.file_type":
                w.add(k, v)
        w.add("general.file_type", np.uint32(int(target)))
        for name, info in r.tensors.items():
            t = picker.pick(name, info.shape)
            w.add_tensor(name, quants.quantize(np.ascontiguousarray(
                r.tensor_data(name), np.float32), t), t)
        w.write()


def make_late_fixtures(tokens: list[int]) -> None:
    for arch, name in LATE_FILES.items():
        src = os.path.join(OUT, f"_{arch}-f32.gguf")
        late_f32(arch, src)
        path = os.path.join(OUT, name)
        if arch == "openelm":
            _quantize_per_layer_heads(src, path)
        else:
            subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                         "quantize.py"),
                            src, path, "q4_k_m"], check=True)
        os.remove(src)
        np.save(os.path.join(OUT, f"logits-jax-{arch}.npy"),
                jax_logits(path, tokens))
    manifest = {
        "tokens": tokens,
        "files": LATE_FILES,
        "made_by": {arch: f"tests/make_torch_fixtures.py --late: the tiny "
                          f"{arch} model (seed {LATE_SEED[arch]}), then "
                          f"tools/quantize.py's q4_k_m into "
                          f"tests/fixtures/portgguf/{name}"
                    for arch, name in LATE_FILES.items()},
        "logits": "logits-jax-<arch>.npy: the JAX package's forward "
                  "(koboldcpp_tpu.models.llama.forward, or "
                  "models.deepseek2.forward for deepseek2 / minicpm3; "
                  "packed weights, f32 cache, CPU) on `tokens` at positions "
                  "0..11, shape (12, vocab) f32; the JAX package's numbers, "
                  "not reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "late.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


def arch_f32(arch: str, path: str) -> None:
    """The tiny transformers model of `arch`, converted to an f32 GGUF."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    import transformers as tf
    from convert_hf import (convert_arch_state_dict, convert_mpt_state_dict,
                            convert_phi2_state_dict)

    from tests.test_model_forward import tiny_tokenizer_md

    torch.manual_seed(ARCH_SEED[arch])
    md = tiny_tokenizer_md(512)
    if arch == "gemma2":
        cfg = tf.Gemma2Config(vocab_size=512, hidden_size=256,
                              intermediate_size=512, num_hidden_layers=2,
                              num_attention_heads=4, num_key_value_heads=2,
                              head_dim=64, max_position_embeddings=128,
                              query_pre_attn_scalar=64, sliding_window=4,
                              attn_logit_softcapping=50.0,
                              final_logit_softcapping=30.0)
        model, convert = tf.Gemma2ForCausalLM(cfg), partial(
            convert_arch_state_dict, "gemma2")
    elif arch == "phi2":
        cfg = tf.PhiConfig(vocab_size=512, hidden_size=256,
                           intermediate_size=1024, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=4,
                           max_position_embeddings=128,
                           partial_rotary_factor=0.5)
        model, convert = tf.PhiForCausalLM(cfg), convert_phi2_state_dict
    else:
        cfg = tf.MptConfig(vocab_size=512, d_model=256, n_heads=4,
                           n_layers=2, max_seq_len=128, expansion_ratio=4,
                           attn_config={"clip_qkv": 0.5})
        model, convert = tf.MptForCausalLM(cfg), convert_mpt_state_dict
    state = {k: v.numpy() for k, v in model.eval().float().state_dict().items()}
    convert(state, cfg, path, tokenizer_md=md)


def moe_f32(arch: str, path: str) -> None:
    """The tiny MoE model of `arch` (hidden 256, 2 layers, 4 heads of 64
    over 2 kv heads, 8 experts of 256), as an f32 GGUF."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    if arch == "grok":
        grok_f32(path)
        return
    import torch
    import transformers as tf
    from convert_hf import (convert_mixtral_state_dict,
                            convert_qwen2moe_state_dict)

    from tests.test_model_forward import tiny_tokenizer_md

    md = tiny_tokenizer_md(512)
    torch.manual_seed(MOE_SEED[arch])
    small = dict(vocab_size=512, hidden_size=256, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2,
                 max_position_embeddings=128, tie_word_embeddings=False)
    if arch == "mixtral":
        cfg = tf.MixtralConfig(**small, intermediate_size=256,
                               num_local_experts=8, num_experts_per_tok=2)
        model, convert = tf.MixtralForCausalLM(cfg), convert_mixtral_state_dict
    else:
        cfg = tf.Qwen2MoeConfig(**small, intermediate_size=512,
                                num_experts=8, num_experts_per_tok=4,
                                moe_intermediate_size=256,
                                shared_expert_intermediate_size=512,
                                decoder_sparse_step=1, norm_topk_prob=False)
        model, convert = tf.Qwen2MoeForCausalLM(cfg), convert_qwen2moe_state_dict
    state = {k: v.numpy() for k, v in model.eval().float().state_dict().items()}
    convert(state, cfg, path, tokenizer_md=md)


def grok_f32(path: str) -> None:
    """tests/test_archs_r2.py's grok tensors at hidden 256 (8 experts of 256,
    top-2), drawn from numpy seed MOE_SEED["grok"]."""
    from koboldcpp_tpu.gguf import GGMLType, GGUFWriter

    from tests.test_model_forward import tiny_tokenizer_md

    V, C, H, KV, D, E, FE, L = 512, 256, 4, 2, 64, 8, 256, 2
    rng = np.random.default_rng(MOE_SEED["grok"])

    def w2(out, inp, s=0.05):
        return (rng.standard_normal((out, inp)) * s).astype(np.float32)

    def norm():
        return (rng.standard_normal(C) * 0.1).astype(np.float32) + 1.0

    t = {"token_embd.weight": w2(V, C, 0.02), "output_norm.weight": norm(),
         "output.weight": w2(V, C, 0.02)}
    for i in range(L):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = norm()
        t[p + "attn_output_norm.weight"] = norm()
        t[p + "ffn_norm.weight"] = norm()
        t[p + "layer_output_norm.weight"] = norm()
        t[p + "attn_q.weight"] = w2(H * D, C)
        t[p + "attn_k.weight"] = w2(KV * D, C)
        t[p + "attn_v.weight"] = w2(KV * D, C)
        t[p + "attn_output.weight"] = w2(C, H * D)
        t[p + "ffn_gate_inp.weight"] = w2(E, C)
        for name, shape in (("ffn_gate_exps", (E, FE, C)),
                            ("ffn_up_exps", (E, FE, C)),
                            ("ffn_down_exps", (E, C, FE))):
            t[p + name + ".weight"] = (rng.standard_normal(shape) * 0.05
                                       ).astype(np.float32)
    md = {"grok.context_length": np.uint32(128),
          "grok.embedding_length": np.uint32(C),
          "grok.block_count": np.uint32(L),
          "grok.feed_forward_length": np.uint32(FE),
          "grok.attention.head_count": np.uint32(H),
          "grok.attention.head_count_kv": np.uint32(KV),
          "grok.attention.key_length": np.uint32(D),
          "grok.attention.value_length": np.uint32(D),
          "grok.attention.layer_norm_rms_epsilon": np.float32(1e-5),
          "grok.rope.freq_base": np.float32(10000.0),
          "grok.rope.dimension_count": np.uint32(D),
          "grok.vocab_size": np.uint32(V),
          "grok.expert_count": np.uint32(E),
          "grok.expert_used_count": np.uint32(2)}
    w = GGUFWriter(path, architecture="grok")
    for k, v in {**md, **tiny_tokenizer_md(V)}.items():
        w.add(k, v)
    for name, arr in t.items():
        w.add_tensor(name, arr, GGMLType.F32)
    w.write()


def make_moe_fixtures(tokens: list[int]) -> None:
    for arch, name in MOE_FILES.items():
        src = os.path.join(OUT, f"_{arch}-f32.gguf")
        moe_f32(arch, src)
        path = os.path.join(OUT, name)
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "quantize.py"),
                        src, path, "q4_k_m"], check=True)
        os.remove(src)
        np.save(os.path.join(OUT, f"logits-jax-{arch}.npy"),
                jax_logits(path, tokens))
    manifest = {
        "tokens": tokens,
        "files": MOE_FILES,
        "made_by": {arch: f"tests/make_torch_fixtures.py --moe: the tiny "
                          f"{arch} model (seed {MOE_SEED[arch]}), then "
                          f"python tools/quantize.py <f32 file> "
                          f"tests/fixtures/portgguf/{name} q4_k_m"
                    for arch, name in MOE_FILES.items()},
        "logits": "logits-jax-<arch>.npy: the JAX package's forward "
                  "(koboldcpp_tpu.models.llama.forward, packed weights, f32 "
                  "cache, CPU) on `tokens` at positions 0..11, shape (12, "
                  "vocab) f32; the JAX package's numbers, not "
                  "reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "moe.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


def make_arch_fixtures(tokens: list[int]) -> None:
    for arch, name in ARCH_FILES.items():
        src = os.path.join(OUT, f"_{arch}-f32.gguf")
        arch_f32(arch, src)
        path = os.path.join(OUT, name)
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "quantize.py"),
                        src, path, "q4_k_m"], check=True)
        os.remove(src)
        np.save(os.path.join(OUT, f"logits-jax-{arch}.npy"),
                jax_logits(path, tokens))
    manifest = {
        "tokens": tokens,
        "files": ARCH_FILES,
        "made_by": {arch: f"tests/make_torch_fixtures.py --archs: the tiny "
                          f"transformers {arch} model (seed "
                          f"{ARCH_SEED[arch]}), tools/convert_hf.py, then "
                          f"python tools/quantize.py <f32 file> "
                          f"tests/fixtures/portgguf/{name} q4_k_m"
                    for arch, name in ARCH_FILES.items()},
        "logits": "logits-jax-<arch>.npy: the JAX package's forward "
                  "(koboldcpp_tpu.models.llama.forward, packed weights, f32 "
                  "cache, CPU) on `tokens` at positions 0..11, shape (12, "
                  "vocab) f32; the JAX package's numbers, not "
                  "reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "archs.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


def rwkv6_state(seed: int, C: int, H: int, F: int, V: int, L: int,
                E: int = 32, E2: int = 64, head_scale: float = 0.25) -> dict:
    """An RWKV6 state dict (RWKV-LM names) with RWKV-LM's initialisations:
    lerp ratios 1 - (i / C)^r, the decay ramp -6 + 5 (i / (C-1))^(0.7 +
    1.3 r) and the `time_faaaa` bonus, w1 / w2 / decay_w1 / decay_w2 small
    uniform, the projections normal of std 1 / sqrt(in), the head that
    times head_scale (logits of std ~0.25: at std 1 a bf16 step of a
    projection, carried by the recurrence, moved logits near 0.1 by 0.02,
    0.88 of the fixture tolerance on the CPU)."""
    rng = np.random.default_rng(seed)

    def mat(out, inp):
        return (rng.standard_normal((out, inp)) / np.sqrt(inp)).astype(
            np.float32)

    def vec(n, around_one=False):
        v = (rng.standard_normal(n) * 0.05).astype(np.float32)
        return v + 1.0 if around_one else v

    i = np.arange(C, dtype=np.float32)
    st = {"emb.weight": (rng.standard_normal((V, C)) * 0.1).astype(np.float32),
          "blocks.0.ln0.weight": vec(C, True), "blocks.0.ln0.bias": vec(C),
          "ln_out.weight": vec(C, True), "ln_out.bias": vec(C),
          "head.weight": mat(V, C) * head_scale}
    for li in range(L):
        p = f"blocks.{li}."
        r1 = 1.0 - li / max(L - 1, 1)   # ratio_1_to_almost0
        r0 = li / max(L - 1, 1)         # ratio_0_to_1
        ddd = i / C
        st |= {p + "ln1.weight": vec(C, True), p + "ln1.bias": vec(C),
               p + "ln2.weight": vec(C, True), p + "ln2.bias": vec(C)}
        for g, pw in zip("xwkvrg", (1.0, 1.0, 1.0, 1.0, 0.5, 0.5)):
            st[p + f"att.time_maa_{g}"] = (1.0 - ddd ** (pw * r1)).astype(
                np.float32)
        decay = -6 + 5 * (i / (C - 1)) ** (0.7 + 1.3 * r0)
        first = r1 * (1 - i / (C - 1)) + ((i + 1) % 3 - 1) * 0.1
        st |= {p + "att.time_maa_w1": rng.uniform(
                   -1e-4, 1e-4, (C, 5 * E)).astype(np.float32),
               p + "att.time_maa_w2": rng.uniform(
                   -1e-2, 1e-2, (5, E, C)).astype(np.float32),
               p + "att.time_decay": decay.astype(np.float32),
               p + "att.time_decay_w1": rng.uniform(
                   -1e-4, 1e-4, (C, E2)).astype(np.float32),
               p + "att.time_decay_w2": rng.uniform(
                   -1e-2, 1e-2, (E2, C)).astype(np.float32),
               p + "att.time_faaaa": first.reshape(H, C // H).astype(
                   np.float32),
               p + "att.key.weight": mat(C, C),
               p + "att.value.weight": mat(C, C),
               p + "att.receptance.weight": mat(C, C),
               p + "att.gate.weight": mat(C, C),
               p + "att.output.weight": mat(C, C),
               p + "att.ln_x.weight": vec(C, True),
               p + "att.ln_x.bias": vec(C),
               p + "ffn.time_maa_k": (1.0 - ddd ** r1).astype(np.float32),
               p + "ffn.time_maa_r": (1.0 - ddd ** r1).astype(np.float32),
               p + "ffn.key.weight": mat(F, C),
               p + "ffn.receptance.weight": mat(C, C),
               p + "ffn.value.weight": mat(C, F)}
    return st


def bert_family_tensors(arch: str, seed: int, C: int, H: int, D: int,
                        F: int, L: int, V: int) -> dict:
    """The f32 tensors of a nomic-bert (fused unbiased qkv, gated FFN) or
    jina-bert-v2 (biased q / k / v, a QK LayerNorm on layer 0, attn_norm_2
    on layer 1, gated FFN with a down bias) model, as
    tests/test_archs_r2.py writes its cases, at any width."""
    rng = np.random.default_rng(seed)

    def w2(out, inp, s=0.05):
        return (rng.standard_normal((out, inp)) * s).astype(np.float32)

    def w1(n, around_one=False):
        v = (rng.standard_normal(n) * 0.1).astype(np.float32)
        return v + 1.0 if around_one else v

    t = {"token_embd.weight": w2(V, C, 0.02),
         "token_types.weight": w2(2, C, 0.02),
         "token_embd_norm.weight": w1(C, True),
         "token_embd_norm.bias": w1(C)}
    for i in range(L):
        p = f"blk.{i}."
        if arch == "nomic-bert":
            t[p + "attn_qkv.weight"] = w2(3 * H * D, C)
        else:
            for nm in ("attn_q", "attn_k", "attn_v"):
                t[p + nm + ".weight"] = w2(H * D, C)
                t[p + nm + ".bias"] = w1(H * D)
            t[p + "attn_output.bias"] = w1(C)
            t[p + "ffn_down.bias"] = w1(C)
        t[p + "attn_output.weight"] = w2(C, H * D)
        t[p + "attn_output_norm.weight"] = w1(C, True)
        t[p + "attn_output_norm.bias"] = w1(C)
        t[p + "ffn_gate.weight"] = w2(F, C)
        t[p + "ffn_up.weight"] = w2(F, C)
        t[p + "ffn_down.weight"] = w2(C, F)
        t[p + "layer_output_norm.weight"] = w1(C, True)
        t[p + "layer_output_norm.bias"] = w1(C)
    if arch == "jina-bert-v2":
        for nm in ("attn_q_norm", "attn_k_norm"):
            t[f"blk.0.{nm}.weight"] = w1(H * D, True)
            t[f"blk.0.{nm}.bias"] = w1(H * D)
        t[f"blk.{L - 1}.attn_norm_2.weight"] = w1(C, True)
        t[f"blk.{L - 1}.attn_norm_2.bias"] = w1(C)
    return t


def write_bert_family(path: str, arch: str, tensors: dict, C: int, H: int,
                      D: int, F: int, L: int, V: int,
                      pooling: int = 1) -> None:
    """An f32 GGUF of `bert_family_tensors` with its keys (layer norms,
    NEOX rope at base 1000 for nomic-bert) and the toy tokenizer."""
    sys.path.insert(0, ROOT)
    from koboldcpp_tpu.gguf import GGMLType, GGUFWriter
    from tests.test_model_forward import tiny_tokenizer_md

    w = GGUFWriter(path, architecture=arch)
    for k, v in {"context_length": np.uint32(128),
                 "embedding_length": np.uint32(C),
                 "block_count": np.uint32(L),
                 "feed_forward_length": np.uint32(F),
                 "attention.head_count": np.uint32(H),
                 "attention.head_count_kv": np.uint32(H),
                 "attention.key_length": np.uint32(D),
                 "attention.value_length": np.uint32(D),
                 "attention.layer_norm_epsilon": np.float32(1e-5),
                 "rope.freq_base": np.float32(1000.0),
                 "rope.dimension_count": np.uint32(D),
                 "vocab_size": np.uint32(V),
                 "pooling_type": np.uint32(pooling)}.items():
        w.add(f"{arch}.{k}", v)
    for k, v in tiny_tokenizer_md(V).items():
        w.add(k, v)
    for name, arr in tensors.items():
        w.add_tensor(name, np.asarray(arr, np.float32), GGMLType.F32)
    w.write()


def write_byte_vocab(path: str, n: int) -> None:
    """A legacy RWKV vocab sidecar (rwkv_vocab.embd: one GPT-2-unicode
    line a token): <|endoftext|>, the 256 bytes, then tok{i} filler."""
    sys.path.insert(0, ROOT)
    from koboldcpp_tpu.gguf.legacy import _gpt2_byte_encoder

    enc = _gpt2_byte_encoder()
    words = [b"<|endoftext|>"] + [bytes([b]) for b in range(256)]
    words += [f"tok{i}".encode() for i in range(len(words), n)]
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join("".join(enc[b] for b in w) for w in words[:n]))


def text_f32(arch: str, path: str) -> None:
    """The text fixture model of `arch` (hidden 256, 2 layers, vocab 512)
    as an f32 GGUF (for rwkv4: the q8_0 legacy .bin itself)."""
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    import transformers as tf
    from convert_hf import (convert_mamba_state_dict,
                            convert_rwkv6_state_dict, convert_t5_state_dict)
    from convert_rwkv import convert_state_dict

    from tests.test_model_forward import tiny_tokenizer_md

    md = tiny_tokenizer_md(512)
    seed = TEXT_SEED[arch]
    torch.manual_seed(seed)
    if arch == "mamba":
        cfg = tf.MambaConfig(vocab_size=512, hidden_size=256, state_size=16,
                             num_hidden_layers=2, conv_kernel=4,
                             intermediate_size=512, time_step_rank=16,
                             use_cache=False, initializer_range=0.02)
        model = tf.MambaForCausalLM(cfg).eval().float()
        convert_mamba_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, cfg,
            path, tokenizer_md=md)
    elif arch == "rwkv6":
        cfg = dict(num_hidden_layers=2, hidden_size=256, head_size=64,
                   intermediate_size=512, vocab_size=512, rescale_every=6,
                   layer_norm_epsilon=1e-5)
        convert_rwkv6_state_dict(rwkv6_state(seed, 256, 4, 512, 512, 2),
                                 cfg, path, tokenizer_md=md)
    elif arch == "rwkv4":
        cfg = tf.RwkvConfig(vocab_size=512, hidden_size=256,
                            num_hidden_layers=2, attention_hidden_size=256,
                            intermediate_size=512, context_length=256,
                            use_cache=False)
        convert_state_dict(tf.RwkvForCausalLM(cfg).eval().float()
                           .state_dict(), path, dtype="f16", quant="q8_0")
        write_byte_vocab(os.path.join(os.path.dirname(path),
                                      "rwkv_vocab.embd"), 512)
    elif arch == "nomic-bert":
        write_bert_family(path, arch, bert_family_tensors(
            arch, seed, 256, 4, 64, 512, 2, 512), 256, 4, 64, 512, 2, 512)
    else:
        cfg = tf.T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=512,
                          num_layers=2, num_heads=4,
                          relative_attention_num_buckets=32,
                          relative_attention_max_distance=128,
                          feed_forward_proj="gated-gelu",
                          tie_word_embeddings=False,
                          decoder_start_token_id=0, pad_token_id=0,
                          eos_token_id=1, initializer_factor=0.2)
        model = tf.T5ForConditionalGeneration(cfg).eval().float()
        convert_t5_state_dict(
            {k: v.numpy() for k, v in model.state_dict().items()}, cfg,
            path, tokenizer_md=md)


def text_jax_numbers(arch: str, path: str, tokens: list[int]) -> np.ndarray:
    """The JAX package's numbers on a text fixture (packed weights, f32, on
    the CPU): logits (12, vocab) of mamba / rwkv6 / rwkv4 over `tokens`,
    nomic-bert's final hidden states (12, C), T5's decoder logits over
    [decoder start] + tokens[:11] with `tokens` through the encoder."""
    sys.path.insert(0, ROOT)
    import jax.numpy as jnp

    from koboldcpp_tpu.models import bert, mamba, rwkv4, rwkv6, t5
    from koboldcpp_tpu.models.loader import load_model

    m = load_model(path, packed=True, dtype=jnp.float32)
    toks = jnp.asarray([tokens], jnp.int32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    if arch == "nomic-bert":
        out = bert.forward_embed(m.params, m.cfg, toks, pos)
    elif arch == "t5":
        enc = t5.encode(m.params, m.cfg, toks, pos)
        cache = t5.prepare_cross(m.params, m.cfg, enc, pos >= 0,
                                 t5.init_cache(m.cfg, 1, 64, len(tokens)))
        dec = jnp.asarray([[m.cfg.extras["decoder_start"]] + tokens[:-1]],
                          jnp.int32)
        out, _ = t5.forward(m.params, m.cfg, dec, pos, cache)
    else:
        mod = {"mamba": mamba, "rwkv6": rwkv6, "rwkv4": rwkv4}[arch]
        out, _ = mod.forward(m.params, m.cfg, toks, pos,
                             mod.init_state(m.cfg, 1))
    return np.asarray(out, np.float32)[0]


def text_numbers_name(arch: str) -> str:
    return (f"embed-jax-{arch}.npy" if arch == "nomic-bert"
            else f"logits-jax-{arch}.npy")


def make_text_fixtures(tokens: list[int]) -> None:
    for arch, name in TEXT_FILES.items():
        path = os.path.join(OUT, name)
        if arch == "rwkv4":
            text_f32(arch, path)
        else:
            src = os.path.join(OUT, f"_{arch}-f32.gguf")
            text_f32(arch, src)
            subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                         "quantize.py"),
                            src, path, "q4_k_m"], check=True)
            os.remove(src)
        np.save(os.path.join(OUT, text_numbers_name(arch)),
                text_jax_numbers(arch, path, tokens))
    manifest = {
        "tokens": tokens,
        "files": TEXT_FILES,
        "made_by": {arch: f"tests/make_torch_fixtures.py --text: the tiny "
                          f"{arch} model (seed {TEXT_SEED[arch]}), then "
                          + ("tools/convert_rwkv.py --quant q8_0 with the "
                             "vocab sidecar rwkv_vocab.embd beside it"
                             if arch == "rwkv4" else
                             "tools/quantize.py's q4_k_m")
                          + f" into tests/fixtures/portgguf/{name}"
                    for arch, name in TEXT_FILES.items()},
        "numbers": {a: text_numbers_name(a) for a in TEXT_FILES},
        "logits": "the JAX package's numbers on the CPU (packed weights, "
                  "f32): logits-jax-<arch>.npy the forward's logits over "
                  "`tokens` at positions 0..11 (T5: the decoder over "
                  "[decoder start] + tokens[:11], the encoder over "
                  "`tokens`), shape (12, vocab); embed-jax-nomic-bert.npy "
                  "bert.forward_embed's final hidden states, shape (12, "
                  "256); not reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "text.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    tokens = json.load(open(os.path.join(REF, "manifest.json")))["tokens"]
    only = {"--archs", "--moe", "--late", "--text"} & set(sys.argv[1:])
    for flag, make in (("--archs", make_arch_fixtures),
                       ("--moe", make_moe_fixtures),
                       ("--late", make_late_fixtures),
                       ("--text", make_text_fixtures)):
        if not only or flag in only:
            make(tokens)
    if only:
        return 0
    src = os.path.join(REF, "tiny-f16.gguf")
    for fmt, name in FILES.items():
        path = os.path.join(OUT, name)
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "quantize.py"),
                        src, path, fmt], check=True)
        np.save(os.path.join(OUT, f"logits-jax-{fmt}.npy"),
                jax_logits(path, tokens))
    manifest = {
        "tokens": tokens,
        "files": FILES,
        "made_by": {fmt: f"python tools/quantize.py "
                         f"tests/fixtures/refgguf/tiny-f16.gguf "
                         f"tests/fixtures/portgguf/{name} {fmt}"
                    for fmt, name in FILES.items()},
        "logits": "logits-jax-<fmt>.npy: the JAX package's forward "
                  "(koboldcpp_tpu.models.llama.forward, packed weights, f32 "
                  "cache, CPU) on `tokens` at positions 0..11, shape (12, "
                  "vocab) f32; the JAX package's numbers, not "
                  "reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
