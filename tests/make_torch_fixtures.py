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

The logits are the JAX package's `forward` (packed weights, f32 cache and
activations, on the CPU) over the refgguf manifest's 12 tokens. They are
the JAX package's own numbers, not reference-runtime goldens.

Run from the repository root when the fixtures need regenerating (--archs:
the architecture fixtures only; --moe: the MoE fixtures only):

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py [--archs | --moe]
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


def jax_logits(path: str, tokens: list[int]) -> np.ndarray:
    """The JAX forward's f32 logits (T, vocab) for tokens at positions 0.."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from koboldcpp_tpu.kv.cache import init_cache
    from koboldcpp_tpu.models import llama
    from koboldcpp_tpu.models.loader import load_model

    m = load_model(path, packed=True, dtype=jnp.float32)
    cache = init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                       m.cfg.head_dim, dtype=jnp.float32)
    toks = jnp.asarray([tokens], jnp.int32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    fwd = jax.jit(lambda p, t, s, c: llama.forward(p, m.cfg, t, s, c))
    logits, _ = fwd(m.params, toks, pos, cache)
    return np.asarray(logits, np.float32)[0]


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


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    tokens = json.load(open(os.path.join(REF, "manifest.json")))["tokens"]
    if "--moe" not in sys.argv[1:]:
        make_arch_fixtures(tokens)
    if "--archs" not in sys.argv[1:]:
        make_moe_fixtures(tokens)
    if {"--archs", "--moe"} & set(sys.argv[1:]):
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
