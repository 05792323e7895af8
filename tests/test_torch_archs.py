"""The dense architecture branches of the port's `forward` held against the
JAX package's, on the CPU in f32.

Each case builds the tiny transformers model (2 layers, hidden 64, random
weights from a seed, no download) that tests/test_archs.py,
test_archs_layernorm.py, test_archs_batch2.py and test_archs_equiv.py
build, converted by the same tools/convert_hf.py converter, or the
hand-written GGUF of tests/test_archs_r2.py (refact, codeshell, exaone),
and feeds the same file and tokens to the JAX `forward` and the port's
`forward` (dense weights, f32 cache and activations): the logits agree
within 1e-4 (rtol and atol). Gemma-2 runs with a sliding window of 4 over
12 tokens, so its local layers see a window the causal mask does not.

Beyond `forward`: the port's `Engine` (a chunked prefill, then T = 1
decode steps) on gemma2, mpt and phi2 against the JAX `forward` over the
whole sequence, `forward_paged` on gemma2 and mpt, `forward_stacked` on
gemma2 against the JAX `forward_stacked`, which layers reach the decode
kernel (K5 on gemma2's global layers only, none under ALiBi), what
`check_supported` and `check_stacked_supported` refuse, the loader's new
tensors and `params_from_jax`, `synthetic_params` against the loader's
keys, the three served arch fixtures against their committed JAX logits,
and three faults of the reference: the JAX `forward_paged` and
`forward_stacked` depart from its own `forward` (no post-norms or window;
no layer norm or parallel residual), and its context shift rotates a
rope-less model's K. The last five dense branches (LATE: chameleon's swin
norm, and test_archs_r2.py's plamo, jais, bitnet and openelm GGUFs) run
the same cases, the JAX scan body's departures on them, and their Q4_K_M
fixtures (late.json) against the committed JAX logits.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koboldcpp_tpu.engine import engine as jengine
from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu_torch.engine import Engine
from koboldcpp_tpu_torch.engine import engine as tengine
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.kv.cache import init_cache, init_pool_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import config_from_metadata
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.models.synthetic import synthetic_params
from koboldcpp_tpu_torch.ops import rope as trope

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_hf as ch  # noqa: E402

from . import test_archs_r2 as r2  # noqa: E402
from .test_model_forward import tiny_tokenizer_md  # noqa: E402

TOKENS = [1, 5, 9, 42, 7, 300, 11, 250, 3, 77, 128, 400]
TOL = dict(rtol=1e-4, atol=1e-4)
PORT_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")


# ---------------------------------------------------------------------------
# the tiny models (the JAX tests' configs and seeds)
# ---------------------------------------------------------------------------

def _state(model_cls, cfg, seed):
    torch.manual_seed(seed)
    model = model_cls(cfg).eval().float()
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _hf(path, name):
    import transformers as tf

    md = tiny_tokenizer_md(512)
    small = dict(vocab_size=512, hidden_size=64, intermediate_size=128,
                 num_hidden_layers=2, num_attention_heads=4)
    if name in ("gemma", "gemma2"):
        if name == "gemma":
            cfg = tf.GemmaConfig(**small, num_key_value_heads=2, head_dim=16,
                                 max_position_embeddings=128)
            st = _state(tf.GemmaForCausalLM, cfg, 18)
        else:
            cfg = tf.Gemma2Config(**small, num_key_value_heads=2, head_dim=16,
                                  max_position_embeddings=128,
                                  query_pre_attn_scalar=16, sliding_window=4,
                                  attn_logit_softcapping=50.0,
                                  final_logit_softcapping=30.0)
            st = _state(tf.Gemma2ForCausalLM, cfg, 4)
        ch.convert_arch_state_dict(name, st, cfg, path, tokenizer_md=md)
    elif name == "qwen2":
        cfg = tf.Qwen2Config(**small, num_key_value_heads=2,
                             max_position_embeddings=128,
                             tie_word_embeddings=False)
        ch.convert_arch_state_dict("qwen2", _state(tf.Qwen2ForCausalLM, cfg, 3),
                                   cfg, path, tokenizer_md=md)
    elif name == "phi3":
        cfg = tf.Phi3Config(**small, num_key_value_heads=2,
                            max_position_embeddings=128,
                            tie_word_embeddings=False, pad_token_id=0)
        ch.convert_arch_state_dict("phi3", _state(tf.Phi3ForCausalLM, cfg, 5),
                                   cfg, path, tokenizer_md=md)
    elif name == "granite":
        cfg = tf.GraniteConfig(**small, num_key_value_heads=2,
                               max_position_embeddings=64,
                               embedding_multiplier=6.0,
                               attention_multiplier=0.08,
                               residual_multiplier=0.5, logits_scaling=4.0,
                               tie_word_embeddings=False)
        ch.convert_granite_state_dict(_state(tf.GraniteForCausalLM, cfg, 20),
                                      cfg, path, tokenizer_md=md)
    elif name == "gpt2":
        cfg = tf.GPT2Config(vocab_size=512, n_positions=64, n_embd=64,
                            n_layer=2, n_head=4)
        ch.convert_gpt2_state_dict(_state(tf.GPT2LMHeadModel, cfg, 6), cfg,
                                   path, tokenizer_md=md)
    elif name.startswith("gptneox"):
        cfg = tf.GPTNeoXConfig(**small, max_position_embeddings=64,
                               rotary_pct=0.25,
                               use_parallel_residual=name == "gptneox-par")
        ch.convert_gptneox_state_dict(_state(tf.GPTNeoXForCausalLM, cfg, 7),
                                      cfg, path, tokenizer_md=md)
    elif name == "falcon":
        cfg = tf.FalconConfig(vocab_size=512, hidden_size=64,
                              num_hidden_layers=2, num_attention_heads=4,
                              multi_query=True, parallel_attn=True,
                              new_decoder_architecture=False, bias=False,
                              max_position_embeddings=64, alibi=False)
        ch.convert_falcon_state_dict(_state(tf.FalconForCausalLM, cfg, 8),
                                     cfg, path, tokenizer_md=md)
    elif name == "stablelm":
        cfg = tf.StableLmConfig(**small, num_key_value_heads=2,
                                max_position_embeddings=64,
                                partial_rotary_factor=0.25)
        ch.convert_stablelm_state_dict(_state(tf.StableLmForCausalLM, cfg, 9),
                                       cfg, path, tokenizer_md=md)
    elif name == "phi2":
        cfg = tf.PhiConfig(**small, num_key_value_heads=4,
                           max_position_embeddings=64,
                           partial_rotary_factor=0.5)
        ch.convert_phi2_state_dict(_state(tf.PhiForCausalLM, cfg, 10), cfg,
                                   path, tokenizer_md=md)
    elif name == "olmo":
        cfg = tf.OlmoConfig(**small, num_key_value_heads=2,
                            max_position_embeddings=64,
                            tie_word_embeddings=False)
        ch.convert_olmo_state_dict(_state(tf.OlmoForCausalLM, cfg, 11), cfg,
                                   path, tokenizer_md=md)
    elif name == "mpt":
        cfg = tf.MptConfig(vocab_size=512, d_model=64, n_heads=4, n_layers=2,
                           max_seq_len=64, expansion_ratio=2,
                           attn_config={"clip_qkv": 0.05})
        ch.convert_mpt_state_dict(_state(tf.MptForCausalLM, cfg, 13), cfg,
                                  path, tokenizer_md=md)
    elif name == "command-r":
        cfg = tf.CohereConfig(**small, num_key_value_heads=2,
                              max_position_embeddings=64, logit_scale=0.25,
                              use_qk_norm=False, tie_word_embeddings=True)
        ch.convert_commandr_state_dict(_state(tf.CohereForCausalLM, cfg, 14),
                                       cfg, path, tokenizer_md=md)
    elif name == "starcoder2":
        cfg = tf.Starcoder2Config(**small, num_key_value_heads=2,
                                  max_position_embeddings=64, use_bias=True,
                                  tie_word_embeddings=False)
        ch.convert_starcoder2_state_dict(
            _state(tf.Starcoder2ForCausalLM, cfg, 15), cfg, path,
            tokenizer_md=md)
    elif name == "gptj":
        cfg = tf.GPTJConfig(vocab_size=512, n_positions=64, n_embd=64,
                            n_layer=2, n_head=4, rotary_dim=8)
        ch.convert_gptj_state_dict(_state(tf.GPTJForCausalLM, cfg, 17), cfg,
                                   path, tokenizer_md=md)
    elif name == "bloom":
        cfg = tf.BloomConfig(vocab_size=512, hidden_size=64, n_layer=2,
                             n_head=4, layer_norm_epsilon=1e-5,
                             tie_word_embeddings=False)
        ch.convert_bloom_state_dict(_state(tf.BloomForCausalLM, cfg, 31), cfg,
                                    path, tokenizer_md=md)
    elif name == "starcoder":
        cfg = tf.GPTBigCodeConfig(vocab_size=512, n_embd=64, n_layer=2,
                                  n_head=4, n_positions=128, multi_query=True,
                                  layer_norm_epsilon=1e-5,
                                  tie_word_embeddings=False,
                                  activation_function="gelu")
        ch.convert_starcoder_state_dict(
            _state(tf.GPTBigCodeForCausalLM, cfg, 32), cfg, path,
            tokenizer_md=md)
    elif name == "nemotron":
        cfg = tf.NemotronConfig(**small, num_key_value_heads=2,
                                max_position_embeddings=128, norm_eps=1e-5,
                                partial_rotary_factor=0.5,
                                tie_word_embeddings=False)
        ch.convert_nemotron_state_dict(
            _state(tf.NemotronForCausalLM, cfg, 33), cfg, path,
            tokenizer_md=md)
    elif name.startswith("chameleon"):
        vq = dict(embed_dim=32, num_embeddings=16, latent_channels=32,
                  base_channels=32, channel_multiplier=[1], num_res_blocks=1,
                  resolution=16, attn_resolutions=[])
        cfg = tf.ChameleonConfig(**small, num_key_value_heads=2,
                                 max_position_embeddings=128,
                                 swin_norm=name == "chameleon-swin",
                                 vq_config=vq, vocabulary_map={"<image>": 1},
                                 tie_word_embeddings=False)
        st = {k: v for k, v in _state(tf.ChameleonForConditionalGeneration,
                                      cfg, 34).items()
              if not k.startswith("model.vqmodel")}
        ch.convert_chameleon_state_dict(st, cfg, path, tokenizer_md=md)
    else:
        _llama_family(path, name, md)


def _llama_family(path, name, md):
    """test_archs_equiv.py's twins of one llama state (seed 51)."""
    import transformers as tf

    cfg = tf.LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=96,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=4, max_position_embeddings=128,
                         tie_word_embeddings=False)
    st = _state(tf.LlamaForCausalLM, cfg, 51)
    if name in ("baichuan", "xverse", "minicpm"):
        ch.convert_llama_like_state_dict(name, st, cfg, path, tokenizer_md=md)
    elif name == "orion":
        rng = np.random.default_rng(5)
        st = dict(st)
        for i in range(2):
            for n in ("input_layernorm", "post_attention_layernorm"):
                st[f"model.layers.{i}.{n}.bias"] = (
                    rng.standard_normal(64).astype(np.float32) * 0.1)
        st["model.norm.bias"] = rng.standard_normal(64).astype(np.float32) * 0.1
        ch.convert_llama_like_state_dict("orion", st, cfg, path,
                                         tokenizer_md=md, norm_bias=True)
    elif name == "internlm2":
        D, E = 16, 64
        il2 = {"model.tok_embeddings.weight": st["model.embed_tokens.weight"],
               "model.norm.weight": st["model.norm.weight"],
               "output.weight": st["lm_head.weight"]}
        for i in range(2):
            hp = f"model.layers.{i}."
            il2[hp + "attention_norm.weight"] = st[hp + "input_layernorm.weight"]
            il2[hp + "ffn_norm.weight"] = st[hp + "post_attention_layernorm.weight"]
            q, k, v = (st[hp + f"self_attn.{n}_proj.weight"].reshape(4, 1, D, E)
                       for n in "qkv")
            il2[hp + "attention.wqkv.weight"] = np.concatenate(
                [q, k, v], axis=1).reshape(-1, E)
            il2[hp + "attention.wo.weight"] = st[hp + "self_attn.o_proj.weight"]
            for w, n in (("w1", "gate"), ("w3", "up"), ("w2", "down")):
                il2[hp + f"feed_forward.{w}.weight"] = st[hp + f"mlp.{n}_proj.weight"]
        ch.convert_internlm2_state_dict(il2, cfg, path, tokenizer_md=md)
    elif name == "qwen":
        v1 = {"transformer.wte.weight": st["model.embed_tokens.weight"],
              "transformer.ln_f.weight": st["model.norm.weight"],
              "lm_head.weight": st["lm_head.weight"]}
        rng = np.random.default_rng(52)
        for i in range(2):
            hp, vp = f"model.layers.{i}.", f"transformer.h.{i}."
            v1[vp + "ln_1.weight"] = st[hp + "input_layernorm.weight"]
            v1[vp + "ln_2.weight"] = st[hp + "post_attention_layernorm.weight"]
            v1[vp + "attn.c_attn.weight"] = np.concatenate(
                [st[hp + f"self_attn.{n}_proj.weight"] for n in "qkv"], axis=0)
            v1[vp + "attn.c_attn.bias"] = (
                rng.standard_normal(192).astype(np.float32) * 0.02)
            v1[vp + "attn.c_proj.weight"] = st[hp + "self_attn.o_proj.weight"]
            v1[vp + "mlp.w2.weight"] = st[hp + "mlp.gate_proj.weight"]
            v1[vp + "mlp.w1.weight"] = st[hp + "mlp.up_proj.weight"]
            v1[vp + "mlp.c_proj.weight"] = st[hp + "mlp.down_proj.weight"]
        ch.convert_qwen_state_dict(v1, cfg, path, tokenizer_md=md)
    else:
        raise KeyError(name)


def _r2(path, name):
    """test_archs_r2.py's hand-written GGUFs of exaone, refact, codeshell
    (the same tensors from the same seeds)."""
    V, C, H, KV, D, F, L = r2.V, r2.C, r2.H, r2.KV, r2.D, r2.F, r2.L
    seed = {"exaone": 101, "refact": 102, "codeshell": 104}[name]
    rng = r2.rng_weights(seed)
    t = {"token_embd.weight": r2.w2(rng, V, C, 0.02),
         "output_norm.weight": r2.w1(rng, C, True)}
    if name == "codeshell":
        t["output_norm.bias"] = r2.w1(rng, C)
    t["output.weight"] = r2.w2(rng, V, C, 0.02)
    for i in range(L):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = r2.w1(rng, C, True)
        if name != "codeshell":
            t[p + "ffn_norm.weight"] = r2.w1(rng, C, True)
            r2._std_attn_tensors(rng, t, i)
            r2._gated_ffn_tensors(rng, t, i)
            continue
        t[p + "attn_norm.bias"] = r2.w1(rng, C)
        t[p + "attn_qkv.weight"] = r2.w2(rng, (H + 2 * KV) * D, C)
        t[p + "attn_qkv.bias"] = r2.w1(rng, (H + 2 * KV) * D)
        t[p + "attn_output.weight"] = r2.w2(rng, C, H * D)
        t[p + "attn_output.bias"] = r2.w1(rng, C)
        t[p + "ffn_norm.weight"] = r2.w1(rng, C, True)
        t[p + "ffn_norm.bias"] = r2.w1(rng, C)
        t[p + "ffn_up.weight"] = r2.w2(rng, F, C)
        t[p + "ffn_up.bias"] = r2.w1(rng, F)
        t[p + "ffn_down.weight"] = r2.w2(rng, C, F)
        t[p + "ffn_down.bias"] = r2.w1(rng, C)
    r2.write_gguf(path, name, r2.base_md(name, rms=name != "codeshell"), t)


def _r2_late(path, name):
    """test_archs_r2.py's hand-written GGUFs of plamo, jais, bitnet and
    openelm (the same tensors, drawn in the same order from the same
    seeds)."""
    V, C, H, KV, D, F, L = r2.V, r2.C, r2.H, r2.KV, r2.D, r2.F, r2.L
    w1, w2 = r2.w1, r2.w2
    rng = r2.rng_weights({"plamo": 103, "jais": 106, "bitnet": 107,
                          "openelm": 110}[name])
    t = {"token_embd.weight": w2(rng, V, C, 0.02),
         "output_norm.weight": w1(rng, C, True)}
    if name == "jais":
        t["output_norm.bias"] = w1(rng, C)
    if name in ("plamo", "jais"):
        t["output.weight"] = w2(rng, V, C, 0.02)
    md = r2.base_md(name, rms=name != "jais")
    heads, kv_heads, ffs = [4, 2], [2, 1], [96, 64]  # openelm's per layer
    for i in range(L):
        p = f"blk.{i}."
        if name == "openelm":
            nh, nkv, ff = heads[i], kv_heads[i], ffs[i]
            t[p + "attn_norm.weight"] = w1(rng, C, True)
            t[p + "attn_qkv.weight"] = w2(rng, (nh + 2 * nkv) * D, C)
            t[p + "attn_q_norm.weight"] = w1(rng, D, True)
            t[p + "attn_k_norm.weight"] = w1(rng, D, True)
            t[p + "attn_output.weight"] = w2(rng, C, nh * D)
            t[p + "ffn_norm.weight"] = w1(rng, C, True)
            t[p + "ffn_gate.weight"] = w2(rng, ff, C)
            t[p + "ffn_up.weight"] = w2(rng, ff, C)
            t[p + "ffn_down.weight"] = w2(rng, C, ff)
        elif name == "plamo":
            t[p + "attn_norm.weight"] = w1(rng, C, True)
            r2._std_attn_tensors(rng, t, i)
            r2._gated_ffn_tensors(rng, t, i)
        elif name == "jais":
            t[p + "attn_norm.weight"] = w1(rng, C, True)
            t[p + "attn_norm.bias"] = w1(rng, C)
            t[p + "attn_qkv.weight"] = w2(rng, (H + 2 * KV) * D, C)
            t[p + "attn_qkv.bias"] = w1(rng, (H + 2 * KV) * D)
            t[p + "attn_output.weight"] = w2(rng, C, H * D)
            t[p + "attn_output.bias"] = w1(rng, C)
            t[p + "ffn_norm.weight"] = w1(rng, C, True)
            t[p + "ffn_norm.bias"] = w1(rng, C)
            for nm in ("ffn_gate", "ffn_up"):
                t[p + nm + ".weight"] = w2(rng, F, C)
                t[p + nm + ".bias"] = w1(rng, F)
            t[p + "ffn_down.weight"] = w2(rng, C, F)
            t[p + "ffn_down.bias"] = w1(rng, C)
        else:  # bitnet
            t[p + "attn_norm.weight"] = w1(rng, C, True)
            t[p + "attn_sub_norm.weight"] = w1(rng, H * D, True)
            r2._std_attn_tensors(rng, t, i)
            for nm in ("attn_q", "attn_k", "attn_v", "attn_output"):
                t[p + nm + ".scale"] = np.array(
                    [1.0 + 0.2 * rng.standard_normal()], np.float32)
            t[p + "ffn_norm.weight"] = w1(rng, C, True)
            t[p + "ffn_sub_norm.weight"] = w1(rng, F, True)
            r2._gated_ffn_tensors(rng, t, i)
            for nm in ("ffn_gate", "ffn_up", "ffn_down"):
                t[p + nm + ".scale"] = np.array(
                    [1.0 + 0.2 * rng.standard_normal()], np.float32)
    if name == "jais":
        md["jais.attention.max_alibi_bias"] = np.float32(8.0)
    if name == "openelm":
        md["openelm.attention.head_count"] = np.array(heads, np.uint32)
        md["openelm.attention.head_count_kv"] = np.array(kv_heads, np.uint32)
        md["openelm.feed_forward_length"] = np.array(ffs, np.uint32)
    r2.write_gguf(path, name, md, t)


# the models the dense branches admit, then the ones admitted before
# them (plain llama-like graphs)
NEW = ["gemma", "gemma2", "gpt2", "starcoder", "gptneox-par", "gptneox-seq",
       "gptj", "falcon", "phi2", "nemotron", "command-r", "mpt", "bloom",
       "olmo", "starcoder2", "chameleon", "refact", "codeshell"]
OLD = ["qwen2", "phi3", "granite", "stablelm", "baichuan", "xverse",
       "minicpm", "qwen", "orion", "internlm2", "exaone"]
# the last dense branches of the JAX forward
LATE = ["chameleon-swin", "plamo", "jais", "bitnet", "openelm"]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """name -> the tiny model's GGUF path, built on first use."""
    d = tmp_path_factory.mktemp("archs")
    made: dict = {}

    def get(name):
        if name not in made:
            path = str(d / f"{name}.gguf")
            if name in ("exaone", "refact", "codeshell"):
                _r2(path, name)
            elif name in ("plamo", "jais", "bitnet", "openelm"):
                _r2_late(path, name)
            else:
                _hf(path, name)
            made[name] = path
        return made[name]
    return get


def _jax(path, tokens=TOKENS, S=32):
    m = j_load_model(path, packed=False, dtype=jnp.float32)
    cache = j_init_cache(m.cfg.n_layers, 1, S, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=jnp.float32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    logits, _ = jllama.forward(m.params, m.cfg, jnp.asarray([tokens],
                                                            jnp.int32),
                               pos, cache)
    return m, np.asarray(logits)[0]


def _port_model(path):
    return load_model(path, packed=False, dtype=torch.float32, device="cpu")


def _port(m, tokens=TOKENS, S=32):
    cache = init_cache(m.cfg.n_layers, 1, S, m.cfg.n_kv_heads,
                       m.cfg.head_dim, dtype=torch.float32)
    with torch.inference_mode():
        logits, _ = tllama.forward(m.params, m.cfg, torch.tensor([tokens]),
                                   torch.arange(len(tokens))[None], cache)
    return logits[0].numpy()


@pytest.mark.parametrize("name", NEW + OLD + LATE)
def test_forward_matches_jax(gguf, name):
    """check_supported admits the model, and the port's forward over the 12
    tokens equals the JAX forward's within 1e-4."""
    path = gguf(name)
    jm, want = _jax(path)
    tm = _port_model(path)
    # the same config_from_metadata
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    np.testing.assert_allclose(_port(tm), want, **TOL)


def test_learned_positions_past_the_table(gguf):
    """gpt2's position table has 64 rows; at positions 60..67 the JAX
    gather clamps the index to the last row, and so does the port (where
    a plain index would raise), within 1e-4."""
    path = gguf("gpt2")
    jm = j_load_model(path, packed=False, dtype=jnp.float32)
    pos = np.arange(60, 68, dtype=np.int32)[None]
    jcache = j_init_cache(2, 1, 72, jm.cfg.n_kv_heads, jm.cfg.head_dim,
                          dtype=jnp.float32)
    want, _ = jllama.forward(jm.params, jm.cfg,
                             jnp.asarray([TOKENS[:8]], jnp.int32),
                             jnp.asarray(pos), jcache)
    tm = _port_model(path)
    assert tm.params["pos_embd"].shape[0] == 64
    cache = init_cache(2, 1, 72, tm.cfg.n_kv_heads, tm.cfg.head_dim,
                       dtype=torch.float32)
    with torch.inference_mode():
        got, _ = tllama.forward(tm.params, tm.cfg, torch.tensor([TOKENS[:8]]),
                                torch.from_numpy(pos).long(), cache)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want)[0], **TOL)


def _branches(cfg, params):
    """Which of the dense branches a loaded model takes (for the
    coverage assertion below)."""
    layer = params["layers"][0]
    out = {cfg.act if cfg.ffn_gated else f"{cfg.act} non-gated"}
    for hit, what in ((cfg.parallel_residual, "parallel residual"),
                      (cfg.use_alibi, "alibi"), (cfg.clamp_kqv > 0, "clamp"),
                      ("pos_embd" in params, "learned positions"),
                      ("tok_norm" in params, "embedding norm"),
                      ("attn_q_norm_bias" in layer, "per-head QK norm"),
                      (not cfg.use_rope, "rope-less"),
                      (cfg.sliding_window_pattern == 2, "window pattern"),
                      ("b_up" in layer, "ffn biases"),
                      ("attn_post_norm" in layer, "post-norms")):
        if hit:
            out.add(what)
    return out


def test_the_new_cases_cover_every_branch(gguf):
    """The models of NEW take every dense branch of the forward."""
    seen = set()
    for name in NEW:
        m = j_load_model(gguf(name), packed=False, dtype=jnp.float32)
        seen |= _branches(m.cfg, m.params)
    assert {"gelu", "gelu non-gated", "gelu_exact non-gated",
            "relu2 non-gated", "silu", "parallel residual", "alibi", "clamp",
            "learned positions", "embedding norm", "per-head QK norm",
            "rope-less", "window pattern", "ffn biases",
            "post-norms"} <= seen


# ---------------------------------------------------------------------------
# the engines and the other forwards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["gemma2", "mpt", "phi2", "openelm",
                                  "bitnet"])
def test_engine_prefill_then_decode(gguf, name):
    """The port's Engine on the CPU: a prefill in two chunks (4 tokens, then
    3 at position 4) and 5 greedy T = 1 steps through `_forward` over an
    f32 cache. Every step's logits are within 1e-4 of the JAX forward's
    over the whole 12-token sequence at that position, and its argmax is
    the JAX argmax there, so JAX greedy decoding picks the same tokens
    (gemma2's window of 4 is passed from position 4 on)."""
    path = gguf(name)
    tm = _port_model(path)
    eng = Engine(tm, max_context=32, device="cpu")
    eng.cache = init_cache(tm.cfg.n_layers, 1, 32, tm.cfg.n_kv_heads,
                           tm.cfg.head_dim, dtype=torch.float32)
    seq = TOKENS[:7]
    with torch.inference_mode():
        rows = [eng._eval_chunk(seq[:4], 0), eng._eval_chunk(seq[4:], 4)]
        for _ in range(5):
            seq.append(int(torch.argmax(rows[-1])))
            rows.append(eng._forward(torch.tensor([[seq[-1]]]),
                                     torch.tensor([[len(seq) - 1]]),
                                     last_only=True)[0, -1])
    _, want = _jax(path, seq)
    got = torch.stack(rows).numpy()
    at = [3] + list(range(6, 12))
    np.testing.assert_allclose(got, want[at], **TOL)
    assert [int(np.argmax(w)) for w in want[6:11]] == seq[7:]


def _f32_pool(cfg, n_pages, P):
    kd = cfg.n_kv_heads * cfg.head_dim
    z = [torch.zeros(n_pages * P, kd) for _ in range(2 * cfg.n_layers)]
    return tpaged.PagedKVCache(k=z[:cfg.n_layers], v=z[cfg.n_layers:],
                               page_size=P, heads=cfg.n_kv_heads)


@pytest.mark.parametrize("name", ["gemma2", "mpt"] + LATE)
def test_forward_paged_matches_jax_forward(gguf, name):
    """forward_paged over an f32 pool of 4-row pages (a shuffled table): a
    7-token chunk, then five T = 1 steps, each step's logits within 1e-4 of
    the JAX `forward`'s over the whole sequence (openelm's narrower layer
    writes its K / V padded to the pool's kv heads and reads its own)."""
    path = gguf(name)
    tm = _port_model(path)
    pool = _f32_pool(tm.cfg, 6, 4)
    table = torch.tensor([[4, 1, 5, 0]])
    seq = list(TOKENS)
    rows = []
    with torch.inference_mode():
        lg, _ = tllama.forward_paged(tm.params, tm.cfg, torch.tensor([seq[:7]]),
                                     torch.arange(7)[None], pool, table)
        rows += list(lg[0])
        for p in range(7, 12):
            lg, _ = tllama.forward_paged(tm.params, tm.cfg,
                                         torch.tensor([[seq[p]]]),
                                         torch.tensor([[p]]), pool, table)
            rows.append(lg[0, 0])
    _, want = _jax(path)
    np.testing.assert_allclose(torch.stack(rows).numpy(), want, **TOL)


def test_jax_forward_paged_departs_on_gemma2(gguf):
    """A fault of the reference: the JAX `forward_paged` drops gemma2's
    sandwich norms and its sliding window, so its logits depart from the
    JAX `forward`'s on the same file and tokens by far more than its bf16
    pool could (the port's forward_paged shares the forward's layer body;
    see the test above). The measured departure is written into the
    assertion message."""
    path = gguf("gemma2")
    jm, want = _jax(path)
    pool = jpaged.init_paged_cache(jm.cfg.n_layers, 6, 4, jm.cfg.n_kv_heads,
                                   jm.cfg.head_dim)
    got, _ = jllama.forward_paged(jm.params, jm.cfg,
                                  jnp.asarray([TOKENS], jnp.int32),
                                  jnp.arange(12, dtype=jnp.int32)[None], pool,
                                  jnp.asarray([[4, 1, 5, 0]], jnp.int32))
    err = float(np.abs(np.asarray(got)[0] - want).max())
    assert err > 0.1 * float(np.abs(want).max()), err


def test_forward_stacked_matches_jax_on_gemma2(gguf):
    """forward_stacked on gemma2 (post-norms, sliding window with its layer
    pattern, gelu, softcaps) against the JAX forward_stacked on the same
    stacked params: the 12 tokens as one chunk over a per-layer f32 cache,
    then a pooled cache with a 7-token chunk and five T = 1 steps (the
    rows kernel is off under a sliding window, in both packages); both
    also equal the port's forward."""
    path = gguf("gemma2")
    jm, want = _jax(path)
    jst = jllama.stack_layers(jm.params)
    jcache = j_init_cache(2, 1, 32, jm.cfg.n_kv_heads, jm.cfg.head_dim,
                          dtype=jnp.float32)
    jl, _ = jllama.forward_stacked(jst, jm.cfg, jnp.asarray([TOKENS],
                                                            jnp.int32),
                                   jnp.arange(12, dtype=jnp.int32)[None],
                                   jcache)
    tm = _port_model(path)
    tst = tllama.stack_layers(tm.params)
    assert "layers_stacked" in tst
    cache = init_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim,
                       dtype=torch.float32)
    pool = init_pool_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim,
                           dtype=torch.float32)
    with torch.inference_mode():
        tl, _ = tllama.forward_stacked(tst, tm.cfg, torch.tensor([TOKENS]),
                                       torch.arange(12)[None], cache)
        rows = list(tllama.forward_stacked(tst, tm.cfg,
                                           torch.tensor([TOKENS[:7]]),
                                           torch.arange(7)[None], pool)[0][0])
        for p in range(7, 12):
            rows.append(tllama.forward_stacked(
                tst, tm.cfg, torch.tensor([[TOKENS[p]]]),
                torch.tensor([[p]]), pool)[0][0, 0])
    np.testing.assert_allclose(tl[0].numpy(), np.asarray(jl)[0], **TOL)
    np.testing.assert_allclose(torch.stack(rows).numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["command-r", "olmo"])
def test_jax_forward_stacked_departs_on_layer_norm(gguf, name):
    """A fault of the reference: the JAX scan body takes RMS norms and a
    sequential residual whatever the config says, so on a layer-norm model
    (command-r: with parallel residual too) its logits depart from its own
    forward's; the port's forward_stacked refuses the model, naming layer
    norm. (On a non-gated FFN, phi2 or gpt-neox, the JAX scan body raises
    KeyError: 'w_gate'.)"""
    path = gguf(name)
    jm, want = _jax(path)
    jst = jllama.stack_layers(jm.params)
    jcache = j_init_cache(2, 1, 32, jm.cfg.n_kv_heads, jm.cfg.head_dim,
                          dtype=jnp.float32)
    jl, _ = jllama.forward_stacked(jst, jm.cfg, jnp.asarray([TOKENS],
                                                            jnp.int32),
                                   jnp.arange(12, dtype=jnp.int32)[None],
                                   jcache)
    err = float(np.abs(np.asarray(jl)[0] - want).max())
    assert err > 0.1 * float(np.abs(want).max()), err
    tm = _port_model(path)
    cache = init_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    with pytest.raises(NotImplementedError, match="layer norm"):
        tllama.forward_stacked(tllama.stack_layers(tm.params), tm.cfg,
                               torch.tensor([TOKENS]),
                               torch.arange(12)[None], cache)


@pytest.mark.parametrize("name", LATE)
def test_forward_stacked_refuses_the_late_branches(gguf, name):
    """The JAX scan body computes another function than its forward on
    each of the five (a fault of the reference): chameleon's swin norm, the
    per-head QK-norm and bitnet's attention sub-norm and scales are dropped
    and jais's layer norm, biases and ALiBi taken as RMS / none, so the
    logits depart; plamo's missing `ffn_norm` raises KeyError, and
    openelm's layers do not stack (KeyError 'layers_stacked'). The port
    refuses each, naming the branch."""
    path = gguf(name)
    jm, want = _jax(path)
    jst = jllama.stack_layers(jm.params)
    jcache = j_init_cache(2, 1, 32, jm.cfg.n_kv_heads, jm.cfg.head_dim,
                          dtype=jnp.float32)
    if name in ("plamo", "openelm"):
        with pytest.raises(KeyError):
            jllama.forward_stacked(jst, jm.cfg, jnp.asarray([TOKENS],
                                                            jnp.int32),
                                   jnp.arange(12, dtype=jnp.int32)[None],
                                   jcache)
    else:
        jl, _ = jllama.forward_stacked(jst, jm.cfg,
                                       jnp.asarray([TOKENS], jnp.int32),
                                       jnp.arange(12, dtype=jnp.int32)[None],
                                       jcache)
        err = float(np.abs(np.asarray(jl)[0] - want).max())
        assert err > 0.1 * float(np.abs(want).max()), err
    tm = _port_model(path)
    cache = init_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    match = {"chameleon-swin": "swin norm", "plamo": "plamo",
             "jais": "bias", "bitnet": "bitnet",
             "openelm": "openelm"}[name]
    with pytest.raises(NotImplementedError, match=match):
        tllama.forward_stacked(tllama.stack_layers(tm.params), tm.cfg,
                               torch.tensor([TOKENS]),
                               torch.arange(12)[None], cache)


STACKED_REFUSALS = {
    "a non-gated FFN": dict(ffn_gated=False),
    "parallel residual": dict(parallel_residual=True),
    "ALiBi": dict(use_alibi=True),
    "learned positions": dict(learned_pos=True),
    "clamp_kqv": dict(clamp_kqv=8.0),
    "QK-norm": None,
    "rope-less": dict(use_rope=False),
}


@pytest.mark.parametrize("why", list(STACKED_REFUSALS))
def test_forward_stacked_refuses_what_the_scan_body_drops(gguf, why):
    """Each branch the JAX scan body computes another function for raises
    NotImplementedError naming it, on gemma2's stacked params with that
    branch switched on."""
    tm = _port_model(gguf("gemma2"))
    params = dict(tm.params)
    change = STACKED_REFUSALS[why]
    cfg = tm.cfg if change is None else dataclasses.replace(tm.cfg, **change)
    if why == "learned positions":
        params["pos_embd"] = torch.zeros(64, 64)
    st = tllama.stack_layers(params)
    if why == "QK-norm":
        st["layers_stacked"]["attn_q_norm"] = torch.ones(2, 64)
    cache = init_cache(2, 1, 32, cfg.n_kv_heads, cfg.head_dim)
    tllama.check_supported(st, cfg)  # forward serves it
    with pytest.raises(NotImplementedError, match=why):
        tllama.check_stacked_supported(st, cfg, cache)


def _md(arch, **extra):
    md = {"general.architecture": arch, f"{arch}.embedding_length": 64,
          f"{arch}.attention.head_count": 4, f"{arch}.block_count": 2}
    md.update({k.format(arch=arch): v for k, v in extra.items()})
    return md


REFUSED = {
    "swin norm": (_md("chameleon", **{"{arch}.swin_norm": True}), {}),
    "openelm": (_md("openelm", **{"{arch}.attention.head_count": [4, 4],
                                  "{arch}.attention.head_count_kv": [2, 2]}),
                {}),
    "plamo": (_md("plamo"), {}),
    "bitnet": (_md("bitnet"), {}),
    "jais": (_md("jais"), {}),
    "MoE": (_md("qwen2moe", **{"{arch}.expert_count": 4}), {}),
    "arctic's residual MoE": (_md("arctic"), {"ffn_norm_exps": None}),
}


# every case was refused by name until its branch was ported; each is now
# admitted: the MoE ones held to the JAX forward in tests/test_torch_moe.py,
# the five others in test_forward_matches_jax (LATE)
ADMITTED = tuple(REFUSED)
# what config_from_metadata gives each of the five, which the forward reads
LATE_FLAGS = {"swin norm": lambda c: c.extras["swin_norm"],
              "openelm": lambda c: (c.extras["head_counts"] == [4, 4]
                                    and c.extras["qk_head_rms"]
                                    and c.n_kv_heads == 2),
              "plamo": lambda c: c.extras["plamo_parallel"],
              "bitnet": lambda c: c.extras["bitnet"],
              "jais": lambda c: (c.use_alibi and c.norm_type == "layer"
                                 and c.attn_scale == 1 / 16)}


@pytest.mark.parametrize("why", list(REFUSED))
def test_check_supported_refuses_by_name(why):
    """The branches once refused by name are admitted: a MoE config,
    arctic's residual MoE layer, and (since the last dense branches were
    ported) swin norm, openelm, plamo, bitnet and jais, each with the
    config flags its branch of the forward reads."""
    md, layer = REFUSED[why]
    cfg = config_from_metadata(md)
    assert why in ADMITTED
    if why in LATE_FLAGS:
        assert LATE_FLAGS[why](cfg)
    else:
        assert cfg.n_experts == 4 or "ffn_norm_exps" in layer
    tllama.check_supported({"layers": [layer]}, cfg)
    tllama.check_supported({"layers": [layer]}, cfg, "cuda")


def _kernel_cfg(arch, **extra):
    """A config from `arch`'s GGUF keys at a head shape the decode kernels
    take (2 kv heads of 64: Hkv * D = 128)."""
    return config_from_metadata(_md(arch, **{
        "{arch}.embedding_length": 256, "{arch}.attention.head_count_kv": 2,
        "{arch}.attention.key_length": 64, "{arch}.feed_forward_length": 512,
        "{arch}.context_length": 64, "{arch}.vocab_size": 512, **extra}))


def test_decode_kernel_only_on_global_layers(monkeypatch):
    """The layers that reach K5's wrapper at T = 1 (synthetic weights at a
    head shape K5 takes): gemma2's global (odd) layers only, as JAX's
    `use_flash_dec`; none under ALiBi (mpt); every layer of gemma; and with
    flash_prefill set, K4's wrapper on no layer under gemma2's softcap or
    mpt's ALiBi and on every layer of gemma (no softcap, no window)."""
    calls = []
    real5, real4 = (tllama.flash_decode.decode_attention_batched,
                    tllama.flash_prefill_attention)

    def k5(*a, **kw):
        calls.append("K5")
        return real5(*a, **kw)

    def k4(*a, **kw):
        calls.append("K4")
        return real4(*a, **kw)

    monkeypatch.setattr(tllama.flash_decode, "decode_attention_batched", k5)
    monkeypatch.setattr(tllama, "flash_prefill_attention", k4)
    gemma2 = {"{arch}.attention.sliding_window": 4,
              "{arch}.attn_logit_softcapping": 50.0,
              "{arch}.block_count": 4}
    for cfg, want_dec, want_pre in ((_kernel_cfg("gemma2", **gemma2), 2, 0),
                                    (_kernel_cfg("mpt"), 0, 0),
                                    (_kernel_cfg("gemma"), 2, 2)):
        params = synthetic_params(cfg, "dense", device="cpu")
        cache = init_cache(cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim)
        with torch.inference_mode():
            calls.clear()
            tllama.forward(params, cfg, torch.tensor([TOKENS[:6]]),
                           torch.arange(6)[None], cache, flash_prefill=True)
            assert calls.count("K4") == want_pre, cfg.arch
            calls.clear()
            tllama.forward(params, cfg, torch.tensor([[5]]),
                           torch.tensor([[6]]), cache)
            assert calls.count("K5") == want_dec, cfg.arch


def test_flash_prefill_rows_equal_plain(gguf):
    """A chunk from position 0 padded at its end (the engine's flash
    prefill layout) gives the unpadded chunk's logits on gemma2 (plain
    attention on every layer: softcap) and gemma (K4's plain version)."""
    for name in ("gemma2", "gemma"):
        tm = _port_model(gguf(name))
        want = _port(tm, TOKENS[:9])
        cache = init_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim,
                           dtype=torch.float32)
        with torch.inference_mode():
            got, _ = tllama.forward(tm.params, tm.cfg,
                                    torch.tensor([TOKENS[:9] + [0] * 7]),
                                    torch.tensor([list(range(9)) + [-1] * 7]),
                                    cache, flash_prefill=True)
        np.testing.assert_allclose(got[0, :9].numpy(), want, **TOL)


def test_context_shift_moves_ropeless_rows_only():
    """A fault of the reference: the JAX `_shift_rows` re-rotates the moved
    K rows by RoPE whatever `cfg.use_rope` says, so on an ALiBi or learned-
    position model (whose K was never rotated) it changes them; the port
    moves them only (the upstream K-shift skips a model without rope), and
    still equals JAX where the model has rope."""
    rng = np.random.default_rng(7)
    k = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((1, 16, 2, 8)).astype(np.float32)
    cfg = config_from_metadata(_md("mpt", **{"{arch}.attention.head_count": 2}))
    assert not cfg.use_rope
    freqs = trope.rope_frequencies(dataclasses.replace(cfg, rope_dim=8))
    gk, gv = tengine._shift_rows(torch.from_numpy(k), torch.from_numpy(v), 3,
                                 7, freqs, cfg.rope_type, 8, cfg.use_rope)
    moved = np.concatenate([k[:, :3], k[:, 7:], np.repeat(k[:, -1:], 4, 1)], 1)
    np.testing.assert_array_equal(gk.numpy(), moved)
    np.testing.assert_array_equal(gv.numpy(), np.concatenate(
        [v[:, :3], v[:, 7:], np.repeat(v[:, -1:], 4, 1)], 1))
    wk, _ = jengine._shift_rows(jnp.asarray(k), jnp.asarray(v), 3, 7,
                                jnp.asarray(freqs.numpy()), cfg.rope_type, 8)
    err = float(np.abs(np.asarray(wk) - moved).max())
    assert err > 0.1, err  # JAX rotates the moved rows
    rk, _ = tengine._shift_rows(torch.from_numpy(k), torch.from_numpy(v), 3,
                                7, freqs, cfg.rope_type, 8)
    np.testing.assert_allclose(rk.numpy(), np.asarray(wk), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# the loader, params_from_jax, synthetic_params and the served fixtures
# ---------------------------------------------------------------------------

def test_loader_maps_the_new_tensors(gguf):
    """position_embd -> pos_embd (gpt2), token_embd_norm weight and bias ->
    tok_norm / tok_norm_bias (bloom), attn_q/k_norm biases (chameleon);
    params_from_jax carries the same keys, and its tree gives the JAX
    logits through the port's forward."""
    for name, keys in (("gpt2", ("pos_embd",)),
                       ("bloom", ("tok_norm", "tok_norm_bias")),
                       ("chameleon", ())):
        path = gguf(name)
        tm = _port_model(path)
        jm, want = _jax(path)
        for key in keys:
            assert key in tm.params
            np.testing.assert_array_equal(tm.params[key].numpy(),
                                          np.asarray(jm.params[key]))
        if name == "chameleon":
            for key in ("attn_q_norm_bias", "attn_k_norm_bias"):
                assert key in tm.params["layers"][0]
        conv = params_from_jax(_numpy_tree(jm.params))
        assert set(conv) == set(tm.params)
        assert set(conv["layers"][0]) == set(tm.params["layers"][0])
        np.testing.assert_allclose(_port(_with(tm, conv)), want, **TOL)


def _with(model, params):
    from koboldcpp_tpu_torch.models.loader import Model

    return Model(model.cfg, params, model.tokenizer, "cpu")


def _numpy_tree(p):
    import jax

    return jax.tree_util.tree_map(np.asarray, p)


@pytest.mark.parametrize("name", ["gemma2", "phi2", "mpt", "gpt2", "bloom"])
def test_synthetic_params_have_the_loaders_keys(gguf, name):
    """synthetic_params for a loaded file's config builds the tensors the
    loader gives for it (post-norms, layer-norm biases, projection and
    output biases, a gateless w_up, a tied dense head where the file has no
    output.weight, learned positions, the embedding norm; gemma2's converted
    tiny file has an output.weight, where the converter of a real Gemma-2
    writes none, as `synthetic_params` assumes), and the port's forward
    runs on them."""
    tm = load_model(gguf(name), device="cpu")  # packed, as quantized files
    sp = synthetic_params(tm.cfg, "q4_k", device="cpu")
    assert set(sp) == set(tm.params)
    assert set(sp["layers"][0]) == set(tm.params["layers"][0])
    if name == "mpt":  # its file has no output.weight
        assert sp["output"] is sp["tok_embd"]
        assert tm.params["output"] is tm.params["tok_embd"]
    for k, v in sp["layers"][0].items():
        if not isinstance(v, torch.Tensor):
            continue
        assert v.shape == tm.params["layers"][0][k].shape, k
    logits = _port(_with(tm, sp))
    assert logits.shape == (12, 512) and np.isfinite(logits).all()


def test_served_arch_fixtures_match_jax_logits():
    """The gemma2, phi2 and mpt Q4_K_M fixtures (tests/make_torch_fixtures.py)
    loaded packed in f32: the port's forward over the manifest's tokens
    against the committed JAX logits, |err| <= 2e-2 + 2e-2 |want| (the
    tolerance of the opt-in fixtures' decode row in
    test_torch_opt_in_layouts.py). The packed projections of the two
    packages agree to a bf16 step alone (their plain versions round x and
    y at other places), and these models' 1024-wide non-gated FFNs and
    biases carry that through two layers: phi2's worst logit sits at 1.006
    of the llama fixtures' 1e-2 + 1e-2 |want|, at 0.5 of this one; the
    same branches in f32 agree within 1e-4 (test_forward_matches_jax)."""
    man = json.load(open(os.path.join(PORT_FIX, "archs.json")))
    assert sorted(man["files"]) == ["gemma2", "mpt", "phi2"]
    for arch, name in man["files"].items():
        tm = load_model(os.path.join(PORT_FIX, name), dtype=torch.float32,
                        device="cpu")
        assert tm.cfg.arch == arch
        got = _port(tm, man["tokens"], 64)
        want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
        worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want)))
                      .max())
        assert worst <= 1.0, (arch, worst)
        assert (got.argmax(-1) == want.argmax(-1)).all(), arch


LATE_FIXTURES = ["chameleon_swin", "openelm", "bitnet", "jais", "plamo"]


@pytest.mark.parametrize("arch", LATE_FIXTURES)
def test_late_fixtures_match_jax_logits(arch):
    """The chameleon (swin norm), openelm, bitnet, jais and plamo Q4_K_M
    fixtures (tests/make_torch_fixtures.py --late, late.json) loaded packed
    in f32: the port's forward over the manifest's tokens against the
    committed JAX logits within test_served_arch_fixtures_match_jax_logits's
    tolerance, and the same argmax."""
    man = json.load(open(os.path.join(PORT_FIX, "late.json")))
    tm = load_model(os.path.join(PORT_FIX, man["files"][arch]),
                    dtype=torch.float32, device="cpu")
    assert tm.cfg.arch == arch.split("_")[0]
    got = _port(tm, man["tokens"], 64)
    want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
    worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())
    assert worst <= 1.0, worst
    assert (got.argmax(-1) == want.argmax(-1)).all()


def test_openelm_decode_kernel_takes_the_layers_heads(monkeypatch):
    """openelm's Q4_K_M fixture (4 query heads over 2 kv heads of 64 on
    layer 0, 2 over 1 on layer 1; the cache holds 2): a T = 1 step sends
    layer 0 to the decode kernel with that layer's 4 query heads and layer
    1 (fewer kv heads than the cache) to the plain attention; layer 1's
    K / V are written padded to 2 heads, and the pad head stays zero.
    `check_supported` on the card checks the shape of layer 0, the one
    that reaches the kernel."""
    tm = load_model(os.path.join(PORT_FIX, "tiny-openelm-q4_k_m.gguf"),
                    device="cpu")
    cfg = tm.cfg
    assert cfg.extras["head_counts"] == [4, 2] and cfg.n_kv_heads == 2
    seen = []
    real = tllama.flash_decode.decode_attention_batched

    def k5(q, k_new, v_new, kc, vc, pos, n_heads, n_kv_heads, *a):
        seen.append((tuple(q.shape), n_heads, n_kv_heads))
        return real(q, k_new, v_new, kc, vc, pos, n_heads, n_kv_heads, *a)

    monkeypatch.setattr(tllama.flash_decode, "decode_attention_batched", k5)
    cache = init_cache(2, 1, 32, 2, 64, dtype=torch.float32)
    with torch.inference_mode():
        tllama.forward(tm.params, cfg, torch.tensor([TOKENS[:6]]),
                       torch.arange(6)[None], cache)
        assert not seen
        tllama.forward(tm.params, cfg, torch.tensor([[5]]),
                       torch.tensor([[6]]), cache)
    assert seen == [((1, 4, 64), 4, 2)]
    k1 = cache.k[1].view(1, 32, 2, 64)
    assert k1[0, :7, 0].abs().amax(-1).min() > 0
    assert k1[0, :, 1].abs().max() == 0 and cache.v[1].view(
        1, 32, 2, 64)[0, :, 1].abs().max() == 0
    tllama.check_supported(tm.params, cfg, "cuda")
    bad = dataclasses.replace(cfg, extras={**cfg.extras,
                                           "head_counts": [3, 2]})
    with pytest.raises(NotImplementedError, match="3 query heads"):
        tllama.check_supported(tm.params, bad, "cuda")


def test_bitnet_loader_keeps_scaled_projections_apart(gguf):
    """bitnet: the loader keeps q / k / v and gate / up unfused where scale
    scalars apply (the JAX loader's has_scales rule), loads the sub-norms
    and the seven scales equal to the JAX loader's, and params_from_jax
    carries them; the converted tree gives the JAX logits."""
    path = gguf("bitnet")
    tm = _port_model(path)
    jm, want = _jax(path)
    layer, jlayer = tm.params["layers"][0], jm.params["layers"][0]
    assert "wqkv" not in layer and "w_gateup" not in layer
    keys = ("attn_sub_norm", "ffn_sub_norm", "wq_scale", "wk_scale",
            "wv_scale", "wo_scale", "ffn_gate_scale", "ffn_up_scale",
            "ffn_down_scale")
    for key in keys:
        np.testing.assert_array_equal(layer[key].numpy(),
                                      np.asarray(jlayer[key]))
    assert layer["wq_scale"].shape == (1,)
    conv = params_from_jax(_numpy_tree(jm.params))
    assert set(conv["layers"][0]) == set(layer)
    np.testing.assert_allclose(_port(_with(tm, conv)), want, **TOL)


@pytest.mark.parametrize("arch", ["openelm", "jais"])
def test_batched_engine_serves_late_fixtures(arch):
    """BatchedEngine (paged pool of 16-row pages, 2 slots) over the openelm
    (narrower layers padded in the pool) and jais (ALiBi, biases) Q4_K_M
    fixtures: two greedy requests served together get the tokens each
    gets alone through the same engine."""
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
    from koboldcpp_tpu_torch.engine.engine import GenParams
    from koboldcpp_tpu_torch.sampling import SamplerParams

    man = json.load(open(os.path.join(PORT_FIX, "late.json")))
    tm = load_model(os.path.join(PORT_FIX, man["files"][arch]), device="cpu")
    gp = GenParams(max_length=6, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    prompts = [man["tokens"][:7], man["tokens"][3:12]]
    eng = BatchedEngine(tm, max_context=64, n_slots=2, paged=True,
                        page_size=16, device="cpu")
    try:
        alone = [eng.generate(p, gp).tokens for p in prompts]
        reqs = [eng.submit(p, gp) for p in prompts]
        for r in reqs:
            assert r.done.wait(120)
        together = [r.result.tokens for r in reqs]
    finally:
        eng.shutdown()
    assert together == alone and all(len(t) == 6 for t in alone)
