"""Sparse MoE serving in the port held against the JAX package, on the CPU.

- ops/moe.py: `dispatch_indices` bit-equal to JAX's (random, skewed and
  overflowing routing), its `expert_order`, and `moe_ffn_ep` within 1e-5
  in f32; the chip model's zero-mean q4_k maker;
- `models/llama.py: _moe_ffn` in its three forms (gather, dense-EP,
  sorted-EP) against the same JAX form within 1e-5 in f32, on a mixtral,
  a qwen2moe (shared expert, top-k not renormalized) and a grok (tanh-gelu)
  layer, over a prefill chunk (grouped by expert) and single-token steps
  (every expert, no host sync); a constructed top-k tie
  goes to the lower index, as jax.lax.top_k;
- `forward` and `forward_paged` on the JAX tests' own tiny models
  (tests/test_moe.py's Mixtral, test_qwen2moe.py's Qwen2-MoE, DBRX and
  OLMoE, test_archs_batch2.py's Granite-MoE, test_archs_r2.py's Grok and
  Arctic) against the JAX `forward` within 1e-4 in f32, and
  `params_from_jax`;
- the loader: 3-D expert stacks dequantized bit-equal to JAX's, Grok's
  post-norms;
- the MoE fixtures (tests/fixtures/portgguf/moe.json) against the
  committed JAX logits, served over HTTP on the CPU, `BatchedEngine`'s
  tokens against the single `Engine`'s, a decode chunk with no host sync;
- `check_stacked_supported` refusing MoE where the JAX scan body fails.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.config import ModelConfig as JModelConfig
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import moe as jmoe
from koboldcpp_tpu_torch import cli
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine import device_sampler as tds
from koboldcpp_tpu_torch.engine import engine as tengine
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.gguf import quants as tquants
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.kv.cache import init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import Model, load_model
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import moe as tmoe
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import convert_hf as ch  # noqa: E402

from . import test_archs_r2 as r2  # noqa: E402
from .test_model_forward import tiny_tokenizer_md  # noqa: E402
from .test_torch_batch_engine import assert_same_tokens  # noqa: E402

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

TOKENS = [1, 5, 9, 42, 7, 300, 11, 250, 3, 77, 128, 400]
TOL = dict(rtol=1e-4, atol=1e-4)
FORM_TOL = dict(rtol=1e-5, atol=1e-5)
PORT_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")
MOE_MAN = json.load(open(os.path.join(PORT_FIX, "moe.json")))
MIXTRAL_FIX = os.path.join(PORT_FIX, MOE_MAN["files"]["mixtral"])


# ---------------------------------------------------------------------------
# ops/moe.py
# ---------------------------------------------------------------------------

def _routing(case: str, rng, N=16, k=2, E=8) -> np.ndarray:
    if case == "random":  # k distinct experts per token
        return np.stack([rng.permutation(E)[:k] for _ in range(N)]
                        ).astype(np.int32)
    if case == "skewed":  # every token to experts 0 and 1
        return np.stack([np.zeros(N), np.ones(N)], 1).astype(np.int32)
    return np.zeros((3, 1), np.int32)  # overflow: 3 tokens, one expert


@pytest.mark.parametrize("case", ["random", "skewed", "overflow"])
def test_dispatch_indices_bit_equal(case):
    """dest and valid equal JAX's bit for bit, dropless and at capacities
    that drop (the overflow case of tests/test_moe.py:118: capacity 2 of 3
    tokens on expert 0)."""
    topi = _routing(case, np.random.default_rng(3))
    E = 2 if case == "overflow" else 8
    for capacity in sorted({len(topi), 2, 1}):
        wd, wv = jmoe.dispatch_indices(jnp.asarray(topi), E, capacity)
        gd, gv = tmoe.dispatch_indices(torch.from_numpy(topi).long(), E,
                                       capacity)
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        if case == "overflow" and capacity == 2:
            assert gv.tolist() == [True, True, False]


@pytest.mark.parametrize("case", ["random", "skewed", "overflow"])
def test_expert_order_groups_by_expert(case):
    """`expert_order`, the sort both the gather form's grouping and the
    sorted-EP dispatch read: a stable argsort of the flat expert ids (token
    order within an expert) and each expert's first sorted index."""
    topi = _routing(case, np.random.default_rng(5))
    E = 2 if case == "overflow" else 8
    flat = topi.reshape(-1)
    order, starts = tmoe.expert_order(torch.from_numpy(flat).long(), E)
    np.testing.assert_array_equal(order.numpy(),
                                  np.argsort(flat, kind="stable"))
    np.testing.assert_array_equal(
        starts.numpy(), np.searchsorted(np.sort(flat), np.arange(E + 1)))


def test_rand_q4k_centered_is_zero_mean():
    """The Mixtral-widths chip model's q4_k maker: rand_q4k's draws with
    each sub-block's min at its grid's midpoint (min = 8 d round(15 sc /
    16)), so the weights have a mean near zero where rand_q4k's have one
    as large as their spread."""
    from koboldcpp_tpu_torch.models import synthetic

    a = synthetic.rand_q4k(np.random.default_rng(0), 64, 1024)
    b = synthetic.rand_q4k_centered(np.random.default_rng(0), 64, 1024)
    for key in ("qs2", "scale", "sc", "d"):
        assert torch.equal(a.data[key], b.data[key])
    sc = b.data["sc"].float().reshape(64, 4, 8)
    want = (b.data["d"][:, :, None] * 8 * torch.round(sc * 15 / 16))
    assert torch.equal(b.data["min"],
                       want.reshape(64, 32).to(torch.bfloat16))
    wa = tlinear.dequant(a, dtype=torch.float32)
    wb = tlinear.dequant(b, dtype=torch.float32)
    assert float(wa.mean()) > 0.5 * float(wa.std())
    assert abs(float(wb.mean())) < 0.02 * float(wb.std())


def _experts(rng, E, C, F, s=0.1):
    return [(rng.standard_normal(shape) * s).astype(np.float32)
            for shape in ((E, F, C), (E, F, C), (E, C, F))]


@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("cap", [None, 1.0, 2])
def test_moe_ffn_ep_matches_jax(act, cap):
    """moe_ffn_ep on skewed routing (every token to experts 0 and 1, so a
    capped bucket drops): dropless, capacity_factor 1.0 and capacity 2,
    within 1e-5 of the JAX function in f32; a dropped assignment adds
    nothing."""
    rng = np.random.default_rng(5)
    N, C, F, E, k = 16, 8, 16, 8, 2
    xt = rng.standard_normal((N, C)).astype(np.float32)
    wg, wu, wd = _experts(rng, E, C, F)
    topi = _routing("skewed", rng, N, k, E)
    topw = rng.random((N, k)).astype(np.float32)
    jact = (jax.nn.silu if act == "silu"
            else lambda v: jax.nn.gelu(v, approximate=True))
    tact = (torch.nn.functional.silu if act == "silu"
            else lambda v: torch.nn.functional.gelu(v, approximate="tanh"))
    kw = ({"capacity": cap} if isinstance(cap, int)
          else {"capacity_factor": cap})
    want = jmoe.moe_ffn_ep(*map(jnp.asarray, (xt, topi, topw, wg, wu, wd)),
                           jact, **kw)
    got = tmoe.moe_ffn_ep(*map(torch.from_numpy, (xt, topi.astype(np.int64),
                                                  topw, wg, wu, wd)),
                          tact, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORM_TOL)
    if cap == 2:  # only the first two tokens fit each expert
        assert float(got[2:].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# _moe_ffn: the three forms, the step forms of the gather, ties
# ---------------------------------------------------------------------------

# (E, k, renormalize, act, shared expert): mixtral, qwen2moe, grok
VARIANTS = {"mixtral": (8, 2, True, "silu", False),
            "qwen2moe": (8, 4, False, "silu", True),
            "grok": (8, 2, True, "gelu", False)}
FORMS = {"gather": {}, "dense_ep": {"moe_dense_ep": True},
         "sorted_ep": {"moe_sorted_ep": True}}
C_, F_, FS_ = 64, 32, 48


def _moe_layer(variant: str, seed=0, router=None):
    """A MoE layer of numpy f32 weights as (JAX layer, port layer, JAX
    config, port config)."""
    E, k, norm, act, shared = VARIANTS[variant]
    rng = np.random.default_rng(seed)
    w = {"ffn_gate_inp": (rng.standard_normal((E, C_)) * 0.3
                          ).astype(np.float32) if router is None else router}
    w.update(zip(("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"),
                 _experts(rng, E, C_, F_)))
    if shared:
        for key, shape in (("ffn_gate_shexp", (FS_, C_)),
                           ("ffn_up_shexp", (FS_, C_)),
                           ("ffn_down_shexp", (C_, FS_)),
                           ("ffn_gate_inp_shexp", (1, C_))):
            w[key] = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    kw = dict(hidden_size=C_, n_experts=E, n_experts_used=k,
              moe_norm_topk=norm,
              extras={"moe_act": "gelu"} if act == "gelu" else {})
    return ({n: jlinear.dense(a, dtype=jnp.float32) for n, a in w.items()},
            {n: tlinear.dense(a, dtype=torch.float32) for n, a in w.items()},
            JModelConfig(**kw), ModelConfig(**kw))


# (B, T): a prefill chunk (grouped by expert), one sequence's step and
# three sequences' step (every expert)
SHAPES = ((1, 6), (1, 1), (3, 1))


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_moe_ffn_form_matches_jax(variant, form):
    """The port's `_moe_ffn` in each form against the JAX `_moe_ffn` in the
    same form, f32, within 1e-5, at each of SHAPES."""
    jl, tl, jc, tc = _moe_layer(variant)
    jc = dataclasses.replace(jc, **FORMS[form])
    tc = dataclasses.replace(tc, **FORMS[form])
    rng = np.random.default_rng(1)
    for B, T in SHAPES:
        x = rng.standard_normal((B, T, C_)).astype(np.float32)
        want = jllama._moe_ffn(jnp.asarray(x), jl, jc)
        with torch.inference_mode():
            got = tllama._moe_ffn(torch.from_numpy(x), tl, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **FORM_TOL, err_msg=f"{(B, T)}")


def test_gather_step_form_has_no_host_sync(monkeypatch):
    """The gather form's dispatch: a prefill chunk groups by expert (one
    host read of the counts); a single-token step, of one sequence or of
    three, runs every expert with no host read at all."""
    _, tl, _, tc = _moe_layer("mixtral")
    seen = []
    real = tllama.moe.expert_products
    monkeypatch.setattr(tllama.moe, "expert_products",
                        lambda bx, *a: seen.append(bx.dim()) or real(bx, *a))
    x = torch.randn(3, 6, C_)
    with torch.inference_mode():
        tllama._moe_ffn(x[:1], tl, tc)
        assert seen and set(seen) == {2}  # one product per expert

        def boom(*a, **k):
            raise AssertionError("host sync in a single-token step")

        with monkeypatch.context() as m:
            for meth in ("item", "tolist", "cpu", "numpy"):
                m.setattr(torch.Tensor, meth, boom)
            for B in (1, 3):
                seen.clear()
                tllama._moe_ffn(x[:B, :1], tl, tc)
                assert seen == [3]  # every expert at once


def test_top_k_tie_goes_to_the_lower_index():
    """Ties in the router weights pick the lower expert index first, as
    jax.lax.top_k does, on a matrix full of ties; and a layer whose
    router rows for experts 2, 5 and 6 are equal (their softmax weights
    tie exactly) gives JAX's output, where the higher index would give
    another."""
    rng = np.random.default_rng(9)
    w = rng.integers(0, 4, size=(64, 8)).astype(np.float32) / 4
    for k in (1, 2, 3, 5):
        wv, wi = jax.lax.top_k(jnp.asarray(w), k)
        gv, gi = tllama._top_k(torch.from_numpy(w), k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    router = np.zeros((8, C_), np.float32)
    router[[2, 5, 6]] = 0.5
    jl, tl, jc, tc = _moe_layer("mixtral", router=router)
    x = np.abs(rng.standard_normal((1, 4, C_))).astype(np.float32)
    want = jllama._moe_ffn(jnp.asarray(x), jl, jc)
    with torch.inference_mode():
        got = tllama._moe_ffn(torch.from_numpy(x), tl, tc)
        xt = torch.from_numpy(x[0])
        topi = tllama._top_k(torch.softmax(
            tlinear.matmul(xt, tl["ffn_gate_inp"]), -1), 2)[1]
        assert (topi == torch.tensor([2, 5])).all()
        wgt = torch.full((4, 2), 0.5)
        lay = [tl[n].data["w"] for n in ("ffn_gate_exps", "ffn_up_exps",
                                         "ffn_down_exps")]
        higher = tllama._moe_gather(xt, torch.tensor([[2, 6]] * 4), wgt,
                                    *lay, torch.nn.functional.silu, False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FORM_TOL)
    assert float((higher - got[0]).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# forward and forward_paged on the JAX tests' tiny models
# ---------------------------------------------------------------------------

def _state(model_cls, cfg, seed):
    torch.manual_seed(seed)
    model = model_cls(cfg).eval().float()
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _hf(path, name):
    import transformers as tf

    md = tiny_tokenizer_md(512)
    if name == "mixtral":  # tests/test_moe.py:17
        cfg = tf.MixtralConfig(
            vocab_size=512, hidden_size=64, intermediate_size=96,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2,
            max_position_embeddings=128, tie_word_embeddings=False)
        ch.convert_mixtral_state_dict(_state(tf.MixtralForCausalLM, cfg, 5),
                                      cfg, path, tokenizer_md=md)
    elif name == "qwen2moe":  # tests/test_qwen2moe.py:17
        cfg = tf.Qwen2MoeConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, num_experts=4, num_experts_per_tok=2,
            moe_intermediate_size=32, shared_expert_intermediate_size=64,
            decoder_sparse_step=1, norm_topk_prob=False,
            tie_word_embeddings=False)
        ch.convert_qwen2moe_state_dict(
            _state(tf.Qwen2MoeForCausalLM, cfg, 16), cfg, path,
            tokenizer_md=md)
    elif name == "dbrx":  # tests/test_qwen2moe.py:46
        from transformers.models.dbrx.configuration_dbrx import (
            DbrxAttentionConfig, DbrxFFNConfig)

        cfg = tf.DbrxConfig(
            d_model=64, n_heads=4, n_layers=2, max_seq_len=64, vocab_size=512,
            attn_config=DbrxAttentionConfig(kv_n_heads=2, clip_qkv=8.0,
                                            rope_theta=10000.0),
            ffn_config=DbrxFFNConfig(ffn_hidden_size=32, moe_num_experts=4,
                                     moe_top_k=2,
                                     moe_normalize_expert_weights=1.0))
        ch.convert_dbrx_state_dict(_state(tf.DbrxForCausalLM, cfg, 19), cfg,
                                   path, tokenizer_md=md)
    elif name == "olmoe":  # tests/test_qwen2moe.py:78
        cfg = tf.OlmoeConfig(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            max_position_embeddings=64, num_experts=4, num_experts_per_tok=2,
            norm_topk_prob=False, tie_word_embeddings=False)
        ch.convert_olmoe_state_dict(_state(tf.OlmoeForCausalLM, cfg, 21),
                                    cfg, path, tokenizer_md=md)
    elif name == "granitemoe":  # tests/test_archs_batch2.py:123
        cfg = tf.GraniteMoeConfig(
            vocab_size=512, hidden_size=64, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
            num_local_experts=4, num_experts_per_tok=2,
            max_position_embeddings=128, embedding_multiplier=6.0,
            attention_multiplier=0.2, residual_multiplier=0.5,
            logits_scaling=4.0, tie_word_embeddings=False)
        ch.convert_granitemoe_state_dict(
            _state(tf.GraniteMoeForCausalLM, cfg, 35), cfg, path,
            tokenizer_md=md)
    else:
        raise KeyError(name)


def _r2(path, name):
    """tests/test_archs_r2.py's hand-written Grok (:475) and Arctic (:536)
    GGUFs: the same tensors from the same seeds."""
    V, C, L = r2.V, r2.C, r2.L
    E, K, FE = 4, 2, 32
    rng = r2.rng_weights({"grok": 108, "arctic": 109}[name])
    t = {"token_embd.weight": r2.w2(rng, V, C, 0.02),
         "output_norm.weight": r2.w1(rng, C, True),
         "output.weight": r2.w2(rng, V, C, 0.02)}
    for i in range(L):
        p = f"blk.{i}."
        t[p + "attn_norm.weight"] = r2.w1(rng, C, True)
        if name == "grok":
            t[p + "attn_output_norm.weight"] = r2.w1(rng, C, True)
            t[p + "ffn_norm.weight"] = r2.w1(rng, C, True)
            t[p + "layer_output_norm.weight"] = r2.w1(rng, C, True)
            r2._std_attn_tensors(rng, t, i)
        else:
            t[p + "ffn_norm.weight"] = r2.w1(rng, C, True)
            t[p + "ffn_norm_exps.weight"] = r2.w1(rng, C, True)
            r2._std_attn_tensors(rng, t, i)
            t[p + "ffn_gate.weight"] = r2.w2(rng, C, C)
            t[p + "ffn_up.weight"] = r2.w2(rng, C, C)
            t[p + "ffn_down.weight"] = r2.w2(rng, C, C)
        t[p + "ffn_gate_inp.weight"] = r2.w2(rng, E, C)
        for tname, shape in (("ffn_gate_exps", (E, FE, C)),
                             ("ffn_up_exps", (E, FE, C)),
                             ("ffn_down_exps", (E, C, FE))):
            t[p + tname + ".weight"] = (rng.standard_normal(shape) * 0.05
                                        ).astype(np.float32)
    md = r2.base_md(name, ff=FE)
    md[f"{name}.expert_count"] = np.uint32(E)
    md[f"{name}.expert_used_count"] = np.uint32(K)
    r2.write_gguf(path, name, md, t)


ARCHS = ["mixtral", "qwen2moe", "dbrx", "olmoe", "granitemoe", "grok",
         "arctic"]


@pytest.fixture(scope="module")
def gguf(tmp_path_factory):
    """name -> the tiny model's GGUF path, built on first use."""
    d = tmp_path_factory.mktemp("moe")
    made: dict = {}

    def get(name):
        if name not in made:
            path = str(d / f"{name}.gguf")
            (_r2 if name in ("grok", "arctic") else _hf)(path, name)
            made[name] = path
        return made[name]
    return get


def _jax(path, tokens=TOKENS):
    m = j_load_model(path, packed=False, dtype=jnp.float32)
    cache = j_init_cache(m.cfg.n_layers, 1, 32, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=jnp.float32)
    logits, _ = jllama.forward(m.params, m.cfg,
                               jnp.asarray([tokens], jnp.int32),
                               jnp.arange(len(tokens), dtype=jnp.int32)[None],
                               cache)
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


@pytest.mark.parametrize("name", ARCHS)
def test_forward_matches_jax(gguf, name):
    """check_supported admits the model, the two packages read the same
    config (n_experts, n_experts_used, moe_norm_topk, grok's gelu), and the
    port's forward over 12 tokens equals the JAX forward's within 1e-4."""
    path = gguf(name)
    jm, want = _jax(path)
    tm = _port_model(path)
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.n_experts == 4 and tm.cfg.n_experts_used == 2
    assert tm.cfg.moe_norm_topk == (name not in ("qwen2moe", "olmoe"))
    assert ((tm.cfg.extras or {}).get("moe_act") == "gelu") == (
        name == "grok")
    layer = tm.params["layers"][0]
    assert layer["ffn_gate_exps"].shape[0] == 4
    assert ("ffn_norm_exps" in layer) == (name == "arctic")
    assert ("ffn_up_shexp" in layer) == (name == "qwen2moe")
    np.testing.assert_allclose(_port(tm), want, **TOL)


def _f32_pool(cfg, n_pages, P):
    kd = cfg.n_kv_heads * cfg.head_dim
    z = [torch.zeros(n_pages * P, kd) for _ in range(2 * cfg.n_layers)]
    return tpaged.PagedKVCache(k=z[:cfg.n_layers], v=z[cfg.n_layers:],
                               page_size=P, heads=cfg.n_kv_heads)


@pytest.mark.parametrize("name", ARCHS)
def test_forward_paged_matches_jax_forward(gguf, name):
    """forward_paged over an f32 pool of 4-row pages (a shuffled table): a
    7-token chunk, then five single-token steps, each step's logits within
    1e-4 of the JAX `forward`'s over the whole sequence (arctic too, whose
    JAX forward_paged would run the MoE branch in place of the dense FFN;
    the port's shares the forward's layer body)."""
    path = gguf(name)
    _, want = _jax(path)
    tm = _port_model(path)
    pool = _f32_pool(tm.cfg, 6, 4)
    table = torch.tensor([[4, 1, 5, 0]])
    rows = []
    with torch.inference_mode():
        lg, _ = tllama.forward_paged(tm.params, tm.cfg,
                                     torch.tensor([TOKENS[:7]]),
                                     torch.arange(7)[None], pool, table)
        rows += list(lg[0])
        for p in range(7, 12):
            lg, _ = tllama.forward_paged(tm.params, tm.cfg,
                                         torch.tensor([[TOKENS[p]]]),
                                         torch.tensor([[p]]), pool, table)
            rows.append(lg[0, 0])
    np.testing.assert_allclose(torch.stack(rows).numpy(), want, **TOL)


@pytest.mark.parametrize("name", ["mixtral", "qwen2moe", "arctic"])
def test_params_from_jax_carries_the_moe_tensors(gguf, name):
    """params_from_jax carries the router, the expert stacks, the shared
    expert and arctic's MoE norm: the loader's keys, and the JAX logits
    through the port's forward."""
    path = gguf(name)
    jm, want = _jax(path)
    tm = _port_model(path)
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    assert set(conv["layers"][0]) == set(tm.params["layers"][0])
    for key in ("ffn_gate_exps", "ffn_down_exps", "ffn_gate_inp"):
        np.testing.assert_array_equal(
            conv["layers"][1][key].data["w"].numpy(),
            tm.params["layers"][1][key].data["w"].numpy())
    np.testing.assert_allclose(
        _port(Model(tm.cfg, conv, tm.tokenizer, "cpu")), want, **TOL)


@pytest.mark.parametrize("name", ["mixtral", "arctic"])
def test_forward_stacked_refuses_moe(gguf, name):
    """A fault of the reference: the JAX scan body runs the dense `_ffn`
    only, so on Mixtral (no dense FFN) its forward_stacked raises KeyError
    ('w_gate'), and on Arctic it drops the residual MoE branch and departs
    from its own forward; the port's forward_stacked refuses both, naming
    MoE."""
    path = gguf(name)
    jm, want = _jax(path)
    jst = jllama.stack_layers(jm.params)
    assert "layers_stacked" in jst
    jcache = j_init_cache(2, 1, 32, jm.cfg.n_kv_heads, jm.cfg.head_dim,
                          dtype=jnp.float32)
    run = lambda: jllama.forward_stacked(  # noqa: E731
        jst, jm.cfg, jnp.asarray([TOKENS], jnp.int32),
        jnp.arange(12, dtype=jnp.int32)[None], jcache)
    if name == "mixtral":
        with pytest.raises(KeyError, match="w_gate"):
            run()
    else:
        err = float(np.abs(np.asarray(run()[0])[0] - want).max())
        assert err > 0.1 * float(np.abs(want).max()), err
    tm = _port_model(path)
    st = tllama.stack_layers(tm.params)
    assert "layers_stacked" in st
    tllama.check_supported(st, tm.cfg)  # forward serves it
    cache = init_cache(2, 1, 32, tm.cfg.n_kv_heads, tm.cfg.head_dim)
    with pytest.raises(NotImplementedError, match="MoE"):
        tllama.forward_stacked(st, tm.cfg, torch.tensor([TOKENS]),
                               torch.arange(12)[None], cache)


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gtype", ["Q4_K", "Q5_K", "Q6_K", "Q8_0"])
def test_expert_stack_dequant_bit_equal(gtype):
    """A 3-D (E, F, C) stack quantized to each kind the fixtures' stacks
    use (and q5_k) loads dense bit-equal to the JAX `from_gguf(...,
    packed=False)`, in f32 and in bf16."""
    t = GGMLType[gtype]
    x = (np.random.default_rng(4).standard_normal((3, 8, 512)) * 0.05
         ).astype(np.float32)
    raw = tquants.quantize(x, t)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jlinear.from_gguf(raw, t, x.shape, packed=False,
                                 dtype=jdt).data["w"]
        got = tlinear.from_gguf(raw, t, x.shape, packed=False,
                                dtype=tdt).data["w"]
        assert got.shape == x.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("arch", list(MOE_MAN["files"]))
def test_fixture_expert_stacks_bit_equal(arch):
    """The MoE fixtures loaded packed (their stacks q4_k and q6_k, 3-D):
    every expert stack, the router and the shared expert equal the JAX
    loader's, the stacks dense, bit for bit."""
    path = os.path.join(PORT_FIX, MOE_MAN["files"][arch])
    jm = j_load_model(path, dtype=jnp.float32)
    tm = load_model(path, dtype=torch.float32, device="cpu")
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    for li, layer in enumerate(tm.params["layers"]):
        keys = [k for k in layer if "exps" in k or "shexp" in k
                or k == "ffn_gate_inp"]
        assert len(keys) == (8 if arch == "qwen2moe" else 4), keys
        for key in keys:
            got, want = layer[key], conv["layers"][li][key]
            assert got.kind == want.kind
            if "exps" in key:
                assert got.kind == "dense" and len(got.shape) == 3
            for n in got.data:
                np.testing.assert_array_equal(got.data[n].float().numpy(),
                                              want.data[n].float().numpy())


def test_grok_post_norms_load(gguf):
    """The loader reads Grok's post-norms (`attn_output_norm`,
    `layer_output_norm`) into every layer's attn_post_norm /
    ffn_post_norm, equal to the JAX loader's (the tiny Grok and the Grok
    fixture)."""
    for path in (gguf("grok"),
                 os.path.join(PORT_FIX, MOE_MAN["files"]["grok"])):
        jm = j_load_model(path, packed=False, dtype=jnp.float32)
        tm = _port_model(path)
        for jl, tl in zip(jm.params["layers"], tm.params["layers"]):
            for key in ("attn_post_norm", "ffn_post_norm"):
                np.testing.assert_array_equal(tl[key].numpy(),
                                              np.asarray(jl[key]))


# ---------------------------------------------------------------------------
# the MoE fixtures, the engines and the server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list(MOE_MAN["files"]))
def test_moe_fixture_matches_jax_logits(arch):
    """The Mixtral, Qwen2-MoE and Grok Q4_K_M fixtures loaded packed in
    f32: the port's forward over the manifest's tokens against the
    committed JAX logits, |err| <= 2e-2 + 2e-2 |want| (the arch fixtures'
    tolerance; the packed projections of the two packages agree to a bf16
    step alone), and an argmax whose JAX logit lies within that tolerance
    of JAX's best (the grok fixture has a near-tie)."""
    tm = load_model(os.path.join(PORT_FIX, MOE_MAN["files"][arch]),
                    dtype=torch.float32, device="cpu")
    assert tm.cfg.n_experts == 8
    got = _port(tm, MOE_MAN["tokens"], 64)
    want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
    tol = 2e-2 + 2e-2 * np.abs(want)
    worst = float((np.abs(got - want) / tol).max())
    assert worst <= 1.0, worst
    rows = np.arange(len(want))
    pick = got.argmax(-1)
    assert (want[rows, pick] >= want.max(-1) - tol[rows, pick]).all()


PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of"]


def _greedy(n=8):
    return GenParams(max_length=n, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


@pytest.fixture(scope="module")
def mixtral():
    return load_model(MIXTRAL_FIX, device="cpu")


@pytest.fixture(scope="module")
def mixtral_engine(mixtral):
    return Engine(mixtral, max_context=256, device="cpu")


@pytest.mark.parametrize("paged", [False, True])
def test_batched_engine_matches_single(mixtral, mixtral_engine, paged):
    """BatchedEngine (4 slots, slot cache or 16-row pages) on the Mixtral
    fixture: three concurrent greedy requests get the single Engine's
    tokens (near-ties apart)."""
    want = []
    for p in PROMPTS:
        mixtral_engine.reset_context()
        want.append(mixtral_engine.generate(p, _greedy()).tokens)
    eng = BatchedEngine(mixtral, max_context=256, n_slots=4, paged=paged,
                        page_size=16, device="cpu")
    try:
        with eng._admit_lock:
            reqs = [eng.submit(p, _greedy()) for p in PROMPTS]
        for r in reqs:
            assert r.done.wait(300)
    finally:
        eng.shutdown()
    for p, r, w in zip(PROMPTS, reqs, want):
        assert_same_tokens(mixtral, p, r.result.tokens, w)


def test_decode_chunks_have_no_host_sync(mixtral_engine, monkeypatch):
    """A greedy and a stochastic device chunk on the Mixtral fixture (every
    step through the MoE layers) pull nothing to the host (the sync guard
    of test_torch_stoch_decode.py), and the greedy chunk's tokens are the
    argmax of the host loop's steps."""
    eng = mixtral_engine
    eng.reset_context()
    with torch.inference_mode():
        logits = eng._eval_chunk(eng.tokenizer.encode(PROMPTS[0]), 0)
    n = len(eng.tokenizer.encode(PROMPTS[0]))
    ban = torch.zeros_like(logits)
    sp = SamplerParams(seed=3, temperature=0.8, top_p=0.9, min_p=0.05,
                       rep_pen=1.1)
    chunk = eng._get_stoch_chunk(sp.sampler_order)
    rec = torch.zeros(256, dtype=torch.int64)
    g = torch.Generator().manual_seed(3)

    def boom(*a, **k):
        raise AssertionError("host sync inside the chunk")

    with monkeypatch.context() as m:
        for meth in ("item", "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, meth, boom)
        with torch.inference_mode():
            toks, _ = eng._greedy_chunk(logits, n, ban)
            chunk(logits, n, ban, rec, torch.tensor([n]), g,
                  tds.make_dyn(sp, 256))
    toks = toks.tolist()
    assert len(toks) == tengine.FAST_DECODE_K
    eng.reset_context()
    with torch.inference_mode():
        lg = eng._eval_chunk(eng.tokenizer.encode(PROMPTS[0]), 0)
        for i, t in enumerate(toks):
            assert int(torch.argmax(lg)) == t
            lg = eng._forward(torch.tensor([[t]]), torch.tensor([[n + i]]),
                              last_only=True)[0, -1]


async def test_mixtral_fixture_served_over_http(mixtral_engine,
                                                aiohttp_client):
    """/api/v1/generate on the Mixtral fixture at temperature 0: two
    identical non-empty replies."""
    client = await aiohttp_client(make_app(mixtral_engine, ServerSettings(
        model_name="test/tiny-mixtral-q4_k_m")))
    body = {"prompt": PROMPTS[0], "max_length": 6, "temperature": 0,
            "rep_pen": 1.0}
    texts = []
    for _ in range(2):
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] == texts[1] and texts[0]


def test_cli_serves_the_mixtral_fixture(capsys):
    """`python -m koboldcpp_tpu_torch <tiny Mixtral Q4_K_M> --device cpu
    --prompt ...` loads and generates."""
    assert cli.main([MIXTRAL_FIX, "--device", "cpu", "--contextsize", "256",
                     "--prompt", "Once upon", "--promptlimit", "4"]) == 0
    assert "on cpu" in capsys.readouterr().out


def test_synthetic_moe_params_have_the_loaders_keys(mixtral):
    """synthetic_params for the Mixtral fixture's config in "q4_k_m" gives
    the loader's layer keys (q / k / v unfused, the router and the dense
    expert stacks, no dense FFN) and shapes, the head and v projections
    q6_k, the stacks the same for the same seed; the forward runs on
    them."""
    from koboldcpp_tpu_torch.models.synthetic import synthetic_params

    cfg = mixtral.cfg
    sp = synthetic_params(cfg, "q4_k_m", seed=3, device="cpu")
    assert set(sp) == set(mixtral.params)
    for got, want in zip(sp["layers"], mixtral.params["layers"]):
        assert set(got) == set(want)
        for k, v in got.items():
            assert tuple(v.shape) == tuple(want[k].shape), k
    layer = sp["layers"][1]
    assert layer["wq"].kind == "q4_k" and layer["wv"].kind == "q6_k"
    assert sp["output"].kind == "q6_k"
    assert layer["ffn_gate_exps"].data["w"].dtype == torch.bfloat16
    assert layer["ffn_gate_inp"].data["w"].dtype == torch.float32
    again = synthetic_params(cfg, "q4_k_m", seed=3, device="cpu")
    assert torch.equal(again["layers"][1]["ffn_down_exps"].data["w"],
                       layer["ffn_down_exps"].data["w"])
    logits = _port(Model(cfg, sp, mixtral.tokenizer, "cpu"), TOKENS[:6])
    assert logits.shape == (6, 512) and np.isfinite(logits).all()
