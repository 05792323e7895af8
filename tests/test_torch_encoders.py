"""The embedding and encoder-decoder models in the port (bert, nomic-bert,
jina-bert-v2, t5encoder, t5) held against the JAX package, on the CPU in
f32.

The tiny models: tests/test_embeddings.py's transformers BertModel
(hidden 64, 2 layers, 4 heads) and T5EncoderModel, tests/test_t5.py's
T5ForConditionalGeneration (hidden 48, 4 heads of 12, 8 buckets; ReLU
and gated-gelu FFNs), all written by tools/convert_hf.py, and nomic-bert /
jina-bert-v2 files of tests/test_archs_r2.py's tensors
(tests/make_torch_fixtures.py `bert_family_tensors`). No download. Each
case: the port's `forward_embed` / `encode` / T5 decoder against the JAX
one within 1e-4 (padding rows too), padding that leaves the valid rows
alone, `Engine.embed` against the JAX engine's under mean and CLS
pooling, the T5 Engine's greedy tokens against the JAX Engine's, the
embeddings routes and the generate refusal through the port's app,
`params_from_jax` on the encoder trees, the relative-position buckets,
a fault of the reference (the JAX T5 decoder writes a padded chunk's pad
rows into its cache's last slot), and the tiny nomic-bert and T5
fixtures (tests/fixtures/portgguf/text.json) against their committed JAX
numbers.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koboldcpp_tpu.engine.engine import Engine as JEngine
from koboldcpp_tpu.engine.engine import GenParams as JGenParams
from koboldcpp_tpu.models import bert as jbert
from koboldcpp_tpu.models import t5 as jt5
from koboldcpp_tpu.models.loader import Model as JModel
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.models import bert, t5
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import Model, load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_hf import (convert_bert_state_dict,  # noqa: E402
                        convert_t5_state_dict, convert_t5encoder_state_dict)

from .make_torch_fixtures import (bert_family_tensors,  # noqa: E402
                                  write_bert_family)
from .test_model_forward import tiny_tokenizer_md  # noqa: E402

pytest_plugins = ("aiohttp.pytest_plugin",)

BERTS = ("bert", "nomic-bert", "jina-bert-v2")
TOKENS = [2, 5, 9, 42, 7, 301]
TOL = dict(rtol=1e-4, atol=1e-4)
PORT_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from transformers import (BertConfig, BertModel, T5Config,
                              T5EncoderModel, T5ForConditionalGeneration)

    d = tmp_path_factory.mktemp("encoders")
    out = {a: str(d / f"{a}.gguf") for a in
           BERTS + ("t5encoder", "t5-relu", "t5-gated-gelu")}
    torch.manual_seed(41)
    cfg = BertConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                     num_attention_heads=4, intermediate_size=128,
                     max_position_embeddings=128, layer_norm_eps=1e-12)
    m = BertModel(cfg, add_pooling_layer=False).eval().float()
    convert_bert_state_dict({k: v.numpy() for k, v in m.state_dict().items()},
                            cfg, out["bert"],
                            tokenizer_md=tiny_tokenizer_md(512))
    for seed, arch in ((111, "nomic-bert"), (112, "jina-bert-v2")):
        write_bert_family(out[arch], arch, bert_family_tensors(
            arch, seed, 64, 4, 16, 96, 2, 512), 64, 4, 16, 96, 2, 512)
    t5kw = dict(vocab_size=512, d_model=48, d_kv=12, d_ff=96, num_layers=2,
                num_heads=4, relative_attention_num_buckets=8,
                relative_attention_max_distance=128,
                tie_word_embeddings=False, decoder_start_token_id=0,
                pad_token_id=0, eos_token_id=1)
    torch.manual_seed(42)
    cfg = T5Config(feed_forward_proj="relu", **t5kw)
    m = T5EncoderModel(cfg).eval().float()
    convert_t5encoder_state_dict(
        {k: v.numpy() for k, v in m.state_dict().items()}, cfg,
        out["t5encoder"], tokenizer_md=tiny_tokenizer_md(512))
    for ff in ("relu", "gated-gelu"):
        torch.manual_seed(13)
        cfg = T5Config(feed_forward_proj=ff, **t5kw)
        m = T5ForConditionalGeneration(cfg).eval().float()
        convert_t5_state_dict(
            {k: v.numpy() for k, v in m.state_dict().items()}, cfg,
            out[f"t5-{ff}"], tokenizer_md=tiny_tokenizer_md(512))
    return out


@pytest.fixture(scope="module")
def models(files):
    """name -> (JAX model, port model), both f32 unpacked."""
    return {a: (j_load_model(p, packed=False, dtype=jnp.float32),
                load_model(p, packed=False, dtype=torch.float32,
                           device="cpu")) for a, p in files.items()}


def _padded(tokens, pad):
    return tokens + [0] * pad, list(range(len(tokens))) + [-1] * pad


def _embed_both(arch, jm, tm, tokens, positions):
    """(JAX hidden, port hidden) of forward_embed / encode, (S, C)."""
    jfn, tfn = ((jt5.encode, t5.encode) if arch == "t5encoder"
                else (jbert.forward_embed, bert.forward_embed))
    want = jfn(jm.params, jm.cfg, jnp.asarray([tokens], jnp.int32),
               jnp.asarray([positions], jnp.int32))
    with torch.inference_mode():
        got = tfn(tm.params, tm.cfg, torch.tensor([tokens]),
                  torch.tensor([positions]))
    return np.asarray(want, np.float32)[0], got[0].float().numpy()


@pytest.mark.parametrize("arch", BERTS + ("t5encoder",))
def test_encoder_matches_jax(models, arch):
    """The same file and a chunk padded at its end: the port's hidden
    states within 1e-4 of the JAX ones on every row (the padding rows too),
    the valid rows equal to the unpadded chunk's (1e-5), and the config
    equal to the JAX one (nomic: NEOX rope; jina: ALiBi, a QK norm on
    layer 0, attn_norm_2 on layer 1)."""
    jm, tm = models[arch]
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert tm.cfg.is_embedding
    if arch == "jina-bert-v2":
        assert tm.cfg.use_alibi and "attn_q_norm" in tm.params["layers"][0]
        assert "attn_norm_2" in tm.params["layers"][1]
    if arch == "nomic-bert":
        assert tm.cfg.use_rope and tm.cfg.rope_type == "neox"
    toks, pos = _padded(TOKENS, 4)
    want, got = _embed_both(arch, jm, tm, toks, pos)
    np.testing.assert_allclose(got, want, **TOL)
    _, clean = _embed_both(arch, jm, tm, TOKENS, list(range(len(TOKENS))))
    np.testing.assert_allclose(got[:len(TOKENS)], clean, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["bert", "jina-bert-v2", "t5encoder"])
def test_encoder_quantized_file_matches_jax(files, arch, tmp_path):
    """The tiny file through tools/quantize.py's Q4_K_M recipe (at hidden
    64 the K-quants fall back to Q8_0 and F16) and loaded packed in f32 by
    both packages: the port's hidden states against the JAX ones, |err| <=
    2e-2 + 2e-2 |want| (the fixture tolerance); nomic-bert's Q4_K_M file
    at hidden 256 is test_fixture_matches_jax_numbers'."""
    from quantize import TYPE_MAP, quantize_file

    dst = str(tmp_path / f"{arch}-q4_k_m.gguf")
    quantize_file(files[arch], dst, TYPE_MAP["q4_k_m"], verbose=False)
    jm = j_load_model(dst, packed=True, dtype=jnp.float32)
    tm = load_model(dst, dtype=torch.float32, device="cpu")
    kinds = {getattr(v, "kind", None)
             for ly in tm.params.get("layers") or tm.params["enc_layers"]
             for v in ly.values()}
    assert "q8_0" in kinds
    want, got = _embed_both(arch, jm, tm, TOKENS, list(range(len(TOKENS))))
    worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())
    assert worst <= 1.0, worst


@pytest.mark.parametrize("pooling", [1, 2], ids=["mean", "cls"])
@pytest.mark.parametrize("arch", ["bert", "t5encoder"])
def test_engine_embed_matches_jax(models, arch, pooling):
    """`Engine.embed` against the JAX engine's on two texts, under mean
    (pooling type 1) and CLS (2) pooling: within 1e-4, the shape (2, C),
    and `generate` refused with ValueError as in JAX."""
    jm, tm = models[arch]
    jcfg = dataclasses.replace(jm.cfg, extras={**jm.cfg.extras,
                                               "pooling": pooling})
    tcfg = dataclasses.replace(tm.cfg, extras={**tm.cfg.extras,
                                               "pooling": pooling})
    texts = ["hello world", "different text entirely"]
    want = JEngine(JModel(jcfg, jm.params, jm.tokenizer),
                   max_context=64).embed(texts)
    eng = Engine(Model(tcfg, tm.params, tm.tokenizer, "cpu"),
                 max_context=64, device="cpu")
    assert eng.embedding and eng.cache is None
    got = eng.embed(texts)
    assert got.shape == (2, tm.cfg.hidden_size)
    np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(ValueError):
        eng.generate([1, 2, 3], GenParams())


def test_pool_modes():
    """`pool`: the mean over the valid rows (padding rows left out), or
    row 0 under CLS; the JAX `pool`'s values."""
    h = np.random.default_rng(0).standard_normal((2, 5, 8)).astype(
        np.float32)
    pos = np.array([[0, 1, 2, -1, -1], [0, 1, 2, 3, 4]], np.int32)
    for mode in ("mean", "cls"):
        want = np.asarray(jbert.pool(jnp.asarray(h), jnp.asarray(pos), mode))
        got = bert.pool(torch.from_numpy(h), torch.from_numpy(pos), mode)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        bert.pool(torch.from_numpy(h), torch.from_numpy(pos), "mean")[0],
        h[0, :3].mean(0), rtol=1e-6, atol=1e-6)


def _t5_jax(jm, enc, dec, S=16):
    epos = jnp.arange(len(enc), dtype=jnp.int32)[None]
    e = jt5.encode(jm.params, jm.cfg, jnp.asarray([enc], jnp.int32), epos)
    c = jt5.prepare_cross(jm.params, jm.cfg, e, epos >= 0,
                          jt5.init_cache(jm.cfg, 1, S, len(enc)))
    lg, c = jt5.forward(jm.params, jm.cfg, jnp.asarray([dec], jnp.int32),
                        jnp.arange(len(dec), dtype=jnp.int32)[None], c)
    return np.asarray(lg)[0], c


def _t5_port_cache(tm, enc, S=16):
    epos = torch.arange(len(enc))[None]
    with torch.inference_mode():
        e = t5.encode(tm.params, tm.cfg, torch.tensor([enc]), epos)
        return t5.prepare_cross(tm.params, tm.cfg, e, epos >= 0,
                                t5.init_cache(tm.cfg, 1, S, len(enc)))


@pytest.mark.parametrize("ffn", ["relu", "gated-gelu"])
def test_t5_matches_jax(models, ffn):
    """The T5 decoder over the cached cross K / V: the port's logits and
    self-attention cache within 1e-4 of the JAX ones in one shot, and
    token by token (each step against the one-shot row)."""
    jm, tm = models[f"t5-{ffn}"]
    assert tm.cfg.is_encoder_decoder and tm.cfg.extras["rel_buckets"] == 8
    assert ("ffn_gate" in tm.params["dec_layers"][0]) == (ffn != "relu")
    enc, dec = [4, 9, 100, 7, 3, 51], [0, 12, 40, 8, 77]
    want, jc = _t5_jax(jm, enc, dec)
    cache = _t5_port_cache(tm, enc)
    with torch.inference_mode():
        got, cache = t5.forward(tm.params, tm.cfg, torch.tensor([dec]),
                                torch.arange(len(dec))[None], cache)
    np.testing.assert_allclose(got[0].numpy(), want, **TOL)
    np.testing.assert_allclose(cache.self_k.numpy(), np.asarray(jc.self_k),
                               **TOL)
    np.testing.assert_allclose(cache.cross_v.numpy(), np.asarray(jc.cross_v),
                               **TOL)
    cache = _t5_port_cache(tm, enc)
    rows = []
    with torch.inference_mode():
        for t, tok in enumerate(dec):
            lg, cache = t5.forward(tm.params, tm.cfg, torch.tensor([[tok]]),
                                   torch.tensor([[t]]), cache)
            rows.append(lg[0, 0].numpy())
    np.testing.assert_allclose(np.stack(rows), want, rtol=2e-4, atol=2e-4)


def test_relative_buckets_match_jax():
    """`relative_buckets` equals the JAX one for relative positions -300 ..
    300, bidirectional and causal, at 8 and 32 buckets."""
    rel = np.arange(-300, 301)
    for nb in (8, 32):
        for bidir in (True, False):
            want = np.asarray(jt5.relative_buckets(jnp.asarray(rel), nb,
                                                   bidir))
            got = t5.relative_buckets(torch.from_numpy(rel), nb, bidir)
            np.testing.assert_array_equal(got.numpy(), want)


def _greedy(n):
    return GenParams(max_length=n, use_default_badwordsids=True,
                     sampler=SamplerParams(temperature=0.0))


def _jgreedy(n):
    return JGenParams(max_length=n, use_default_badwordsids=True,
                      sampler=JSamplerParams(temperature=0.0))


def test_t5_engine_matches_jax_engine(models):
    """The port's Engine (the encoder-decoder branch: the encoder on every
    request, a fresh decoder cache from decoder_start, one-row steps)
    against the JAX Engine: the same greedy tokens, twice (no state kept
    between requests), and for another prompt."""
    jm, tm = models["t5-gated-gelu"]
    je = JEngine(jm, max_context=64)
    eng = Engine(tm, max_context=64, device="cpu")
    assert eng.encdec and not eng._fast_greedy_ok(_greedy(6), None)
    for prompt in ([4, 9, 100, 7], [4, 9, 100, 7], [30, 2, 8]):
        want = je.generate(prompt, _jgreedy(6)).tokens
        got = eng.generate(prompt, _greedy(6)).tokens
        assert got == want
        assert eng.context_tokens[0] == tm.cfg.extras["decoder_start"]
        assert eng.last_timings.prompt_tokens == 1
    with pytest.raises(ValueError, match="no state"):
        eng.save_state("unused.npz")


def test_t5_pad_rows_fault_of_the_reference(models):
    """A fault of the reference: the JAX T5 decoder scatters with
    mode="drop", which on this JAX wraps a padding row's position -1 to
    the cache's last slot (t5.py:196-199), so a left-padded chunk (the JAX
    engine's `_eval_chunk`) writes its pad rows' K / V into slot S - 1;
    the port drops them. That slot is masked for every row before the
    decoder reaches it, so the valid rows' logits agree (1e-4)."""
    jm, tm = models["t5-relu"]
    enc, S = [4, 9, 100, 7, 3, 51], 16
    dec, pos = [0] * 3 + [0, 12, 40], [-1] * 3 + [0, 1, 2]
    epos = jnp.arange(len(enc), dtype=jnp.int32)[None]
    e = jt5.encode(jm.params, jm.cfg, jnp.asarray([enc], jnp.int32), epos)
    jc = jt5.prepare_cross(jm.params, jm.cfg, e, epos >= 0,
                           jt5.init_cache(jm.cfg, 1, S, len(enc)))
    want, jc = jt5.forward(jm.params, jm.cfg, jnp.asarray([dec], jnp.int32),
                           jnp.asarray([pos], jnp.int32), jc)
    cache = _t5_port_cache(tm, enc, S)
    with torch.inference_mode():
        got, cache = t5.forward(tm.params, tm.cfg, torch.tensor([dec]),
                                torch.tensor([pos]), cache)
    np.testing.assert_allclose(got[0, 3:].numpy(), np.asarray(want)[0, 3:],
                               **TOL)
    assert np.abs(np.asarray(jc.self_k)[:, 0, S - 1]).max() > 1e-3
    assert cache.self_k[:, 0, S - 1].abs().max() == 0
    assert cache.self_k[:, 0, 3:S].abs().max() == 0


def test_params_from_jax_encoder_trees(models):
    """`params_from_jax` on the JAX bert and t5 trees (nested layer lists
    of dense weights, tables and norms) gives the port's keys and, through
    the port's forwards, the JAX numbers."""
    for name in ("jina-bert-v2", "t5-gated-gelu"):
        jm, tm = models[name]
        conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
        assert set(conv) == set(tm.params)
        model = Model(tm.cfg, conv, tm.tokenizer, "cpu")
        if name == "t5-gated-gelu":
            assert set(conv["dec_layers"][1]) == set(
                tm.params["dec_layers"][1])
            want, _ = _t5_jax(jm, TOKENS, [0, 12, 40])
            cache = _t5_port_cache(model, TOKENS)
            with torch.inference_mode():
                got, _ = t5.forward(conv, tm.cfg, torch.tensor([[0, 12, 40]]),
                                    torch.arange(3)[None], cache)
            np.testing.assert_allclose(got[0].numpy(), want, **TOL)
        else:
            want, got = _embed_both(name, jm, model, TOKENS,
                                    list(range(len(TOKENS))))
            np.testing.assert_allclose(got, want, **TOL)


async def test_embeddings_routes(models, aiohttp_client):
    """/v1/embeddings and /api/extra/embeddings on the port's app give
    `Engine.embed`'s vectors (the OpenAI list layout); the generate routes
    answer 400 for an embedding model."""
    tm = models["nomic-bert"][1]
    eng = Engine(tm, max_context=64, device="cpu")
    client = await aiohttp_client(make_app(eng, ServerSettings()))
    r = await client.post("/v1/embeddings", json={"input": ["abc", "xyz"]})
    assert r.status == 200
    d = await r.json()
    assert d["object"] == "list" and len(d["data"]) == 2
    assert d["data"][1]["index"] == 1
    np.testing.assert_allclose(np.array([e["embedding"] for e in d["data"]]),
                               eng.embed(["abc", "xyz"]), rtol=1e-6)
    r2 = await client.post("/api/extra/embeddings", json={"input": "abc"})
    d2 = await r2.json()
    np.testing.assert_allclose(d2["data"][0]["embedding"],
                               d["data"][0]["embedding"], rtol=1e-6)
    for route in ("/api/v1/generate", "/v1/completions"):
        r3 = await client.post(route, json={"prompt": "x"})
        assert r3.status == 400


def _manifest():
    return json.load(open(os.path.join(PORT_FIX, "text.json")))


@pytest.mark.parametrize("arch", ["nomic-bert", "t5"])
def test_fixture_matches_jax_numbers(arch):
    """The tiny nomic-bert and T5 Q4_K_M fixtures (tests/
    make_torch_fixtures.py --text) loaded packed in f32: nomic-bert's final
    hidden states over the manifest's tokens and T5's decoder logits
    (decoder start + the first 11 tokens, the 12 through the encoder)
    against the committed JAX numbers, |err| <= 2e-2 + 2e-2 |want|
    (test_torch_archs.py's fixture tolerance)."""
    man = _manifest()
    tm = load_model(os.path.join(PORT_FIX, man["files"][arch]),
                    dtype=torch.float32, device="cpu")
    toks = man["tokens"]
    pos = torch.arange(len(toks))[None]
    with torch.inference_mode():
        if arch == "nomic-bert":
            got = bert.forward_embed(tm.params, tm.cfg, torch.tensor([toks]),
                                     pos)[0].numpy()
        else:
            cache = _t5_port_cache(tm, toks, 64)
            dec = [tm.cfg.extras["decoder_start"]] + toks[:-1]
            got = t5.forward(tm.params, tm.cfg, torch.tensor([dec]), pos,
                             cache)[0][0].numpy()
    want = np.load(os.path.join(PORT_FIX, man["numbers"][arch]))
    worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())
    assert worst <= 1.0, worst
