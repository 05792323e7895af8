"""The port's q2_k and q3_k kinds (GGUF Q2_K and Q3_K; kernels K12, the T=1
matvec, and K13, the tiled matmul) against the JAX package, on the CPU
(plain kernel versions; the JAX side's Pallas kernels in interpret mode):
packing and dequant bit for bit on the tests/fixtures/portgguf fixtures,
the dispatch, the JAX synthetic params carried across, the fixtures'
logits, and serving over HTTP and through the batched engine."""
import dataclasses
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatchedEngine
from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.gguf.reader import GGUFReader
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.models.synthetic import synthetic_params as j_synth
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu.server.app import ServerSettings as JServerSettings
from koboldcpp_tpu.server.app import make_app as j_make_app
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.models.synthetic import rand_q2k, rand_q3k
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")
MANIFEST = json.load(open(os.path.join(FIX, "manifest.json")))
TOKENS = np.asarray([MANIFEST["tokens"]], dtype=np.int64)
LOWBIT = (GGMLType.Q2_K, GGMLType.Q3_K)
LOWBIT_FMTS = ("q2_k", "q3_k_m")  # the IQ fixtures: tests/test_torch_iq.py
PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of", "A B C D"]

SMALL = ModelConfig(arch="llama", name="small", vocab_size=512,
                    hidden_size=512, n_layers=2, n_heads=8, n_kv_heads=2,
                    head_dim=64, intermediate_size=1024,
                    max_position_embeddings=512, rope_theta=10000.0,
                    rope_dim=64)

_jax_dequant = jax.jit(jlinear.dequant_xla, static_argnames="dtype")
NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py


def _greedy(n=8, **kw):
    return GenParams(max_length=n, sampler=SamplerParams(temperature=0.0,
                                                         rep_pen=1.0), **kw)


def _assert_same_tokens(model, prompt, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits there (single-stream, on the port) within NEAR_TIE of
    each other: the tiny Q2_K fixture's logits lie close together, and
    two bf16-rounded paths may pick either of two tokens a bf16 step
    apart."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)  # one stopped early: not a tie
    ctx = model.tokenizer.encode(prompt) + got[:i]
    with torch.inference_mode():
        lg = Engine(model, max_context=256, device="cpu").eval_tokens(ctx, 0)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


def _path(fmt):
    return os.path.join(FIX, MANIFEST["files"][fmt])


def _assert_same_dequant(jq, tq):
    assert tq.kind == jq.kind and tuple(tq.shape) == tuple(jq.shape)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(_jax_dequant(jq, dtype=jdt).astype(jnp.float32))
        got = tlinear.dequant(tq, dtype=tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", LOWBIT_FMTS)
def test_fixture_packs_and_dequantizes_as_jax(fmt):
    """Every Q2_K / Q3_K tensor of both fixtures packs into q2_k / q3_k (no
    NotImplementedError) and dequantizes to JAX `dequant_xla`'s bits."""
    kinds = set()
    with GGUFReader(_path(fmt)) as r:
        for n, i in r.tensors.items():
            if i.ggml_type in LOWBIT:
                raw, shape = r.tensor_raw(n), tuple(i.shape)
                jq = jlinear.from_gguf(raw, i.ggml_type, shape, packed=True)
                tq = tlinear.from_gguf(raw, i.ggml_type, shape, packed=True)
                _assert_same_dequant(jq, tq)
                kinds.add(tq.kind)
    assert kinds == {"q2_k": {"q2_k", "q3_k"}, "q3_k_m": {"q3_k"}}[fmt]


def test_q3k_high_bit_order():
    """hmask bit 4h+j of byte l of superblock s is the 3rd bit of col
    256s+128h+32j+l: flipping it in the GGUF bytes moves exactly that
    weight's code by 4."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((256, 512)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, GGMLType.Q3_K)
    row, sb, l, h, j = 5, 1, 9, 1, 2
    flip = raw.copy()
    flip[row, sb * 110 + l] ^= 1 << (4 * h + j)

    def codes(r):
        qt = tlinear.from_gguf(r, GGMLType.Q3_K, (256, 512))
        return tlinear.q3k_values(qt.data["qs"], qt.data["hmask"]).int()

    diff = codes(flip) - codes(raw)
    col = sb * 256 + 128 * h + 32 * j + l
    assert diff.nonzero().tolist() == [[row, col]]
    assert abs(int(diff[row, col])) == 4


@pytest.mark.parametrize("t", LOWBIT, ids=lambda t: t.name)
def test_dispatch_k12_at_one_token_k13_above(t):
    """matmul_packed sends T=1 to K12 (int8 activations from in_f 512 up,
    bf16 below) and every T >= 2, the batched decode step included, to
    K13; out_f 128 is declined (the dequant path), as in JAX."""
    rng = np.random.default_rng(2)
    for in_f in (256, 512):
        w = (rng.standard_normal((256, in_f)) * 0.1).astype(np.float32)
        tq = tlinear.from_gguf(quants.quantize(w, t), t, (256, in_f))
        x = torch.from_numpy(rng.standard_normal((8, in_f)).astype(
            np.float32)).bfloat16()
        _build.launches.clear()
        assert torch.equal(tqm.matmul_packed(x[:1], tq),
                           tqm.q23k_matvec_plain(x[0], tq, in_f >= 512))
        assert not torch.equal(tqm.q23k_matvec_plain(x[0], tq, True),
                               tqm.q23k_matvec_plain(x[0], tq, False))
        for T in (2, 8):
            assert torch.equal(tqm.matmul_packed(x[:T], tq),
                               tqm.kq_matmul_plain(x[:T], tq))
        assert sum(_build.launches.values()) == 0  # plain versions
    narrow = tlinear.from_gguf(quants.quantize(w[:128], t), t, (128, 512))
    assert tqm.matmul_packed(x[:1], narrow) is None
    assert tqm.matmul_packed(x, narrow) is None


@pytest.mark.parametrize("kind", ["q2_k", "q3_k"])
def test_params_from_jax_and_synthetic_maker(kind):
    """A JAX synthetic q2_k / q3_k QTensor (plane-major scale_p / min_p,
    the hm2 sidecar) carried across by params_from_jax equals the port's
    maker on the same seed, field for field (the port's q3_k scales are
    the JAX draws / 2, exactly), and dequantizes to JAX's bits."""
    from koboldcpp_tpu.models import synthetic as jsyn

    jq = {"q2_k": jsyn._rand_q2k, "q3_k": jsyn._rand_q3k}[kind](
        np.random.default_rng(3), 256, 512)
    tq = {"q2_k": rand_q2k, "q3_k": rand_q3k}[kind](
        np.random.default_rng(3), 256, 512)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    assert got.kind == tq.kind and set(got.data) == set(tq.data)
    for name, v in tq.data.items():
        half = kind == "q3_k" and name == "scale"
        assert torch.equal(got.data[name] / 2 if half else got.data[name],
                           v), name
    _assert_same_dequant(jq, got)


def _run_steps(fwd, init, seed):
    """A 16-token prefill, then 3 single-token steps; every call's logits."""
    toks = np.random.default_rng(seed).integers(3, 500, size=19)
    cache = init()
    lg, cache = fwd(toks[None, :16], np.arange(16)[None], cache)
    out = [lg]
    for p in range(16, 19):
        lg, cache = fwd(toks[None, p:p + 1], np.array([[p]]), cache)
        out.append(lg)
    return out


@pytest.mark.parametrize("kind,tol", [("q2_k", 1e-2), ("q3_k", 4e-2)])
def test_synthetic_forward_matches_jax(kind, tol):
    """JAX synthetic q2_k / q3_k params through params_from_jax: the
    16-token prefill through K13 (T=16), the decode steps through K12
    (T=1, int8 activations at in_f 512 and 1024), each projection within a
    bf16 step of JAX's (test_torch_quant_matmul.py). q2_k is held at
    test_torch_forward.py's 1e-2 of the largest logit. The JAX q3_k maker's
    signed scales (weights of std ~0.027) make a model that amplifies such
    steps, as its q8_0 maker does: the test asserts that premise (the
    jitted JAX forward itself moves by more than 1e-2 of its largest logit
    when 1% of its bf16 embedding entries move by one step) and holds q3_k
    at 4e-2, test_synthetic_q8_0_forward_matches_jax's tolerance."""
    from koboldcpp_tpu.models.config import ModelConfig as JCfg

    jcfg = JCfg(**{f.name: getattr(SMALL, f.name)
                   for f in dataclasses.fields(SMALL)})
    jparams = j_synth(jcfg, kind=kind, seed=7)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert tparams["layers"][0]["w_down"].kind == kind
    f = jax.jit(lambda p, t, s, c: jllama.forward(p, jcfg, t, s, c,
                                                  last_only=True))

    def jax_steps(params):
        def jfwd(tok, pos, cache):
            lg, cache = f(params, jnp.asarray(tok, jnp.int32),
                          jnp.asarray(pos, jnp.int32), cache)
            return np.asarray(lg, np.float32)[0, -1], cache
        return _run_steps(jfwd, lambda: j_init_cache(
            2, 1, 64, 2, 64, dtype=jnp.bfloat16), 11)

    def tfwd(tok, pos, cache):
        with torch.inference_mode():
            lg, cache = tllama.forward(tparams, SMALL, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cache,
                                       last_only=True)
        return lg.float().numpy()[0, -1], cache

    want = jax_steps(jparams)
    got = _run_steps(tfwd, lambda: t_init_cache(2, 1, 64, 2, 64), 11)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= tol * np.abs(w).max()
    if tol > 1e-2:
        emb = jparams["tok_embd"]
        bits = np.asarray(emb.data["w"]).view(np.uint16).copy()
        bits[np.random.default_rng(0).random(bits.shape) < 0.01] += 1
        moved = dict(jparams, tok_embd=dataclasses.replace(
            emb, data={"w": jnp.asarray(bits.view(jnp.bfloat16))}))
        spread = max(np.abs(m - w).max() / np.abs(w).max()
                     for m, w in zip(jax_steps(moved), want))
        assert spread > 1e-2


@pytest.mark.parametrize("fmt", LOWBIT_FMTS)
def test_fixture_logits_match_jax(fmt):
    """Both fixtures loaded packed in f32: the port's logits within 1e-2 of
    the JAX forward's, computed now and as committed (logits-jax-*.npy)."""
    m = load_model(_path(fmt), dtype=torch.float32, device="cpu")
    cache = t_init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=torch.float32)
    pos = torch.arange(TOKENS.shape[1])[None]
    with torch.inference_mode():
        got, _ = tllama.forward(m.params, m.cfg, torch.from_numpy(TOKENS),
                                pos, cache)
    got = got[0].numpy()
    jm = j_load_model(_path(fmt), packed=True, dtype=jnp.float32)
    jc = j_init_cache(jm.cfg.n_layers, 1, 64, jm.cfg.n_kv_heads,
                      jm.cfg.head_dim, dtype=jnp.float32)
    want, _ = jax.jit(lambda p, t, s, c: jllama.forward(p, jm.cfg, t, s, c))(
        jm.params, jnp.asarray(TOKENS, jnp.int32),
        jnp.asarray(pos.numpy(), jnp.int32), jc)
    want = np.asarray(want)[0]
    committed = np.load(os.path.join(FIX, f"logits-jax-{fmt}.npy"))
    np.testing.assert_array_equal(want, committed)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("fmt", LOWBIT_FMTS)
async def test_served_text_matches_jax_server(fmt, aiohttp_client):
    """/api/v1/generate at temperature 0 on both servers (single-stream
    engines, bf16 caches): the same text twice over on the port, and the
    JAX server's text; where the two servers' texts part, the engines'
    tokens for the request part at a near-tie (see _assert_same_tokens)."""
    gen = {"prompt": PROMPTS[0], "max_length": 8, "temperature": 0,
           "rep_pen": 1.0}
    model = load_model(_path(fmt), device="cpu")
    eng = Engine(model, max_context=512, device="cpu")
    jeng = JEngine(j_load_model(_path(fmt)), max_context=512,
                   cache_dtype=jnp.bfloat16)
    port = await aiohttp_client(make_app(
        eng, ServerSettings(model_name=f"tiny-{fmt}")))
    ref = await aiohttp_client(j_make_app(
        jeng, JServerSettings(model_name=f"tiny-{fmt}")))
    texts = []
    for client in (port, port, ref):
        r = await client.post("/api/v1/generate", json=gen)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] and texts[0] == texts[1]
    if texts[0] != texts[2]:
        eng.reset_context()
        jeng.reset_context()
        got = eng.generate(PROMPTS[0], _greedy()).tokens
        want = jeng.generate(PROMPTS[0], JGenParams(
            max_length=8, sampler=JSamplerParams(temperature=0.0,
                                                 rep_pen=1.0))).tokens
        assert got != want
        _assert_same_tokens(model, PROMPTS[0], got, want)


def test_multiuser_q2_k_matches_jax_batched_engine():
    """Four concurrent greedy requests through the port's BatchedEngine (4
    slots: each decode step is a (4, 1) forward, so the q2_k / q3_k
    projections run K13) get the tokens the JAX BatchedEngine gives each
    request (its 2-D `_q2k_kernel` / `_q3k_kernel` in interpret mode),
    near-ties apart."""
    gp = JGenParams(max_length=8, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    jeng = JBatchedEngine(j_load_model(_path("q2_k")), max_context=256,
                          n_slots=4, cache_dtype=jnp.bfloat16)
    try:
        want = [jeng.generate(p, gp).tokens for p in PROMPTS]
    finally:
        jeng.shutdown()
    model = load_model(_path("q2_k"), device="cpu")
    eng = BatchedEngine(model, max_context=256, n_slots=4, device="cpu")
    got = [None] * len(PROMPTS)

    def run(i):
        got[i] = eng.generate(PROMPTS[i], _greedy(bypass_eos=True)).tokens

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        eng.shutdown()
    for p, g, w in zip(PROMPTS, got, want):
        _assert_same_tokens(model, p, g, w)
