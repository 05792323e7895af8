"""The single-stream engine's device-side stochastic decode chunks
(engine/device_sampler.py: `sample_step`, `make_stoch_chunk`; Engine's
`_fast_stoch_ok` and the stochastic branch of the pipelined dispatch)
against the JAX package, on the committed Q4_K_M fixture (CPU, plain
kernel versions): the same gate, the same candidate distribution, the
rep-pen window carried across a chunk, the greedy tokens at top-k 1, seeded
repeatability through the HTTP API, and the empirical frequencies of the
draw."""
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine import device_sampler as jds
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine import device_sampler as tds
from koboldcpp_tpu_torch.engine import engine as tengine
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

from .test_torch_batch_engine import assert_same_tokens

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf", "tiny-q4_k_m.gguf")
PROMPT = "The gradient of a function, e.g. f(x), points uphill."
MAX_CTX = 256
PRESET = dict(temperature=0.8, top_p=0.9, min_p=0.05, rep_pen=1.1)


@pytest.fixture(scope="module")
def model():
    return load_model(FIX, device="cpu")


@pytest.fixture(scope="module")
def engine(model):
    return Engine(model, max_context=MAX_CTX, device="cpu")


@pytest.fixture(scope="module")
def jengine():
    return JEngine(j_load_model(FIX), max_context=MAX_CTX,
                   cache_dtype=jnp.bfloat16)


# the sampler cases of tests/test_device_sampler.py::test_gate, and the
# host-only stages and switches around them
GATE_CASES = {
    "default_seeded": (dict(seed=1), {}, None),
    "mirostat": (dict(mirostat=2), {}, None),
    "xtc": (dict(xtc_probability=0.5), {}, None),
    "greedy": (dict(temperature=0.0), {}, None),
    "dry": (dict(dry_multiplier=0.8), {}, None),
    "rep_pen_not_leading": (dict(sampler_order=(0, 6, 2, 5)), {}, None),
    "rep_pen_off_any_order": (dict(sampler_order=(0, 6, 2, 5), rep_pen=1.0),
                              {}, None),
    "top_a": (dict(top_a=0.2), {}, None),
    "tfs": (dict(tfs=0.9), {}, None),
    "typical": (dict(typical_p=0.9), {}, None),
    "dynatemp": (dict(dynatemp_range=0.5), {}, None),
    "smoothing": (dict(smoothing_factor=0.3), {}, None),
    "banned_phrases": (dict(seed=1), dict(banned_phrases=["foo"]), None),
    "biases_and_bans": (dict(logit_biases={3: 2.0}, banned_tokens=(5,)),
                        {}, None),
    "fast_decode_off": (dict(seed=1), {}, "0"),
}


@pytest.mark.parametrize("case", sorted(GATE_CASES))
def test_fast_stoch_gate_matches_jax(case, engine, jengine, monkeypatch):
    sp, gp, fast = GATE_CASES[case]
    if fast is not None:
        monkeypatch.setenv("KCPP_FAST_DECODE", fast)
    want = jengine._fast_stoch_ok(
        JGenParams(sampler=JSamplerParams(**sp), **gp), None)
    got = engine._fast_stoch_ok(
        GenParams(sampler=SamplerParams(**sp), **gp), None)
    assert got == want
    # the greedy gate reads the same switch
    gsp = dict(sp, temperature=0.0, rep_pen=1.0)
    assert engine._fast_greedy_ok(
        GenParams(sampler=SamplerParams(**gsp), **gp), None) == \
        jengine._fast_greedy_ok(
            JGenParams(sampler=JSamplerParams(**gsp), **gp), None)


def _step_inputs(engine, sp, ctx_len=40):
    """The fixture's logits after a prompt, the right-aligned rep-pen window
    of its tokens and the bias row the engine builds."""
    tk = engine.tokenizer
    ctx = tk.encode(PROMPT)[:ctx_len]
    engine.reset_context()
    with torch.inference_mode():
        logits = engine.eval_tokens(ctx, 0).float()
    rec = np.zeros(MAX_CTX, np.int64)
    rec[-len(ctx):] = ctx
    bias = np.zeros(logits.shape[0], np.float32)
    for tid, b in sp.logit_biases.items():
        bias[tid] += np.float32(b)
    for t in sp.banned_tokens:
        bias[t] = np.float32(-1e30)
    return logits, torch.from_numpy(bias), torch.from_numpy(rec), len(ctx)


SP_CASES = {
    "preset": SamplerParams(**PRESET),
    "top_k_temp_first": SamplerParams(temperature=0.6, top_k=20, top_p=0.95,
                                      rep_pen=1.2, rep_pen_range=16,
                                      sampler_order=(6, 5, 0, 2)),
    "biases_presence": SamplerParams(temperature=1.1, top_k=0, top_p=1.0,
                                     presence_penalty=0.5,
                                     logit_biases={7: 3.0, 11: -2.0},
                                     banned_tokens=(1, 2)),
}


@pytest.mark.parametrize("name", sorted(SP_CASES))
def test_sample_step_distribution_matches_jax(name, engine):
    """The chain sample_step draws from (one row) puts the same
    probabilities on the fixture's vocabulary as the JAX chain, within
    1e-5, and sample_step's draw lies in that support."""
    sp = SP_CASES[name]
    logits, bias, rec, count = _step_inputs(engine, sp)
    want = np.asarray(jds.candidate_distribution(
        jnp.asarray(logits.numpy()), jnp.asarray(bias.numpy()),
        jnp.asarray(rec.numpy(), jnp.int32), jnp.int32(count),
        jds.make_dyn(sp, MAX_CTX), sp.sampler_order))
    dyn = tds.make_dyn(sp, MAX_CTX)
    got = tds.candidate_distribution(logits, bias, rec, count, dyn,
                                     sp.sampler_order).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    g = torch.Generator().manual_seed(5)
    for _ in range(20):
        tok = tds.sample_step(logits, bias, rec, torch.tensor([count]), g,
                              dyn, sp.sampler_order)
        assert tok.shape == (1,) and want[int(tok)] > 0


def test_sample_step_frequencies_match_jax(engine):
    """4000 draws of sample_step at one fixed step: every token's
    frequency within 0.03 of the JAX package's candidate probability."""
    sp = SamplerParams(temperature=1.5, top_k=8, top_p=1.0, rep_pen=1.1)
    logits, bias, rec, count = _step_inputs(engine, sp)
    want = np.asarray(jds.candidate_distribution(
        jnp.asarray(logits.numpy()), jnp.asarray(bias.numpy()),
        jnp.asarray(rec.numpy(), jnp.int32), jnp.int32(count),
        jds.make_dyn(sp, MAX_CTX), sp.sampler_order))
    dyn = tds.make_dyn(sp, MAX_CTX)
    g = torch.Generator().manual_seed(11)
    cnt = torch.tensor([count])
    n = 4000
    with torch.inference_mode():
        toks = torch.cat([tds.sample_step(logits, bias, rec, cnt, g, dyn,
                                          sp.sampler_order)
                          for _ in range(n)])
    freq = np.bincount(toks.numpy(), minlength=want.shape[0]) / n
    assert (want > 0).sum() >= 4  # a draw over several candidates
    assert np.abs(freq - want).max() <= 0.03, np.abs(freq - want).max()


def test_chunk_carries_recent_and_count(engine, monkeypatch):
    """One chunk: the returned window and count equal those rebuilt from
    the context plus the chunk's tokens; nothing in the chunk pulls a
    value to the host."""
    sp = SamplerParams(seed=3, **PRESET)
    logits, bias, rec, count = _step_inputs(engine, sp, ctx_len=12)
    ctx = rec[-count:].tolist()
    chunk = engine._get_stoch_chunk(sp.sampler_order)
    g = torch.Generator().manual_seed(3)

    def boom(*a, **k):
        raise AssertionError("host sync inside the chunk")

    with monkeypatch.context() as m:
        for meth in ("item", "tolist", "cpu", "numpy"):
            m.setattr(torch.Tensor, meth, boom)
        toks, last, recent, cnt = chunk(
            logits, count, bias, rec, torch.tensor([count]), g,
            tds.make_dyn(sp, MAX_CTX))
    K = tengine.FAST_DECODE_K
    toks = toks.tolist()
    assert len(toks) == K and last.shape == logits.shape
    full = ctx + toks
    want = np.zeros(MAX_CTX, np.int64)
    want[-len(full):] = full
    np.testing.assert_array_equal(recent.numpy(), want)
    assert cnt.tolist() == [min(len(full), MAX_CTX)]


def test_top_k_1_gives_the_jax_greedy_tokens(model, engine, jengine):
    """At top-k 1 (rep-pen off) the stochastic chunk can only take the
    argmax: the port's greedy chunks' tokens exactly, and the JAX engine's
    greedy tokens up to a near-tie (2^-6), across two chunks."""
    n = 2 * tengine.FAST_DECODE_K + 5
    jengine.reset_context()
    want = jengine.generate(PROMPT, JGenParams(
        max_length=n, bypass_eos=True,
        sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))).tokens
    engine.reset_context()
    greedy = engine.generate(PROMPT, GenParams(
        max_length=n, bypass_eos=True,
        sampler=SamplerParams(temperature=0.0, rep_pen=1.0))).tokens
    gp = GenParams(max_length=n, bypass_eos=True, sampler=SamplerParams(
        temperature=0.8, top_k=1, rep_pen=1.0, seed=9))
    assert engine._fast_stoch_ok(gp, None)
    engine.reset_context()
    calls = []
    real = engine._get_stoch_chunk
    engine._get_stoch_chunk = lambda order: calls.append(order) or real(order)
    try:
        got = engine.generate(PROMPT, gp).tokens
    finally:
        del engine._get_stoch_chunk
    assert calls and got == greedy
    assert_same_tokens(model, PROMPT, got, want)


def test_stoch_chunks_equal_the_host_loop_at_near_zero_temperature(
        monkeypatch):
    """tests/test_device_sampler.py's near-greedy case on the port: at
    temperature 1e-5 the chunks and the host-sampled loop (forced with
    KCPP_FAST_DECODE=0) give the same tokens, rep-pen carried across
    chunks. Dense f32 weights, as the JAX case's model: the host loop's
    steps run 16-row buckets, the chunks T=1 forwards, and packed weights
    round those two apart at near-ties."""
    engine = Engine(load_model(FIX, device="cpu", packed=False,
                               dtype=torch.float32),
                    max_context=MAX_CTX, device="cpu")
    sp = SamplerParams(temperature=1e-5, rep_pen=1.3, rep_pen_range=32,
                       top_k=50, top_p=0.9, seed=3)
    gp = GenParams(max_length=40, sampler=sp, use_default_badwordsids=True)
    engine.reset_context()
    fast = engine.generate(PROMPT, gp)
    monkeypatch.setenv("KCPP_FAST_DECODE", "0")
    assert not engine._fast_stoch_ok(gp, None)
    engine.reset_context()
    host = engine.generate(PROMPT, gp)
    assert fast.tokens == host.tokens and fast.text == host.text


async def test_same_seed_same_text_over_http(engine, aiohttp_client):
    client = await aiohttp_client(make_app(engine, ServerSettings(
        model_name="test/tiny-q4_k_m")))
    body = {"prompt": PROMPT, "max_length": 40, "sampler_seed": 77,
            "temperature": 0.8, "top_p": 0.9, "min_p": 0.05, "rep_pen": 1.1}
    texts = []
    for _ in range(2):
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] == texts[1] and texts[0]


def test_fast_decode_k_from_the_environment():
    code = ("from koboldcpp_tpu_torch.engine import engine as e; "
            "print(e.FAST_DECODE_K)")
    env = dict(os.environ, KCPP_FAST_DECODE_K="8", PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "8", out.stderr[-2000:]
