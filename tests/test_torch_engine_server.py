"""The port's Engine and HTTP server on the committed Q4_K_M fixture (CPU,
plain kernel versions): the same greedy tokens as the JAX Engine, and the
black-box API checks of tests/test_server.py."""
import os

import jax.numpy as jnp
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import STATE, ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
PROMPT = "The gradient of a function, e.g. f(x), points uphill."
GEN = {"prompt": PROMPT, "max_length": 6, "temperature": 0, "rep_pen": 1.0}


@pytest.fixture(scope="module")
def engine():
    return Engine(load_model(FIX, device="cpu"), max_context=512,
                  device="cpu")


@pytest.fixture
async def client(engine, aiohttp_client):
    return await aiohttp_client(make_app(engine, ServerSettings(
        model_name="test/tiny-q4_k_m")))


def test_greedy_tokens_match_jax_engine(engine):
    """Both engines prefill the prompt in a left-padded 16-row bucket and
    decode greedily in device chunks; packed q4_k/q6_k weights and a bf16
    cache on both sides."""
    jeng = JEngine(j_load_model(FIX), max_context=512,
                   cache_dtype=jnp.bfloat16)
    want = jeng.generate(PROMPT, JGenParams(
        max_length=8, sampler=JSamplerParams(temperature=0.0, rep_pen=1.0),
        bypass_eos=True)).tokens
    engine.reset_context()
    got = engine.generate(PROMPT, GenParams(
        max_length=8, sampler=SamplerParams(temperature=0.0, rep_pen=1.0),
        bypass_eos=True)).tokens
    assert got == want


def test_fast_forward_and_context_shift(engine):
    gp = GenParams(max_length=4, sampler=SamplerParams(temperature=0.0,
                                                       rep_pen=1.0),
                   bypass_eos=True)
    engine.reset_context()
    first = engine.generate(PROMPT, gp)
    assert engine.last_timings.prompt_tokens > 1
    again = engine.generate(PROMPT, gp)
    assert engine.last_timings.prompt_tokens == 1  # the prefix was reused
    assert again.tokens == first.tokens
    # a history that scrolled: drop a gap after the first sentence and
    # keep a >= 96-token tail; the cache slides instead of re-evaluating
    head = engine.tokenizer.encode("Once upon a time. ")
    gap = engine.tokenizer.encode("This part scrolls away. " * 4)
    tail = engine.tokenizer.encode("the river ran past the old mill " * 12)
    engine.reset_context()
    engine.generate(head + gap + tail, gp)
    shifted = engine.generate(head + tail + engine.tokenizer.encode(" and"),
                              gp)
    assert engine.last_timings.prompt_tokens < 10
    assert len(shifted.tokens) == 4


def _greedy(max_length, **kw):
    return GenParams(max_length=max_length, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0), **kw)


def test_grammar_constrains_output(engine):
    engine.reset_context()
    r = engine.generate(PROMPT, _greedy(6, grammar="root ::= [0-9]+"))
    assert r.text and all(c.isdigit() for c in r.text)


def test_antislop_rewinds_and_bans(engine, monkeypatch):
    """Anti-slop on the host sampling loop: the banned phrase never shows,
    the cache bookkeeping matches the output after the rewind, held-back
    streaming flushes to exactly the final text, and reruns repeat."""
    monkeypatch.setattr(engine, "_fast_greedy_ok", lambda params, g: False)
    tk = engine.tokenizer
    engine.reset_context()
    r1 = engine.generate(PROMPT, _greedy(8))
    phrase = b"".join(tk.decode_token_bytes(t, skip_special=False)
                      for t in r1.tokens[2:4]).decode("utf-8", "ignore")
    assert phrase.strip()
    engine.reset_context()
    pieces = []
    r2 = engine.generate(PROMPT, _greedy(8, banned_phrases=[phrase]),
                         on_token=lambda t, s: pieces.append(s))
    assert phrase.lower() not in r2.text.lower()
    assert r2.tokens != r1.tokens
    assert engine.context_tokens == tk.encode(PROMPT) + r2.tokens
    assert "".join(pieces) == r2.text
    engine.reset_context()
    r3 = engine.generate(PROMPT, _greedy(8, banned_phrases=[phrase]))
    assert r3.tokens == r2.tokens


def test_abort_mid_generation(engine):
    engine.reset_context()
    r = engine.generate(PROMPT, _greedy(50),
                        on_token=lambda t, s: engine.abort())
    assert r.stop_reason == "abort" and len(r.tokens) <= 2


def test_cli_one_shot_and_unserved_flag(capsys):
    from koboldcpp_tpu_torch import cli

    # --mesh is served now: a mesh of more ranks than visible GPUs raises
    # (here no GPU), as the JAX launcher's make_mesh raises
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 GPUs"):
            cli.main([FIX, "--mesh", "1,2"])
    # --sdmodel is served: a missing file is skipped under --ignoremissing
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "256",
                     "--prompt", PROMPT, "--promptlimit", "4",
                     "--sdmodel", "1", "--ignoremissing"]) == 0
    out = capsys.readouterr().out
    assert "on cpu" in out and "skipping missing sdmodel 1" in out


async def test_generate_is_deterministic(client):
    r1 = await client.post("/api/v1/generate", json=GEN)
    r2 = await client.post("/api/v1/generate", json=GEN)
    assert r1.status == 200 and r2.status == 200
    t1 = (await r1.json())["results"][0]["text"]
    assert t1 == (await r2.json())["results"][0]["text"] and t1


async def test_seeded_sampling_is_deterministic(client):
    body = {**GEN, "temperature": 1.0, "sampler_seed": 1234}
    r1 = await client.post("/api/v1/generate", json=body)
    r2 = await client.post("/api/v1/generate", json=body)
    assert (await r1.json()) == (await r2.json())


async def test_fast_forward_through_the_api(client):
    await client.post("/api/v1/generate", json=GEN)
    await client.post("/api/v1/generate", json=GEN)
    perf = await (await client.get("/api/extra/perf")).json()
    assert perf["idle"] == 1 and perf["total_gens"] >= 2
    assert client.server.app[STATE].engine.last_timings.prompt_tokens == 1


async def test_stop_sequence(client):
    full = (await (await client.post("/api/v1/generate", json={
        **GEN, "max_length": 8})).json())["results"][0]["text"]
    stop = full[2:4]
    j = await (await client.post("/api/v1/generate", json={
        **GEN, "max_length": 8, "stop_sequence": [stop]})).json()
    text = j["results"][0]["text"]
    assert j["results"][0]["finish_reason"] == "stop"
    assert stop not in text and full.startswith(text)


async def test_openai_endpoints_and_stream(client):
    j = await (await client.post("/v1/completions", json={
        "prompt": PROMPT, "max_tokens": 3, "temperature": 0})).json()
    assert j["object"] == "text_completion"
    j = await (await client.post("/v1/chat/completions", json={
        "messages": [{"role": "user", "content": "hi"}], "max_tokens": 3,
        "temperature": 0})).json()
    assert j["choices"][0]["message"]["role"] == "assistant"
    r = await client.post("/api/extra/generate/stream", json=GEN)
    assert r.headers["Content-Type"].startswith("text/event-stream")
    assert "finish_reason" in (await r.read()).decode()


async def test_info_and_tokencount(client):
    assert (await (await client.get("/api/v1/model")).json())["result"] == \
        "test/tiny-q4_k_m"
    assert (await (await client.get(
        "/api/v1/config/max_context_length")).json())["value"] == 512
    j = await (await client.post("/api/extra/tokencount",
                                 json={"prompt": PROMPT})).json()
    assert j["value"] == len(j["ids"]) > 0
    r = await client.post("/api/v1/generate", json=GEN,
                          headers={"Origin": "x"})
    assert r.headers["Access-Control-Allow-Origin"] == "*"


async def test_auth(engine, aiohttp_client):
    c = await aiohttp_client(make_app(engine, ServerSettings(password="k")))
    assert (await c.post("/api/v1/generate", json=GEN)).status == 401
    r = await c.post("/api/v1/generate", json=GEN,
                     headers={"Authorization": "Bearer k"})
    assert r.status == 200
