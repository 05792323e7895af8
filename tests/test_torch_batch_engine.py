"""The port's continuous-batching engine (`BatchedEngine`, `--multiuser N`)
on the committed Q4_K_M fixture (CPU, plain kernel versions): the JAX
BatchedEngine's greedy tokens on the slot cache and the paged pool, and the
points of tests/test_batch_engine.py (concurrency, paged == slot, page
accounting, fast-forward, abort, context shift, interleaved admission,
stop/grammar/anti-slop parity with the single engine), plus the
`--multiuser` server and CLI."""
import asyncio
import dataclasses
import os
import threading

import jax.numpy as jnp
import pytest
import torch

from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatchedEngine
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine import batch_engine as be
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.models.loader import Model, load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import STATE, ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of"]


# bf16 logits: a step where two tokens' logits lie within a few bf16 steps
# (2^-8 relative) may pick either, depending on where each side rounds
NEAR_TIE = 2 ** -6


def assert_same_tokens(model, prompt, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits at that step (single-stream, on the port) within
    NEAR_TIE of each other."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)  # one stopped early: not a tie
    ctx = model.tokenizer.encode(prompt) + got[:i]
    with torch.inference_mode():
        lg = Engine(model, max_context=256, device="cpu").eval_tokens(ctx, 0)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


def greedy(n=8, **kw):
    return GenParams(max_length=n, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0), **kw)


@pytest.fixture(scope="module")
def model():
    return load_model(FIX, device="cpu")


@pytest.fixture(scope="module")
def slot_engine(model):
    eng = BatchedEngine(model, max_context=256, n_slots=4, device="cpu")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def paged_engine(model):
    eng = BatchedEngine(model, max_context=256, n_slots=4, paged=True,
                        page_size=16, device="cpu")
    yield eng
    eng.shutdown()


@pytest.fixture(scope="module")
def jax_tokens():
    """The JAX BatchedEngine's greedy tokens for PROMPTS, serially, on the
    slot cache and on the paged pool (bf16, n_slots 4: its decode steps run
    the batched q4_k matvec and, paged, `decode_attention_paged` in
    interpret mode). Each engine is built once.

    The JAX paged engine keeps page 0 out of its free list here: a dead
    slot's row of the page table is all zeros, and `decode_attention_paged`
    writes back the page its overshoot path maps (page 0) in the same call
    in which a live slot writes its new row into page 0, which undoes that
    write. With page 0 in use, its second prompt parts from its own slot-cache
    run at a step whose logits are 0.07 apart. The port's K8 writes nothing
    for a dead slot."""
    jm = j_load_model(FIX)
    gp = JGenParams(max_length=8, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    out = {}
    for kind, kw in (("slot", {}), ("paged", {"paged": True, "page_size": 16})):
        eng = JBatchedEngine(jm, max_context=256, n_slots=4,
                             cache_dtype=jnp.bfloat16, **kw)
        if kind == "paged":
            eng.allocator.free.remove(0)
        try:
            out[kind] = [eng.generate(p, gp).tokens for p in PROMPTS]
        finally:
            eng.shutdown()
    return out


def _engine(request, kind):
    return request.getfixturevalue(f"{kind}_engine")


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_greedy_tokens_match_jax_batched_engine(request, kind, jax_tokens,
                                                model):
    """The JAX engine's tokens, near-ties apart (the first token of the
    third prompt is one: its two best logits lie one bf16 step apart)."""
    eng = _engine(request, kind)
    eng.reset_context()
    for p, want in zip(PROMPTS, jax_tokens[kind]):
        assert_same_tokens(model, p, eng.generate(p, greedy()).tokens, want)
    assert eng.generate(PROMPTS[0], greedy()).tokens == jax_tokens[kind][0]


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_concurrent_requests_batch_together(request, kind):
    """Concurrent results equal serial ones: batching does not mix rows."""
    eng = _engine(request, kind)
    prompts = PROMPTS + ["A B C D"]
    results = [None] * len(prompts)

    def run(i):
        results[i] = eng.generate(prompts[i], greedy())

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert all(r is not None and len(r.tokens) == 8 for r in results)
    eng.reset_context()
    assert [r.tokens for r in results] == [eng.generate(p, greedy()).tokens
                                           for p in prompts]


def test_paged_matches_slot(slot_engine, paged_engine):
    for eng in (slot_engine, paged_engine):
        eng.reset_context()
    for p in PROMPTS:
        assert (paged_engine.generate(p, greedy(6)).tokens
                == slot_engine.generate(p, greedy(6)).tokens)


def test_queue_overflow_handled(slot_engine):
    """More requests than slots: all complete."""
    reqs = [slot_engine.submit([1, i + 2], greedy(4)) for i in range(7)]
    assert all(r.done.wait(timeout=120) for r in reqs)
    assert all(r.result.stop_reason == "length" and len(r.result.tokens) == 4
               for r in reqs)


def test_many_threads_submit_at_once(slot_engine):
    """16 client threads (more than the cores) submit and abort while the
    worker runs, with the interpreter switching threads every microsecond:
    every request finishes, each non-aborted one with the tokens it gets
    alone, and no slot is left holding a request."""
    import sys

    prompts = [[1, 3 + i % 5, 40 + i % 3] for i in range(16)]
    slot_engine.reset_context()
    alone = {tuple(p): slot_engine.generate(p, greedy(4)).tokens
             for p in prompts[:15]}
    results = [None] * 16
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def run(i):
            req = slot_engine.submit(prompts[i], greedy(4 if i < 15 else 40),
                                     genkey=f"S{i}")
            if i == 15:
                slot_engine.abort("S15")
            results[i] = req.result if req.done.wait(120) else None

        threads = [threading.Thread(target=run, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert all(r is not None for r in results)
    assert results[15].stop_reason == "abort"
    for p, r in zip(prompts[:15], results[:15]):
        assert r.stop_reason == "length" and r.tokens == alone[tuple(p)]
    assert not any(s.active for s in slot_engine.slots)


def test_paged_page_accounting(paged_engine):
    a = paged_engine.allocator
    paged_engine.reset_context()
    prompt = [1, 5, 9] + [7] * 30
    r = paged_engine.generate(prompt, greedy(4))
    assert len(r.tokens) == 4
    # the slot keeps the pages of its context for fast-forward reuse
    held = {s: len(p) for s, p in a.slot_pages.items() if p}
    assert a.n_free + sum(held.values()) == a.n_pages
    assert max(held.values()) >= -(-(len(prompt) + 3) // a.page_size)
    # a shorter request on that slot trims its pages to the reused prefix
    r2 = paged_engine.generate(prompt[:5], greedy(2))
    assert len(r2.tokens) == 2
    assert a.n_free + sum(len(p) for p in a.slot_pages.values()) == a.n_pages


@pytest.mark.parametrize("kind", ["slot", "paged"])
def test_slot_fast_forward(request, kind):
    eng = _engine(request, kind)
    p = [1, 5, 9, 42]
    r1 = eng.generate(p, greedy(4))
    r2 = eng.generate(p + r1.tokens[:-1] + [7], greedy(4))
    # only the tail is prefilled on the reused slot
    assert r2.timings.prompt_tokens <= 3


def test_abort_by_genkey(slot_engine):
    def cb(t, s):
        slot_engine.abort("KEY1")

    req = slot_engine.submit([1, 5], greedy(50), on_token=cb, genkey="KEY1")
    other = slot_engine.submit([1, 6], greedy(12), genkey="KEY2")
    assert req.done.wait(timeout=120) and other.done.wait(timeout=120)
    assert req.result.stop_reason == "abort" and len(req.result.tokens) < 50
    assert other.result.stop_reason == "length"


def test_context_shift(slot_engine):
    """A scrolled-history prompt reuses the slot's rows via per-slot context
    shift: only the genuinely new tail is evaluated."""
    base = [1, 5] + [(7 * i) % 500 + 2 for i in range(116)]
    slot_engine.reset_context()
    slot_engine.generate(base, greedy(2))
    scrolled = base[:4] + base[16:] + [9, 11]
    r = slot_engine.generate(scrolled, greedy(2))
    assert r.timings.prompt_tokens <= 8


def test_interleaved_admission_preserves_outputs(model):
    """A long prompt (3 prefill chunks) admitted while another slot decodes
    changes neither slot's output."""
    eng = BatchedEngine(model, max_context=512, n_slots=2, device="cpu")
    try:
        long_prompt = [1] + [(13 * i) % 500 + 2 for i in range(300)]
        short = [1, 5, 9]
        ref_short = eng.generate(short, greedy(12)).tokens
        ref_long = eng.generate(long_prompt, greedy(4)).tokens
        eng.reset_context()
        a = eng.submit(short, greedy(12))
        b = eng.submit(long_prompt, greedy(4))
        assert a.done.wait(timeout=120) and b.done.wait(timeout=120)
        assert a.result.tokens == ref_short
        assert b.result.tokens == ref_long
    finally:
        eng.shutdown()


def _pair_run(model, batched, prompt, gp):
    simple = Engine(model, max_context=256, device="cpu")
    want = simple.generate(prompt, gp)
    batched.reset_context()
    return want, batched.generate(prompt, gp)


def test_parity_stop_sequences(model, slot_engine):
    r0 = Engine(model, max_context=256, device="cpu").generate(
        PROMPTS[0], greedy(8))
    stop = r0.text[2:4]
    want, got = _pair_run(model, slot_engine, PROMPTS[0],
                          greedy(8, stop_sequences=[stop]))
    assert want.stop_reason == got.stop_reason == "stop_sequence"
    assert got.text == want.text


def test_parity_grammar(model, slot_engine):
    want, got = _pair_run(model, slot_engine, PROMPTS[0],
                          greedy(6, grammar="root ::= [0-9]+"))
    assert got.tokens == want.tokens and got.text == want.text
    assert got.text and all(c.isdigit() for c in got.text)


def test_parity_antislop_rewind(model, slot_engine):
    tk = model.tokenizer
    r0 = Engine(model, max_context=256, device="cpu").generate(
        PROMPTS[0], greedy(8))
    phrase = b"".join(tk.decode_token_bytes(t, skip_special=False)
                      for t in r0.tokens[2:4]).decode("utf-8", "ignore")
    gp = greedy(8, banned_phrases=[phrase])
    want, got = _pair_run(model, slot_engine, PROMPTS[0], gp)
    assert phrase.lower() not in got.text.lower()
    # the replay after a rewind is a T=1 step here (K7 rows) and a padded
    # 16-row chunk (K3) in the single engine: near-ties may part
    assert_same_tokens(model, PROMPTS[0], got.tokens, want.tokens)
    pieces = []
    slot_engine.reset_context()
    r = slot_engine.generate(PROMPTS[0], gp,
                             on_token=lambda t, s: pieces.append(s))
    assert "".join(pieces) == r.text and r.tokens == got.tokens


def test_device_sampled_and_host_slots(slot_engine, monkeypatch):
    """A stochastic common-preset slot samples on the device; a DRY slot
    takes the host chain; a greedy slot beside them keeps its tokens."""
    calls = {"sampled": 0}
    orig = slot_engine._sampled_step

    def spy(*a, **k):
        calls["sampled"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(slot_engine, "_sampled_step", spy)
    slot_engine.reset_context()
    want = slot_engine.generate(PROMPTS[1], greedy(8)).tokens
    slot_engine.reset_context()
    reqs = {
        "greedy": slot_engine.submit(PROMPTS[1], greedy(8)),
        "stoch": slot_engine.submit(PROMPTS[0], GenParams(
            max_length=8, bypass_eos=True, sampler=SamplerParams(
                temperature=0.8, top_p=0.9, top_k=60, rep_pen=1.05))),
        "dry": slot_engine.submit(PROMPTS[2], GenParams(
            max_length=8, bypass_eos=True, sampler=SamplerParams(
                temperature=0.0, rep_pen=1.0, dry_multiplier=0.8))),
    }
    assert all(r.done.wait(timeout=120) for r in reqs.values())
    assert calls["sampled"] > 0, "device sampled path never engaged"
    assert all(len(r.result.tokens) == 8 for r in reqs.values())
    assert reqs["greedy"].result.tokens == want


def test_failed_step_ends_requests_with_an_error(model):
    """A step that raises finishes the active requests with stop reason
    "error: ..." and the engine keeps serving on a rebuilt cache."""
    eng = BatchedEngine(model, max_context=64, n_slots=2, device="cpu")
    try:
        orig = eng._forward
        state = {"fail": True}

        def boom(*a, **k):
            if state.pop("fail", False):
                raise RuntimeError("injected")
            return orig(*a, **k)

        eng._forward = boom
        r = eng.generate([1, 5, 9], greedy(4))
        assert r.stop_reason.startswith("error: injected")
        assert eng.generate([1, 5, 9], greedy(4)).stop_reason == "length"
    finally:
        eng.shutdown()


def test_unported_inputs_raise(model):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedEngine(model)
    mla = Model(dataclasses.replace(model.cfg, arch="deepseek2"),
                model.params, model.tokenizer, model.device)
    with pytest.raises(NotImplementedError, match="deepseek2"):
        BatchedEngine(mla, device="cpu")


async def test_multiuser_server_multiplexes(slot_engine, aiohttp_client):
    """4 concurrent /api/v1/generate requests at temperature 0 on a
    multiuser server: each reply equals the one the request gets alone."""
    client = await aiohttp_client(make_app(slot_engine, ServerSettings(
        model_name="tiny", multiuser=4)))
    bodies = [{"prompt": p, "max_length": 6, "temperature": 0,
               "rep_pen": 1.0} for p in PROMPTS + ["A B C D"]]

    async def one(b):
        r = await client.post("/api/v1/generate", json=b)
        assert r.status == 200
        return (await r.json())["results"][0]["text"]

    together = await asyncio.gather(*(one(b) for b in bodies))
    alone = [await one(b) for b in bodies]
    assert together == alone and all(together)
    perf = await (await client.get("/api/extra/perf")).json()
    assert perf["queue"] == 0 and perf["idle"] == 1


async def test_single_engine_queue_and_503(model, aiohttp_client):
    """The single engine keeps its busy lock: with multiuser 2 one request
    waits in the FIFO queue (/api/extra/perf counts it), a third gets 503."""
    eng = Engine(model, max_context=256, device="cpu")
    client = await aiohttp_client(make_app(eng, ServerSettings(multiuser=2)))
    state = client.server.app[STATE]
    body = {"prompt": PROMPTS[1], "max_length": 2, "temperature": 0}
    await state.busy.acquire()  # a generation in progress
    waiting = asyncio.ensure_future(client.post("/api/v1/generate", json=body))
    for _ in range(200):
        if state.requests_in_queue:
            break
        await asyncio.sleep(0.01)
    perf = await (await client.get("/api/extra/perf")).json()
    assert perf["queue"] == 1 and perf["idle"] == 0
    assert (await client.post("/api/v1/generate", json=body)).status == 503
    state.busy.release()
    assert (await waiting).status == 200


def test_cli_multiuser(capsys, monkeypatch):
    """`--multiuser` (bare = 5 slots), `--paged`, `--pagesize` select the
    batched engine; argparse still refuses flags the port does not serve."""
    from koboldcpp_tpu_torch import cli

    built = []
    orig = be.BatchedEngine.__init__

    def spy(self, *a, **k):
        built.append(k)
        orig(self, *a, **k)

    monkeypatch.setattr(be.BatchedEngine, "__init__", spy)
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--multiuser", "--paged", "--pagesize", "32",
                     "--prompt", PROMPTS[1], "--promptlimit", "3"]) == 0
    assert built[-1]["n_slots"] == 5 and built[-1]["paged"]
    assert built[-1]["page_size"] == 32
    assert "Continuous batching enabled: 5 KV slots (paged)" in \
        capsys.readouterr().out
    # an architecture the batched scheduler does not serve: the single
    # engine with a note, as the JAX launcher does
    monkeypatch.setattr(be, "batch_capable", lambda cfg: False)
    n_built = len(built)
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--multiuser", "4", "--prompt", PROMPTS[1],
                     "--promptlimit", "2"]) == 0
    assert len(built) == n_built
    assert "continuous batching is unavailable" in capsys.readouterr().out
    # --sdmodel is served beside --multiuser: a missing SD file is skipped
    # under --ignoremissing and the batched one-shot run goes on
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--multiuser", "4", "--sdmodel", "x", "--ignoremissing",
                     "--prompt", PROMPTS[1], "--promptlimit", "2"]) == 0
    assert "--ignoremissing: skipping missing sdmodel x" in \
        capsys.readouterr().out
