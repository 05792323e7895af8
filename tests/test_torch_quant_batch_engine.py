"""The continuous-batching engine over the quantized KV caches
(`BatchedEngine(quantkv=1|2)`, `--multiuser N --quantkv 1|2`) on the
committed Q4_K_M fixture (CPU, plain kernel versions): the JAX
BatchedEngine's greedy tokens on the Q8 pool (K9), the Q4 pool (K10) and
the Q4 slot cache, concurrent requests equal to serial ones, context shift
off, and the CLI's routing of `--quantkv` with `--multiuser`."""
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
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of"]
NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py
# (quantkv, paged) of the JAX launcher's --multiuser routes at the default
# page size: --quantkv 1 forces the Q8 pool, --quantkv 2 takes the Q4 pool
# with --paged and the Q4 slot cache without
KINDS = {"q8 paged": (1, True), "q4 paged": (2, True), "q4 slot": (2, False)}


def greedy(n=8):
    return GenParams(max_length=n, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


@pytest.fixture(scope="module")
def model():
    return load_model(FIX, device="cpu")


def _engine(model, kind, **kw):
    quantkv, paged = KINDS[kind]
    return BatchedEngine(model, max_context=256, n_slots=4, paged=paged,
                         page_size=16, device="cpu", quantkv=quantkv, **kw)


@pytest.mark.parametrize("kind", list(KINDS))
def test_greedy_tokens_match_jax_batched_engine(model, kind):
    """The JAX BatchedEngine of the same kind (page 0 kept out of its
    free list, for the reason tests/test_torch_batch_engine.py gives),
    serially; near-ties apart: where the two part, the picks' logits on
    the port's single engine over a cache of the same quantization level
    lie within NEAR_TIE."""
    quantkv, paged = KINDS[kind]
    kw = {"paged": True, "page_size": 16} if paged else {}
    jeng = JBatchedEngine(j_load_model(FIX), max_context=256, n_slots=4,
                          cache_dtype=jnp.bfloat16, quantkv=quantkv,
                          use_contextshift=False, **kw)
    if paged:
        jeng.allocator.free.remove(0)
    gp = JGenParams(max_length=8, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    try:
        want = [jeng.generate(p, gp).tokens for p in PROMPTS]
    finally:
        jeng.shutdown()
    eng = _engine(model, kind)
    try:
        got = [eng.generate(p, greedy()).tokens for p in PROMPTS]
    finally:
        eng.shutdown()
    single = Engine(model, max_context=256, device="cpu", quantkv=quantkv)
    for p, g, w in zip(PROMPTS, got, want):
        if g == w:
            continue
        i = next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
        assert i is not None, (g, w)  # one stopped early: not a tie
        single.reset_context()
        with torch.inference_mode():
            lg = single.eval_tokens(single.tokenizer.encode(p) + g[:i], 0)
        assert abs(float(lg[g[i]]) - float(lg[w[i]])) <= NEAR_TIE, (i, g, w)


@pytest.mark.parametrize("kind", list(KINDS))
def test_concurrent_requests_equal_serial(model, kind):
    """Concurrent results equal serial ones: batching over a quantized cache
    does not mix rows."""
    eng = _engine(model, kind)
    prompts = PROMPTS + ["A B C D"]
    results = [None] * len(prompts)
    try:
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
        assert [r.tokens for r in results] == [
            eng.generate(p, greedy()).tokens for p in prompts]
    finally:
        eng.shutdown()


def test_context_shift_off_under_quantkv(model):
    """The Q4 slot cache (the one quantized kind without pages, where the
    bf16 cache would shift): a scrolled history re-evaluates past the
    common prefix, and the reply equals a fresh engine's."""
    base = [1, 5] + [(7 * i) % 500 + 2 for i in range(116)]
    scrolled = base[:4] + base[16:] + [9, 11]
    eng = _engine(model, "q4 slot")
    try:
        assert not eng.use_contextshift
        eng.generate(base, greedy(2))
        r = eng.generate(scrolled, greedy(4))
        assert r.timings.prompt_tokens == len(scrolled) - 4
        eng.reset_context()
        fresh = _engine(model, "q4 slot")
        try:
            assert r.tokens == fresh.generate(scrolled, greedy(4)).tokens
        finally:
            fresh.shutdown()
    finally:
        eng.shutdown()


def test_cli_multiuser_quantkv(capsys, monkeypatch):
    """`--quantkv 1` with `--multiuser` forces the paged Q8 pool; `--quantkv
    2` takes the Q4 pool with `--paged` (with the JAX launcher's note) and
    the Q4 slot cache without."""
    from koboldcpp_tpu_torch import cli

    built = []
    orig = be.BatchedEngine.__init__

    def spy(self, *a, **k):
        built.append(k)
        orig(self, *a, **k)

    monkeypatch.setattr(be.BatchedEngine, "__init__", spy)
    for flags, paged, note in (
            (["--quantkv", "1"], True, "4 KV slots (paged)"),
            (["--quantkv", "2", "--paged"], True, "Paged KV pool: Q4"),
            (["--quantkv", "2"], False, "4 KV slots\n")):
        assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                         "--multiuser", "4", *flags, "--prompt", PROMPTS[1],
                         "--promptlimit", "2"]) == 0
        assert built[-1]["paged"] == paged
        assert built[-1]["quantkv"] == int(flags[1])
        assert note in capsys.readouterr().out
