"""The single-sequence Engine over the quantized KV caches (`quantkv=1|2`,
`--quantkv`) on the committed Q4_K_M fixture (CPU, plain kernel versions):
the JAX Engine's greedy tokens (built with `use_contextshift=False`; see
below), context shift off under a quantized cache, and the CLI routing."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.kv.cache import QuantKVCache
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
PROMPT = "The gradient of a function, e.g. f(x), points uphill."
NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py


def greedy(n=8):
    return GenParams(max_length=n, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


def assert_same_tokens(eng, prompt, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits at that step (on `eng`, the port's engine of the same
    cache kind) within NEAR_TIE of each other."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)  # one stopped early: not a tie
    ctx = eng.tokenizer.encode(prompt) if isinstance(prompt, str) else prompt
    eng.reset_context()
    with torch.inference_mode():
        lg = eng.eval_tokens(list(ctx) + got[:i], 0)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


@pytest.fixture(scope="module")
def model():
    return load_model(FIX, device="cpu")


@pytest.mark.parametrize("quantkv", [1, 2])
def test_greedy_tokens_match_jax_engine(model, quantkv):
    """Q8: the decode steps run K6's plain version here and
    `decode_attention_batched_q8` in interpret mode in JAX; Q4: write + read
    + attention on both. The JAX engine is built with context shift off:
    its context shift rebuilds a quantized cache without its scales
    (ROADMAP §3), so the port turns it off under quantkv, as upstream and
    the JAX BatchedEngine do."""
    jeng = JEngine(j_load_model(FIX), max_context=256,
                   cache_dtype=jnp.bfloat16, quantkv=quantkv,
                   use_contextshift=False)
    want = jeng.generate(PROMPT, JGenParams(
        max_length=8, bypass_eos=True,
        sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))).tokens
    eng = Engine(model, max_context=256, device="cpu", quantkv=quantkv)
    assert isinstance(eng.cache, QuantKVCache)
    assert eng.cache.bits == (4 if quantkv == 2 else 8)
    got = eng.generate(PROMPT, greedy()).tokens
    # fast-forward still applies: the repeat re-evaluates one token
    assert eng.generate(PROMPT, greedy()).tokens == got
    assert eng.last_timings.prompt_tokens == 1
    assert_same_tokens(eng, PROMPT, got, want)


@pytest.mark.parametrize("quantkv", [0, 1, 2])
def test_context_shift_off_under_quantkv(model, quantkv):
    """A scrolled history (a gap dropped after the first tokens, a >= 96
    token tail kept): the bf16 engine shifts the cache and re-evaluates a
    few tokens; a quantized one re-evaluates the prompt past the common
    prefix instead, and its reply equals a fresh engine's."""
    rng = np.random.default_rng(3)
    base = [1] + rng.integers(3, model.cfg.vocab_size, 159).tolist()
    scrolled = base[:10] + base[40:] + [7, 9]
    eng = Engine(model, max_context=256, device="cpu", quantkv=quantkv)
    assert eng.use_contextshift == (quantkv == 0)
    eng.generate(base, greedy(2))
    r = eng.generate(scrolled, greedy(4))
    if quantkv == 0:
        assert eng.last_timings.prompt_tokens <= 4
        return
    assert eng.last_timings.prompt_tokens == len(scrolled) - 10
    fresh = Engine(model, max_context=256, device="cpu", quantkv=quantkv)
    assert r.tokens == fresh.generate(scrolled, greedy(4)).tokens


def test_cli_quantkv_single(capsys, monkeypatch):
    """`--quantkv 1|2` builds the single engine over the Q8 / Q4 cache and
    prints the JAX launcher's note; `--flashattention` is accepted."""
    from koboldcpp_tpu_torch import cli
    from koboldcpp_tpu_torch.engine import engine as eng_mod

    built = []
    orig = eng_mod.Engine.__init__

    def spy(self, *a, **k):
        built.append(k)
        orig(self, *a, **k)

    monkeypatch.setattr(eng_mod.Engine, "__init__", spy)
    for level, note in ((1, "Q8-quantized KV cache enabled"),
                        (2, "Q4_0-quantized KV cache enabled")):
        assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                         "--quantkv", str(level), "--flashattention",
                         "--prompt", PROMPT, "--promptlimit", "3"]) == 0
        assert built[-1]["quantkv"] == level
        assert note in capsys.readouterr().out


def test_jax_context_shift_drops_the_quantized_scales():
    """Why the port turns context shift off under quantkv: the JAX Engine
    (which leaves it on) rebuilds a Q8 cache through `_kv_shift_jit` as a
    plain KVCache of int8 leaves, without the scales, when a scrolled
    history takes the shift (engine.py:509-539, :1147-1173); its next T=1
    step then hands bf16 rows to that int8 cache and raises. Upstream turns
    the shift off under a quantized KV (koboldcpp.py:840), as the JAX
    BatchedEngine does."""
    from koboldcpp_tpu.kv.cache import KVCache, QuantKVCache as JQuant

    jeng = JEngine(j_load_model(FIX), max_context=512,
                   cache_dtype=jnp.bfloat16, quantkv=True)
    gp = JGenParams(max_length=4, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    base = [1] + np.random.default_rng(5).integers(3, 512, 299).tolist()
    reply = jeng.generate(base, gp).tokens
    assert isinstance(jeng.cache, JQuant)
    assert jeng._context_shift(base[:10] + base[120:] + reply) is not None
    assert type(jeng.cache) is KVCache  # the scales are gone
    assert jeng.cache.k[0].dtype == jnp.int8
