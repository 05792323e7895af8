"""The opt-in decode kernels as a slice: a one-layer synthetic q4_k model at
hidden 2048 with KCPP_FFN_FUSED=1 and KCPP_SBQ=1, the port's `forward`
against the JAX package's (Pallas in interpret mode) on the same weights,
and the port's 16-slot `BatchedEngine` (slot cache and paged pool) under
KCPP_SBQ=1, where every request gets the tokens it gets alone, and
`--multiuser 16` over HTTP."""
import asyncio
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.synthetic import synthetic_params as j_synth
from koboldcpp_tpu_torch.engine import GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.synthetic import synthetic_model
from koboldcpp_tpu_torch.ops import ffn_fused as tffn
from koboldcpp_tpu_torch.ops import quant_matmul as tqm
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")

# every projection but w_down (in_f 512) is wide enough for K14
CFG = ModelConfig(arch="llama", name="slice7", vocab_size=512,
                  hidden_size=2048, n_layers=1, n_heads=16, n_kv_heads=4,
                  head_dim=128, intermediate_size=512,
                  max_position_embeddings=256, rope_theta=10000.0,
                  rope_dim=128)


@pytest.fixture
def both_envs(monkeypatch):
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    monkeypatch.setenv("KCPP_SBQ", "1")


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return fn(*a, **k)
    monkeypatch.setattr(module, name, wrapped)


def test_forward_matches_jax_with_both_kernels(both_envs, monkeypatch):
    """An 8-token prefill from position 0 (the FFN through K15a, wqkv and
    wo through K14) and two decode steps (K15b, K1), JAX's
    synthetic weights carried across: the logits of each call within 1e-2
    * max |logit| of the JAX forward's (both round every projection to
    bf16)."""
    from koboldcpp_tpu.models.config import ModelConfig as JCfg

    jcfg = JCfg(**{f.name: getattr(CFG, f.name)
                   for f in dataclasses.fields(CFG)})
    jparams = j_synth(jcfg, kind="q4_k", seed=3)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    calls = {}
    for name in ("q4k_matvec_sbq", "q4k_matvec", "q4k_matvec_t"):
        _spy(monkeypatch, tqm, name, calls)
    _spy(monkeypatch, tffn, "ffn_fused_plain", calls)
    jf = jax.jit(lambda p, t, s, c: jllama.forward(p, jcfg, t, s, c,
                                                   last_only=True))
    toks = np.random.default_rng(4).integers(3, 500, size=10)
    jc = j_init_cache(1, 1, 64, 4, 128, dtype=jnp.bfloat16)
    tc = t_init_cache(1, 1, 64, 4, 128)
    steps = [(toks[:8], np.arange(8))] + [(toks[p:p + 1], np.array([p]))
                                         for p in (8, 9)]
    for i, (tok, pos) in enumerate(steps):
        want, jc = jf(jparams, jnp.asarray(tok[None], jnp.int32),
                      jnp.asarray(pos[None], jnp.int32), jc)
        want = np.asarray(want, np.float32)[0, -1]
        with torch.inference_mode():
            got, tc = tllama.forward(tparams, CFG, torch.from_numpy(tok[None]),
                                     torch.from_numpy(pos[None]), tc,
                                     last_only=True)
        got = got.float().numpy()[0, -1]
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max(), i
        if i == 0:  # the prefill: K15a, K14 (wqkv, wo), K1 (last row)
            assert calls == {"ffn_fused_plain": 1, "q4k_matvec_sbq": 2,
                             "q4k_matvec": 1}
    # the decode steps: K15b and K1 (wqkv, wo, output)
    assert calls == {"ffn_fused_plain": 3, "q4k_matvec_sbq": 2,
                     "q4k_matvec": 7}


@pytest.mark.parametrize("paged", [False, True], ids=["slot", "paged"])
def test_sixteen_slots_under_sbq(paged, monkeypatch):
    """BatchedEngine(n_slots=16) under KCPP_SBQ=1: every decode step is one
    forward at T = 16, whose q4_k projections of in_f 2048 go to K14 (the
    FFN declines K15 above 8 tokens); each of 4 concurrent greedy requests
    gets the tokens it gets alone through the same engine (a row of K14
    depends on its own token only)."""
    monkeypatch.setenv("KCPP_SBQ", "1")
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    model = synthetic_model(CFG, "q4_k", seed=1, device="cpu")
    calls = {}
    for name in ("q4k_matvec_sbq", "q4k_matvec_t"):
        _spy(monkeypatch, tqm, name, calls)
    gp = GenParams(max_length=5, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 500, size=int(n)).tolist()
               for n in rng.integers(4, 30, size=4)]
    eng = BatchedEngine(model, max_context=128, n_slots=16, paged=paged,
                        page_size=16, device="cpu")
    try:
        with eng._admit_lock:  # admitted together, in one tick
            reqs = [eng.submit(p, gp) for p in prompts]
        for r in reqs:
            assert r.done.wait(300)
        together = [r.result.tokens for r in reqs]
        steps = calls.get("q4k_matvec_sbq", 0)
        alone = []
        for p in prompts:
            eng.reset_context()
            alone.append(eng.generate(p, gp).tokens)
    finally:
        eng.shutdown()
    assert all(len(t) == 5 for t in together)
    assert together == alone
    # wqkv, wo, w_gateup and output at T = 16 on each of the 4 decode
    # steps (and the 16-row prefill chunks' wqkv, wo, w_gateup); no K7
    assert steps >= 4 * 4
    assert "q4k_matvec_t" not in calls


async def test_multiuser_16_over_http(aiohttp_client, monkeypatch):
    """`--multiuser 16` on the Q4_K_M fixture: the CLI builds a 16-slot
    engine, and a 16-slot server answers 16 concurrent /api/v1/generate
    requests (15 greedy and one stochastic, through the device sampler's
    (16, V) rows), each greedy reply equal to the one it gets alone."""
    from koboldcpp_tpu_torch import cli
    from koboldcpp_tpu_torch.engine import batch_engine as be

    built = []
    orig = be.BatchedEngine.__init__

    def spy(self, *a, **k):
        built.append(k)
        orig(self, *a, **k)

    monkeypatch.setattr(be.BatchedEngine, "__init__", spy)
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--multiuser", "16", "--prompt", "Once upon",
                     "--promptlimit", "2"]) == 0
    assert built[-1]["n_slots"] == 16
    model = load_model(FIX, device="cpu")
    eng = BatchedEngine(model, max_context=128, n_slots=16, device="cpu")
    try:
        client = await aiohttp_client(make_app(eng, ServerSettings(
            model_name="tiny", multiuser=16)))
        words = "the a of to in it is on at by we he".split()
        bodies = [{"prompt": " ".join(words[i % 12:] + words[:i % 5]),
                   "max_length": 4, "temperature": 0, "rep_pen": 1.0}
                  for i in range(15)]
        bodies.append({"prompt": "Once upon a time", "max_length": 4,
                       "temperature": 0.8, "top_p": 0.9, "top_k": 40})

        async def one(b):
            r = await client.post("/api/v1/generate", json=b)
            assert r.status == 200
            return (await r.json())["results"][0]["text"]

        together = await asyncio.gather(*(one(b) for b in bodies))
        alone = [await one(b) for b in bodies[:15]]
    finally:
        eng.shutdown()
    assert together[:15] == alone and all(together)
