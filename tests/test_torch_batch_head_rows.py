"""The batched engine's output projection follows the JAX dispatch.

The JAX `BatchedEngine` runs a lone prefill chunk's LM head at T=1 (the
int8-activation row kernel on a q8_0 head) and an admission wave's and a
decode step's at T=n_slots (the bf16 2-D kernel), so a request's
first-token logits move with its company. The port's `BatchedEngine` runs
the head over the forward's rows in the same way. Both engines serve
tiny-q8_0.gguf here, on the CPU (the port's plain versions, JAX's Pallas
kernels in interpret mode): the port's first-token logits equal JAX's,
lone to lone and wave to wave, within NEAR_TIE; both move between the two
alike; and the greedy tokens agree up to near-ties."""
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatchedEngine
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q8_0.gguf")
PROMPTS = ["Once upon a time there was", "The gradient of a function",
           "hello world, this is a test of the"]
N_SLOTS = 4
N_TOKENS = 4
NEAR_TIE = 2 ** -6  # logits this close may pick either token (bf16 steps)


def _recorder(eng, to_np):
    """Wrap the engine's two prefill paths: the first-token logits of every
    request whose prompt finished, keyed by its tokens."""
    got = {}
    chunk, wave = eng._prefill_chunk, eng._prefill_wave

    def record(slots):
        for s in slots:
            if not s.pending_prefill and s.pending_first is not None:
                got[tuple(s.context)] = to_np(s.pending_first)

    def prefill_chunk(slot):
        chunk(slot)
        record([slot])

    def prefill_wave(slots):
        wave(slots)
        record(slots)

    eng._prefill_chunk = prefill_chunk
    eng._prefill_wave = prefill_wave
    return got


def _serve(eng, prompts, params, together: bool):
    """Each prompt alone (a one-row prefill chunk), or all of them
    admitted in one tick (one prefill wave). Returns their tokens."""
    eng.reset_context()
    if not together:
        out = []
        for p in prompts:
            eng.reset_context()
            out.append(eng.generate(p, params).tokens)
        return out
    gate = threading.Event()
    admit = eng._admit
    eng._admit = lambda: admit() if gate.is_set() else 0
    try:
        reqs = [eng.submit(p, params) for p in prompts]
        gate.set()
        for r in reqs:
            assert r.done.wait(300)
    finally:
        eng._admit = admit
    return [r.result.tokens for r in reqs]


def _run(eng, tok, to_np, params):
    """(first-token logits alone, in a wave, tokens alone, in a wave)."""
    got = _recorder(eng, to_np)
    alone = _serve(eng, PROMPTS, params, together=False)
    lg_alone = dict(got)
    got.clear()
    together = _serve(eng, PROMPTS, params, together=True)
    keys = [tuple(tok(p)) for p in PROMPTS]
    return ([lg_alone[k] for k in keys], [got[k] for k in keys], alone,
            together)


@pytest.fixture(scope="module")
def port_run():
    model = load_model(FIX, device="cpu")
    eng = BatchedEngine(model, max_context=256, n_slots=N_SLOTS, device="cpu")
    gp = GenParams(max_length=N_TOKENS, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    try:
        return model, _run(eng, model.tokenizer.encode,
                           lambda t: t.float().numpy().copy(), gp)
    finally:
        eng.shutdown()


@pytest.fixture(scope="module")
def jax_run():
    jm = j_load_model(FIX)
    eng = JBatchedEngine(jm, max_context=256, n_slots=N_SLOTS,
                         cache_dtype=jnp.bfloat16)
    gp = JGenParams(max_length=N_TOKENS, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    try:
        return _run(eng, jm.tokenizer.encode,
                    lambda t: np.asarray(t, np.float32).copy(), gp)
    finally:
        eng.shutdown()


def test_port_first_logits_equal_alone_and_in_a_wave(port_run, jax_run):
    """The port's first-token logits equal the JAX engine's alone (both
    heads at T=1) and in a wave (both at T=n_slots), within NEAR_TIE: the
    same kernel for the same rows on each side."""
    _, (alone, wave, _, _) = port_run
    j_alone, j_wave, _, _ = jax_run
    for got, want in ((alone, j_alone), (wave, j_wave)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=NEAR_TIE)


def test_jax_first_logits_differ_alone_and_in_a_wave(jax_run):
    """The reference's behaviour, pinned: its lone prefill runs the q8_0
    head at T=1 (int8 activations), its wave at T=n_slots (bf16), so the
    first-token logits of one request move with its company."""
    alone, wave, _, _ = jax_run
    gaps = [float(np.abs(a - w).max()) for a, w in zip(alone, wave)]
    assert all(g > 0 for g in gaps), gaps


def test_port_first_logits_differ_alone_and_in_a_wave(port_run, jax_run):
    """The port moves with its company as JAX does: every request's lone
    and wave logits differ, and by what JAX's differ by, within NEAR_TIE
    (the T=1 int8 head against the T=n_slots bf16 one)."""
    _, (alone, wave, _, _) = port_run
    j_alone, j_wave, _, _ = jax_run
    gaps = [float(np.abs(a - w).max()) for a, w in zip(alone, wave)]
    assert all(g > 0 for g in gaps), gaps
    for a, w, ja, jw in zip(alone, wave, j_alone, j_wave):
        np.testing.assert_allclose(a - w, ja - jw, rtol=0, atol=NEAR_TIE)


def test_port_tokens_equal_jax_up_to_near_ties(port_run, jax_run):
    """The port's greedy tokens, alone and in a wave, equal the JAX
    engine's alone and in a wave, up to a step where the port's
    single-stream logits of the two picks lie within NEAR_TIE."""
    model, (_, _, port_alone, port_wave) = port_run
    _, _, jax_alone, jax_wave = jax_run
    for got_all, want_all in ((port_alone, jax_alone), (port_wave, jax_wave)):
        for p, got, want in zip(PROMPTS, got_all, want_all):
            if got == want:
                continue
            i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
            ctx = model.tokenizer.encode(p) + got[:i]
            with torch.inference_mode():
                lg = Engine(model, max_context=256,
                            device="cpu").eval_tokens(ctx, 0)
            gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
            assert gap <= NEAR_TIE, (p, i, got, want, gap)
