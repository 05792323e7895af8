"""Flash prefill (K4): the plain version against the JAX package's
`flash_prefill_attention`, which runs JAX's library Pallas TPU
`flash_attention` (here under `force_tpu_interpret_mode`, as on a CPU it
cannot run otherwise); then `forward(flash_prefill=True)` and an Engine with
flash prefill forced on, on the committed Q4_K_M fixture, against the JAX
ones in the same mode."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.kv.cache import init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import flash_prefill as tfp
from koboldcpp_tpu_torch.sampling import SamplerParams

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py


def _pos(T, n_real):
    return np.array([list(range(n)) + [-1] * (T - n) for n in n_real],
                    np.int32)


@pytest.mark.parametrize("H, HKV, D, n_real", [
    (4, 2, 64, (100,)), (4, 1, 128, (128, 60)), (2, 2, 256, (77,))])
def test_plain_matches_jax_flash_prefill(H, HKV, D, n_real):
    """End-padded chunks of T=128 (the engine's layout), GQA by head group
    on the port's side and by repeated heads on JAX's. Both round p to bf16
    before p . V and return bf16; the library kernel's online softmax and
    the plain version's global one differ by about one bf16 step of the
    output: 2^-7 of the largest |v|."""
    B, T = len(n_real), 128
    rng = np.random.default_rng(D + H)
    q, k, v = (rng.standard_normal((B, T, h, D)).astype(np.float32)
               for h in (H, HKV, HKV))
    pos = _pos(T, n_real)
    scale = D ** -0.5
    with pltpu.force_tpu_interpret_mode():
        want = jllama.flash_prefill_attention(
            *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
            jnp.asarray(pos), scale)
    got = tfp.flash_prefill_attention(
        *(torch.from_numpy(x).bfloat16() for x in (q, k, v)),
        torch.from_numpy(pos), scale)
    assert got.dtype == torch.bfloat16 and got.shape == (B, T, H, D)
    tol = 2 ** -7 * np.abs(np.asarray(jnp.asarray(v, jnp.bfloat16)
                                      .astype(jnp.float32))).max()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=tol)


def test_pad_rows_are_their_own_segment():
    """A real row's output does not depend on the pad rows' K/V, and a pad
    row sees only the pad rows up to itself."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 128, 2, 64))
                                .astype(np.float32)).bfloat16()
               for _ in range(3))
    pos = torch.from_numpy(_pos(128, (90,)))
    a = tfp.flash_prefill_attention(q, k, v, pos, 0.125)
    k2, v2 = k.clone(), v.clone()
    k2[:, 90:] = 7.0
    v2[:, 90:] = -7.0
    b = tfp.flash_prefill_attention(q, k2, v2, pos, 0.125)
    assert torch.equal(a[:, :90], b[:, :90])
    assert torch.equal(b[0, 90], v2[0, 90])  # first pad row: itself only


def test_plain_counts_no_launch():
    q = torch.zeros((1, 128, 2, 64), dtype=torch.bfloat16)
    _build.launches.clear()
    tfp.flash_prefill_attention(q, q, q, torch.arange(128)[None], 0.125)
    assert sum(_build.launches.values()) == 0


@pytest.fixture(scope="module")
def models():
    return j_load_model(FIX), load_model(FIX, device="cpu")


def test_forward_flash_prefill_matches_jax(models):
    """A 100-token chunk from position 0, end-padded to 128 rows, through
    forward(flash_prefill=True, last_index=99) on both sides (JAX: the
    library kernel in interpret mode). Logits within the 5% of the largest
    logit that tests/test_torch_paged.py allows the fixture's forward (bf16
    rounding at other places), and equal to the port's own left-padded
    plain-attention forward of the same tokens within that bound too; the
    cache rows written are the same as that forward's, bit for bit."""
    jm, tm = models
    cfg = tm.cfg
    rng = np.random.default_rng(1)
    toks = np.zeros((1, 128), np.int32)
    toks[0, :100] = rng.integers(3, cfg.vocab_size, 100)
    pos = _pos(128, (100,))
    jc = j_init_cache(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim,
                      dtype=jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        jl, _ = jllama.forward(jm.params, jm.cfg, jnp.asarray(toks),
                               jnp.asarray(pos), jc,
                               last_index=jnp.asarray([99]),
                               flash_prefill=True)
    tc = init_cache(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim)
    ref = init_cache(cfg.n_layers, 1, 256, cfg.n_kv_heads, cfg.head_dim)
    left_t = np.zeros((1, 128), np.int64)
    left_t[0, 28:] = toks[0, :100]
    left_p = np.full((1, 128), -1, np.int64)
    left_p[0, 28:] = np.arange(100)
    with torch.inference_mode():
        tl, _ = tllama.forward(tm.params, cfg, torch.from_numpy(toks).long(),
                               torch.from_numpy(pos).long(), tc,
                               last_index=torch.tensor([99]),
                               flash_prefill=True)
        rl, _ = tllama.forward(tm.params, cfg, torch.from_numpy(left_t),
                               torch.from_numpy(left_p), ref, last_only=True)
    want = np.asarray(jl)[0, -1]
    bound = 5e-2 * np.abs(want).max()
    assert np.abs(tl.numpy()[0, -1] - want).max() <= bound
    assert np.abs(tl.numpy()[0, -1] - rl.numpy()[0, -1]).max() <= bound
    for a, b in zip(tc.k + tc.v, ref.k + ref.v):
        assert torch.equal(a, b)


def test_engine_flash_prefill_tokens_match_jax(models):
    """An Engine with flash prefill forced on (as on the card) against the
    JAX Engine forced on in interpret mode: the same greedy tokens for a
    100-token prompt, near-ties apart (a step where the two picks' logits
    lie within 2^-6 on the port's side may part)."""
    jm, tm = models
    prompt = [1] + np.random.default_rng(2).integers(
        3, tm.cfg.vocab_size, 99).tolist()
    jeng = JEngine(jm, max_context=256, cache_dtype=jnp.bfloat16)
    jeng.use_flash_prefill = True
    with pltpu.force_tpu_interpret_mode():
        want = jeng.generate(prompt, JGenParams(
            max_length=8, bypass_eos=True,
            sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))).tokens
    eng = Engine(tm, max_context=256, device="cpu")
    assert not eng.use_flash_prefill  # off on the CPU, as in JAX
    eng.use_flash_prefill = True
    got = eng.generate(prompt, GenParams(
        max_length=8, bypass_eos=True,
        sampler=SamplerParams(temperature=0.0, rep_pen=1.0))).tokens
    if got != want:
        i = next(j for j, (a, b) in enumerate(zip(got, want)) if a != b)
        eng.reset_context()
        with torch.inference_mode():
            lg = eng.eval_tokens(prompt + got[:i], 0)
        assert abs(float(lg[got[i]]) - float(lg[want[i]])) <= NEAR_TIE
