"""The port's device sampler (engine/device_sampler.py) against the JAX
package's: the same candidate set and probabilities (`candidate_distribution`)
on the presets of tests/test_device_sampler.py, plus the batched draw."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import device_sampler as jds
from koboldcpp_tpu_torch.engine import device_sampler as tds
from koboldcpp_tpu_torch.sampling import SamplerParams

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

MAX_CTX = 64

PRESETS = {
    "default": SamplerParams(),  # temp .7, top_k 100, top_p .92, rep_pen 1.1
    "min_p_only": SamplerParams(temperature=1.3, top_k=0, top_p=1.0,
                                min_p=0.08, rep_pen=1.0),
    "temp_before_top_p": SamplerParams(temperature=0.45, top_k=0, top_p=0.8,
                                       rep_pen=1.15, sampler_order=(6, 5, 0, 2)),
    "presence_only": SamplerParams(temperature=1.0, top_k=50, top_p=1.0,
                                   rep_pen=1.0, presence_penalty=0.7,
                                   rep_pen_range=24),
    "slope_short_range": SamplerParams(temperature=0.9, rep_pen=1.4,
                                       rep_pen_slope=0.5, rep_pen_range=16),
    "boost_below_one": SamplerParams(temperature=1.0, rep_pen=0.8, top_k=0,
                                     top_p=1.0),
    "biases_and_bans": SamplerParams(temperature=0.8,
                                     logit_biases={3: 5.0, 7: -4.0},
                                     banned_tokens=(1, 2, 11)),
}


def _inputs(sp, V, seed=0, ctx_len=40):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 3.0, V).astype(np.float32)
    ctx = rng.integers(0, V, ctx_len).tolist()
    rec = np.zeros(MAX_CTX, np.int64)
    tail = ctx[-MAX_CTX:]
    if tail:
        rec[-len(tail):] = tail
    bias = np.zeros(V, np.float32)
    for tid, b in sp.logit_biases.items():
        bias[tid] += np.float32(b)
    for t in sp.banned_tokens:
        bias[t] = np.float32(-1e30)
    return logits, bias, rec, min(len(ctx), MAX_CTX)


def _jax_dist(sp, logits, bias, rec, count):
    return np.asarray(jds.candidate_distribution(
        jnp.asarray(logits), jnp.asarray(bias), jnp.asarray(rec, jnp.int32),
        jnp.int32(count), jds.make_dyn(sp, MAX_CTX), sp.sampler_order))


@pytest.mark.parametrize("V", [300, 6000])  # 6000: the top-5000 prefilter
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_candidate_distribution_matches_jax(name, V):
    """The same candidate set (exact) and probabilities (f32 softmax of the
    same values, summed in another order: 1e-6) as the JAX chain."""
    sp = PRESETS[name]
    logits, bias, rec, count = _inputs(sp, V, seed=len(name))
    want = _jax_dist(sp, logits, bias, rec, count)
    got = tds.candidate_distribution(
        torch.from_numpy(logits), torch.from_numpy(bias),
        torch.from_numpy(rec), count, tds.make_dyn(sp, MAX_CTX),
        sp.sampler_order).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_empty_context():
    sp = SamplerParams()
    logits, bias, rec, count = _inputs(sp, 300, ctx_len=0)
    want = _jax_dist(sp, logits, bias, rec, count)
    got = tds.candidate_distribution(
        torch.from_numpy(logits), torch.from_numpy(bias),
        torch.from_numpy(rec), count, tds.make_dyn(sp, MAX_CTX),
        sp.sampler_order).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_supported_order():
    default = (6, 0, 1, 3, 4, 2, 5)
    for order, rep, ok in ((default, True, True), ((0, 6, 2, 5), False, True),
                           ((0, 6, 2, 5), True, False)):
        assert tds.supported_order(order, rep) == ok
        assert jds.supported_order(order, rep) == ok


def test_batched_draw_rows():
    """sample_step_batched over three slots with their own knobs: a greedy
    row takes argmax(logits + bias); a stochastic row draws only inside its
    candidate set, with the frequencies of its distribution; the same
    generator seed gives the same draws."""
    V, W, n = 300, MAX_CTX, 4000
    sps = [SamplerParams(temperature=0.0, rep_pen=1.0),
           PRESETS["default"], PRESETS["biases_and_bans"]]
    rows = [_inputs(sp, V, seed=i) for i, sp in enumerate(sps)]
    logits = torch.from_numpy(np.stack([r[0] for r in rows]))
    bias = torch.from_numpy(np.stack([r[1] for r in rows]))
    rec = torch.from_numpy(np.stack([r[2] for r in rows]))
    count = torch.tensor([r[3] for r in rows])
    dyn = tds.make_dyn_rows(sps, W)
    greedy = torch.tensor([True, False, False])
    order = tuple(s for s in sps[1].sampler_order if s in (0, 2, 5))

    def draw(seed):
        g = torch.Generator().manual_seed(seed)
        return torch.stack([tds.sample_step_batched(
            logits, bias, rec, count, g, dyn, order, greedy)
            for _ in range(n)])

    toks = draw(1)
    assert torch.equal(toks, draw(1))
    assert (toks[:, 0] == torch.argmax(logits[0] + bias[0])).all()
    for b in (1, 2):
        want = _jax_dist(sps[b], *rows[b])
        freq = np.bincount(toks[:, b].numpy(), minlength=V) / n
        assert (want[freq > 0] > 0).all()  # never outside the candidates
        # 4000 draws: each frequency within 5 standard errors
        se = np.sqrt(want * (1 - want) / n)
        assert (np.abs(freq - want) <= 5 * se + 1e-3).all()
