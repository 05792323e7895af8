"""The port's llama forward against the JAX package's, and against the
reference runtime's golden logits on the committed GGUF fixtures."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import engine as jengine
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.models.synthetic import synthetic_params as j_synth
from koboldcpp_tpu.ops import norms as jnorms
from koboldcpp_tpu.ops import rope as jrope
from koboldcpp_tpu_torch.engine import engine as tengine
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model as t_load_model
from koboldcpp_tpu_torch.ops import norms as tnorms
from koboldcpp_tpu_torch.ops import rope as trope

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf")
MANIFEST = json.load(open(os.path.join(FIX, "manifest.json")))
TOKENS = np.asarray([MANIFEST["tokens"]], dtype=np.int64)
# the reference-runtime tolerances of tests/test_ref_gguf_fixtures.py
TOL = {"f16": 2e-3, "q4_0": 4e-2, "q5_1": 4e-2, "q8_0": 4e-2,
       "q4_k_m": 4e-2, "q6_k": 4e-2, "iq4_nl": 4e-2, "tq2_0": 4e-2}

SMALL = ModelConfig(arch="llama", name="small", vocab_size=512,
                    hidden_size=512, n_layers=2, n_heads=8, n_kv_heads=2,
                    head_dim=64, intermediate_size=1024,
                    max_position_embeddings=512, rope_theta=10000.0,
                    rope_dim=64)


def _jax_cfg(cfg):
    from koboldcpp_tpu.models.config import ModelConfig as JCfg

    return JCfg(**{f.name: getattr(cfg, f.name)
                   for f in dataclasses.fields(cfg)})


def _run_steps(fwd, init, n_prefill, n_decode, seed):
    """A left-padded 16-row prefill of n_prefill tokens, then n_decode
    single-token steps; returns the logits of every call (f32 numpy)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(3, 500, size=n_prefill + n_decode)
    pad = 16 - n_prefill
    cache = init()
    tok = np.concatenate([np.zeros(pad, np.int64), toks[:n_prefill]])[None]
    pos = np.concatenate([-np.ones(pad, np.int64), np.arange(n_prefill)])[None]
    out = []
    lg, cache = fwd(tok, pos, cache)
    out.append(lg)
    for i in range(n_decode):
        p = n_prefill + i
        lg, cache = fwd(toks[p:p + 1][None], np.array([[p]]), cache)
        out.append(lg)
    return out


def _jax_fwd(params, cfg):
    f = jax.jit(lambda p, t, s, c: jllama.forward(p, cfg, t, s, c,
                                                  last_only=True))

    def fwd(tok, pos, cache):
        lg, cache = f(params, jnp.asarray(tok, jnp.int32),
                      jnp.asarray(pos, jnp.int32), cache)
        return np.asarray(lg, np.float32)[0, -1], cache
    return fwd


def _torch_fwd(params, cfg):
    def fwd(tok, pos, cache):
        with torch.inference_mode():
            lg, cache = tllama.forward(params, cfg, torch.from_numpy(tok),
                                       torch.from_numpy(pos), cache,
                                       last_only=True)
        return lg.float().numpy()[0, -1], cache
    return fwd


def test_synthetic_forward_matches_jax():
    """Same q4_k weights (JAX synthetic_params -> params_from_jax), 16-token
    prefill then 3 decode steps through K3 (T=16), K1 and K5 (T=1). Both
    round every projection's output (the logits too) to bf16: the logits
    agree to one bf16 step of the largest, 2^-8 of it, within 1e-2."""
    jcfg = _jax_cfg(SMALL)
    jparams = j_synth(jcfg, kind="q4_k", seed=5)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    want = _run_steps(_jax_fwd(jparams, jcfg), lambda: j_init_cache(
        2, 1, 64, 2, 64, dtype=jnp.bfloat16), 16, 3, seed=9)
    got = _run_steps(_torch_fwd(tparams, SMALL), lambda: t_init_cache(
        2, 1, 64, 2, 64), 16, 3, seed=9)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 1e-2 * np.abs(w).max()


@pytest.mark.parametrize("fmt", list(MANIFEST["files"]))
def test_fixture_logits_match_goldens_and_jax(fmt):
    """f16 loads dense in f32 (as the reference-runtime test does); the
    quantized files load packed, the port's serving layout (q4_k, q5_k,
    q6_k, q8_0 as the JAX loader packs them), through the K3 plain versions
    and the dequant path."""
    path = os.path.join(FIX, MANIFEST["files"][fmt])
    packed = fmt != "f16"
    golden = np.load(os.path.join(FIX, f"logits-{fmt}.npy"))
    m = t_load_model(path, packed=packed, dtype=torch.float32, device="cpu")
    cache = t_init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=torch.float32)
    pos = torch.arange(TOKENS.shape[1])[None]
    with torch.inference_mode():
        got, _ = tllama.forward(m.params, m.cfg, torch.from_numpy(TOKENS),
                                pos, cache)
    got = got[0].numpy()
    np.testing.assert_allclose(got, golden, rtol=TOL[fmt], atol=TOL[fmt])

    jm = j_load_model(path, packed=packed, dtype=jnp.float32)
    jc = j_init_cache(jm.cfg.n_layers, 1, 64, jm.cfg.n_kv_heads,
                      jm.cfg.head_dim, dtype=jnp.float32)
    jfwd = jax.jit(lambda p, t, s, c: jllama.forward(p, jm.cfg, t, s, c))
    want, _ = jfwd(jm.params, jnp.asarray(TOKENS, jnp.int32),
                   jnp.asarray(pos.numpy(), jnp.int32), jc)
    want = np.asarray(want)[0]
    # f16: f32 throughout, only summation order differs; quantized: bf16
    # matmul outputs on both sides, one rounding step apart at most per
    # projection
    tol = 1e-4 if fmt == "f16" else 1e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_synthetic_q8_0_forward_matches_jax():
    """JAX synthetic q8_0 params through params_from_jax: the 16-token
    prefill through K3.q8_0, the 3 decode steps through K2.q8_0 (T=1).
    Every projection agrees with JAX's to a bf16 step (tests/
    test_torch_quant_matmul.py), but this model amplifies such steps: the
    JAX maker's q8_0 weights have std 0.002 * 127 / 3 ~ 0.085 (6x its q4_k
    maker's), a gain near 2 per projection at hidden 512. The test
    asserts that premise (the jitted JAX forward itself moves by more than
    1e-2 of its largest logit when 1% of its bf16 embedding entries move by
    one step) and holds the port at 4e-2, the reference fixtures'
    tolerance."""
    jcfg = _jax_cfg(SMALL)
    jparams = j_synth(jcfg, kind="q8_0", seed=6)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    assert tparams["layers"][0]["wqkv"].kind == "q8_0"

    def jax_steps(params):
        return _run_steps(_jax_fwd(params, jcfg), lambda: j_init_cache(
            2, 1, 64, 2, 64, dtype=jnp.bfloat16), 16, 3, seed=10)

    want = jax_steps(jparams)
    got = _run_steps(_torch_fwd(tparams, SMALL), lambda: t_init_cache(
        2, 1, 64, 2, 64), 16, 3, seed=10)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        assert np.abs(g - w).max() <= 4e-2 * np.abs(w).max()
    emb = jparams["tok_embd"]
    bits = np.asarray(emb.data["w"]).view(np.uint16).copy()
    bits[np.random.default_rng(0).random(bits.shape) < 0.01] += 1
    moved = dict(jparams, tok_embd=dataclasses.replace(
        emb, data={"w": jnp.asarray(bits.view(jnp.bfloat16))}))
    spread = max(np.abs(m - w).max() / np.abs(w).max()
                 for m, w in zip(jax_steps(moved), want))
    assert spread > 1e-2


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        xt = torch.from_numpy(x).to(dt)
        xj = jnp.asarray(x, jdt)
        # f32 math on both sides; rsqrt may differ in the last bit
        np.testing.assert_allclose(
            tnorms.rms_norm(xt, torch.from_numpy(w), 1e-5).float().numpy(),
            np.asarray(jnorms.rms_norm(xj, jnp.asarray(w), 1e-5), np.float32),
            rtol=1e-2 if dt == torch.bfloat16 else 1e-5, atol=1e-5)
        np.testing.assert_allclose(
            tnorms.layer_norm(xt, torch.from_numpy(w), torch.from_numpy(b),
                              1e-5).float().numpy(),
            np.asarray(jnorms.layer_norm(xj, jnp.asarray(w), jnp.asarray(b),
                                         1e-5), np.float32),
            rtol=1e-2 if dt == torch.bfloat16 else 1e-5, atol=1e-5)


@pytest.mark.parametrize("rope_type", ["norm", "neox"])
@pytest.mark.parametrize("scaling", [("none", 1.0), ("linear", 2.0),
                                     ("yarn", 4.0)])
def test_rope_matches_jax(rope_type, scaling):
    cfg = dataclasses.replace(SMALL, rope_scaling_type=scaling[0],
                              rope_scaling_factor=scaling[1],
                              rope_orig_ctx=256, rope_dim=48)
    jcfg = _jax_cfg(cfg)
    np.testing.assert_allclose(trope.rope_frequencies(cfg).numpy(),
                               np.asarray(jrope.rope_frequencies(jcfg)),
                               rtol=1e-6)
    assert trope.yarn_attn_scale(cfg) == jrope.yarn_attn_scale(jcfg)
    assert trope.gradientai_rope_base(1e4, 64, 8192, 2048) == \
        jrope.gradientai_rope_base(1e4, 64, 8192, 2048)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 7, 4, 64)).astype(np.float32)
    pos = np.arange(100, 107)[None]
    got = trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                           trope.rope_frequencies(cfg), rope_type, 48)
    want = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                            jrope.rope_frequencies(jcfg), rope_type, 48)
    # f32 cos/sin of the same angles: last-bit differences at angle ~100
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("rope_type", ["norm", "neox"])
def test_shift_rows_matches_jax(rope_type):
    rng = np.random.default_rng(2)
    k = rng.standard_normal((1, 32, 2, 64)).astype(np.float32)
    v = rng.standard_normal((1, 32, 2, 64)).astype(np.float32)
    freqs = trope.rope_frequencies(SMALL)
    gk, gv = tengine._shift_rows(torch.from_numpy(k).bfloat16(),
                                 torch.from_numpy(v).bfloat16(), 5, 12,
                                 freqs, rope_type, 64)
    wk, wv = jengine._shift_rows(jnp.asarray(k, jnp.bfloat16),
                                 jnp.asarray(v, jnp.bfloat16), 5, 12,
                                 jnp.asarray(freqs.numpy()), rope_type, 64)
    np.testing.assert_array_equal(gv.float().numpy(),
                                  np.asarray(wv.astype(jnp.float32)))
    # re-rotated keys: f32 rotation then bf16, at most one bf16 step apart
    np.testing.assert_allclose(gk.float().numpy(),
                               np.asarray(wk.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)
    # slots below the gap keep their keys bit for bit
    np.testing.assert_array_equal(
        gk[:, :5].float().numpy(),
        torch.from_numpy(k[:, :5]).bfloat16().float().numpy())


@pytest.mark.parametrize("head_dim,n_heads,n_kv_heads", [(36, 64, 32),
                                                          (640, 8, 4),
                                                          (1152, 8, 4),
                                                          (2048, 8, 4),
                                                          (4864, 8, 4),
                                                          (64, 6, 4)])
def test_k5_head_shape_refused_at_load_on_cuda(head_dim, n_heads, n_kv_heads):
    """A head shape K5 is not built for (query heads that are not a
    multiple of the kv heads, where Hkv * head_dim % 128 == 0 sends it to
    the kernel) fails when the model is checked on a CUDA device, naming
    K5, not at the first decoded token; the head_dims it was not built for
    before (36, not a multiple of 8; 640, above 512; 1152 and 2048, past
    the limit of 1024; 4864, past the later limit of 4800), all of which
    the streamed instance takes, pass there. The CPU, which runs K5's
    plain version, takes all of them."""
    cfg = dataclasses.replace(SMALL, n_heads=n_heads, n_kv_heads=n_kv_heads,
                              head_dim=head_dim, rope_dim=head_dim)
    params = {"layers": [{}]}
    if n_heads % n_kv_heads:
        with pytest.raises(NotImplementedError,
                           match=f"K5.*head_dim {head_dim}"):
            tllama.check_supported(params, cfg, torch.device("cuda"))
    else:
        tllama.check_supported(params, cfg, torch.device("cuda"))
    tllama.check_supported(params, cfg, "cpu")
    tllama.check_supported(params, SMALL, torch.device("cuda"))
