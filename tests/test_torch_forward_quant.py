"""`forward` (slot cache) and `forward_paged` (paged pool) over the
quantized KV caches (`--quantkv 1|2`) on the committed Q4_K_M fixture,
against the JAX forward over the same kind of cache: K6 / K9 / K10 in the
port's plain versions against the JAX kernels in interpret mode, and the
Q4 slot cache's write + read + attention path on both sides."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv import cache as jcache
from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu_torch.kv import cache as tcache
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.loader import load_model

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")


@pytest.fixture(scope="module")
def models():
    return j_load_model(FIX), load_model(FIX, device="cpu")


@pytest.mark.parametrize("kind", ["slot q8", "slot q4", "paged q8",
                                  "paged q4"])
def test_forward_over_quantized_cache_matches_jax(models, kind):
    """The fixture through `forward` (slot) or `forward_paged` over a
    quantized cache on both sides: a 16-row prefill of two sequences (one
    left-padded), then three decode steps (T = 1: K6 / K9 / K10 in the
    port's plain versions and the JAX kernels in interpret mode; the Q4 slot
    cache takes write + read + attention on both), one with a dead row.
    The tolerance of tests/test_torch_paged.py's bf16 pool test, 5% of the
    largest logit: projections round to bf16 at other places on the two
    sides, so the K/V rows that are quantized differ by a bf16 step here
    and there too."""
    jm, tm = models
    cfg = tm.cfg
    layout, level = kind.split()
    qz = 4 if level == "q4" else 1
    table = np.array([[5, 2, 9, 0], [1, 11, 3, 0]], np.int32)
    if layout == "slot":
        jc = jcache.init_cache(cfg.n_layers, 2, 64, cfg.n_kv_heads,
                               cfg.head_dim, quantized=qz)
        tc = tcache.init_cache(cfg.n_layers, 2, 64, cfg.n_kv_heads,
                               cfg.head_dim, quantized=qz)
    else:
        jc = jpaged.init_paged_cache(cfg.n_layers, 12, 16, cfg.n_kv_heads,
                                     cfg.head_dim, quantized=level)
        tc = tpaged.init_paged_cache(cfg.n_layers, 12, 16, cfg.n_kv_heads,
                                     cfg.head_dim, quantized=level)
    rng = np.random.default_rng(4)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    pos[1, :5] = -1  # left padding of the shorter sequence
    steps = [(rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32), pos)]
    for i in range(3):
        p = np.array([[16 + i], [16 + i]], np.int32)
        if i == 1:
            p[1, 0] = -1  # a dead row
        steps.append((rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32),
                      p))
    for tok, p in steps:
        tt, tp = torch.from_numpy(tok).long(), torch.from_numpy(p).long()
        if layout == "slot":
            jl, jc = jllama.forward(jm.params, jm.cfg, jnp.asarray(tok),
                                    jnp.asarray(p), jc, last_only=True)
            with torch.inference_mode():
                tl, _ = tllama.forward(tm.params, cfg, tt, tp, tc,
                                       last_only=True)
        else:
            jl, jc = jllama.forward_paged(jm.params, jm.cfg, jnp.asarray(tok),
                                          jnp.asarray(p), jc,
                                          jnp.asarray(table), last_only=True)
            with torch.inference_mode():
                tl, _ = tllama.forward_paged(tm.params, cfg, tt, tp, tc,
                                             torch.from_numpy(table),
                                             last_only=True)
        live = [b for b in range(2) if p[b, -1] >= 0]
        want = np.asarray(jl)[live]
        assert np.abs(tl.numpy()[live] - want).max() <= \
            5e-2 * np.abs(want).max()
