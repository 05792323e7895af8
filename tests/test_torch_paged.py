"""The port's paged bf16 KV pool (kv/paged.py) and `forward_paged` against
the JAX package's: `write`/`gather` bit for bit, the page allocator, and the
fixture's logits through a paged prefill and K8 decode steps. The quantized
pools are held in tests/test_torch_kv_quant.py."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.loader import load_model

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")


def test_write_gather_bit_exact_against_jax():
    """Two sequences over shuffled pages, a padding row (-1) that must drop
    and a position past the table, which both pools put in its last page."""
    rng = np.random.default_rng(0)
    L, NP, P, H, D = 2, 10, 4, 2, 8
    table = np.array([[3, 5, 0], [7, 1, 8]], np.int32)
    pos = np.array([[-1, 0, 1, 2, 5, 6], [3, 4, 9, 10, 11, 13]], np.int32)
    k = rng.standard_normal((2, 6, H, D)).astype(np.float32)
    v = rng.standard_normal((2, 6, H, D)).astype(np.float32)
    jc = jpaged.init_paged_cache(L, NP, P, H, D)
    jc = jpaged.write(jc, 1, jnp.asarray(table), jnp.asarray(pos),
                      jnp.asarray(k), jnp.asarray(v))
    tc = tpaged.init_paged_cache(L, NP, P, H, D)
    assert tpaged.write(tc, 1, torch.from_numpy(table), torch.from_numpy(pos),
                        torch.from_numpy(k), torch.from_numpy(v)) is tc
    for layer in range(L):
        for jt, tt in ((jc.k, tc.k), (jc.v, tc.v)):
            np.testing.assert_array_equal(
                tt[layer].float().numpy(),
                np.asarray(jt[layer].astype(jnp.float32)))
    jk, jv = jpaged.gather(jc, 1, jnp.asarray(table))
    tk, tv = tpaged.gather(tc, 1, torch.from_numpy(table))
    assert tk.shape == (2, 12, H, D)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk.astype(jnp.float32)))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv.astype(jnp.float32)))


def test_allocator():
    a = tpaged.PageAllocator(n_pages=6, page_size=4, max_pages_per_slot=3)
    p0 = a.ensure(0, 5)   # 2 pages
    p1 = a.ensure(1, 4)   # 1 page
    assert len(p0) == 2 and len(p1) == 1
    assert a.n_free == 3
    assert set(p0) != set(p1)
    a.ensure(0, 12)       # grow to 3
    assert len(a.slot_pages[0]) == 3
    with pytest.raises(MemoryError):
        a.ensure(0, 16)   # > max_pages
    a.trim(0, 4)
    assert len(a.slot_pages[0]) == 1 and a.n_free == 4
    a.release(1)
    assert a.n_free == 5
    t = a.table(0)
    assert t.shape == (3,) and t[0] == p0[0] and t.dtype == np.int32
    b = tpaged.PageAllocator(n_pages=2, page_size=4, max_pages_per_slot=4)
    b.ensure(0, 8)
    with pytest.raises(MemoryError):
        b.ensure(1, 4)


def test_forward_paged_matches_jax():
    """The fixture through forward_paged on both sides: a 16-row prefill of
    two sequences (T > 1: write, gather, attention), then three batched
    decode steps (T = 1: K8 and K7 in the port, `decode_attention_paged`
    and the batched matvec kernels in interpret mode in JAX), one of them
    with a dead row. Packed q4_k/q6_k weights and a bf16 pool on both
    sides, each projection rounded to bf16 at other places: over these
    steps the JAX contiguous `forward` and the port's `forward` differ by
    1-4% of the largest logit as well, so 5e-2. The port's paged logits
    equal its slot-cache logits bit for bit."""
    jm = j_load_model(FIX)
    tm = load_model(FIX, device="cpu")
    cfg = tm.cfg
    P, MP, NP = 16, 4, 12
    table = np.array([[5, 2, 9, 0], [1, 11, 3, 0]], np.int32)
    jc = jpaged.init_paged_cache(cfg.n_layers, NP, P, cfg.n_kv_heads,
                                 cfg.head_dim)
    tc = tpaged.init_paged_cache(cfg.n_layers, NP, P, cfg.n_kv_heads,
                                 cfg.head_dim)
    slot = t_init_cache(cfg.n_layers, 2, MP * P, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, cfg.vocab_size, (2, 16)).astype(np.int32)
    pos = np.tile(np.arange(16, dtype=np.int32), (2, 1))
    pos[1, :5] = -1  # left padding of the shorter sequence
    steps = [(toks, pos)]
    for i in range(3):
        p = np.array([[16 + i], [16 + i]], np.int32)
        if i == 1:
            p[1, 0] = -1  # a dead row
        steps.append((rng.integers(3, cfg.vocab_size, (2, 1)).astype(np.int32),
                      p))
    tab_t = torch.from_numpy(table)
    for tok, p in steps:
        jl, jc = jllama.forward_paged(jm.params, jm.cfg, jnp.asarray(tok),
                                      jnp.asarray(p), jc, jnp.asarray(table),
                                      last_only=True)
        tt, tp = torch.from_numpy(tok).long(), torch.from_numpy(p).long()
        with torch.inference_mode():
            tl, tc2 = tllama.forward_paged(tm.params, cfg, tt, tp, tc, tab_t,
                                           last_only=True)
            sl, _ = tllama.forward(tm.params, cfg, tt, tp, slot,
                                   last_only=True)
        assert tc2 is tc  # updated in place
        live = [b for b in range(2) if p[b, -1] >= 0]
        want = np.asarray(jl)[live]
        got = tl.numpy()[live]
        assert np.abs(got - want).max() <= 5e-2 * np.abs(want).max()
        assert torch.equal(tl[live], sl[live])
