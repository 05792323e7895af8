"""The port's quantized KV caches (`--quantkv 1|2`) against the JAX
package's: the quantizers bit for bit, and `write` / `read` (slot cache) and
`write` / `gather` (paged pool) on equal values, dead and out-of-range
positions included. The paged pools are checked at P=64, where the JAX pool
keeps rows, and at P=128, where it switches to its column layout; the port
keeps rows at both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv import cache as jcache
from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu_torch.kv import cache as tcache
from koboldcpp_tpu_torch.kv import paged as tpaged

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)


def _f32(a):
    return np.array(jnp.asarray(a).astype(jnp.float32))


def _rows(seed, shape):
    """bf16-representable rows with per-row magnitudes from 1e-2 to 30 and
    one all-zero row (scale 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape) * rng.uniform(0.01, 30, shape[:-1] + (1,))
    x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    x[(0,) * (len(shape) - 1)] = 0
    return x


@pytest.mark.parametrize("name", ["_q8", "_q4", "_quantize_q8",
                                  "_quantize_q4"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quantizers_bit_exact(name, dtype):
    """Codes and scales equal the JAX functions' bit for bit: amax / 127 or
    / 7 per row in f32, round half to even, scale rounded to bf16."""
    jmod, tmod = ((jcache, tcache) if name in ("_q8", "_q4")
                  else (jpaged, tpaged))
    x = _rows(len(name), (48, 4, 64))
    jq, js = getattr(jmod, name)(jnp.asarray(x, getattr(jnp, dtype)))
    tq, ts = getattr(tmod, name)(torch.from_numpy(x).to(getattr(torch,
                                                                 dtype)))
    assert tq.dtype == (torch.uint8 if "4" in name else torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.float().numpy(), _f32(js))


@pytest.mark.parametrize("pair", [("_q4", "_q4_unpack"),
                                  ("_quantize_q4", "_dequantize_q4")])
def test_q4_unpack_bit_exact(pair):
    quant, unpack = pair
    jmod, tmod = ((jcache, tcache) if quant == "_q4" else (jpaged, tpaged))
    x = _rows(3, (32, 2, 64))
    jq, js = getattr(jmod, quant)(jnp.asarray(x, jnp.bfloat16))
    want = getattr(jmod, unpack)(jq, js)
    got = getattr(tmod, unpack)(torch.from_numpy(np.array(jq)),
                                torch.from_numpy(_f32(js)).bfloat16())
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))


@pytest.mark.parametrize("level", [1, 4])
def test_slot_cache_write_read(level):
    """Two sequences and a padding row (-1), which drops; the stored codes
    and scales and the dequantized view equal JAX's. (No position past S:
    the JAX scatter at such a position writes part of the last row instead
    of dropping it, in this jax version on the CPU; the engines never
    write there.)"""
    L, S, H, D = 2, 12, 2, 16
    rng = np.random.default_rng(level)
    pos = np.array([[-1, 0, 1, 2, 7, 11], [3, 4, 9, 10, 0, 5]], np.int32)
    k, v = (_rows(int(rng.integers(99)), (2, 6, H, D)) for _ in range(2))
    jc = jcache.init_cache(L, 2, S, H, D, quantized=level)
    jc = jcache.write(jc, 1, jnp.asarray(pos), jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(v, jnp.bfloat16))
    tc = tcache.init_cache(L, 2, S, H, D, quantized=level)
    assert isinstance(tc, tcache.QuantKVCache)
    assert tc.bits == (4 if level == 4 else 8)
    assert tcache.write(tc, 1, torch.from_numpy(pos),
                        torch.from_numpy(k).bfloat16(),
                        torch.from_numpy(v).bfloat16()) is tc
    for layer in range(L):
        for jt, tt in ((jc.k, tc.k), (jc.v, tc.v)):
            np.testing.assert_array_equal(tt[layer].numpy(),
                                          np.asarray(jt[layer]))
        for jt, tt in ((jc.k_scale, tc.k_scale), (jc.v_scale, tc.v_scale)):
            np.testing.assert_array_equal(tt[layer].float().numpy(),
                                          _f32(jt[layer]))
    for got, want in zip(tcache.read(tc, 1), jcache.read(jc, 1)):
        assert got.shape == (2, S, H, D)
        np.testing.assert_array_equal(got.float().numpy(), _f32(want))


def test_rows_view_writes_through():
    """`rows(cache, i)` is a one-sequence view: a write lands in row i."""
    tc = tcache.init_cache(1, 3, 8, 2, 16, quantized=1)
    sub = tcache.rows(tc, 1)
    k = torch.ones((1, 2, 2, 16), dtype=torch.bfloat16)
    tcache.write(sub, 0, torch.tensor([[2, 3]]), k, -k)
    assert torch.equal(tc.k[0][1, 2:4], torch.full((2, 32), 127,
                                                  dtype=torch.int8))
    assert tc.k[0][[0, 2]].abs().sum() == 0
    assert torch.equal(tc.v_scale[0][1, 2], torch.full((2,), 1 / 127,
                                                       dtype=torch.bfloat16))


@pytest.mark.parametrize("level", ["q8", "q4"])
@pytest.mark.parametrize("P", [64, 128])
def test_paged_write_gather(level, P):
    """Shuffled pages, a padding row (-1) that must drop, and a position past
    the table, which both pools put in its last page. The JAX pool is a
    column pool at P=128 and a row pool at P=64; the port's gather gives
    the same dequantized values at both."""
    L, NP, H, D = 2, 7, 2, 16
    rng = np.random.default_rng(P)
    table = np.array([[3, 5], [6, 1]], np.int32)
    pos = np.array([[-1, 0, 1, P - 1, P, 2 * P + 3],
                    [2, P + 5, 40, 2 * P - 1, 3, 0]], np.int32)
    k, v = (_rows(int(rng.integers(99)), (2, 6, H, D)) for _ in range(2))
    jc = jpaged.init_paged_cache(L, NP, P, H, D, quantized=level)
    assert jc.col == (P == 128)
    jc = jpaged.write(jc, 1, jnp.asarray(table), jnp.asarray(pos),
                      jnp.asarray(k, jnp.bfloat16),
                      jnp.asarray(v, jnp.bfloat16))
    tc = tpaged.init_paged_cache(L, NP, P, H, D, quantized=level)
    assert tc.quantized and tc.bits == (4 if level == "q4" else 8)
    assert tpaged.write(tc, 1, torch.from_numpy(table),
                        torch.from_numpy(pos), torch.from_numpy(k).bfloat16(),
                        torch.from_numpy(v).bfloat16()) is tc
    for layer in range(L):
        jk, jv = jpaged.gather(jc, layer, jnp.asarray(table))
        tk, tv = tpaged.gather(tc, layer, torch.from_numpy(table))
        assert tk.shape == (2, 2 * P, H, D)
        np.testing.assert_array_equal(tk.float().numpy(), _f32(jk))
        np.testing.assert_array_equal(tv.float().numpy(), _f32(jv))
    # the written rows hold codes: nonzero exactly where a row landed
    written = (tc.k_scale[1].float() != 0).any(dim=1).nonzero().flatten()
    want = sorted({int(table[b, min(p // P, 1)]) * P + p % P
                   for b in range(2) for p in pos[b] if p >= 0})
    assert written.tolist() == want
