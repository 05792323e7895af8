"""Plain versions of K6 (flash decode over the Q8 slot cache), K9 (over a
Q8 paged pool) and K10 (over a Q4 paged pool) against the JAX package's
`decode_attention_batched_q8`, `decode_attention_paged_q8` and
`decode_attention_paged_q4` (Pallas, interpret mode), on the patterns of
tests/test_flash_decode.py: non-contiguous page tables, pos 0 (self term
only), page boundaries and a dead slot; and K9 / K10 at page size 128
against K11 (`decode_attention_paged_q8c` / `_q4c`), which JAX runs over
its column pools there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv import cache as jcache
from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu.ops import flash_decode as jfd
from koboldcpp_tpu_torch.kv import cache as tcache
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import flash_decode as tfd

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

B, H, HKV, D = 4, 8, 2, 64
SCALE = D ** -0.5


def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _j(a, dt=jnp.bfloat16):
    return jnp.asarray(a, dt)


def _new_rows(rng, bits):
    """This step's K/V rows as integers times a power of two whose amax
    hits the code range, so the scale is that power of two exactly and
    quantizing them involves no rounding tie (the JAX wrappers quantize
    under jit, where XLA may fuse round(x * (1 / s)) otherwise, as
    tests/test_flash_decode.py notes)."""
    top, unit = (7, 2 ** -3) if bits == 4 else (127, 2 ** -7)
    x = rng.integers(-top, top + 1, (2, B, HKV, D)).astype(np.float32)
    x[:, :, :, 0] = top
    return x[0] * unit, x[1] * unit


def _tol(*vals):
    """One bf16 step (2^-8) of the largest |V|: p is rounded to bf16 against
    another running max on each side (JAX's online softmax rescales per
    block, the plain version against the global max)."""
    return 2 ** -8 * max(float(np.abs(np.asarray(v, np.float32)).max())
                         for v in vals)


@pytest.mark.parametrize("positions, softcap", [((0, 5, 63, -1), 0.0),
                                               ((17, 64, 1, 40), 5.0)])
def test_k6_plain_matches_jax(positions, softcap):
    """Q8 slot cache of S=64 rows: position 64 = S attends every row and
    writes nothing, -1 is a dead slot (every row, nothing written)."""
    S = 64
    rng = np.random.default_rng(sum(positions) + 3)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = _new_rows(rng, 8)
    kc = rng.integers(-127, 128, (2, B, S, HKV * D)).astype(np.int8)
    sc = _j(rng.uniform(0.001, 0.02, (2, B, S, HKV)))
    pos = np.asarray(positions, np.int32)
    out_j, k_j, v_j, ks_j, vs_j = jfd.decode_attention_batched_q8(
        _j(q), _j(kn), _j(vn), jnp.asarray(kc[0]), jnp.asarray(kc[1]),
        sc[0], sc[1], jnp.asarray(pos), H, HKV, SCALE, softcap,
        interpret=True)
    caches = [torch.from_numpy(kc[0].copy()), torch.from_numpy(kc[1].copy()),
              torch.from_numpy(np.asarray(sc[0].astype(jnp.float32))
                               ).bfloat16(),
              torch.from_numpy(np.asarray(sc[1].astype(jnp.float32))
                               ).bfloat16()]
    out_t, *ret = tfd.decode_attention_batched_q8(
        _bf(q), _bf(kn), _bf(vn), *caches, torch.from_numpy(pos), H, HKV,
        SCALE, softcap)
    assert all(a is b for a, b in zip(ret, caches))  # updated in place
    vmax = np.abs(np.asarray(tcache.read(tcache.QuantKVCache(
        [caches[0]], [caches[1]], [caches[2]], [caches[3]], HKV), 0)[1]
        .float())).max()
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=_tol(vn, [vmax]))
    # the codes and scales written at pos equal the kernel's bit for bit
    for got, want in zip(caches, (k_j, v_j, ks_j, vs_j)):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    changed = (caches[0] != torch.from_numpy(kc[0])).any(dim=2)
    for b, p in enumerate(positions):
        assert changed[b].nonzero().flatten().tolist() == (
            [p] if 0 <= p < S else [])


P, NP, MP = 8, 40, 8


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("positions, softcap", [((0, 5, 8, 33), 0.0),
                                               ((7, -1, 16, 63), 5.0)])
def test_paged_quant_plain_matches_jax(positions, softcap, bits):
    """K9 (bits 8) and K10 (bits 4): history written by both pools' `write`
    (equal values, checked), then one decode step on each side."""
    rng = np.random.default_rng(sum(positions) + bits)
    level = "q4" if bits == 4 else "q8"
    jc = jpaged.init_paged_cache(1, NP, P, HKV, D, quantized=level)
    tc = tpaged.init_paged_cache(1, NP, P, HKV, D, quantized=level)
    table = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    for b, p in enumerate(positions):
        if p <= 0:
            continue
        ks, vs = rng.standard_normal((2, 1, p, HKV, D)).astype(np.float32)
        jc = jpaged.write(jc, 0, jnp.asarray(table[b:b + 1]),
                          jnp.arange(p)[None], _j(ks), _j(vs))
        tpaged.write(tc, 0, torch.from_numpy(table[b:b + 1]),
                     torch.arange(p)[None], _bf(ks), _bf(vs))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = _new_rows(rng, bits)
    pos = np.asarray(positions, np.int32)
    jfn = (jfd.decode_attention_paged_q4 if bits == 4
           else jfd.decode_attention_paged_q8)
    tfn = (tfd.decode_attention_paged_q4 if bits == 4
           else tfd.decode_attention_paged_q8)
    out_j, *upd = jfn(_j(q), _j(kn), _j(vn), jc.k[0], jc.v[0],
                      jc.k_scale[0], jc.v_scale[0], jnp.asarray(table),
                      jnp.asarray(pos), H, HKV, P, SCALE, softcap,
                      interpret=True)
    pools = (tc.k[0], tc.v[0], tc.k_scale[0], tc.v_scale[0])
    out_t, *ret = tfn(_bf(q), _bf(kn), _bf(vn), *pools,
                      torch.from_numpy(table), torch.from_numpy(pos), H, HKV,
                      P, SCALE, softcap)
    assert all(a is b for a, b in zip(ret, pools))  # updated in place
    live = [b for b, p in enumerate(positions) if p >= 0]  # dead: discarded
    _, tv = tpaged.gather(tc, 0, torch.from_numpy(table))
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               rtol=0, atol=_tol(vn, tv.float()))
    # after the step both pools hold the same values (the rows at pos are
    # the quantized new rows), and no other pool row changed
    jc = jc.with_layer(0, *upd)
    for got, want in zip(tpaged.gather(tc, 0, torch.from_numpy(table)),
                         jpaged.gather(jc, 0, jnp.asarray(table))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [8, 4])
def test_k9_k10_serve_the_column_pools_of_k11(bits):
    """At page size 128 the JAX pool is a column pool (kv/paged.py:116-118:
    P % 128 == 0 and a stored KV width under 1 KiB), and its decode runs
    K11 (`decode_attention_paged_q8c` / `_q4c`). The port keeps row pools
    at every P, so K9 / K10 serve P=128: their plain versions over the
    port's row pool against K11 over the JAX column pool, the same history
    written by both pools' `write`, with test_paged_quant_plain_matches_jax's
    tolerance; afterwards both pools hold the same values."""
    P128, NP128, MP128 = 128, 10, 2
    positions = (0, 130, 255, -1)
    rng = np.random.default_rng(11 + bits)
    level = "q4" if bits == 4 else "q8"
    jc = jpaged.init_paged_cache(1, NP128, P128, HKV, D, quantized=level)
    assert jc.kd > 0  # the column layout, where JAX runs K11
    tc = tpaged.init_paged_cache(1, NP128, P128, HKV, D, quantized=level)
    table = rng.permutation(NP128)[:B * MP128].reshape(B, MP128).astype(
        np.int32)
    for b, p in enumerate(positions):
        if p <= 0:
            continue
        ks, vs = rng.standard_normal((2, 1, p, HKV, D)).astype(np.float32)
        jc = jpaged.write(jc, 0, jnp.asarray(table[b:b + 1]),
                          jnp.arange(p)[None], _j(ks), _j(vs))
        tpaged.write(tc, 0, torch.from_numpy(table[b:b + 1]),
                     torch.arange(p)[None], _bf(ks), _bf(vs))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = _new_rows(rng, bits)
    pos = np.asarray(positions, np.int32)
    jfn = (jfd.decode_attention_paged_q4c if bits == 4
           else jfd.decode_attention_paged_q8c)
    tfn = (tfd.decode_attention_paged_q4 if bits == 4
           else tfd.decode_attention_paged_q8)
    out_j, *upd = jfn(_j(q), _j(kn), _j(vn), jc.k[0], jc.v[0],
                      jc.k_scale[0], jc.v_scale[0], jnp.asarray(table),
                      jnp.asarray(pos), H, HKV, P128, SCALE, 0.0,
                      interpret=True)
    out_t, *_ = tfn(_bf(q), _bf(kn), _bf(vn), tc.k[0], tc.v[0],
                    tc.k_scale[0], tc.v_scale[0], torch.from_numpy(table),
                    torch.from_numpy(pos), H, HKV, P128, SCALE, 0.0)
    live = [b for b, p in enumerate(positions) if p >= 0]
    _, tv = tpaged.gather(tc, 0, torch.from_numpy(table))
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               rtol=0, atol=_tol(vn, tv.float()))
    jc = jc.with_layer(0, *upd)
    for got, want in zip(tpaged.gather(tc, 0, torch.from_numpy(table)),
                         jpaged.gather(jc, 0, jnp.asarray(table))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def test_quant_plain_counts_no_launch():
    rng = np.random.default_rng(0)
    q = _bf(rng.standard_normal((B, H, D)))
    kn, vn = (_bf(x) for x in _new_rows(rng, 8))
    c = tcache.init_cache(1, B, 16, HKV, D, quantized=1)
    p8 = tpaged.init_paged_cache(1, NP, P, HKV, D, quantized=1)
    p4 = tpaged.init_paged_cache(1, NP, P, HKV, D, quantized=4)
    table = torch.arange(B * 2).reshape(B, 2)
    pos = torch.tensor([3, 0, 9, -1])
    _build.launches.clear()
    tfd.decode_attention_batched_q8(q, kn, vn, c.k[0], c.v[0], c.k_scale[0],
                                    c.v_scale[0], pos, H, HKV, SCALE)
    for fn, pc in ((tfd.decode_attention_paged_q8, p8),
                   (tfd.decode_attention_paged_q4, p4)):
        fn(q, kn, vn, pc.k[0], pc.v[0], pc.k_scale[0], pc.v_scale[0], table,
           pos, H, HKV, P, SCALE)
    assert sum(_build.launches.values()) == 0
