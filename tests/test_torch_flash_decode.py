"""Plain versions of K5 (batched flash decode with the in-place K/V row
write) and K8 (the same over a paged pool) against the JAX package's
`decode_attention_batched` and `decode_attention_paged` (Pallas, interpret
mode)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.ops import flash_decode as jfd
from koboldcpp_tpu_torch.ops import flash_decode as tfd

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

B, S, H, HKV, D = 2, 64, 8, 2, 64


def _inputs(seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    kc = (rng.standard_normal((B, S, HKV * D)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((B, S, HKV * D)) * 0.5).astype(np.float32)
    return q, kn, vn, kc, vc


def _bf16(a):
    return torch.from_numpy(a).bfloat16()


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("positions", [(0, 31), (63, 17), (-1, 40)])
def test_plain_matches_jax(positions, softcap):
    """Scores are bf16 q.k in f32 on both sides and p is rounded to bf16
    before p.V; JAX's online softmax rescales per 64-row block against a
    running max, the plain version against the global max, so a p can land
    one bf16 step apart: 2e-3 absolute on outputs of size ~0.5."""
    q, kn, vn, kc, vc = _inputs(sum(positions) + 7)
    pos = np.asarray(positions, np.int32)
    scale = D ** -0.5
    out_j, k_j, v_j = jfd.decode_attention_batched(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16),
        jnp.asarray(vn, jnp.bfloat16), jnp.asarray(kc, jnp.bfloat16),
        jnp.asarray(vc, jnp.bfloat16), jnp.asarray(pos), H, HKV, scale,
        softcap, interpret=True)
    k_t, v_t = _bf16(kc), _bf16(vc)
    out_t, k_ret, v_ret = tfd.decode_attention_batched(
        _bf16(q), _bf16(kn), _bf16(vn), k_t, v_t, torch.from_numpy(pos), H,
        HKV, scale, softcap)
    assert k_ret is k_t and v_ret is v_t  # updated in place
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=0, atol=2e-3)
    # the cache update is exact: one row at pos, nothing where pos < 0
    np.testing.assert_array_equal(k_t.float().numpy(),
                                  np.asarray(k_j.astype(jnp.float32)))
    np.testing.assert_array_equal(v_t.float().numpy(),
                                  np.asarray(v_j.astype(jnp.float32)))
    for b, p in enumerate(positions):
        changed = (k_t[b].float() != _bf16(kc)[b].float()).any(dim=1)
        assert changed.nonzero().flatten().tolist() == ([p] if p >= 0 else [])


def test_plain_counts_no_launch():
    from koboldcpp_tpu_torch.ops import _build

    q, kn, vn, kc, vc = _inputs(0)
    _build.launches.clear()
    tfd.decode_attention_batched(_bf16(q), _bf16(kn), _bf16(vn), _bf16(kc),
                                 _bf16(vc), torch.tensor([3, 4]), H, HKV, 0.125)
    assert sum(_build.launches.values()) == 0


# K8: B sequences over a pool of NP pages of P rows, MP pages per sequence
P, NP, MP = 8, 40, 8


def _paged_inputs(seed):
    """Shuffled pages: every sequence's MP table entries are distinct pool
    pages in a random order, so a row read through the wrong entry (or as
    if the pool were contiguous) lands on another sequence's data."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    vn = rng.standard_normal((B, HKV, D)).astype(np.float32)
    kp = (rng.standard_normal((NP * P, HKV * D)) * 0.5).astype(np.float32)
    vp = (rng.standard_normal((NP * P, HKV * D)) * 0.5).astype(np.float32)
    table = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    return q, kn, vn, kp, vp, table


@pytest.mark.parametrize("softcap", [0.0, 5.0])
@pytest.mark.parametrize("positions", [(0, 9), (63, 17), (-1, 40), (8, 70)])
def test_paged_plain_matches_jax(positions, softcap):
    """The K5 tolerance (2e-3, see test_plain_matches_jax): JAX's online
    softmax rescales per page. Position 70 is past MP*P = 64 (overshoot:
    every page read, nothing written); -1 is a dead slot."""
    q, kn, vn, kp, vp, table = _paged_inputs(sum(positions) + 11)
    pos = np.asarray(positions, np.int32)
    scale = D ** -0.5
    out_j, k_j, v_j = jfd.decode_attention_paged(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16),
        jnp.asarray(vn, jnp.bfloat16), jnp.asarray(kp, jnp.bfloat16),
        jnp.asarray(vp, jnp.bfloat16), jnp.asarray(table), jnp.asarray(pos),
        H, HKV, P, scale, softcap, interpret=True)
    k_t, v_t = _bf16(kp), _bf16(vp)
    out_t, k_ret, v_ret = tfd.decode_attention_paged(
        _bf16(q), _bf16(kn), _bf16(vn), k_t, v_t, torch.from_numpy(table),
        torch.from_numpy(pos), H, HKV, P, scale, softcap)
    assert k_ret is k_t and v_ret is v_t  # updated in place
    live = [b for b, p in enumerate(positions) if p >= 0]  # dead: discarded
    np.testing.assert_allclose(out_t.numpy()[live], np.asarray(out_j)[live],
                               rtol=0, atol=2e-3)
    # the pool update is exact: the row at pos through the table, only
    np.testing.assert_array_equal(k_t.float().numpy(),
                                  np.asarray(k_j.astype(jnp.float32)))
    np.testing.assert_array_equal(v_t.float().numpy(),
                                  np.asarray(v_j.astype(jnp.float32)))
    want = sorted(int(table[b, p // P]) * P + p % P
                  for b, p in enumerate(positions) if 0 <= p < MP * P)
    changed = (k_t.float() != _bf16(kp).float()).any(dim=1)
    assert changed.nonzero().flatten().tolist() == want


def test_paged_plain_equals_contiguous_plain():
    """K8 over a page table gives K5's output on the same history laid out
    contiguously, bit for bit (the kernels share split boundaries and
    arithmetic; so do the plain versions), and the same row writes."""
    q, kn, vn, kp, vp, table = _paged_inputs(5)
    pos = torch.tensor([37, -1])
    rows = tfd._page_rows(torch.from_numpy(table), P, NP)
    kc, vc = _bf16(kp)[rows], _bf16(vp)[rows]  # (B, MP*P, KD) contiguous
    k_t, v_t = _bf16(kp), _bf16(vp)
    out_p, _, _ = tfd.decode_attention_paged(
        _bf16(q), _bf16(kn), _bf16(vn), k_t, v_t, torch.from_numpy(table),
        pos, H, HKV, P, 0.125)
    out_c, _, _ = tfd.decode_attention_batched(
        _bf16(q), _bf16(kn), _bf16(vn), kc, vc, pos, H, HKV, 0.125)
    assert torch.equal(out_p, out_c)
    assert torch.equal(k_t[rows], kc) and torch.equal(v_t[rows], vc)


def test_paged_plain_counts_no_launch():
    from koboldcpp_tpu_torch.ops import _build

    q, kn, vn, kp, vp, table = _paged_inputs(0)
    _build.launches.clear()
    tfd.decode_attention_paged(_bf16(q), _bf16(kn), _bf16(vn), _bf16(kp),
                               _bf16(vp), torch.from_numpy(table),
                               torch.tensor([3, 4]), H, HKV, P, 0.125)
    assert sum(_build.launches.values()) == 0
