"""Plain version of K5 (batched flash decode with the in-place K/V row
write) against the JAX package's `decode_attention_batched` (Pallas,
interpret mode)."""
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
