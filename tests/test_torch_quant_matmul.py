"""Plain versions of K1 (q4_k matvec), K2 (q6_k matvec) and K3 (q4_k/q6_k
tiled matmul) against the JAX package's `matmul_packed` (Pallas kernels in
interpret mode), on the same GGUF bytes and the same bf16 activations."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)


def _pair(t, out_f, in_f, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, t)
    return (jlinear.from_gguf(raw, t, (out_f, in_f), packed=True),
            tlinear.from_gguf(raw, t, (out_f, in_f), packed=True))


def _x(T, in_f, seed=1):
    x = np.random.default_rng(seed).standard_normal((T, in_f)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _run_both(jq, tq, x):
    want = np.asarray(jqm.matmul_packed(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jq).astype(jnp.float32))
    got = tqm.matmul_packed(x, tq).float().numpy()
    return got, want


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("in_f", [256, 512, 1024])
def test_matvec_plain_matches_jax(t, in_f):
    """T=1: bf16-activation variant below in_f 512, int8 above, as in JAX.
    The int8 variants quantize x identically (same f32 formula, rint), so
    each group's integer dot is exact on both sides; the f32 sums run in
    another order and the bf16 outputs may differ by a rounding step (2^-8
    relative). The bf16 variant is the exact dot, where JAX's magic-number
    kernel subtracts a bf16-rounded group sum: about 2^-8 of one group's
    term more."""
    jq, tq = _pair(t, 512, in_f)
    x = _x(1, in_f)
    got, want = _run_both(jq, tq, x)
    scale = np.abs(want).max()
    tol = 1e-2 if in_f >= 512 else 2e-2
    assert np.abs(got - want).max() <= tol * scale


def test_matvec_variant_follows_in_f():
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    x = _x(1, 512)
    i8 = tqm.q4k_matvec_plain(x[0], tq, i8=True)
    bf = tqm.q4k_matvec_plain(x[0], tq, i8=False)
    assert torch.equal(tqm.matmul_packed(x, tq), i8)
    assert not torch.equal(i8, bf)


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("T", [16, 48])
def test_tiled_matmul_plain_matches_jax(t, T):
    """T >= 16: both feed bf16(q * scale) weights and bf16 group sums to an
    f32-accumulated product; the sums' order differs, so the bf16 outputs
    may differ by a rounding step."""
    jq, tq = _pair(t, 256, 512)
    x = _x(T, 512)
    got, want = _run_both(jq, tq, x)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-2 * scale


def test_small_batch_raises_naming_k7():
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    with pytest.raises(NotImplementedError, match="K7"):
        tqm.matmul_packed(_x(4, 512), tq)


def test_plain_versions_do_not_count_launches():
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    _build.launches.clear()
    tqm.matmul_packed(_x(1, 512), tq)
    tqm.matmul_packed(_x(16, 512), tq)
    assert sum(_build.launches.values()) == 0
