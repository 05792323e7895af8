"""Plain versions of K1 (q4_k/q5_k matvec), K7 (q4_k/q5_k batched matvec),
K2 (q6_k and q8_0 matvec), K12 (q2_k/q3_k matvec), K3 (q4_k/q5_k/q6_k/q8_0
tiled matmul) and K13 (its q2_k/q3_k bodies) against
the JAX package's `matmul_packed` (Pallas kernels in interpret mode), on the
same GGUF bytes and the same bf16 activations."""
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


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_K,
                               GGMLType.Q8_0, GGMLType.Q2_K, GGMLType.Q3_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("in_f", [256, 512, 1024])
def test_matvec_plain_matches_jax(t, in_f):
    """T=1: bf16-activation variant below in_f 512, int8 above, as in JAX
    (q8_0: int8 at every in_f, `_q8_0_row_kernel_i8`).
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
    tol = 1e-2 if in_f >= 512 or t == GGMLType.Q8_0 else 2e-2
    assert np.abs(got - want).max() <= tol * scale


def test_matvec_variant_follows_in_f():
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    x = _x(1, 512)
    i8 = tqm.q4k_matvec_plain(x[0], tq, i8=True)
    bf = tqm.q4k_matvec_plain(x[0], tq, i8=False)
    assert torch.equal(tqm.matmul_packed(x, tq), i8)
    assert not torch.equal(i8, bf)


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_K,
                               GGMLType.Q8_0, GGMLType.Q2_K, GGMLType.Q3_K],
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


@pytest.mark.parametrize("in_f,T", [(512, 2), (512, 4), (512, 8),
                                    (1024, 2), (1024, 4), (1024, 8),
                                    (256, 2), (256, 4)])
def test_batched_matvec_plain_matches_jax(in_f, T):
    """2 <= T <= 8 q4_k (K7): JAX's `_q4k_decode_kernel_i8_t` for in_f >=
    512, the bf16 `_q4k_decode_kernel` over per-token stacks below, with
    the tolerances of test_matvec_plain_matches_jax."""
    jq, tq = _pair(GGMLType.Q4_K, 512, in_f)
    x = _x(T, in_f, seed=T)
    _build.launches.clear()
    got, want = _run_both(jq, tq, x)
    assert got.shape == (T, 512)
    tol = 1e-2 if in_f >= 512 else 2e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()
    assert sum(_build.launches.values()) == 0  # plain version, no launch


@pytest.mark.parametrize("i8", [True, False])
def test_batched_matvec_rows_equal_single_token(i8):
    """Row t of K7 is K1 on x[t] alone, bit for bit: a request served in a
    batch gets the logits it gets alone."""
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    x = _x(8 if i8 else 4, 512, seed=3)
    y = tqm.q4k_matvec_t_plain(x, tq, i8)
    for t in range(x.shape[0]):
        assert torch.equal(y[t:t + 1], tqm.q4k_matvec_plain(x[t], tq, i8))


def test_batched_matvec_dispatch():
    """matmul_packed sends q4_k 2 <= T <= 8 to K7 with JAX's variant choice
    (int8 for in_f >= 512, bf16 at T <= 4 below), and beyond to K3."""
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    x = _x(8, 512)
    assert torch.equal(tqm.matmul_packed(x, tq),
                       tqm.q4k_matvec_t_plain(x, tq, True))
    _, tq256 = _pair(GGMLType.Q4_K, 256, 256)
    x = _x(4, 256)
    assert torch.equal(tqm.matmul_packed(x, tq256),
                       tqm.q4k_matvec_t_plain(x, tq256, False))
    x = _x(5, 256)
    assert torch.equal(tqm.matmul_packed(x, tq256), tqm.kq_matmul_plain(x, tq256))


def test_plain_versions_do_not_count_launches():
    _, tq = _pair(GGMLType.Q4_K, 256, 512)
    _build.launches.clear()
    tqm.matmul_packed(_x(1, 512), tq)
    tqm.matmul_packed(_x(16, 512), tq)
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("in_f,T", [(512, 2), (512, 4), (512, 8), (1024, 8),
                                    (256, 2), (256, 4)])
def test_batched_q5k_matvec_plain_matches_jax(in_f, T):
    """2 <= T <= 8 q5_k (K7.q5_k): JAX's `_q5k_decode_kernel_i8_t` for in_f
    >= 512, the bf16 `_q5k_decode_kernel` below, with the tolerances of
    test_matvec_plain_matches_jax."""
    jq, tq = _pair(GGMLType.Q5_K, 512, in_f)
    x = _x(T, in_f, seed=T)
    got, want = _run_both(jq, tq, x)
    assert got.shape == (T, 512)
    tol = 1e-2 if in_f >= 512 else 2e-2
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def test_q8_0_batch_takes_the_tiled_matmul():
    """q8_0 at T=4 (a batched decode step) goes to JAX's 2-D `_q8_0_kernel`
    as at prefill; the port's K3 plain version, with its tolerance."""
    jq, tq = _pair(GGMLType.Q8_0, 512, 1024)
    x = _x(4, 1024, seed=4)
    got, want = _run_both(jq, tq, x)
    assert torch.equal(tqm.matmul_packed(x, tq), tqm.kq_matmul_plain(x, tq))
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("i8", [True, False])
def test_batched_q5k_rows_equal_single_token(i8):
    """K7.q5_k row t is K1.q5_k on x[t] alone, bit for bit."""
    _, tq = _pair(GGMLType.Q5_K, 256, 512)
    x = _x(8 if i8 else 4, 512, seed=5)
    y = tqm.q4k_matvec_t_plain(x, tq, i8)
    for t in range(x.shape[0]):
        assert torch.equal(y[t:t + 1], tqm.q4k_matvec_plain(x[t], tq, i8))


def test_new_kinds_dispatch():
    """matmul_packed routes q5_k as q4_k (K1 / K7 / K3 by T and in_f) and
    q8_0 to K2.q8_0 at T=1 and K3 above, as the JAX dispatch does."""
    _, q5 = _pair(GGMLType.Q5_K, 256, 512)
    _, q8 = _pair(GGMLType.Q8_0, 256, 256)
    x = _x(8, 512)
    assert torch.equal(tqm.matmul_packed(x[:1], q5),
                       tqm.q4k_matvec_plain(x[0], q5, True))
    assert torch.equal(tqm.matmul_packed(x, q5),
                       tqm.q4k_matvec_t_plain(x, q5, True))
    x16 = _x(16, 512)
    assert torch.equal(tqm.matmul_packed(x16, q5), tqm.kq_matmul_plain(x16, q5))
    x = _x(2, 256)
    assert torch.equal(tqm.matmul_packed(x[:1], q8),
                       tqm.q8_0_matvec_plain(x[0], q8))
    assert torch.equal(tqm.matmul_packed(x, q8), tqm.kq_matmul_plain(x, q8))


def test_q8_0_lane_order_sum():
    """The fixed summation order of K2.q8_0 (csrc/rowmv_g.cuh: per row and
    group i of the 4 in each 128-column span, warp w adds the terms of
    groups 4sp + i of its spans sp = 8k + w from 0, then (i 0 + i 1) + (i 2
    + i 3), then the 8 warps in order) equals a scalar f32 walk of that
    order bit for bit, and adds every group term once: it equals an f64 sum
    to f32 rounding, also for group counts that do not fill the last K step
    (8, 64 and 176 groups: in_f 256, 2048, 5632)."""
    rng = np.random.default_rng(6)
    for ng in (8, 64, 176):
        v = torch.from_numpy(rng.standard_normal((5, ng)).astype(np.float32))
        got = tqm._q8_0_order_sum(v)
        vn = v.numpy()
        for r in range(5):
            warps = []
            for w in range(8):
                acc = [np.float32(0.0)] * 4
                for k in range(-(-ng // 32)):
                    for i in range(4):
                        g = 4 * (8 * k + w) + i
                        if g < ng:
                            acc[i] = np.float32(acc[i] + vn[r, g])
                warps.append(np.float32(np.float32(acc[0] + acc[1])
                                        + np.float32(acc[2] + acc[3])))
            t = warps[0]
            for w in range(1, 8):
                t = np.float32(t + warps[w])
            assert got[r].item() == t
        want = v.double().sum(dim=1)
        assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-5)
