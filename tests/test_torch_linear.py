"""The port's q4_k / q6_k packing and dequant against the JAX package's:
the same GGUF bytes must dequantize to the same bits."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.gguf.reader import GGUFReader
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu_torch.ops import linear as tlinear

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf")


def _both(raw, t, shape):
    return (jlinear.from_gguf(raw, t, shape, packed=True),
            tlinear.from_gguf(raw, t, shape, packed=True, device="cpu"))


# jitted, as the JAX forward runs it: one compile per shape instead of one
# per op
_jax_dequant = jax.jit(jlinear.dequant_xla, static_argnames="dtype")


def _assert_same_dequant(jq, tq):
    assert tq.kind == jq.kind and tuple(tq.shape) == tuple(jq.shape)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(_jax_dequant(jq, dtype=jdt).astype(jnp.float32))
        got = tlinear.dequant(tq, dtype=tdt).float().numpy()
        # bit for bit: same f32 products, same rounding to bf16
        np.testing.assert_array_equal(got, want)


def _fixture_tensors():
    with GGUFReader(os.path.join(FIX, "tiny-q4_k_m.gguf")) as r:
        return [(n, r.tensor_raw(n), i.ggml_type, tuple(i.shape))
                for n, i in r.tensors.items()
                if i.ggml_type in (GGMLType.Q4_K, GGMLType.Q6_K)
                and len(i.shape) == 2 and i.shape[1] % 256 == 0]


@pytest.mark.parametrize("name,raw,t,shape", _fixture_tensors(),
                         ids=lambda v: v if isinstance(v, str) else "")
def test_dequant_matches_jax_on_fixture(name, raw, t, shape):
    _assert_same_dequant(*_both(raw, t, shape))


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("in_f", [256, 512, 1024])
def test_dequant_matches_jax_on_quantized(t, in_f):
    rng = np.random.default_rng(in_f)
    w = (rng.standard_normal((256, in_f)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, t)
    jq, tq = _both(raw, t, (256, in_f))
    _assert_same_dequant(jq, tq)
    # and the logical bf16 scales equal JAX's plane-ordered ones
    if t == GGMLType.Q4_K:
        s = tq.data["scale"].float().numpy().reshape(256, -1, 2, 4)
        np.testing.assert_array_equal(
            s[:, :, 0].reshape(256, -1),
            np.asarray(jq.data["scale_lo"].astype(jnp.float32)))
        np.testing.assert_array_equal(
            s[:, :, 1].reshape(256, -1),
            np.asarray(jq.data["scale_hi"].astype(jnp.float32)))


def test_unported_packed_kinds_raise():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 256)) * 0.1).astype(np.float32)
    for t, kernel in ((GGMLType.Q8_0, "K12/K13"), (GGMLType.Q5_K, "q5_k")):
        with pytest.raises(NotImplementedError, match=kernel):
            tlinear.from_gguf(quants.quantize(w, t), t, (256, 256))
    # a type the JAX package also dequantizes stays dense
    f16 = tlinear.from_gguf(w.astype(np.float16).view(np.uint8), GGMLType.F16,
                            (256, 256))
    assert f16.kind == "dense"


def test_matmul_dequant_path_for_declined_shapes():
    """out_f % 256 != 0: the JAX dispatch declines and dequantizes; the
    port does the same (dequant + f32-accumulated matmul)."""
    rng = np.random.default_rng(3)
    w = (rng.standard_normal((128, 256)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, GGMLType.Q4_K)
    jq, tq = _both(raw, GGMLType.Q4_K, (128, 256))
    x = rng.standard_normal((3, 256)).astype(np.float32)
    want = np.asarray(jlinear.matmul(jnp.asarray(x, jnp.bfloat16), jq)
                      .astype(jnp.float32))
    got = tlinear.matmul(torch.from_numpy(x).bfloat16(), tq).float().numpy()
    # same bf16 inputs and weights, f32 sums in another order, bf16 output:
    # at most one bf16 rounding step apart
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-3)


def test_activation_collector_matches_jax():
    """The imatrix hook in `matmul` records the same per-column sum(x^2) and
    row count on both sides (bf16 inputs squared in f32; the sums run in
    another order)."""
    rng = np.random.default_rng(4)
    raw = quants.quantize((rng.standard_normal((256, 512)) * 0.1)
                          .astype(np.float32), GGMLType.Q4_K)
    jq, tq = _both(raw, GGMLType.Q4_K, (256, 512))
    x = torch.from_numpy(rng.standard_normal((2, 16, 512)).astype(np.float32)
                         ).bfloat16()
    jc = jlinear.ActivationCollector({id(jq): "w"})
    tc = tlinear.ActivationCollector({id(tq): "w"})
    try:
        jlinear._COLLECTOR, tlinear._COLLECTOR = jc, tc
        for _ in range(2):
            jlinear.matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16), jq)
            tlinear.matmul(x, tq)
    finally:
        jlinear._COLLECTOR = tlinear._COLLECTOR = None
    assert tc.counts == jc.counts == {"w": 64}
    np.testing.assert_allclose(tc.weights()["w"], jc.weights()["w"],
                               rtol=1e-5)
