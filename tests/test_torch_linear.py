"""The port's packing and dequant (q2_k, q3_k, q4_k, q5_k, q6_k, q8_0 and the GGUF
types mapped onto them) against the JAX package's: the same GGUF bytes must
pack into the same kind and dequantize to the same bits."""
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
MANIFEST = json.load(open(os.path.join(FIX, "manifest.json")))


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


@pytest.mark.parametrize("fmt", list(MANIFEST["files"]))
def test_dequant_matches_jax_on_every_fixture(fmt):
    """Every 2-D tensor of each reference fixture packs into the JAX kind
    (Q4_0 -> q4_k, Q5_1 -> q5_k, Q8_0 / IQ4_NL / TQ2_0 -> q8_0, ...) and
    dequantizes to the same bits."""
    kinds = set()
    with GGUFReader(os.path.join(FIX, MANIFEST["files"][fmt])) as r:
        for n, i in r.tensors.items():
            if len(i.shape) == 2:
                jq, tq = _both(r.tensor_raw(n), i.ggml_type, tuple(i.shape))
                _assert_same_dequant(jq, tq)
                kinds.add(tq.kind)
    assert kinds == {"f16": {"dense"}, "q4_0": {"q4_k", "q6_k"},
                     "q5_1": {"q5_k", "q6_k"}, "q8_0": {"q8_0"},
                     "q4_k_m": {"q4_k", "q6_k"}, "q6_k": {"q6_k"},
                     "iq4_nl": {"q8_0", "q6_k"},
                     "tq2_0": {"q8_0", "q4_k", "q6_k"}}[fmt]


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q6_K, GGMLType.Q5_K,
                               GGMLType.Q8_0, GGMLType.Q4_0, GGMLType.Q4_1,
                               GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.IQ4_NL,
                               GGMLType.IQ4_XS, GGMLType.TQ1_0,
                               GGMLType.TQ2_0, GGMLType.Q2_K, GGMLType.Q3_K],
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


@pytest.mark.parametrize("t", [GGMLType.Q4_0, GGMLType.Q4_1, GGMLType.Q5_0,
                               GGMLType.Q5_1], ids=lambda t: t.name)
def test_odd_width_block32_packs_as_q8_0(t):
    """A block-32 tensor whose width is a multiple of 32 but not of 256 is
    served as q8_0 through the int8 expansion, as in JAX, bit for bit."""
    rng = np.random.default_rng(7)
    w = (rng.standard_normal((64, 288)) * 0.1).astype(np.float32)
    jq, tq = _both(quants.quantize(w, t), t, (64, 288))
    assert tq.kind == "q8_0"
    _assert_same_dequant(jq, tq)
    np.testing.assert_array_equal(tq.data["q"].numpy(), np.asarray(jq.data["q"]))


def test_q5k_bit_plane_order():
    """qh bit b of byte j is the 5th bit of logical col 8j+b: flipping one
    5th bit in the GGUF bytes (qh byte l bit b of superblock s: col
    256s+32b+l) moves exactly that weight's code by 16."""
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((256, 512)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, GGMLType.Q5_K)
    row, sb, l, b = 3, 1, 5, 6
    flip = raw.copy()
    flip[row, sb * 176 + 16 + l] ^= 1 << b

    def codes(r):
        qt = tlinear.from_gguf(r, GGMLType.Q5_K, (256, 512))
        return tlinear.q5k_values(qt.data["qs2"], qt.data["qh"]).int()

    diff = codes(flip) - codes(raw)
    col = sb * 256 + 32 * b + l
    assert diff.nonzero().tolist() == [[row, col]]
    assert abs(int(diff[row, col])) == 16


@pytest.mark.parametrize("t", [GGMLType.Q5_K, GGMLType.Q8_0],
                         ids=lambda t: t.name)
def test_params_from_jax_converts_q5k_and_q8_0(t):
    """A JAX-packed q5_k / q8_0 QTensor handed over as numpy (scale_lo /
    scale_hi and the hb sidecar for q5_k) becomes the port's logical
    fields, equal to the port's own packing of the same bytes."""
    from koboldcpp_tpu_torch.models.convert import params_from_jax

    rng = np.random.default_rng(9)
    w = (rng.standard_normal((256, 512)) * 0.1).astype(np.float32)
    jq, tq = _both(quants.quantize(w, t), t, (256, 512))
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    assert got.kind == tq.kind and set(got.data) == set(tq.data)
    for name, v in tq.data.items():
        assert torch.equal(got.data[name], v), name


def test_unported_packed_kinds_raise():
    """No packed kind raises any more: Q2_K and Q3_K pack to q2_k / q3_k
    (test_dequant_matches_jax_on_quantized holds their dequant to JAX's),
    as Q5_K and Q8_0 do, and the native IQ1-3 types to iq2p / iq3px /
    iq3ps / iq1p (tests/test_torch_iq.py holds their dequant to JAX's)."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((256, 256)) * 0.1).astype(np.float32)
    for t, kind in ((GGMLType.Q2_K, "q2_k"), (GGMLType.Q3_K, "q3_k")):
        assert tlinear.from_gguf(quants.quantize(w, t), t,
                                 (256, 256)).kind == kind
    for t, kind, nbytes in ((GGMLType.IQ2_XXS, "iq2p", 66),
                            (GGMLType.IQ2_XS, "iq2p", 74),
                            (GGMLType.IQ2_S, "iq2p", 82),
                            (GGMLType.IQ3_XXS, "iq3px", 98),
                            (GGMLType.IQ3_S, "iq3ps", 110),
                            (GGMLType.IQ1_S, "iq1p", 50),
                            (GGMLType.IQ1_M, "iq1p", 56)):
        assert tlinear.from_gguf(np.zeros((256, nbytes), np.uint8), t,
                                 (256, 256)).kind == kind
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
