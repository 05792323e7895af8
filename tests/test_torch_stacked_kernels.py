"""Plain versions of the scan decode path's kernels against the JAX
package's, on the CPU (the JAX Pallas kernels in interpret mode): K17a /
K17b (the layer-stacked matvecs, `matmul_packed_stacked`), K17c (the
pooled-row flash decode, `decode_attention_rows`), K16 (the read-only
single-sequence decode, `decode_attention`) and K5 over an f32 cache."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.gguf.constants import GGML_BLOCK_SIZES
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.ops import flash_decode as jfd
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import flash_decode as tfd
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

L = 3
OUT_F, IN_F = 256, 512
# the stacked kinds and the GGUF type each is quantized from
KINDS = {"q4_k": GGMLType.Q4_K, "q5_k": GGMLType.Q5_K, "q6_k": GGMLType.Q6_K,
         "q8_0": GGMLType.Q8_0, "q2_k": GGMLType.Q2_K, "q3_k": GGMLType.Q3_K,
         "iq2p": GGMLType.IQ2_XS, "iq1p": GGMLType.IQ1_M}


def _raw(rng, t, rows, cols):
    """GGUF bytes of a (rows, cols) weight: quantized from N(0, 0.1^2)
    values, or for an IQ type random blocks with a small finite f16 scale
    (tests/test_torch_iq.py `make_raw`)."""
    if t in (GGMLType.IQ2_XS, GGMLType.IQ1_M, GGMLType.IQ2_XXS):
        blk, sz = GGML_BLOCK_SIZES[t]
        raw = rng.integers(0, 256, size=(rows, cols // blk * sz),
                           dtype=np.uint8)
        b = raw.reshape(rows, cols // blk, sz)
        if t == GGMLType.IQ1_M:
            b[:, :, 55] = (b[:, :, 55] & 0x0F) | 0x20
        else:
            b[:, :, 1] = 0x2C | rng.integers(0, 4, b[:, :, 1].shape)
        return raw
    w = (rng.standard_normal((rows, cols)) * 0.1).astype(np.float32)
    return quants.quantize(w, t)


def _stacked(t, seed, shape=(OUT_F, IN_F)):
    """L layers of GGUF type t packed by both packages: the JAX per-layer
    QTensors stacked field by field (as the JAX `stack_layers` stacks them),
    and the port's conversion of that stack."""
    rng = np.random.default_rng(seed)
    jqs = [jlinear.from_gguf(_raw(rng, t, *shape), t, shape, packed=True)
           for _ in range(L)]
    jst = jlinear.QTensor(kind=jqs[0].kind, shape=jqs[0].shape,
                          data={n: jnp.stack([q.data[n] for q in jqs])
                                for n in jqs[0].data})
    np_st = jlinear.QTensor(kind=jst.kind, shape=jst.shape,
                            data={n: np.asarray(a)
                                  for n, a in jst.data.items()})
    tst = params_from_jax({"layers_stacked": {"w": np_st}})[
        "layers_stacked"]["w"]
    return jst, tst


def _x(in_f=IN_F, seed=1, T=1):
    x = np.random.default_rng(seed).standard_normal((T, in_f)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _jax_y(x, jst, li):
    y = jqm.matmul_packed_stacked(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jst, li)
    return None if y is None else np.asarray(y.astype(jnp.float32))


@pytest.mark.parametrize("kind", list(KINDS))
def test_stacked_matvec_plain_matches_jax(kind):
    """Every layer of L=3 at (256, 512): the port's matmul_packed_stacked
    (K17a for q4_k / q5_k, K17b for the rest, plain on the CPU) against the
    JAX one, at the tolerance of the port's test of the per-layer kernel of
    that kind (1e-2 of max |y| for the K-quants at in_f 512, 2^-7 for the
    IQ kinds: exact int32 dots, f32 sums in another order, one bf16
    rounding); and bit for bit the per-layer plain version on layer li, as
    `matmul_packed` picks it for that layer alone."""
    jst, tst = _stacked(KINDS[kind], seed=10 + list(KINDS).index(kind))
    x = _x()
    tol = 2 ** -7 if kind in tlinear.IQ_KINDS else 1e-2
    for li in range(L):
        index = torch.tensor([li], dtype=torch.int32)
        got = tqm.matmul_packed_stacked(x, tst, index)
        assert got is not None, kind
        assert torch.equal(got, tqm.matmul_packed(x, tqm.layer_of(tst, li)))
        want = _jax_y(x, jst, li)
        err = np.abs(got.float().numpy() - want).max()
        assert err <= tol * np.abs(want).max(), (kind, li, err)


def test_stacked_plain_equals_per_layer_plain():
    """The stacked plain versions at li are the per-layer plain versions on
    layer li, bit for bit, for every body (int8 and bf16 activations)."""
    x = _x()[0]
    per_layer = {"q4_k": tqm.q4k_matvec_plain, "q5_k": tqm.q4k_matvec_plain,
                 "q6_k": tqm.q6k_matvec_plain, "q8_0": tqm.q8_0_matvec_plain,
                 "q2_k": tqm.q23k_matvec_plain,
                 "q3_k": tqm.q23k_matvec_plain,
                 "iq2p": lambda x, qt, i8: tqm.iq_matvec_plain(x, qt),
                 "iq1p": lambda x, qt, i8: tqm.iq_matvec_plain(x, qt)}
    for kind, t in KINDS.items():
        _, tst = _stacked(t, seed=40)
        stacked = (tqm.q4k_matvec_stacked if kind in ("q4_k", "q5_k")
                   else tqm.matvec_stacked)
        for li in (0, L - 1):
            index = torch.tensor([li], dtype=torch.int32)
            for i8 in (True, False):
                got = stacked(x, tst, index, i8)
                want = per_layer[kind](x, tqm.layer_of(tst, li), i8)
                assert torch.equal(got, want), (kind, li, i8)


def test_stacked_q4k_bf16_body(monkeypatch):
    """KCPP_Q4K_I8=0: q4_k takes the bf16 body in both packages (the port's
    K1 bf16 plain version on the layer, within 1e-2 of max |y| of JAX's
    `_q4k_decode_kernel_raw`), and q5_k declines in both."""
    monkeypatch.setenv("KCPP_Q4K_I8", "0")
    jst, tst = _stacked(GGMLType.Q4_K, seed=5)
    x = _x()
    index = torch.tensor([1], dtype=torch.int32)
    got = tqm.matmul_packed_stacked(x, tst, index)
    assert torch.equal(got, tqm.q4k_matvec_plain(
        x[0], tqm.layer_of(tst, 1), False))
    want = _jax_y(x, jst, 1)
    assert np.abs(got.float().numpy() - want).max() \
        <= 1e-2 * np.abs(want).max()
    jst5, tst5 = _stacked(GGMLType.Q5_K, seed=6)
    assert _jax_y(x, jst5, 0) is None
    assert tqm.matmul_packed_stacked(x, tst5, index) is None


def test_stacked_declines_as_jax():
    """T=2, in_f < 512 for q4_k, in_f < 32 G for an IQ kind: None in both
    packages."""
    index = torch.tensor([0], dtype=torch.int32)
    jst, tst = _stacked(GGMLType.Q4_K, seed=7)
    x2 = _x(T=2)
    assert _jax_y(x2, jst, 0) is None
    assert tqm.matmul_packed_stacked(x2, tst, index) is None
    for t, shape in ((GGMLType.Q4_K, (256, 256)),
                     (GGMLType.IQ2_XXS, (256, 512))):  # iq2p G = 32
        jst, tst = _stacked(t, seed=8, shape=shape)
        x = _x(shape[1])
        assert _jax_y(x, jst, 0) is None
        assert tqm.matmul_packed_stacked(x, tst, index) is None


def test_expanded_kind_fault_of_the_reference(monkeypatch):
    """A fault of the JAX package, pinned: under KCPP_KQ_LAYOUT=expanded a
    q6_k weight packs as q6_k_i8f, which `_MATVEC_FIELDS` lists, so the JAX
    `matmul_packed_stacked` reaches `_packed_matvec_stacked`, which has no
    branch for it and raises ValueError. The port declines it, as the JAX
    docstring promises, and its LayerRef matmul takes the layer: K12
    expanded's plain version on it."""
    monkeypatch.setenv("KCPP_KQ_LAYOUT", "expanded")
    jst, tst = _stacked(GGMLType.Q6_K, seed=9)
    assert jst.kind == tst.kind == "q6_k_i8f"
    x = _x()
    with pytest.raises(ValueError, match="q6_k_i8f"):
        _jax_y(x, jst, 1)
    index = torch.tensor([1], dtype=torch.int32)
    assert tqm.matmul_packed_stacked(x, tst, index) is None
    got = tlinear.matmul(x, tlinear.LayerRef(tst, 1, index))
    want = tqm.kq_expanded_matvec_plain(x[0], tqm.layer_of(tst, 1))
    assert torch.equal(got, want)


def test_plain_versions_count_no_launch():
    _, tst = _stacked(GGMLType.Q4_K, seed=3)
    _build.launches.clear()
    tqm.matmul_packed_stacked(_x(), tst, torch.tensor([2], dtype=torch.int32))
    assert sum(_build.launches.values()) == 0


# ---------------------------------------------------------------------------
# K17c, K16, and K5 over an f32 cache
# ---------------------------------------------------------------------------

def _np(rng, shape, s=1.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


def _bf16(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _elementwise_tol(q, kn, vn, k, v, pos, H, Hkv, scale, softcap):
    """2^-7 * 1.05 * W per output element, W = the softmax-weighted sum of
    |v| (the port's K5 tolerance: each p is rounded to bf16 against another
    running max on each side; 5% for sums and exp in another order)."""
    w = tfd.decode_attention_batched_plain(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(np.abs(vn)),
        torch.from_numpy(k.copy()), torch.from_numpy(np.abs(v)),
        torch.from_numpy(pos), H, Hkv, scale, softcap)
    return 2 ** -7 * 1.05 * w.numpy()


@pytest.mark.parametrize("Hkv,D", [(2, 64), (2, 128)])
@pytest.mark.parametrize("li", [0, 2])
@pytest.mark.parametrize("softcap", [0.0, 5.0])
def test_decode_attention_rows_plain_matches_jax(Hkv, D, li, softcap):
    """K17c: B=2, L=3, S=64 pooled, Hkv*D 128 / 256, against the JAX
    `decode_attention_rows` (interpret mode): the output within the K5
    tolerance element by element, the written rows bit for bit, every row
    outside [li B, li B + B) unchanged."""
    rng = np.random.default_rng(li * 7 + D + int(softcap))
    B, S, H = 2, 64, 8
    KD = Hkv * D
    q, kn, vn = _np(rng, (B, H, D)), _np(rng, (B, Hkv, D)), _np(rng, (B, Hkv, D))
    kp = _bf16(_np(rng, (L * B, S, KD), 0.5))
    vp = _bf16(_np(rng, (L * B, S, KD), 0.5))
    pos = np.array([37, 5], np.int32)
    scale = D ** -0.5
    out, ku, vu = jfd.decode_attention_rows(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
        jnp.asarray(pos), jnp.int32(li * B), H, Hkv, scale, softcap,
        interpret=True)
    tk = torch.from_numpy(kp).bfloat16()
    tv = torch.from_numpy(vp).bfloat16()
    got, tk2, tv2 = tfd.decode_attention_rows(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(pos), torch.tensor([li], dtype=torch.int32), H,
        Hkv, scale, softcap)
    assert tk2 is tk and tv2 is tv
    assert np.array_equal(tk.float().numpy(), np.asarray(ku, np.float32))
    assert np.array_equal(tv.float().numpy(), np.asarray(vu, np.float32))
    win = slice(li * B, li * B + B)
    rest = np.ones(L * B, bool)
    rest[win] = False
    assert np.array_equal(tk.float().numpy()[rest], kp[rest])
    tol = _elementwise_tol(q, kn, vn, kp[win], vp[win], pos, H, Hkv, scale,
                           softcap)
    assert (np.abs(got.numpy() - np.asarray(out)) <= tol).all()


def test_decode_attention_rows_dead_row():
    """A dead row (pos -1) writes nothing in either package and leaves every
    other layer's rows as they were; the live row's output meets JAX's."""
    rng = np.random.default_rng(4)
    B, S, H, Hkv, D, li = 2, 64, 8, 2, 64, 1
    KD = Hkv * D
    q, kn, vn = _np(rng, (B, H, D)), _np(rng, (B, Hkv, D)), _np(rng, (B, Hkv, D))
    kp = _bf16(_np(rng, (L * B, S, KD), 0.5))
    vp = _bf16(_np(rng, (L * B, S, KD), 0.5))
    pos = np.array([20, -1], np.int32)
    scale = D ** -0.5
    out, ku, _ = jfd.decode_attention_rows(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn),
        jnp.asarray(kp, jnp.bfloat16), jnp.asarray(vp, jnp.bfloat16),
        jnp.asarray(pos), jnp.int32(li * B), H, Hkv, scale, interpret=True)
    tk, tv = torch.from_numpy(kp).bfloat16(), torch.from_numpy(vp).bfloat16()
    got, _, _ = tfd.decode_attention_rows(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(pos), torch.tensor([li], dtype=torch.int32), H,
        Hkv, scale)
    assert np.array_equal(tk.float().numpy(), np.asarray(ku, np.float32))
    want_k = kp.copy()
    want_k[li * B, 20] = _bf16(kn[0].reshape(KD))
    assert np.array_equal(tk.float().numpy(), want_k)
    tol = _elementwise_tol(q, kn, vn, kp[li * B:li * B + B],
                           vp[li * B:li * B + B], pos, H, Hkv, scale, 0.0)
    assert (np.abs(got.numpy()[0] - np.asarray(out)[0]) <= tol[0]).all()


def test_k5_f32_cache_plain_matches_jax():
    """K5 over an f32 cache (B=2), against the JAX `decode_attention_
    batched`, which takes the cache's own dtype: the output within the K5
    tolerance, the written rows bit for bit (bf16 values widened, as the
    JAX kernel writes its bf16 k_new / v_new operands)."""
    rng = np.random.default_rng(0)
    B, S, H, Hkv, D = 2, 64, 8, 2, 64
    KD = Hkv * D
    q, kn, vn = _np(rng, (B, H, D)), _np(rng, (B, Hkv, D)), _np(rng, (B, Hkv, D))
    kc, vc = _np(rng, (B, S, KD), 0.5), _np(rng, (B, S, KD), 0.5)
    pos = np.array([37, 5], np.int32)
    scale = D ** -0.5
    out, ku, vu = jfd.decode_attention_batched(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(pos), H, Hkv, scale, interpret=True)
    assert ku.dtype == jnp.float32
    tk, tv = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    got, _, _ = tfd.decode_attention_batched(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.from_numpy(pos), H, Hkv, scale)
    assert np.array_equal(tk.numpy(), np.asarray(ku))
    assert np.array_equal(tv.numpy(), np.asarray(vu))
    tol = _elementwise_tol(q, kn, vn, kc, vc, pos, H, Hkv, scale, 0.0)
    assert (np.abs(got.numpy() - np.asarray(out)) <= tol).all()


@pytest.mark.parametrize("H,Hkv,D,S,pos,softcap,tol", [
    (8, 2, 64, 128, 37, 0.0, 2e-2),    # GQA
    (4, 4, 32, 64, 0, 0.0, 2e-2),      # MHA, first position
    (32, 4, 64, 256, 255, 0.0, 2e-2),  # tinyllama shape, full cache
    (8, 2, 64, 64, 20, 5.0, 3e-2),     # softcap
])
def test_decode_attention_plain_matches_jax(H, Hkv, D, S, pos, softcap, tol):
    """K16 against the JAX `decode_attention` (interpret mode) on the cases
    of tests/test_flash_decode.py, at that file's tolerances."""
    rng = np.random.default_rng(1 if not softcap else 2)
    q = _np(rng, (H, D), 3.0 if softcap else 1.0)
    k = _bf16(_np(rng, (S, Hkv, D), 1.0 if softcap else 0.3))
    v = _bf16(_np(rng, (S, Hkv, D), 1.0 if softcap else 0.3))
    scale = D ** -0.5
    want = jfd.decode_attention(
        jnp.asarray(q), jnp.asarray(k, jnp.bfloat16),
        jnp.asarray(v, jnp.bfloat16), jnp.int32(pos), H, scale,
        softcap=softcap, interpret=True)
    got = tfd.decode_attention(
        torch.from_numpy(q), torch.from_numpy(k).bfloat16(),
        torch.from_numpy(v).bfloat16(), torch.tensor([pos], dtype=torch.int32),
        H, scale, softcap)
    assert got.shape == (H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)
    # and the XLA attention over the rows <= pos, as that file holds JAX's
    mask = (jnp.arange(S) <= pos)[None, None, :]
    ref = jllama.attention(jnp.asarray(q)[None, None].astype(jnp.bfloat16),
                           jnp.asarray(k, jnp.bfloat16)[None],
                           jnp.asarray(v, jnp.bfloat16)[None], mask, scale,
                           softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref[0, 0]), rtol=tol,
                               atol=tol)
    # the predicate K16 applies under, as JAX's `supported`
    for B, T in ((1, 1), (2, 1), (1, 2)):
        assert tfd.supported(B, T, Hkv, D) == jfd.supported(B, T, Hkv, D)
