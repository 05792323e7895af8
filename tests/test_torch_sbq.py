"""K14, the superblock batched matvec (KCPP_SBQ=1): the port's raw Q4_K /
Q5_K scale factors (`sc`, `d`) against the JAX package's packed `scp_lo` /
`scp_hi` / `d_sbt`, the plain version against the JAX `matmul_packed`
(`_packed_matvec_q4k_sbq` in interpret mode), and the dispatch rule."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.models import synthetic as jsynth
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.models import synthetic as tsynth
from koboldcpp_tpu_torch.models.convert import params_from_jax
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


def _jax_sc_d(jq):
    """The JAX fields decoded to logical order: sc = 8 (sp >> 4) + (sp &
    15) of the plane-ordered scp_lo / scp_hi, d = d_sbt transposed."""
    rows = jq.shape[0]
    sp = np.stack([np.asarray(jq.data["scp_lo"]).reshape(rows, -1, 4),
                   np.asarray(jq.data["scp_hi"]).reshape(rows, -1, 4)],
                  axis=2).astype(np.int32).reshape(rows, -1)
    return 8 * (sp >> 4) + (sp & 15), np.asarray(jq.data["d_sbt"]).T


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q5_K],
                         ids=lambda t: t.name)
def test_sc_d_bit_equal_to_jax(t):
    """GGUF Q4_K / Q5_K blocks: the port's sc (u8) and d (f32) equal the
    JAX sidecars bit for bit, from the packer and through params_from_jax;
    bf16(d * sc) is the port's scale."""
    jq, tq = _pair(t, 64, 512, seed=int(t))
    sc, d = _jax_sc_d(jq)
    assert tq.data["sc"].dtype == torch.uint8
    assert tq.data["d"].dtype == torch.float32
    np.testing.assert_array_equal(tq.data["sc"].numpy(), sc)
    np.testing.assert_array_equal(tq.data["d"].numpy().view(np.uint32),
                                  d.astype(np.float32).view(np.uint32))
    conv = params_from_jax(type(jq)(kind=jq.kind, shape=jq.shape, data={
        k: np.asarray(v) for k, v in jq.data.items()}))
    for name in ("sc", "d", "scale", "min", "qs2"):
        assert torch.equal(conv.data[name], tq.data[name]), name
    scale = torch.from_numpy((np.repeat(d, 8, axis=1) * sc).astype(
        np.float32)).bfloat16()
    assert torch.equal(scale, tq.data["scale"])


def test_rand_q4k_sc_d_equal_jax_maker():
    """The port's rand_q4k keeps the JAX `_rand_q4k` draws: the same sc and
    d (so the synthetic 1.1B keeps its weights), and the same codes."""
    jq = jsynth._rand_q4k(np.random.default_rng(5), 256, 512)
    tq = tsynth.rand_q4k(np.random.default_rng(5), 256, 512)
    sc, d = _jax_sc_d(jq)
    np.testing.assert_array_equal(tq.data["sc"].numpy(), sc)
    np.testing.assert_array_equal(tq.data["d"].numpy(), d)
    np.testing.assert_array_equal(tq.data["qs2"].numpy(),
                                  np.asarray(jq.data["qs2"]))


@pytest.mark.parametrize("t", [GGMLType.Q4_K, GGMLType.Q5_K],
                         ids=lambda t: t.name)
@pytest.mark.parametrize("T", [2, 9, 16])
def test_sbq_plain_matches_jax(t, T, monkeypatch):
    """matmul_packed under KCPP_SBQ=1 at out_f 256, in_f 2048 on both
    sides: the same int8 codes per 128-column segment and exact integer
    segment dots, f32 combines in another order, bf16 outputs: within one
    bf16 step (2^-8 relative) of max |y|; tolerance 1e-2 * max |y|
    (measured: at most 2^-8 * max |y|, see the assert)."""
    monkeypatch.setenv("KCPP_SBQ", "1")
    jq, tq = _pair(t, 256, 2048, seed=T)
    x = np.random.default_rng(T + 1).standard_normal((T, 2048)) * 0.5
    xb = torch.from_numpy(x.astype(np.float32)).bfloat16()
    want = np.asarray(jqm.matmul_packed(
        jnp.asarray(xb.float().numpy(), jnp.bfloat16), jq).astype(jnp.float32))
    _build.launches.clear()
    got = tqm.matmul_packed(xb, tq).float().numpy()
    assert sum(_build.launches.values()) == 0  # the plain version
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= 1e-2 * scale
    assert err <= 2 ** -8 * scale * 1.01


def test_sbq_rows_depend_on_their_token_alone():
    """Row t of K14's plain version is the same whatever the other tokens
    are, so a request served in a batch gets the tokens it gets alone."""
    _, tq = _pair(GGMLType.Q4_K, 256, 2048, seed=3)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (16, 2048)).astype(np.float32)).bfloat16()
    y = tqm.q4k_matvec_sbq_plain(x, tq)
    y2 = tqm.q4k_matvec_sbq_plain(torch.cat([x[5:7], x[:3]]), tq)
    assert torch.equal(y[5:7], y2[:2])
    assert torch.equal(y[:3], y2[2:])


class _Took(Exception):
    pass


@pytest.mark.parametrize("env, kind, T, in_f, sbq", [
    ("1", GGMLType.Q4_K, 2, 2048, True),
    ("1", GGMLType.Q4_K, 16, 2048, True),
    ("1", GGMLType.Q5_K, 8, 4096, True),
    (None, GGMLType.Q4_K, 8, 2048, False),
    ("0", GGMLType.Q4_K, 16, 2048, False),
    ("1", GGMLType.Q4_K, 8, 1024, False),
    ("1", GGMLType.Q4_K, 17, 2048, False),
    ("1", GGMLType.Q4_K, 1, 2048, False),
    ("1", GGMLType.Q4_0, 8, 2048, False),  # legacy blocks: no sc / d
    ("1", GGMLType.Q6_K, 8, 2048, False),
])
def test_sbq_dispatch_equals_jax(env, kind, T, in_f, sbq, monkeypatch):
    """Both dispatches are stopped at their first kernel call: each takes
    its K14 exactly where the other does (and only with KCPP_SBQ=1, q4_k /
    q5_k from a K-quant file, 2 <= T <= 16, in_f >= 2048)."""
    if env is None:
        monkeypatch.delenv("KCPP_SBQ", raising=False)
    else:
        monkeypatch.setenv("KCPP_SBQ", env)
    jq, tq = _pair(kind, 256, in_f)

    def took(name):
        def fn(*a, **k):
            raise _Took(name)
        return fn

    for name in ("_packed_matvec_q4k_sbq", "_packed_matvec_q4k",
                 "_packed_matvec", "_packed_matmul_2d"):
        monkeypatch.setattr(jqm, name, took(name))
    for name in ("q4k_matvec_sbq", "q4k_matvec", "q4k_matvec_t",
                 "q6k_matvec", "q8_0_matvec", "kq_matmul"):
        monkeypatch.setattr(tqm, name, took(name))
    x = np.zeros((T, in_f), np.float32)
    with pytest.raises(_Took) as j:
        jqm.matmul_packed(jnp.asarray(x, jnp.bfloat16), jq)
    with pytest.raises(_Took) as p:
        tqm.matmul_packed(torch.from_numpy(x).bfloat16(), tq)
    assert (str(j.value) == "_packed_matvec_q4k_sbq") == sbq
    assert (str(p.value) == "q4k_matvec_sbq") == sbq
