"""The opt-in weight layouts and activation variants of the port against the
JAX package, on the CPU (plain kernel versions; the JAX side's Pallas
kernels in interpret mode): KCPP_KQ_LAYOUT=expanded (q6_k_i8f, q3_k_n4,
q2_k_n4: K12 expanded at T=1, the dense kinds' K3 / K13 above),
KCPP_Q4K_LAYOUT=i8 (q4_k_i8: K13 at every T), KCPP_MM_I8=0 (the bf16 T=1
bodies of q8_0, q6_k, q2_k, q3_k) and KCPP_Q4K_I8=0 (the bf16 K1 / K7
bodies of q4_k). Load-time variables are set before `from_gguf`; the
dispatch ones before each call, which is where both packages read them."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.ops import ffn_fused as jffn
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.models.synthetic import _MAKERS
from koboldcpp_tpu_torch.ops import _build, ffn_fused
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures")
OPTIN = json.load(open(os.path.join(FIX, "portgguf", "optin.json")))
# GGUF type -> (variable, value, opt-in kind, default kind)
LAYOUTS = {GGMLType.Q6_K: ("KCPP_KQ_LAYOUT", "expanded", "q6_k_i8f", "q6_k"),
           GGMLType.Q3_K: ("KCPP_KQ_LAYOUT", "expanded", "q3_k_n4", "q3_k"),
           GGMLType.Q2_K: ("KCPP_KQ_LAYOUT", "expanded", "q2_k_n4", "q2_k"),
           GGMLType.Q4_K: ("KCPP_Q4K_LAYOUT", "i8", "q4_k_i8", "q4_k")}
EXPANDED = (GGMLType.Q6_K, GGMLType.Q3_K, GGMLType.Q2_K)
_jax_dequant = jax.jit(jlinear.dequant_xla, static_argnames="dtype")


def _raw(t, out_f, in_f, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    return quants.quantize(w, t)


def _pair(t, out_f=256, in_f=512, seed=0, monkeypatch=None):
    """The JAX and the port's QTensor of one GGUF tensor under t's opt-in
    layout variable."""
    var, val, _, _ = LAYOUTS[t]
    raw = _raw(t, out_f, in_f, seed)
    monkeypatch.setenv(var, val)
    pair = (jlinear.from_gguf(raw, t, (out_f, in_f), packed=True),
            tlinear.from_gguf(raw, t, (out_f, in_f), packed=True))
    monkeypatch.delenv(var)
    return pair


def _x(T, in_f, seed=1):
    x = np.random.default_rng(seed).standard_normal((T, in_f)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _jax_mm(jq, x):
    y = jqm.matmul_packed(jnp.asarray(x.float().numpy(), jnp.bfloat16), jq)
    return None if y is None else np.asarray(y.astype(jnp.float32))


def _assert_same_dequant(jq, tq):
    assert tq.kind == jq.kind and tuple(tq.shape) == tuple(jq.shape)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(_jax_dequant(jq, dtype=jdt).astype(jnp.float32))
        got = tlinear.dequant(tq, dtype=tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("t", list(LAYOUTS), ids=lambda t: t.name)
def test_packers_select_the_kind_and_dequantize_as_jax(t, monkeypatch):
    """Under its variable, a GGUF tensor packs into the opt-in kind in both
    packages and dequantizes to JAX `dequant_xla`'s bits; the expanded
    kinds also carry the dense kind's fields (the same bytes as the dense
    pack); with the variable unset, the dense kind."""
    _, _, kind, dense_kind = LAYOUTS[t]
    jq, tq = _pair(t, monkeypatch=monkeypatch)
    assert tq.kind == kind
    _assert_same_dequant(jq, tq)
    raw = _raw(t, 256, 512)
    dense = tlinear.from_gguf(raw, t, (256, 512))
    assert dense.kind == dense_kind
    assert jlinear.from_gguf(raw, t, (256, 512)).kind == dense_kind
    if t in EXPANDED:
        for name, v in dense.data.items():
            assert torch.equal(tq.data[name], v), name
        assert torch.equal(tlinear.dequant(tq), tlinear.dequant(dense))


@pytest.mark.parametrize("t", EXPANDED, ids=lambda t: t.name)
def test_expanded_t1_body_matches_jax(t, monkeypatch):
    """T=1 through K12 expanded (`_q6k_i8f_row_kernel`,
    `_q3k_n4_row_kernel`, `_q2k_n4_row_kernel`): the same int8 codes of x
    per 16 columns and exact int32 group dots on both sides; f32 sums in
    another order and a bf16 output, so within 2^-7 of max |y|."""
    jq, tq = _pair(t, monkeypatch=monkeypatch)
    x = _x(1, 512)
    _build.launches.clear()
    got = tqm.matmul_packed(x, tq)
    assert torch.equal(got, tqm.kq_expanded_matvec_plain(x[0], tq))
    assert sum(_build.launches.values()) == 0  # plain versions
    want = _jax_mm(jq, x)
    assert np.abs(got.float().numpy() - want).max() \
        <= 2 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("t", EXPANDED, ids=lambda t: t.name)
def test_expanded_layout_gap_is_jax_own(t, monkeypatch):
    """At T=1 and in_f 2048 the expanded kind and its dense kind compute
    different functions in JAX, and the port's two differ by the same
    amount: q6_k's int8 body dots the codes 0..63 and folds -32 s
    bf16(sum x), q6_k_i8f dots q6 - 32 (1.1% rms of y apart; the expanded
    one is the closer to x . W); q3_k / q2_k and their n4 kinds share
    their arithmetic. chip_smoke.py's check of the 1.1B q6_k_i8f logits
    against the default layout's allows for that gap."""
    raw = _raw(t, 512, 2048, seed=4)
    jd = jlinear.from_gguf(raw, t, (512, 2048))
    td = tlinear.from_gguf(raw, t, (512, 2048))
    je, te = _pair(t, 512, 2048, seed=4, monkeypatch=monkeypatch)
    x = _x(1, 2048)

    def gap(a, b):
        return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(a ** 2)))

    jax_gap = gap(_jax_mm(jd, x), _jax_mm(je, x))
    port_gap = gap(tqm.matmul_packed(x, td).float().numpy(),
                   tqm.matmul_packed(x, te).float().numpy())
    assert abs(port_gap - jax_gap) <= 1e-3
    if t == GGMLType.Q6_K:
        assert jax_gap > 5e-3
    else:
        assert jax_gap <= 1e-3


@pytest.mark.parametrize("kind,t", [("q8_0", GGMLType.Q8_0),
                                    ("q6_k", GGMLType.Q6_K),
                                    ("q2_k", GGMLType.Q2_K),
                                    ("q3_k", GGMLType.Q3_K)])
def test_mm_i8_off_takes_the_bf16_t1_bodies(kind, t, monkeypatch):
    """KCPP_MM_I8=0, read at the call: T=1 q8_0 takes the bf16 body
    (K2.q8_0_bf16, `_q8_0_row_kernel`), q6_k / q2_k / q3_k the bf16 bodies
    of K2 / K12 at in_f 512 (int8 by default), as in JAX. q8_0's products
    are exact on both sides and only the f32 summation order differs;
    the k-quant bf16 bodies differ from JAX's magic-number kernels by the
    rounding of the group sums they subtract, as in
    tests/test_torch_quant_matmul.py, so all are held within 2^-7 of max
    |y|."""
    raw = _raw(t, 256, 512)
    jq = jlinear.from_gguf(raw, t, (256, 512))
    tq = tlinear.from_gguf(raw, t, (256, 512))
    x = _x(1, 512)
    plain = {"q8_0": tqm.q8_0_matvec_plain, "q6_k": tqm.q6k_matvec_plain,
             "q2_k": tqm.q23k_matvec_plain, "q3_k": tqm.q23k_matvec_plain}
    i8_default = tqm.matmul_packed(x, tq)
    assert torch.equal(i8_default, plain[kind](x[0], tq, True))
    monkeypatch.setenv("KCPP_MM_I8", "0")
    got = tqm.matmul_packed(x, tq)
    assert torch.equal(got, plain[kind](x[0], tq, False))
    assert not torch.equal(got, i8_default)
    want = _jax_mm(jq, x)
    assert np.abs(got.float().numpy() - want).max() \
        <= 2 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("T", [1, 8, 300])
def test_q4k_i8_takes_k13_at_every_t(T, monkeypatch):
    """q4_k_i8 has no matvec in JAX: every T, decode included, goes to the
    2-D kernel (`_q4k_i8_kernel`: x . bf16(q*s) in f32 minus bf16 group
    sums . min); the port's K13.q4_k_i8 plain version within 2^-7 of max
    |y|, under KCPP_SBQ=1 as well (K14 declines the kind)."""
    jq, tq = _pair(GGMLType.Q4_K, monkeypatch=monkeypatch)
    x = _x(T, 512)
    monkeypatch.setenv("KCPP_SBQ", "1")
    got = tqm.matmul_packed(x, tq)
    assert torch.equal(got, tqm.kq_matmul_plain(x, tq))
    want = _jax_mm(jq, x)
    assert np.abs(got.float().numpy() - want).max() \
        <= 2 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("T,body", [(1, "K1 bf16"), (4, "K7 bf16"),
                                    (6, "K3")])
def test_q4k_i8_off_takes_the_bf16_q4k_bodies(T, body, monkeypatch):
    """KCPP_Q4K_I8=0, read at the call: q4_k takes the bf16 K1 / K7 bodies
    (`_q4k_decode_kernel(_raw)`) up to MATVEC_MAX_T = 4 tokens and K3
    above, as in JAX; within 1e-2 of max |y| (test_torch_quant_matmul.py's
    tolerance of the bf16 variant at in_f 512)."""
    raw = _raw(GGMLType.Q4_K, 256, 512)
    jq = jlinear.from_gguf(raw, GGMLType.Q4_K, (256, 512))
    tq = tlinear.from_gguf(raw, GGMLType.Q4_K, (256, 512))
    x = _x(T, 512)
    monkeypatch.setenv("KCPP_Q4K_I8", "0")
    got = tqm.matmul_packed(x, tq)
    ref = (tqm.kq_matmul_plain(x, tq) if body == "K3"
           else tqm.q4k_matvec_t_plain(x, tq, False))
    assert torch.equal(got, ref)
    want = _jax_mm(jq, x)
    assert np.abs(got.float().numpy() - want).max() \
        <= 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("t", EXPANDED, ids=lambda t: t.name)
def test_expanded_t_gt_1_runs_the_dense_kind(t, monkeypatch):
    """At T=8 an expanded kind runs as its dense kind (K3 / K13 over the
    dense fields) in both packages; a stripped tensor, the expanded fields
    alone, is declined (None: the dequant path) in both."""
    jq, tq = _pair(t, monkeypatch=monkeypatch)
    dense_kind = LAYOUTS[t][3]
    x = _x(8, 512)
    got = tqm.matmul_packed(x, tq)
    dense = tlinear.QTensor(dense_kind, tq.shape, {
        n: v for n, v in tq.data.items() if n not in ("q", "n4")})
    assert torch.equal(got, tqm.kq_matmul_plain(x, dense))
    want = _jax_mm(jq, x)
    assert np.abs(got.float().numpy() - want).max() \
        <= 2 ** -7 * np.abs(want).max()
    keep = {"q6_k": ("q", "scale"), "q3_k": ("n4", "scale"),
            "q2_k": ("n4", "scale", "min")}[dense_kind]
    jkeep = jqm._FIELD_LISTS[jq.kind] + jqm._MATVEC_FIELDS[jq.kind]
    stripped = tlinear.QTensor(tq.kind, tq.shape,
                               {n: tq.data[n] for n in keep})
    jstripped = jlinear.QTensor(jq.kind, jq.shape,
                                {n: jq.data[n] for n in jkeep})
    assert tqm.matmul_packed(x, stripped) is None
    assert _jax_mm(jstripped, x) is None
    # the stripped tensor still serves T=1, and the dequant path serves T=8
    assert tqm.matmul_packed(x[:1], stripped) is not None
    assert torch.equal(tlinear.dequant(stripped), tlinear.dequant(tq))


def test_expanded_scratch_declines(monkeypatch):
    """q6_k_i8f at in_f 10240: (in_f/16) * in_f > 6 Mi, so T=1 is declined
    (None) in both packages; q2_k_n4 at in_f 256 is served."""
    jq, tq = _pair(GGMLType.Q6_K, 256, 10240, monkeypatch=monkeypatch)
    _, small = _pair(GGMLType.Q2_K, 256, 256, monkeypatch=monkeypatch)
    assert tq.kind == jq.kind == "q6_k_i8f"
    x = _x(1, 10240)
    assert tqm.matmul_packed(x, tq) is None
    assert _jax_mm(jq, x) is None
    assert small.kind == "q2_k_n4"
    assert torch.equal(tqm.matmul_packed(_x(1, 256), small),
                       tqm.kq_expanded_matvec_plain(_x(1, 256)[0], small))


@pytest.mark.parametrize("t", list(LAYOUTS), ids=lambda t: t.name)
def test_params_from_jax_carries_the_opt_in_kinds(t, monkeypatch):
    """A JAX pack of each opt-in kind (with the dense fields) and the JAX
    synthetic maker's tensor (without them) carried across by
    params_from_jax: the pack equals the port's pack field for field, and
    both dequantize to JAX's bits."""
    from koboldcpp_tpu.models import synthetic as jsyn

    jq, tq = _pair(t, monkeypatch=monkeypatch)
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    assert got.kind == tq.kind and set(got.data) == set(tq.data)
    for name, v in tq.data.items():
        assert torch.equal(got.data[name], v), name
    _assert_same_dequant(jq, got)
    js = jsyn._MAKERS[tq.kind](np.random.default_rng(3), 256, 512)
    _assert_same_dequant(js, params_from_jax(
        jax.tree_util.tree_map(np.asarray, js)))


@pytest.mark.parametrize("kind", ["q4_k_i8", "q6_k_i8f", "q3_k_n4",
                                  "q2_k_n4"])
def test_synthetic_makers_relayout_the_dense_draws(kind):
    """The port's makers of the opt-in kinds are relayouts of the dense
    makers' draws on the same seed: the same weights, and the expanded
    kinds keep the dense fields."""
    dense_kind = {"q4_k_i8": "q4_k"}.get(kind, kind[:4])
    qt = _MAKERS[kind](np.random.default_rng(5), 256, 512)
    dense = _MAKERS[dense_kind](np.random.default_rng(5), 256, 512)
    assert qt.kind == kind
    assert torch.equal(tlinear.dequant(qt, torch.float32),
                       tlinear.dequant(dense, torch.float32))
    if kind != "q4_k_i8":
        assert all(torch.equal(qt.data[n], v) for n, v in dense.data.items())


def test_ffn_fused_declines_q4k_i8(monkeypatch):
    """KCPP_FFN_FUSED=1 with q4_k_i8 gate/up and down weights: neither
    package fuses the FFN (None: the composed matmuls serve it)."""
    jgu, tgu = _pair(GGMLType.Q4_K, 1024, 256, monkeypatch=monkeypatch)
    jdn, tdn = _pair(GGMLType.Q4_K, 256, 512, seed=1,
                     monkeypatch=monkeypatch)
    assert tgu.kind == tdn.kind == "q4_k_i8"
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    for T in (1, 4):
        x = _x(T, 256)
        assert ffn_fused.ffn_fused(x, tgu, tdn) is None
        assert jffn.ffn_fused(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jgu, jdn) is None


@pytest.mark.parametrize("run", list(OPTIN["runs"]))
def test_fixture_logits_match_jax(run, monkeypatch):
    """Each fixture loaded packed in f32 under its variable, the manifest's
    tokens as a prefill of 11 and one decode step (the opt-in T=1 body):
    the port's logits against the JAX forward's under the same variable,
    as tests/make_torch_optin_logits.py committed them. The prefill rows
    are held within 1e-2 (tests/test_torch_forward.py's tolerance). The
    decode row is held within 2e-2: at T=1 every fixture's 256-wide
    output projection (Q6_K, or Q8_0) runs a bf16-activation row body, and
    JAX's magic-number `_q6k_row_kernel` subtracts a bf16-rounded group
    sum there, which test_torch_quant_matmul.py holds at 2e-2 of max |y|
    (the default layout's decode row of tiny-q4_k_m lies 1.5x past 1e-2
    on the CPU as well)."""
    spec = OPTIN["runs"][run]
    for k, v in spec["env"].items():
        monkeypatch.setenv(k, v)
    m = load_model(os.path.join(FIX, spec["fixture"]), dtype=torch.float32,
                   device="cpu")
    kinds = {qt.kind for layer in m.params["layers"] for qt in layer.values()
             if isinstance(qt, tlinear.QTensor)}
    want_kind = {"expanded": ("q6_k_i8f", "q3_k_n4", "q2_k_n4"),
                 "i8": ("q4_k_i8",), "0": ("q8_0",)}[
        next(iter(spec["env"].values()))]
    assert kinds & set(want_kind), kinds
    toks = torch.tensor([OPTIN["tokens"]])
    n = toks.shape[1] - 1
    cache = t_init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=torch.float32)
    _build.launches.clear()
    with torch.inference_mode():
        pre, cache = tllama.forward(m.params, m.cfg, toks[:, :n],
                                    torch.arange(n)[None], cache)
        last, _ = tllama.forward(m.params, m.cfg, toks[:, n:],
                                 torch.tensor([[n]]), cache)
    got = torch.cat([pre[0], last[0]]).float().numpy()
    want = np.load(os.path.join(FIX, "portgguf", spec["logits"]))
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got[n:], want[n:], rtol=2e-2, atol=2e-2)
