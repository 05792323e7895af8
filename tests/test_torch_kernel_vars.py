"""The launcher's kernel-selection variables in the port (ops/quant_matmul.py
`matmul_packed` / `matmul_packed_stacked`, ops/ffn_fused.py, the
flash-decode note) held against the JAX dispatch under the same
environment: KCPP_Q4K_DECODE, KCPP_MATVEC_MAX_T, KCPP_Q4K_RAW_X,
KCPP_Q4K_2D, KCPP_PALLAS_MM and KCPP_FLASH_DECODE.

Each case calls both `matmul_packed` functions directly (the JAX one
outside jax.jit, so that it reads the environment; its MATVEC_MAX_T, read
at import, set on the module by monkeypatch, as the port's) on the same
GGUF bytes and bf16 activations. The route is the function each reaches:
recorders around the port's kernel wrappers (`q4k_matvec`, `q4k_matvec_t`,
the T = 1 matvecs, `kq_matmul`) and the JAX ones (`_packed_matvec_q4k`,
`_packed_matvec`, `_packed_matmul_2d`, or None: its dequant path), which
pass every call on. Values within test_torch_quant_matmul.py's
tolerances: 1e-2 of max |y| for int8 matvecs and K3, 2e-2 for the bf16
matvec below in_f 512.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.ops import ffn_fused as tff
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)

ENV = ("KCPP_Q4K_DECODE", "KCPP_Q4K_RAW_X", "KCPP_Q4K_2D", "KCPP_PALLAS_MM",
       "KCPP_Q4K_I8", "KCPP_MM_I8", "KCPP_SBQ", "KCPP_FFN_FUSED",
       "KCPP_FLASH_DECODE")
# the JAX route each port wrapper stands for
PORT_ROUTE = {"q4k_matvec": "matvec_q4k", "q4k_matvec_t": "matvec_q4k",
              "q6k_matvec": "matvec", "q8_0_matvec": "matvec",
              "q23k_matvec": "matvec", "iq_matvec": "matvec",
              "kq_expanded_matvec": "matvec", "q4k_matvec_sbq": "sbq",
              "kq_matmul": "2d"}
JAX_ROUTE = {"_packed_matvec_q4k": "matvec_q4k", "_packed_matvec": "matvec",
             "_packed_matvec_q4k_sbq": "sbq", "_packed_matmul_2d": "2d"}


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)


@pytest.fixture
def routes(monkeypatch):
    """Recorders around both packages' kernel entry points: a list of
    (package, route, kwargs) per call."""
    seen = []

    def wrap(mod, name, pkg, route):
        fn = getattr(mod, name)

        def rec(*a, **kw):
            seen.append((pkg, route, kw))
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, rec)
    for name, route in PORT_ROUTE.items():
        wrap(tqm, name, "port", route)
    for name, route in JAX_ROUTE.items():
        wrap(jqm, name, "jax", route)
    return seen


def _pair(t, out_f, in_f, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, t)
    return (jlinear.from_gguf(raw, t, (out_f, in_f), packed=True),
            tlinear.from_gguf(raw, t, (out_f, in_f), packed=True))


def _x(T, in_f, seed=1):
    x = np.random.default_rng(seed).standard_normal((T, in_f)) * 0.5
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _both(jq, tq, x, seen):
    """(port y, JAX y, port route, JAX route) of one call; a JAX decline
    (None) is its dequant path, `linear.matmul`."""
    seen.clear()
    jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    want = jqm.matmul_packed(jx, jq)
    jroute = next((r for p, r, _ in seen if p == "jax"), None)
    if want is None:
        want = jlinear.matmul(jx, jq)
        jroute = "dequant"
    got = tqm.matmul_packed(x, tq)
    proute = next((r for p, r, _ in seen if p == "port"), None)
    return (got.float().numpy(), np.asarray(want.astype(jnp.float32)),
            proute, jroute)


def _close(got, want, tol=1e-2):
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), err


KINDS = [GGMLType.Q4_K, GGMLType.Q5_K, GGMLType.Q6_K, GGMLType.Q8_0,
         GGMLType.Q2_K, GGMLType.Q3_K]


@pytest.mark.parametrize("t", KINDS, ids=lambda t: t.name)
@pytest.mark.parametrize("T", [1, 4])
def test_q4k_decode_off_takes_the_2d_kernel(monkeypatch, routes, t, T):
    """KCPP_Q4K_DECODE=0: no matvec; T = 1 and the batched T = 4 go to K3 /
    K13 (their swap form), as the JAX dispatch sends them to
    `_packed_matmul_2d`, within K3's tolerance; with it "1" the same calls
    take the matvecs in both."""
    jq, tq = _pair(t, 256, 512)
    x = _x(T, 512)
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr
    monkeypatch.setenv("KCPP_Q4K_DECODE", "0")
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr == "2d"
    _close(got, want)


def test_q4k_decode_off_declines_the_stacked_kernels(monkeypatch):
    """The stacked matvecs (K17a / K17b) decline under KCPP_Q4K_DECODE=0
    and KCPP_PALLAS_MM=0, as JAX's `matmul_packed_stacked` returns None;
    `LayerRef.take()` then serves the layer through `matmul_packed`."""
    jq, tq = _pair(GGMLType.Q4_K, 256, 512)
    st = tlinear.QTensor(kind="q4_k", shape=tq.shape,
                         data={n: a[None] for n, a in tq.data.items()})
    jst = jlinear.QTensor(kind="q4_k", shape=jq.shape,
                          data={n: a[None] for n, a in jq.data.items()})
    x = _x(1, 512)
    li = torch.zeros(1, dtype=torch.int32)
    assert tqm.matmul_packed_stacked(x, st, li) is not None
    for var in ("KCPP_Q4K_DECODE", "KCPP_PALLAS_MM"):
        monkeypatch.setenv(var, "0")
        assert tqm.matmul_packed_stacked(x, st, li) is None
        assert jqm.matmul_packed_stacked(
            jnp.asarray(x.float().numpy(), jnp.bfloat16), jst, 0) is None
        monkeypatch.delenv(var)


@pytest.mark.parametrize("cap,T,in_f,route", [
    (0, 1, 512, "2d"), (1, 2, 512, "2d"), (8, 6, 512, "matvec_q4k"),
    (16, 12, 512, "matvec_q4k"), (16, 12, 4096, "2d"), (4, 6, 256, "2d")])
def test_matvec_max_t(monkeypatch, routes, cap, T, in_f, route):
    """KCPP_MATVEC_MAX_T (the module constant of both, read at import)
    caps the q4_k matvec where its activations are bf16 (KCPP_Q4K_I8=0):
    T up to the cap takes K7's bf16 body (past 8 tokens where the JAX
    `_q4k_matvec_rt` admits the shape: in_f 512 at T = 12, not 4096), the
    rest K3; a cap of 0 sends T = 1 there too. Values within the bf16
    matvec's tolerance (K3's where the route is 2d)."""
    monkeypatch.setattr(jqm, "MATVEC_MAX_T", cap)
    monkeypatch.setattr(tqm, "MATVEC_MAX_T", cap)
    monkeypatch.setenv("KCPP_Q4K_I8", "0")
    jq, tq = _pair(GGMLType.Q4_K, 256, in_f)
    x = _x(T, in_f, seed=T)
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr == route
    _close(got, want, 2e-2 if route != "2d" else 1e-2)


def test_matvec_max_t_gates_every_matvec(monkeypatch, routes):
    """The cap is the JAX `max_t` of every kind but int8 q4_k / q5_k: at 0
    a q6_k T = 1 call leaves K2 for K3 in both; the int8 q4_k matvec keeps
    its 8 tokens."""
    monkeypatch.setattr(jqm, "MATVEC_MAX_T", 0)
    monkeypatch.setattr(tqm, "MATVEC_MAX_T", 0)
    jq, tq = _pair(GGMLType.Q6_K, 256, 512)
    got, want, pr, jr = _both(jq, tq, _x(1, 512), routes)
    assert pr == jr == "2d"
    _close(got, want)
    jq, tq = _pair(GGMLType.Q4_K, 256, 512)
    got, want, pr, jr = _both(jq, tq, _x(8, 512), routes)
    assert pr == jr == "matvec_q4k"
    _close(got, want)


@pytest.mark.parametrize("in_f", [512, 1024, 2048])
def test_q4k_raw_x_bodies_are_one_function(monkeypatch, routes, in_f):
    """KCPP_Q4K_RAW_X: at T = 1 with bf16 activations (KCPP_Q4K_I8=0) the
    JAX dispatch picks `_q4k_decode_kernel_raw` ("1") or the prepped
    `_q4k_decode_kernel` ("0"). On the CPU the two give the same bits, so
    both are K1's bf16 body: the port's route and value do not move with
    the variable (within the matvec's tolerance of either)."""
    monkeypatch.setenv("KCPP_Q4K_I8", "0")
    jq, tq = _pair(GGMLType.Q4_K, 256, in_f)
    x = _x(1, in_f)
    out = {}
    for v in ("1", "0"):
        monkeypatch.setenv("KCPP_Q4K_RAW_X", v)
        got, want, pr, jr = _both(jq, tq, x, routes)
        assert pr == jr == "matvec_q4k"
        _close(got, want)
        out[v] = (got, want)
    np.testing.assert_array_equal(out["1"][1], out["0"][1])
    np.testing.assert_array_equal(out["1"][0], out["0"][0])


@pytest.mark.parametrize("T", [1, 16, 48])
@pytest.mark.parametrize("in_f", [512, 1024])
def test_q4k_2d_magic(monkeypatch, routes, T, in_f):
    """KCPP_Q4K_2D=magic: K3's q4_k calls take K3.q4_k_magic
    (`kq_matmul(..., magic=True)`) where JAX takes `_q4k_magic_kernel`
    (interpret mode): T = 16 and 48 (wgmma), T = 1 under KCPP_Q4K_DECODE=0
    (swap); its plain version within K3's tolerance of the JAX body (1e-2
    of max |y|; measured at most 1.7e-3 of it). At T = 1 the JAX body is
    read on x padded to 16 rows (row 0; its rows are independent): XLA's CPU
    interpreter computes a one-row product in f32 without rounding the
    weights to bf16, so its T = 1 numbers are not the kernel's (measured
    1.1e-2 of max |y| from its own padded row). The magic rounding differs
    from the default body's (bf16(s (128 + 8 n)) against bf16(s n), an
    error of up to s / 32 a weight against s / 32 n), so the two plain
    versions part (measured by up to 1.7e-2 of max |y|)."""
    monkeypatch.setenv("KCPP_Q4K_2D", "magic")
    if T == 1:
        monkeypatch.setenv("KCPP_Q4K_DECODE", "0")
    jq, tq = _pair(GGMLType.Q4_K, 256, in_f)
    x = _x(T, in_f, seed=T)
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr == "2d"
    assert [kw.get("magic") for p, _, kw in routes if p == "port"] == [True]
    if T == 1:
        xp = torch.cat([x, _x(15, in_f, seed=2)])
        want = _both(jq, tq, xp, routes)[1][:1]
    _close(got, want)
    assert not np.array_equal(got, tqm.kq_matmul_plain(x, tq).float().numpy())


def test_q4k_2d_magic_leaves_other_kinds(monkeypatch, routes):
    """KCPP_Q4K_2D=magic changes q4_k alone: q5_k at T = 16 takes its own
    body in both packages."""
    monkeypatch.setenv("KCPP_Q4K_2D", "magic")
    jq, tq = _pair(GGMLType.Q5_K, 256, 512)
    got, want, pr, jr = _both(jq, tq, _x(16, 512), routes)
    assert pr == jr == "2d"
    assert [kw.get("magic") for p, _, kw in routes if p == "port"] == [False]
    _close(got, want)
    with pytest.raises(ValueError, match="q4_k"):
        tqm.kq_matmul(_x(16, 512), tq, magic=True)


@pytest.mark.parametrize("t", KINDS, ids=lambda t: t.name)
@pytest.mark.parametrize("T", [1, 4, 16])
def test_pallas_mm_off(monkeypatch, routes, t, T):
    """KCPP_PALLAS_MM=0: the JAX dispatch declines every packed matmul (its
    XLA dequant path: bf16 weights, f32 accumulation), and the port takes
    K3 / K13 at every T, the same function: within K3's tolerance."""
    monkeypatch.setenv("KCPP_PALLAS_MM", "0")
    jq, tq = _pair(t, 256, 512)
    got, want, pr, jr = _both(jq, tq, _x(T, 512), routes)
    assert (pr, jr) == ("2d", "dequant")
    _close(got, want)


def test_pallas_mm_off_turns_k14_and_k15_off(monkeypatch, routes):
    """KCPP_PALLAS_MM=0 turns K14 (KCPP_SBQ=1) and K15 (KCPP_FFN_FUSED=1)
    off, as the JAX `_pallas_enabled` gates `_packed_matvec_q4k_sbq` and
    `ffn_fused`: with it unset K14 and K15 serve the same calls."""
    monkeypatch.setenv("KCPP_SBQ", "1")
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    jq, tq = _pair(GGMLType.Q4_K, 256, 2048)
    _, gu = _pair(GGMLType.Q4_K, 512, 256)
    _, dn = _pair(GGMLType.Q4_K, 256, 256)
    x, xf = _x(4, 2048), _x(1, 256)
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr == "sbq"
    assert tff.ffn_fused(xf, gu, dn) is not None
    monkeypatch.setenv("KCPP_PALLAS_MM", "0")
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert (pr, jr) == ("2d", "dequant")
    _close(got, want)
    assert tff.ffn_fused(xf, gu, dn) is None


def test_pallas_mm_off_expanded_kind_takes_its_dense_kind(monkeypatch,
                                                          routes):
    """An expanded kind carrying its dense fields (KCPP_KQ_LAYOUT=expanded:
    q6_k_i8f beside q6_k's) takes K12 expanded at T = 1 by default, where
    JAX takes its expanded matvec, and K3 as its dense kind under
    KCPP_PALLAS_MM=0, where JAX dequantizes (within K3's tolerance)."""
    rng = np.random.default_rng(0)
    raw = quants.quantize((rng.standard_normal((256, 512)) * 0.1
                           ).astype(np.float32), GGMLType.Q6_K)
    monkeypatch.setenv("KCPP_KQ_LAYOUT", "expanded")
    jq = jlinear.from_gguf(raw, GGMLType.Q6_K, (256, 512), packed=True)
    tq = tlinear.from_gguf(raw, GGMLType.Q6_K, (256, 512), packed=True)
    monkeypatch.delenv("KCPP_KQ_LAYOUT")
    assert tq.kind == jq.kind == "q6_k_i8f"
    x = _x(1, 512)
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert pr == jr == "matvec"
    monkeypatch.setenv("KCPP_PALLAS_MM", "0")
    got, want, pr, jr = _both(jq, tq, x, routes)
    assert (pr, jr) == ("2d", "dequant")
    _close(got, want)


def test_flash_decode_variable(monkeypatch, capsys):
    """KCPP_FLASH_DECODE=0: the launcher prints its one startup line (the
    JAX package's XLA decode attention is the flash-decode kernel's
    function, which the port's K5 serves), and a prefill plus a decode
    step of the tiny Q4_K_M fixture give the same logits as without it."""
    from koboldcpp_tpu_torch import cli
    from koboldcpp_tpu_torch.kv.cache import init_cache
    from koboldcpp_tpu_torch.models import llama
    from koboldcpp_tpu_torch.models.loader import load_model

    fix = "tests/fixtures/refgguf/tiny-q4_k_m.gguf"
    m = load_model(fix, device="cpu")

    def run():
        c = init_cache(m.cfg.n_layers, 1, 32, m.cfg.n_kv_heads,
                       m.cfg.head_dim)
        with torch.inference_mode():
            a, _ = llama.forward(m.params, m.cfg, torch.tensor([[1, 5, 9]]),
                                 torch.arange(3)[None], c)
            b, _ = llama.forward(m.params, m.cfg, torch.tensor([[7]]),
                                 torch.tensor([[3]]), c)
        return torch.cat([a[0], b[0]])
    want = run()
    assert llama.flash_decode_note() is None
    monkeypatch.setenv("KCPP_FLASH_DECODE", "0")
    assert torch.equal(run(), want)
    assert cli.main([fix, "--device", "cpu", "--prompt", "Once upon",
                     "--promptlimit", "2", "--contextsize", "128"]) == 0
    out = capsys.readouterr().out
    assert out.count("KCPP_FLASH_DECODE=0: the JAX package's XLA decode "
                     "attention is the flash-decode kernel's function; the "
                     "port's K5 (flash decode) serves it") == 1
