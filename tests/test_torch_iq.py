"""The port's native IQ kinds (iq2p, iq3px, iq3ps, iq1p: GGUF IQ2_XXS/XS/S,
IQ3_XXS, IQ3_S, IQ1_S/M; kernels K12.iq, the T=1 matvec, and K13.iq, the
tiled matmul) against the JAX package, on the CPU (plain kernel versions;
the JAX side's Pallas kernels in interpret mode): packing and dequant bit
for bit on the tests/fixtures/portgguf IQ fixtures and on random blocks of
all seven types, the plain versions against JAX `matmul_packed`, the
dispatch, the GGUF bit order, JAX-packed QTensors carried across, the
fixtures' logits, and serving over HTTP and through the batched engine."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatchedEngine
from koboldcpp_tpu.gguf import GGMLType
from koboldcpp_tpu.gguf.constants import GGML_BLOCK_SIZES
from koboldcpp_tpu.gguf.reader import GGUFReader
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu.server.app import ServerSettings as JServerSettings
from koboldcpp_tpu.server.app import make_app as j_make_app
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.kv.cache import init_cache as t_init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.models.synthetic import rand_iq
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as tqm
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")
MANIFEST = json.load(open(os.path.join(FIX, "manifest.json")))
TOKENS = np.asarray([MANIFEST["tokens"]], dtype=np.int64)
# fixture -> the packed kinds of its IQ tensors
IQ_FMTS = {"iq2_xs": {"iq2p"}, "iq3_xxs": {"iq2p", "iq3px", "iq3ps"},
           "iq1_m": {"iq1p", "iq2p"}}
IQ_TYPES = (GGMLType.IQ2_XXS, GGMLType.IQ2_XS, GGMLType.IQ2_S,
            GGMLType.IQ3_XXS, GGMLType.IQ3_S, GGMLType.IQ1_S, GGMLType.IQ1_M)
KIND_G = {GGMLType.IQ2_XXS: ("iq2p", 32), GGMLType.IQ2_XS: ("iq2p", 16),
          GGMLType.IQ2_S: ("iq2p", 16), GGMLType.IQ3_XXS: ("iq3px", 32),
          GGMLType.IQ3_S: ("iq3ps", 32), GGMLType.IQ1_S: ("iq1p", 32),
          GGMLType.IQ1_M: ("iq1p", 8)}
PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of", "A B C D"]
NEAR_TIE = 2 ** -6  # as tests/test_torch_batch_engine.py

_jax_dequant = jax.jit(jlinear.dequant_xla, static_argnames="dtype")


def make_raw(rng, t: GGMLType, rows: int, cols: int,
             finite: bool = False) -> np.ndarray:
    """Random raw blocks as tests/test_iq_native.py:make_raw builds them
    (the leading f16 scale pinned small and finite, IQ1_M's left as drawn);
    finite=True also pins IQ1_M's scale, whose f16 bits come from the top
    nibbles of its four u16 sub-scale words: the top nibble of the last
    (the sign and high exponent bits) is set to 2, a finite d in
    [2^-7, 2^-3)."""
    blk, sz = GGML_BLOCK_SIZES[t]
    raw = rng.integers(0, 256, size=(rows, cols // blk * sz), dtype=np.uint8)
    b = raw.reshape(rows, cols // blk, sz)
    if t != GGMLType.IQ1_M:
        b[:, :, 0] = rng.integers(0, 256, b[:, :, 0].shape)
        b[:, :, 1] = 0x2C | rng.integers(0, 4, b[:, :, 1].shape)
    elif finite:
        b[:, :, 55] = (b[:, :, 55] & 0x0F) | 0x20
    return raw


def _path(fmt):
    return os.path.join(FIX, MANIFEST["files"][fmt])


def _assert_same_dequant(jq, tq):
    assert tq.kind == jq.kind and tuple(tq.shape) == tuple(jq.shape)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = np.asarray(_jax_dequant(jq, dtype=jdt).astype(jnp.float32))
        got = tlinear.dequant(tq, dtype=tdt).float().numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", list(IQ_FMTS))
def test_fixture_packs_and_dequantizes_as_jax(fmt):
    """Every IQ1-3 tensor of the three IQ fixtures packs natively (no
    NotImplementedError) into its kind and dequantizes to JAX
    `dequant_xla`'s bits in f32 and bf16."""
    kinds = set()
    with GGUFReader(_path(fmt)) as r:
        for n, i in r.tensors.items():
            if i.ggml_type in KIND_G and len(i.shape) == 2:
                raw, shape = r.tensor_raw(n), tuple(i.shape)
                jq = jlinear.from_gguf(raw, i.ggml_type, shape, packed=True)
                tq = tlinear.from_gguf(raw, i.ggml_type, shape, packed=True)
                assert tq.kind == KIND_G[i.ggml_type][0]
                assert tlinear.iq_group(tq) == KIND_G[i.ggml_type][1]
                _assert_same_dequant(jq, tq)
                kinds.add(tq.kind)
    assert kinds == IQ_FMTS[fmt]


@pytest.mark.parametrize("t", IQ_TYPES, ids=lambda t: t.name)
def test_random_blocks_dequantize_as_jax(t):
    """Random raw blocks of every IQ type (IQ2_XXS, IQ3_S and IQ1_S too,
    which no fixture holds; IQ1_M's non-finite scales included: NaN where
    JAX has NaN) pack into the type's kind and group and dequantize to
    JAX's bits."""
    raw = make_raw(np.random.default_rng(int(t)), t, 16, 512)
    jq = jlinear.from_gguf(raw, t, (16, 512))
    tq = tlinear.from_gguf(raw, t, (16, 512))
    assert (tq.kind, tlinear.iq_group(tq)) == KIND_G[t]
    _assert_same_dequant(jq, tq)


@pytest.mark.parametrize("t", IQ_TYPES, ids=lambda t: t.name)
def test_plain_versions_match_jax_matmul_packed(t):
    """At 256 x 512 and 256 x 1024, T = 1 and 8: the port's matmul_packed
    (iq_matvec_plain at T=1 where in_f >= 32 G, kq_matmul_plain otherwise)
    against JAX `matmul_packed` (the row kernels `_iq*_row_kernel_i8` and
    the 2-D `_iq*_kernel` in interpret mode), within 2^-7 max|y|: the int32
    dots are exact and the bf16(v * s) weights equal, so only the f32
    summation order and the last bf16 rounding differ."""
    rng = np.random.default_rng(100 + int(t))
    kind, G = KIND_G[t]
    for in_f in (512, 1024):
        raw = make_raw(rng, t, 256, in_f, finite=True)
        jq = jlinear.from_gguf(raw, t, (256, in_f))
        tq = tlinear.from_gguf(raw, t, (256, in_f))
        for T in (1, 8):
            x = (rng.standard_normal((T, in_f)) * 0.5).astype(np.float32)
            xt = torch.from_numpy(x).bfloat16()
            want = np.asarray(jqm.matmul_packed(
                jnp.asarray(x, jnp.bfloat16), jq).astype(jnp.float32))
            plain = (tqm.iq_matvec_plain(xt[0], tq)
                     if T == 1 and in_f >= 32 * G
                     else tqm.kq_matmul_plain(xt, tq))
            got = tqm.matmul_packed(xt, tq)
            assert torch.equal(got, plain)
            assert np.isfinite(want).all()
            err = np.abs(got.float().numpy() - want).max()
            assert err <= 2 ** -7 * np.abs(want).max(), (in_f, T, err)


@pytest.mark.parametrize("t", IQ_TYPES, ids=lambda t: t.name)
def test_dispatch_k12_where_in_f_reaches_32_groups(t):
    """matmul_packed sends T=1 to K12.iq exactly when in_f >= 32 G (G the
    type's scale group: 256 for IQ1_M, 512 for IQ2_XS/S, 1024 for the
    others) and to K13.iq otherwise and at every T >= 2, the batched decode
    step included; out_f 128 is declined (the dequant path), as in JAX.
    Only plain versions run on the CPU: no launch is counted."""
    rng = np.random.default_rng(3)
    G = KIND_G[t][1]
    _build.launches.clear()
    for in_f in (256, 512, 1024):
        tq = tlinear.from_gguf(make_raw(rng, t, 256, in_f, finite=True), t,
                               (256, in_f))
        x = torch.from_numpy(rng.standard_normal((8, in_f)).astype(
            np.float32)).bfloat16()
        k12 = tqm.iq_matvec_plain(x[0], tq)
        k13 = tqm.kq_matmul_plain(x[:1], tq)
        assert not torch.equal(k12, k13)
        assert torch.equal(tqm.matmul_packed(x[:1], tq),
                           k12 if in_f >= 32 * G else k13)
        for T in (2, 8):
            assert torch.equal(tqm.matmul_packed(x[:T], tq),
                               tqm.kq_matmul_plain(x[:T], tq))
    narrow = tlinear.from_gguf(make_raw(rng, t, 128, 512, finite=True), t,
                               (128, 512))
    assert tqm.matmul_packed(x[:1, :512], narrow) is None
    assert tqm.matmul_packed(x[:, :512], narrow) is None
    assert sum(_build.launches.values()) == 0


def _moved(t, raw, flip):
    """(row, col) of the port's dequantized weights that differ between raw
    and flip, and the two dequants."""
    shape = (raw.shape[0], raw.shape[1] // GGML_BLOCK_SIZES[t][1] * 256)
    a = tlinear.dequant(tlinear.from_gguf(raw, t, shape), torch.float32)
    b = tlinear.dequant(tlinear.from_gguf(flip, t, shape), torch.float32)
    return (a != b).nonzero().tolist(), a, b


def test_iq2p_sign_bit_order():
    """IQ2_S sign byte (ib, l) of a superblock (byte 34 + 4 ib + l) bit k
    is the sign of element 32 ib + 8 l + k: flipping it negates exactly
    that weight (the port's sg order)."""
    t = GGMLType.IQ2_S
    raw = make_raw(np.random.default_rng(11), t, 4, 512)
    row, sb, ib, l, k = 2, 1, 5, 3, 6
    flip = raw.copy()
    flip[row, sb * 82 + 34 + 4 * ib + l] ^= 1 << k
    moved, a, b = _moved(t, raw, flip)
    col = sb * 256 + 32 * ib + 8 * l + k
    assert moved == [[row, col]] and b[row, col] == -a[row, col]


def test_iq3ps_sign_and_high_bit_order():
    """IQ3_S: sign byte (ib, l) (byte 74 + 4 ib + l) bit k negates exactly
    element 32 ib + 8 l + k; qh byte ib (byte 66 + ib) bit k is bit 8 of
    grid index (ib, k), whose 4 values are elements 32 ib + 4 k .. + 3:
    flipping it moves only those (the port's hmask and qs order)."""
    t = GGMLType.IQ3_S
    raw = make_raw(np.random.default_rng(12), t, 4, 512)
    row, sb, ib, l, k = 1, 1, 6, 2, 5
    flip = raw.copy()
    flip[row, sb * 110 + 74 + 4 * ib + l] ^= 1 << k
    moved, a, b = _moved(t, raw, flip)
    col = sb * 256 + 32 * ib + 8 * l + k
    assert moved == [[row, col]] and b[row, col] == -a[row, col]
    for k in range(8):
        flip = raw.copy()
        flip[row, sb * 110 + 66 + ib] ^= 1 << k
        moved, _, _ = _moved(t, raw, flip)
        run = [[row, sb * 256 + 32 * ib + 4 * k + e] for e in range(4)]
        assert moved and all(m in run for m in moved), (k, moved)


def test_iq3px_sign_order():
    """IQ3_XXS: bits 7l .. 7l+6 of the u32 at byte 66 + 4 ib are the 7-bit
    sign index of elements 32 ib + 8 l .. + 7, the 8th sign its parity:
    flipping bit k < 7 negates exactly elements 32 ib + 8 l + k and
    32 ib + 8 l + 7."""
    t = GGMLType.IQ3_XXS
    raw = make_raw(np.random.default_rng(13), t, 4, 512)
    row, sb, ib, l, k = 3, 0, 2, 1, 4
    flip = raw.copy()
    bit = 7 * l + k
    flip[row, sb * 98 + 66 + 4 * ib + bit // 8] ^= 1 << (bit % 8)
    moved, a, b = _moved(t, raw, flip)
    cols = [sb * 256 + 32 * ib + 8 * l + e for e in (k, 7)]
    assert moved == [[row, c] for c in cols]
    assert all(b[row, c] == -a[row, c] for c in cols)


@pytest.mark.parametrize("t", [GGMLType.IQ1_S, GGMLType.IQ1_M],
                         ids=lambda t: t.name)
def test_iq1p_delta_bit_order(t):
    """The IQ1 delta sign (IQ1_S: bit 15 of the u16 qh of 32-block ib, byte
    35 + 2 ib; IQ1_M: bit 3 / 7 of qh byte 32 + 2 ib + l // 2 for 8-block
    (ib, l)) moves exactly that group's G weights, all by the same amount
    (the port's min order); and a grid-index bit (IQ1_S qs byte 2 + 4 ib +
    l, bit 0) moves only weights of its 8-element grid entry."""
    rng = np.random.default_rng(14)
    raw = make_raw(rng, t, 4, 512, finite=True)
    row, sb, ib, l = 2, 1, 3, 2
    flip = raw.copy()
    nb = GGML_BLOCK_SIZES[t][1]
    if t == GGMLType.IQ1_S:
        flip[row, sb * nb + 35 + 2 * ib] ^= 0x80
        group = range(32 * ib, 32 * ib + 32)
    else:
        flip[row, sb * nb + 32 + 2 * ib + l // 2] ^= 0x08 << (4 * (l % 2))
        group = range(32 * ib + 8 * l, 32 * ib + 8 * l + 8)
    moved, a, b = _moved(t, raw, flip)
    assert moved == [[row, sb * 256 + c] for c in group]
    d = (b - a)[row, sb * 256 + group.start:sb * 256 + group.stop]
    assert torch.equal(d, d[:1].expand_as(d))
    if t == GGMLType.IQ1_S:
        flip = raw.copy()
        flip[row, sb * nb + 2 + 4 * ib + l] ^= 1
        moved, _, _ = _moved(t, raw, flip)
        entry = [[row, sb * 256 + 32 * ib + 8 * l + e] for e in range(8)]
        assert moved and all(m in entry for m in moved)


@pytest.mark.parametrize("t", IQ_TYPES, ids=lambda t: t.name)
def test_params_from_jax_equals_port_packing(t):
    """A JAX `pack_iq_native` QTensor (qs2, the half-split sg or hs
    sidecar, plane-major scale_p / min_p, lane-transposed copies) carried
    across by params_from_jax equals the port's packing of the same raw
    bytes, field for field, and dequantizes to JAX's bits."""
    raw = make_raw(np.random.default_rng(20 + int(t)), t, 16, 512,
                   finite=True)
    jq = jlinear.pack_iq_native(raw, (16, 512), t)
    tq = tlinear.from_gguf(raw, t, (16, 512))
    got = params_from_jax(jax.tree_util.tree_map(np.asarray, jq))
    assert got.kind == tq.kind and set(got.data) == set(tq.data)
    for name, v in tq.data.items():
        assert got.data[name].dtype == v.dtype
        assert torch.equal(got.data[name], v), name
    _assert_same_dequant(jq, got)


@pytest.mark.parametrize("kind,G", [("iq2p", 32), ("iq2p", 16),
                                    ("iq3px", 32), ("iq3ps", 32),
                                    ("iq1p", 32), ("iq1p", 8)])
def test_synthetic_maker_layout(kind, G):
    """rand_iq draws into the port's layout: the kind's fields and dtypes,
    codes inside the alphabet (iq2p / iq1p never code 3), weights of rms
    ~0.006 (the docstring's spread), and the plain K12.iq / K13.iq agree
    with the f32 product of the dequantized weight within int8-activation
    noise."""
    qt = rand_iq(np.random.default_rng(5), 256, 1024, "cpu", kind, G)
    want = {"iq2p": {"qs", "sg", "scale"},
            "iq3px": {"qs", "hmask", "sg", "scale"},
            "iq3ps": {"qs", "hmask", "sg", "scale"},
            "iq1p": {"qs", "scale", "min"}}[kind]
    assert set(qt.data) == want and tlinear.iq_group(qt) == G
    assert all(v.dtype == tqm._FIELD_DTYPES[n] for n, v in qt.data.items())
    if kind in ("iq2p", "iq1p"):
        assert int(tlinear.q2k_values(qt.data["qs"]).max()) <= 2
    w = tlinear.dequant(qt, torch.float32)
    assert 0.005 < float(w.pow(2).mean().sqrt()) < 0.007
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (2, 1024)).astype(np.float32)).bfloat16()
    ref = x.float() @ w.t()
    for y, r in ((tqm.iq_matvec_plain(x[0], qt), ref[:1]),
                 (tqm.kq_matmul_plain(x, qt), ref)):
        assert (y.float() - r).abs().max() <= 0.03 * r.abs().max()


@pytest.mark.parametrize("fmt", list(IQ_FMTS))
def test_fixture_logits_match_jax(fmt):
    """The three IQ fixtures loaded packed in f32: the port's logits within
    1e-2 (rtol and atol, tests/test_torch_lowbit.py's tolerance) of the JAX
    forward's, computed now and as committed (logits-jax-*.npy)."""
    m = load_model(_path(fmt), dtype=torch.float32, device="cpu")
    cache = t_init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=torch.float32)
    pos = torch.arange(TOKENS.shape[1])[None]
    with torch.inference_mode():
        got, _ = tllama.forward(m.params, m.cfg, torch.from_numpy(TOKENS),
                                pos, cache)
    got = got[0].numpy()
    jm = j_load_model(_path(fmt), packed=True, dtype=jnp.float32)
    jc = j_init_cache(jm.cfg.n_layers, 1, 64, jm.cfg.n_kv_heads,
                      jm.cfg.head_dim, dtype=jnp.float32)
    want, _ = jax.jit(lambda p, t, s, c: jllama.forward(p, jm.cfg, t, s, c))(
        jm.params, jnp.asarray(TOKENS, jnp.int32),
        jnp.asarray(pos.numpy(), jnp.int32), jc)
    want = np.asarray(want)[0]
    committed = np.load(os.path.join(FIX, f"logits-jax-{fmt}.npy"))
    np.testing.assert_array_equal(want, committed)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


def _greedy(n=8, **kw):
    return GenParams(max_length=n, sampler=SamplerParams(temperature=0.0,
                                                         rep_pen=1.0), **kw)


def _assert_same_tokens(model, prompt, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits there (single-stream, on the port) within NEAR_TIE of
    each other (as tests/test_torch_lowbit.py allows: two bf16-rounded
    paths may pick either of two tokens a bf16 step apart)."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)  # one stopped early: not a tie
    ctx = model.tokenizer.encode(prompt) + got[:i]
    with torch.inference_mode():
        lg = Engine(model, max_context=256, device="cpu").eval_tokens(ctx, 0)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


async def test_served_text_matches_jax_server(aiohttp_client):
    """tiny-iq3_xxs (iq2p, iq3px and iq3ps through K13.iq, q3_k through
    K12 / K13, the IQ3_S token_embd dense) over /api/v1/generate at
    temperature 0 on both servers (single-stream engines, bf16 caches): the
    same text twice over on the port, and the JAX server's text; where
    they part, the engines' tokens part at a near-tie."""
    gen = {"prompt": PROMPTS[0], "max_length": 8, "temperature": 0,
           "rep_pen": 1.0}
    model = load_model(_path("iq3_xxs"), device="cpu")
    assert model.params["layers"][0]["w_gateup"].kind == "iq3px"
    eng = Engine(model, max_context=512, device="cpu")
    jeng = JEngine(j_load_model(_path("iq3_xxs")), max_context=512,
                   cache_dtype=jnp.bfloat16)
    port = await aiohttp_client(make_app(
        eng, ServerSettings(model_name="tiny-iq3_xxs")))
    ref = await aiohttp_client(j_make_app(
        jeng, JServerSettings(model_name="tiny-iq3_xxs")))
    texts = []
    for client in (port, port, ref):
        r = await client.post("/api/v1/generate", json=gen)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] and texts[0] == texts[1]
    if texts[0] != texts[2]:
        eng.reset_context()
        jeng.reset_context()
        got = eng.generate(PROMPTS[0], _greedy()).tokens
        want = jeng.generate(PROMPTS[0], JGenParams(
            max_length=8, sampler=JSamplerParams(temperature=0.0,
                                                 rep_pen=1.0))).tokens
        assert got != want
        _assert_same_tokens(model, PROMPTS[0], got, want)


def test_multiuser_iq1_m_matches_jax_batched_engine():
    """Four concurrent greedy requests through the port's BatchedEngine on
    tiny-iq1_m (4 slots: each decode step is a (4, 1) forward, so the iq1p
    (G = 8) and iq2p projections run K13.iq) get the tokens the JAX
    BatchedEngine gives each request (its 2-D `_iq1p_kernel` /
    `_iq2p_kernel` in interpret mode), near-ties apart."""
    gp = JGenParams(max_length=8, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    jeng = JBatchedEngine(j_load_model(_path("iq1_m")), max_context=256,
                          n_slots=4, cache_dtype=jnp.bfloat16)
    try:
        want = [jeng.generate(p, gp).tokens for p in PROMPTS]
    finally:
        jeng.shutdown()
    model = load_model(_path("iq1_m"), device="cpu")
    eng = BatchedEngine(model, max_context=256, n_slots=4, device="cpu")
    got = [None] * len(PROMPTS)

    def run(i):
        got[i] = eng.generate(PROMPTS[i], _greedy(bypass_eos=True)).tokens

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        eng.shutdown()
    for p, g, w in zip(PROMPTS, got, want):
        _assert_same_tokens(model, p, g, w)
