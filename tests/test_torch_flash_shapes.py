"""The head shapes csrc/flash_decode.cu serves beyond head_dim 64 / 128 and
16 query heads per kv head, and the split planner that cuts its grid.

The plain versions of K5, K8, K6 and K9 / K10 against the JAX package's
`decode_attention_batched`, `decode_attention_paged`,
`decode_attention_batched_q8`, `decode_attention_paged_q8` / `_q4` (Pallas,
interpret mode) at head_dim 80 (8 kv heads), 96 (4), 256 (2) and 32 query
heads over one kv head (head_dim 128), with the tolerances of
test_torch_flash_decode.py / test_torch_flash_decode_quant.py; which head
shapes `check_supported` admits on the card; `decode_plan` and the
wrappers' use of it (the same split for the slot, paged and pooled caches
of one length)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv import paged as jpaged
from koboldcpp_tpu.ops import flash_decode as jfd
from koboldcpp_tpu_torch.kv import paged as tpaged
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import ModelConfig
from koboldcpp_tpu_torch.ops import flash_decode as tfd

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

# (H, Hkv, D): head_dim 80, 96, 256; G = 32 at head_dim 128
SHAPES = [(16, 8, 80), (8, 4, 96), (4, 2, 256), (32, 1, 128)]
IDS = ["d80", "d96", "d256", "g32"]
# K5 and K8 also at two head_dims the card's tiles pad: 72 (to 80) and 512
PADDED = [(16, 16, 72), (8, 1, 512)]
PADDED_IDS = ["d72", "d512"]
# head_dims JAX sends to its kernels (Hkv * D % 128 == 0) that are not a
# multiple of 8, or above 512: the card's pieces narrower than 16 bytes,
# and the streamed instance (output columns in chunks of 128, K and V rows
# in pieces of 128 columns) at 640 and past the old limit of 1024
REPAIRED = [(32, 32, 20), (32, 32, 36), (1, 1, 640), (1, 1, 1152),
            (1, 1, 2048)]
REPAIRED_IDS = ["d20", "d36", "d640", "d1152", "d2048"]
B, S = 2, 64
P, NP, MP = 8, 40, 8  # pool pages of P rows, MP pages per sequence


def _bf(a):
    return torch.from_numpy(np.ascontiguousarray(a)).bfloat16()


def _j(a, dt=jnp.bfloat16):
    return jnp.asarray(a, dt)


def _exact_rows(rng, shape, bits):
    """K/V rows as integers times a power of two whose amax hits the code
    range, so that quantizing them meets no rounding tie (see
    test_torch_flash_decode_quant.py `_new_rows`)."""
    top, unit = (7, 2 ** -3) if bits == 4 else (127, 2 ** -7)
    x = rng.integers(-top, top + 1, (2,) + shape).astype(np.float32)
    x[..., 0] = top
    return x[0] * unit, x[1] * unit


@pytest.mark.parametrize("H, HKV, D", SHAPES + PADDED + REPAIRED,
                         ids=IDS + PADDED_IDS + REPAIRED_IDS)
def test_k5_plain_matches_jax(H, HKV, D):
    """The K5 tolerance (2e-3 absolute on outputs of size ~0.5: JAX
    rescales per block against a running max); the cache rows exact. Pos
    63 is the last row, -1 a dead slot."""
    rng = np.random.default_rng(D + H)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = rng.standard_normal((2, B, HKV, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((2, B, S, HKV * D)) * 0.5).astype(np.float32)
    for positions in ((5, 63), (-1, 40)):
        pos = np.asarray(positions, np.int32)
        out_j, k_j, v_j = jfd.decode_attention_batched(
            _j(q), _j(kn), _j(vn), _j(kc), _j(vc), jnp.asarray(pos), H, HKV,
            D ** -0.5, interpret=True)
        k_t, v_t = _bf(kc), _bf(vc)
        out_t, _, _ = tfd.decode_attention_batched(
            _bf(q), _bf(kn), _bf(vn), k_t, v_t, torch.from_numpy(pos), H, HKV,
            D ** -0.5)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                                   atol=2e-3)
        np.testing.assert_array_equal(k_t.float().numpy(),
                                      np.asarray(k_j.astype(jnp.float32)))
        np.testing.assert_array_equal(v_t.float().numpy(),
                                      np.asarray(v_j.astype(jnp.float32)))


@pytest.mark.parametrize("H, HKV, D", SHAPES + PADDED + REPAIRED,
                         ids=IDS + PADDED_IDS + REPAIRED_IDS)
def test_k8_plain_matches_jax(H, HKV, D):
    """K8 over shuffled pages (the K5 tolerance); position 70 is past MP *
    P = 64 (every page read, nothing written); the pool update exact."""
    rng = np.random.default_rng(D + H + 1)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = rng.standard_normal((2, B, HKV, D)).astype(np.float32)
    kp, vp = (rng.standard_normal((2, NP * P, HKV * D)) * 0.5).astype(
        np.float32)
    table = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    pos = np.asarray((17, 70), np.int32)
    out_j, k_j, v_j = jfd.decode_attention_paged(
        _j(q), _j(kn), _j(vn), _j(kp), _j(vp), jnp.asarray(table),
        jnp.asarray(pos), H, HKV, P, D ** -0.5, interpret=True)
    k_t, v_t = _bf(kp), _bf(vp)
    out_t, _, _ = tfd.decode_attention_paged(
        _bf(q), _bf(kn), _bf(vn), k_t, v_t, torch.from_numpy(table),
        torch.from_numpy(pos), H, HKV, P, D ** -0.5)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=2e-3)
    np.testing.assert_array_equal(k_t.float().numpy(),
                                  np.asarray(k_j.astype(jnp.float32)))
    np.testing.assert_array_equal(v_t.float().numpy(),
                                  np.asarray(v_j.astype(jnp.float32)))


@pytest.mark.parametrize("H, HKV, D", SHAPES + REPAIRED[:1],
                         ids=IDS + REPAIRED_IDS[:1])
def test_k6_plain_matches_jax(H, HKV, D):
    """K6 over the Q8 slot cache: within one bf16 step (2^-8) of the
    largest |V| (p rounded against another running max on each side); the
    codes and scales written at pos equal JAX's bit for bit."""
    rng = np.random.default_rng(D + H + 2)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = _exact_rows(rng, (B, HKV, D), 8)
    kc = rng.integers(-127, 128, (2, B, S, HKV * D)).astype(np.int8)
    sc = _j(rng.uniform(0.001, 0.02, (2, B, S, HKV)))
    pos = np.asarray((9, -1), np.int32)
    out_j, *upd = jfd.decode_attention_batched_q8(
        _j(q), _j(kn), _j(vn), jnp.asarray(kc[0]), jnp.asarray(kc[1]), sc[0],
        sc[1], jnp.asarray(pos), H, HKV, D ** -0.5, interpret=True)
    caches = [torch.from_numpy(kc[0].copy()), torch.from_numpy(kc[1].copy()),
              *(torch.from_numpy(np.array(s.astype(jnp.float32))).bfloat16()
                for s in sc)]
    out_t, *_ = tfd.decode_attention_batched_q8(
        _bf(q), _bf(kn), _bf(vn), *caches, torch.from_numpy(pos), H, HKV,
        D ** -0.5)
    vmax = max(float(np.abs(vn).max()),
               float((np.abs(kc[1]).max(-1) * np.asarray(
                   sc[1].astype(jnp.float32)).max(-1)).max()))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=2 ** -8 * vmax)
    for got, want in zip(caches, upd):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("H, HKV, D", SHAPES + REPAIRED[:1],
                         ids=IDS + REPAIRED_IDS[:1])
def test_k9_k10_plain_match_jax(H, HKV, D, bits):
    """K9 (bits 8) and K10 (bits 4): history written by both pools' `write`,
    then one step on each side, within one bf16 step of the largest |V|;
    after it both pools hold the same values."""
    rng = np.random.default_rng(D + H + bits)
    level = "q4" if bits == 4 else "q8"
    jc = jpaged.init_paged_cache(1, NP, P, HKV, D, quantized=level)
    tc = tpaged.init_paged_cache(1, NP, P, HKV, D, quantized=level)
    table = rng.permutation(NP)[:B * MP].reshape(B, MP).astype(np.int32)
    positions = (21, 8)
    for b, p in enumerate(positions):
        ks, vs = rng.standard_normal((2, 1, p, HKV, D)).astype(np.float32)
        jc = jpaged.write(jc, 0, jnp.asarray(table[b:b + 1]),
                          jnp.arange(p)[None], _j(ks), _j(vs))
        tpaged.write(tc, 0, torch.from_numpy(table[b:b + 1]),
                     torch.arange(p)[None], _bf(ks), _bf(vs))
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kn, vn = _exact_rows(rng, (B, HKV, D), bits)
    pos = np.asarray(positions, np.int32)
    jfn = (jfd.decode_attention_paged_q4 if bits == 4
           else jfd.decode_attention_paged_q8)
    tfn = (tfd.decode_attention_paged_q4 if bits == 4
           else tfd.decode_attention_paged_q8)
    out_j, *upd = jfn(_j(q), _j(kn), _j(vn), jc.k[0], jc.v[0],
                      jc.k_scale[0], jc.v_scale[0], jnp.asarray(table),
                      jnp.asarray(pos), H, HKV, P, D ** -0.5, interpret=True)
    out_t, *_ = tfn(_bf(q), _bf(kn), _bf(vn), tc.k[0], tc.v[0],
                    tc.k_scale[0], tc.v_scale[0], torch.from_numpy(table),
                    torch.from_numpy(pos), H, HKV, P, D ** -0.5)
    _, tv = tpaged.gather(tc, 0, torch.from_numpy(table))
    vmax = max(float(np.abs(vn).max()), float(tv.float().abs().max()))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=2 ** -8 * vmax)
    jc = jc.with_layer(0, *upd)
    for got, want in zip(tpaged.gather(tc, 0, torch.from_numpy(table)),
                         jpaged.gather(jc, 0, jnp.asarray(table))):
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))


def _cfg(H, Hkv, D):
    return ModelConfig(hidden_size=H * D, n_heads=H, n_kv_heads=Hkv,
                       head_dim=D, rope_dim=D)


@pytest.mark.parametrize("H, HKV, D", [
    (32, 32, 96),    # Phi-3-mini
    (128, 8, 128),   # Llama-3.1-405B: G = 16, G * D = 2048
    (32, 8, 80), (16, 8, 256), (32, 1, 128), (32, 4, 64), (64, 8, 112),
    # head_dims the tiles pad to a multiple of 16, and 512
    (32, 16, 72), (8, 1, 512), (16, 16, 40)])
def test_check_supported_admits_on_the_card(H, HKV, D):
    """On a CUDA device (only its type is read: no card needed) the head
    shapes JAX's flash decode takes pass; the card serves them: every
    head_dim."""
    tllama.check_supported({"layers": [{}]}, _cfg(H, HKV, D), "cuda")
    tfd.check_kernel_shape(H, HKV, D)


@pytest.mark.parametrize("H, HKV, D", [(32, 32, 20), (8, 1, 640),
                                        (64, 32, 36), (1, 1, 1152),
                                        (1, 1, 2048), (1, 1, 4864),
                                        (1, 1, 8192)])
def test_check_supported_raises_only_where_jax_serves_what_the_card_cannot(
        H, HKV, D):
    """No head_dim limit is left: the streamed instance holds two pieces of
    128 columns whatever the head_dim. The head_dims that are not a
    multiple of 8 (20, 36), those past 512 (640, and 1152 and 2048 past
    the old limit of 1024) and those past the later limit of 4800 (4864,
    8192), each with Hkv * D % 128 == 0 so that JAX's `supported_batched`
    sends them to its kernels, are admitted on the card. The one refusal
    left, an odd head_dim for K10, is one the JAX Q4 pool makes too.
    Shapes that JAX's `supported_batched` refuses (Hkv * D % 128 != 0) take
    the plain attention in both packages, so check_supported admits them.
    Every shape passes on the CPU."""
    cfg = _cfg(H, HKV, D)
    assert jfd.supported_batched(1, HKV, D)
    tllama.check_supported({"layers": [{}]}, cfg, "cuda")
    for kid in ("K5", "K6", "K8", "K9", "K10", "K16", "K17c"):
        tfd.check_kernel_shape(H, HKV, D, kid)
    tllama.check_supported({"layers": [{}]}, cfg, "cpu")
    with pytest.raises(NotImplementedError, match="K10"):
        tfd.check_kernel_shape(128, 128, 9, "K10")  # no nibble planes


def test_supported_batched_equals_jax():
    for T in (1, 2):
        for hkv in (1, 2, 4, 8, 16, 32):
            for d in (40, 64, 72, 80, 96, 112, 128, 256):
                assert (tfd.supported_batched(T, hkv, d)
                        == jfd.supported_batched(T, hkv, d))


@pytest.mark.parametrize("B", [1, 2, 8, 16])
@pytest.mark.parametrize("HKV", [1, 4, 8, 32])
@pytest.mark.parametrize("S", [64, 100, 2048, 4096, 131072])
def test_decode_plan_covers_the_cache(B, HKV, S):
    """Whole 64-row tiles per split, the splits cover S with no empty one,
    at most MAX_SPLITS of them, one split fewer would give fewer than
    TARGET_BLOCKS blocks, and the split is the smallest such multiple of
    64: one tile less would need more blocks or more splits."""
    rps, nsplit = tfd.decode_plan(B, HKV, S)
    assert rps % tfd.TILE_ROWS == 0 and rps >= tfd.TILE_ROWS
    assert (nsplit - 1) * rps < S <= nsplit * rps
    assert nsplit <= tfd.MAX_SPLITS
    assert B * HKV * (nsplit - 1) < tfd.TARGET_BLOCKS
    if rps > tfd.TILE_ROWS:
        fewer = -(-S // (rps - tfd.TILE_ROWS))
        assert (B * HKV * fewer > tfd.TARGET_BLOCKS
                or fewer > tfd.MAX_SPLITS)


def test_decode_plan_fills_the_card_at_one_sequence():
    """The 1.1B single stream (B = 1, Hkv = 4, S = 2048): 64-row splits,
    128 blocks on the 132 SMs; eight sequences: 256-row splits, 256."""
    assert tfd.decode_plan(1, 4, 2048) == (64, 32)
    assert tfd.decode_plan(8, 4, 2048) == (256, 8)


class _FakeLib:
    """Records each entry point's arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def test_wrappers_cut_every_kind_at_the_same_rows(monkeypatch):
    """The launch arguments the wrappers pass (driven with CPU tensors and
    a recording library in place of the CUDA one): K5, K6 and K17c over a
    2048-row cache and K8 / K9 / K10 over a pool of MP * P = 2048 rows get
    decode_plan(B, Hkv, 2048), whatever the positions: the split is never
    read from them, so K8 = K5 and K17c = K5 hold bit for bit."""
    from koboldcpp_tpu_torch.ops import _build

    lib = _FakeLib()
    monkeypatch.setattr(_build, "entry",
                        lambda source, name, argtypes: (lib, getattr(lib, name)))
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_build, "launches", type(_build.launches)())
    Bq, H, Hkv, D, Sq, Pq = 8, 32, 4, 64, 2048, 64
    q = torch.zeros((Bq, H, D), dtype=torch.bfloat16)
    kn = torch.zeros((Bq, Hkv, D), dtype=torch.bfloat16)
    cache = torch.zeros((Bq, Sq, Hkv * D), dtype=torch.bfloat16)
    pool = torch.zeros((Bq * Sq, Hkv * D), dtype=torch.bfloat16)
    i8 = torch.zeros((Bq * Sq, Hkv * D), dtype=torch.int8)
    u8 = torch.zeros((Bq * Sq, Hkv * D // 2), dtype=torch.uint8)
    sc = torch.zeros((Bq * Sq, Hkv), dtype=torch.bfloat16)
    table = torch.arange(Bq * Sq // Pq, dtype=torch.int32).view(Bq, -1)
    for positions in ([0] * Bq, [-1, 5, 2047, 700, 64, 63, 1, 1000]):
        pos = torch.tensor(positions, dtype=torch.int32)
        tfd._launch_rows("K5", q, kn, kn, cache, cache, pos, None, H, Hkv,
                         0.125, 0.0)
        tfd._launch_rows("K17c", q, kn, kn, torch.cat([cache] * 2),
                         torch.cat([cache] * 2), pos,
                         torch.ones(1, dtype=torch.int32), H, Hkv, 0.125, 0.0)
        c8 = cache.to(torch.int8)
        tfd._launch_q8(q, kn, kn, (c8, c8, sc.view(Bq, Sq, Hkv),
                                   sc.view(Bq, Sq, Hkv)), pos, H, Hkv, 0.125,
                       0.0)
        for kid, kp, ks in (("K8", pool, None), ("K9", i8, sc),
                            ("K10", u8, sc)):
            tfd._launch_paged(kid, q, kn, kn, kp, kp, ks, ks, table, pos, H,
                              Hkv, Pq, 0.125, 0.0, D)
    want = tfd.decode_plan(Bq, Hkv, Sq)
    got = {(name, args[-5], args[-4]) for name, args in lib.calls}
    assert {g[1:] for g in got} == {(want[1], want[0])}, got
    assert {g[0] for g in got} == {"k5_flash_decode", "k6_flash_decode_q8",
                                   "k8_flash_decode_paged"}


@pytest.mark.parametrize("H, HKV, D", REPAIRED, ids=REPAIRED_IDS)
def test_decode_plan_and_scratch_at_the_repaired_head_dims(monkeypatch, H,
                                                            HKV, D):
    """At head_dim 20, 36, 640, 1152 and 2048 every kind is launched (a
    recording library in place of the CUDA one) from the library that
    holds its instances (past 256: csrc/flash_decode_wide.cu's) with
    decode_plan's split, which does not read D, and a scratch of (units,
    nsplit, 16, columns a chunk): D itself below 512, chunks of 128 past it
    (640: five; 1152: nine; 2048: sixteen), so the units count the
    chunks."""
    from koboldcpp_tpu_torch.ops import _build

    lib = _FakeLib()
    sources = set()

    def entry(source, name, argtypes):
        sources.add(source)
        return lib, getattr(lib, name)

    monkeypatch.setattr(_build, "entry", entry)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_build, "launches", type(_build.launches)())
    monkeypatch.setattr(tfd, "_SCRATCH", {})
    Bq, Sq, Pq = 2, 2048, 64
    KD = HKV * D
    q = torch.zeros((Bq, H, D), dtype=torch.bfloat16)
    kn = torch.zeros((Bq, HKV, D), dtype=torch.bfloat16)
    cache = torch.zeros((Bq, Sq, KD), dtype=torch.bfloat16)
    pool = torch.zeros((Bq * Sq, KD), dtype=torch.bfloat16)
    sc = torch.zeros((Bq * Sq, HKV), dtype=torch.bfloat16)
    table = torch.arange(Bq * Sq // Pq, dtype=torch.int32).view(Bq, -1)
    pos = torch.tensor([5, 700], dtype=torch.int32)
    tfd._launch_rows("K5", q, kn, kn, cache, cache, pos, None, H, HKV, 0.1,
                     0.0)
    c8 = cache.to(torch.int8)
    tfd._launch_q8(q, kn, kn, (c8, c8, sc.view(Bq, Sq, HKV),
                               sc.view(Bq, Sq, HKV)), pos, H, HKV, 0.1, 0.0)
    for kid, kp in (("K8", pool), ("K9", pool.to(torch.int8)),
                    ("K10", pool[:, :KD // 2].to(torch.uint8).contiguous())):
        tfd._launch_paged(kid, q, kn, kn, kp, kp, None if kid == "K8" else sc,
                          None if kid == "K8" else sc, table, pos, H, HKV, Pq,
                          0.1, 0.0, D)
    rps, nsplit = tfd.decode_plan(Bq, HKV, Sq)
    assert {(args[-6], args[-5], args[-4]) for _, args in lib.calls} == {
        (D, nsplit, rps)}
    assert sources == {"flash_decode_wide" if D > 256 else "flash_decode"}
    assert "flash_decode_wide" in _build.SOURCES
    nc, dc = tfd.col_chunks(D)
    assert (nc, dc) == ((-(-D // 128), 128) if D > 512 else (1, D))
    assert (nc - 1) * dc < D <= nc * dc
    (acc, ml, tickets), _ = next(iter(tfd._SCRATCH.values()))
    units = Bq * HKV * -(-(H // HKV) // tfd.HEAD_GROUP) * nc
    assert acc.shape == (units, nsplit, tfd.HEAD_GROUP, dc)
    assert ml.shape == (units, nsplit, tfd.HEAD_GROUP, 2)
    assert tickets.shape == (units,) and not tickets.any()


def test_entry_points_are_cached_per_library(monkeypatch):
    """The narrow and wide flash-decode libraries export the same entry
    point names: `_build.entry` keeps one per (library, name), so a launch
    at head_dim 512 after one at 64 reaches the wide library's."""
    from types import SimpleNamespace

    from koboldcpp_tpu_torch.ops import _build

    libs = {s: SimpleNamespace(k5_flash_decode=object())
            for s in ("flash_decode", "flash_decode_wide")}
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build, "load", lambda source, sigs: libs[source])
    got = [_build.entry(tfd._source(D), "k5_flash_decode", [])
           for D in (64, 512, 64, 640)]
    assert [g[0] for g in got] == [libs["flash_decode"],
                                   libs["flash_decode_wide"],
                                   libs["flash_decode"],
                                   libs["flash_decode_wide"]]
    assert got[1][1] is libs["flash_decode_wide"].k5_flash_decode


def _plan_bytes(kind: int, D: int) -> int:
    """A block's shared memory in csrc/flash_decode.cu (`Plan`): the Q
    tile and this step's rows (none past 512), then the larger of the tile
    stages (past 512: two pieces of 128 columns, K10's as int8 codes, each
    beside 16 rows of Q's same 128 columns, and two tiles' scales) and the
    combine plus the merge's tables, at 64, 32 or 16 rows a tile."""
    def head(k, d):
        return {0: 2 * d, 1: d, 2: d, 3: d // 2, 4: 4 * d}[k]
    stream = D > 512
    Dp = -(-D // 16) * 16
    dc = 128 if stream else D
    hp = (head(2 if kind == 3 else kind, 128) if stream
          else head(kind, Dp)) + 16
    qp = 2 * (128 if stream else Dp) + 16
    q_bytes = 0 if stream else 16 * qp + -(-4 * D // 16) * 16
    merge = (2 * 256 * 16 * 4 + 16 * 2 * 4 + 16 * 4 + 16
             + (0 if stream else 2 * D * 8))
    for tr in (64, 32, 16):
        stage = tr * hp + 16 * qp if stream else 2 * tr * hp + 2 * tr * 4
        nst = 2 if 2 * stage <= 96 * 1024 else 1
        comb = (tr // 16) * 16 * dc * 4 + (tr // 16) * 16 * 8 + 16 * dc * 4 + 128
        total = q_bytes + max(nst * stage + (16 * tr if stream else 0),
                              comb + merge)
        if total <= 232448:
            break
    return total


def test_max_head_dim_is_the_widest_plan_that_fits():
    """No head_dim is too wide any more: a block's plan (a replica of
    `Plan`) fits its 227 KB for every cache kind (K10 at even head_dims)
    at every head_dim, since past 512 (the streamed instance) Q's rows
    stream in the same pieces of 128 columns as K's and V's and the plan's
    bytes no longer depend on the head_dim. The old limits (1024, 4800),
    the 1.1B's 64 and 4864 past the last limit fit."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(tfd.__file__), "..", "csrc",
                            "flash_decode.cu")).read()
    assert "MAXD" not in src and not hasattr(tfd, "MAX_HEAD_DIM")
    assert int(re.search(r"constexpr int DCH = (\d+);", src).group(1)) \
        == tfd.COL_CHUNK

    def fits(D):
        return all(_plan_bytes(k, D) <= 232448 for k in range(5)
                   if not (k == 3 and D % 2))
    assert all(fits(D) for D in range(1, 4097))
    assert all(fits(D) for D in (4800, 4864, 8192, 65536, 1 << 20))
    # past 512 the plan is the same at every head_dim
    for k in range(5):
        assert len({_plan_bytes(k, D) for D in (514, 4864, 1 << 20)}) == 1
