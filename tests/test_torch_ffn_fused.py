"""K15, the FFN megakernel (KCPP_FFN_FUSED=1): the port's `ffn_fused` (its
plain versions on the CPU) against the JAX package's `ffn_fused` (Pallas in
interpret mode), both declining the same FFNs, and the port's `_ffn` against
the JAX `_ffn`, on the shape of tests/test_ffn_fused.py (C = 512, F = 768)
and the same GGUF Q4_K bytes."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.ops import ffn_fused as jffn
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import ffn_fused as tffn
from koboldcpp_tpu_torch.ops import linear as tlinear

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

C, F = 512, 768


def _q(w, t=GGMLType.Q4_K):
    raw = quants.quantize(w, t)
    return (jlinear.from_gguf(raw, t, w.shape, packed=True),
            tlinear.from_gguf(raw, t, w.shape, packed=True))


def make_pair(seed=0, down=GGMLType.Q4_K):
    """JAX and port QTensors of the same w_gateup (2F, C) and w_down (C, F)
    bytes (tests/test_ffn_fused.py:make_pair's draws)."""
    rng = np.random.default_rng(seed)
    wgu = (rng.standard_normal((2 * F, C)) * 0.1).astype(np.float32)
    wdn = (rng.standard_normal((C, F)) * 0.1).astype(np.float32)
    (jgu, tgu), (jdn, tdn) = _q(wgu), _q(wdn, down)
    return jgu, jdn, tgu, tdn


def _x(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape) * 0.5
    return torch.from_numpy(x.astype(np.float32)).bfloat16()


def _jnp(x):
    return jnp.asarray(x.float().numpy(), jnp.bfloat16)


@pytest.mark.parametrize("shape", [(1, C), (2, C), (8, C), (1, 1, C)],
                         ids=["T1", "T2", "T8", "lead1x1"])
def test_ffn_fused_plain_matches_jax(shape, monkeypatch):
    """T = 1 (K15b: the magic-number row math in both phases) and T = 2, 8
    (K15a: bf16(q s) weights): both sides feed gate/up to the SwiGLU in f32
    and down bf16(a) with bf16(sum a) group sums; sums run in other orders
    and the bf16 outputs differ by rounding steps. Tolerance 1e-2 * max |y|
    (JAX's own test allows 0.03 against the float reference); measured at
    most 2^-7 * max |y| (asserted)."""
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    jgu, jdn, tgu, tdn = make_pair(seed=len(shape) + shape[0])
    x = _x(shape, seed=shape[0])
    want = jffn.ffn_fused(_jnp(x), jgu, jdn)
    assert want is not None
    want = np.asarray(want.astype(jnp.float32))
    _build.launches.clear()
    got = tffn.ffn_fused(x, tgu, tdn)
    assert got is not None and tuple(got.shape) == shape
    assert got.dtype == torch.bfloat16
    assert sum(_build.launches.values()) == 0  # the plain version
    scale = np.abs(want).max()
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * scale
    assert err <= 2 ** -7 * scale


def test_ffn_fused_rows_depend_on_their_token_alone():
    """K15a's rows are independent: a token's output is the same at T = 8
    as among other tokens at T = 3."""
    _, _, tgu, tdn = make_pair(seed=4)
    x = _x((8, C), seed=5)
    y = tffn.ffn_fused_plain(x, tgu, tdn)
    y3 = tffn.ffn_fused_plain(x[[6, 2, 0]].contiguous(), tgu, tdn)
    assert torch.equal(y3, y[[6, 2, 0]])


@pytest.mark.parametrize("case", ["env_unset", "T16", "q6_k_down",
                                  "F_not_256", "env_T9"])
def test_ffn_fused_declines_where_jax_does(case, monkeypatch):
    """None on both sides: KCPP_FFN_FUSED unset, T = 16 (> FUSED_MAX_T),
    a q6_k w_down, F % 256 != 0 (q4_k tensors relabelled to F = 640: both
    decline on the shapes before reading a field), and T = 9."""
    monkeypatch.setenv("KCPP_FFN_FUSED", "1")
    T, down = 1, GGMLType.Q4_K
    if case == "env_unset":
        monkeypatch.delenv("KCPP_FFN_FUSED")
    elif case == "T16":
        T = 16
    elif case == "env_T9":
        T = 9
    elif case == "q6_k_down":
        down = GGMLType.Q6_K
    jgu, jdn, tgu, tdn = make_pair(seed=1, down=down)
    if case == "F_not_256":
        for qt, shape in ((jgu, (1280, C)), (tgu, (1280, C)),
                          (jdn, (C, 640)), (tdn, (C, 640))):
            qt.shape = shape
    x = _x((T, C), seed=2)
    assert jffn.ffn_fused(_jnp(x), jgu, jdn) is None
    assert tffn.ffn_fused(x, tgu, tdn) is None


def test_ffn_fused_tile_rule_mirrors_jax():
    """The VMEM-budget rule that picks the JAX kernel's row tiles (and so
    whether it declines) is shape arithmetic: the port's `_tiles` gives the
    same answer, declines included, over model widths."""
    import inspect

    src = inspect.getsource(jffn)
    assert "_VMEM_BUDGET = 12 * 1024 * 1024" in src
    for T, c, f in [(1, 2048, 5632), (8, 2048, 5632), (1, 4096, 11008),
                    (8, 4096, 11008), (1, 8192, 28672), (4, 8192, 28672),
                    (1, 5120, 13824), (8, 5120, 13824), (2, 3072, 8192)]:
        got = tffn._tiles(T, c, f)
        # the JAX decision, read off its batched / T=1 branches: stub the
        # call and catch the tiles it would use
        seen = []

        def call(x, gu, dn, C, F, rtg, rtd, interpret):
            seen.append((rtg, rtd))
            return jnp.zeros((x.shape[0], C), jnp.bfloat16)

        class Q:
            def __init__(self, shape):
                self.kind, self.shape = "q4_k", shape
                self.data = {n: None for n in jffn._MATVEC_FIELDS_Q4K
                             + jffn._FIELD_LISTS["q4_k"]}

        mp = pytest.MonkeyPatch()
        mp.setenv("KCPP_FFN_FUSED", "1")
        mp.setattr(jffn, "QTensor", Q)
        mp.setattr(jffn, "_ffn_fused_call", call)
        mp.setattr(jffn, "_ffn_fused_call_2d", call)
        try:
            out = jffn.ffn_fused(jnp.zeros((T, c), jnp.bfloat16),
                                 Q((2 * f, c)), Q((c, f)))
        finally:
            mp.undo()
        assert (out is None) == (got is None), (T, c, f)
        assert seen == ([] if got is None else [got]), (T, c, f)


def test_ffn_matches_jax_ffn(monkeypatch):
    """The port's `_ffn` against the JAX `_ffn` with KCPP_FFN_FUSED=1 at T
    = 1 and 8 (both take their megakernel) and with the env unset (both
    compose K1 / K7 and the SwiGLU): within 1e-2 * max |y|."""
    jgu, jdn, tgu, tdn = make_pair(seed=9)
    for env, T in (("1", 1), ("1", 8), (None, 8)):
        if env is None:
            monkeypatch.delenv("KCPP_FFN_FUSED", raising=False)
        else:
            monkeypatch.setenv("KCPP_FFN_FUSED", env)
        x = _x((1, T, C), seed=T)
        want = np.asarray(jllama._ffn(_jnp(x), {
            "w_gateup": jgu, "w_down": jdn}).astype(jnp.float32))
        got = tllama._ffn(x, {"w_gateup": tgu, "w_down": tdn}).float().numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-2 * scale, (env, T)
