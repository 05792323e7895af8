"""`rowmv_plan`, the tiling of the K2 / K12 / K17b body (csrc/rowmv.cuh:
the q6_k, q2_k and q3_k T=1 matvecs), on the CPU: at the TinyLlama-1.1B's
five shapes, the committed fixtures' (256-1024) and a 70B-class w_down and
head, with int8 and with bf16 activations, the persistent grid takes every
16-row tile exactly once, the K steps give every superblock to exactly one
warp, the shared memory fits a block (two where the grid counts on two an
SM), nothing of the summation order depends on the activation variant or
the ring's depth, and a shape the kernel does not take raises. Then the
wrapper, driven with CPU tensors and a recording library in place of the
CUDA one: one launch per matvec (no prep launch) with the plan's grid,
stages and shared memory, and y its only allocation. Last, the bf16-x
bodies under KCPP_MM_I8=0 at in_f 1024 and 2048 against the JAX package's
`matmul_packed` (interpret mode) on the same GGUF bytes."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.gguf import GGMLType, quants
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import quant_matmul as jqm
from koboldcpp_tpu_torch.models.synthetic import rand_q2k, rand_q3k, rand_q6k
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

# (out_f, in_f): the 1.1B's wqkv, w_gateup, wo, w_down and output head;
# the fixtures' projections and heads; a 70B-class w_down and head
SHAPES = ((2560, 2048), (11264, 2048), (2048, 2048), (2048, 5632),
          (32000, 2048), (512, 256), (256, 256), (256, 512), (768, 256),
          (256, 1024), (8192, 28672), (128256, 8192))
SMS = 132
SMEM_PER_SM = 233472
MAKERS = {"q6_k": rand_q6k, "q2_k": rand_q2k, "q3_k": rand_q3k}


def _blocks_tiles(plan) -> list[list[int]]:
    """The tiles each block of the persistent grid walks."""
    return [list(range(b, plan.tiles, plan.grid)) for b in range(plan.grid)]


@pytest.mark.parametrize("i8", (True, False))
@pytest.mark.parametrize("kind", qm.ROWMV_KINDS)
@pytest.mark.parametrize("out_f,in_f", SHAPES)
def test_plan_covers_rows_and_superblocks(out_f, in_f, kind, i8):
    plan = qm.rowmv_plan(kind, out_f, in_f, i8)
    nsb = in_f // 256
    # 16-row tiles, each taken by exactly one block, every block busy
    assert plan.rows == 16 and plan.tiles * plan.rows == out_f
    walked = sorted(t for ts in _blocks_tiles(plan) for t in ts)
    assert walked == list(range(plan.tiles))
    assert all(_blocks_tiles(plan))
    assert 1 <= plan.grid <= min(plan.tiles, 2 * SMS)
    # K step k gives superblock 8k + w to warp w: each exactly once
    taken = [8 * k + w for k in range(plan.ksteps) for w in range(8)
             if 8 * k + w < nsb]
    assert taken == list(range(nsb))
    assert (plan.ksteps - 1) * 8 < nsb <= plan.ksteps * 8
    # the ring keeps at least two stages in flight while one is read
    assert plan.stages in (3, 4)
    lay = qm.rowmv_layout(kind, in_f, i8, plan.stages)
    assert plan.smem == lay["total"] <= qm.SMEM_MAX
    if plan.grid > SMS:
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    # a deeper ring would have cost the second block of an SM
    if plan.stages == 3 and plan.grid > SMS:
        deeper = qm.rowmv_layout(kind, in_f, i8, 4)["total"]
        assert 2 * (deeper + 1024) > SMEM_PER_SM
    # the order of every row's sums: the same for both activation variants
    other = qm.rowmv_plan(kind, out_f, in_f, not i8)
    assert (other.rows, other.tiles, other.ksteps) == (
        plan.rows, plan.tiles, plan.ksteps)


@pytest.mark.parametrize("i8", (True, False))
@pytest.mark.parametrize("kind", qm.ROWMV_KINDS)
def test_layout_holds_x_and_the_sums(kind, i8):
    """The ring's stages, x prepped (in_f codes, or 2 in_f bytes of bf16
    x), sx per group (int8 only), xs per group and the partial sums, each
    region 16-byte aligned; a q6_k stage holds 16 rows of 8 superblocks of
    ql, qh and scale (~28.8 KiB), a q2_k / q3_k one ~16.8 KiB."""
    for in_f in (256, 2048, 5632, 28672):
        lay = qm.rowmv_layout(kind, in_f, i8, 3)
        per_row = {"q6_k": 128 + 64 + 32, "q2_k": 64 + 32 + 32,
                   "q3_k": 64 + 32 + 32}[kind] * 8
        assert 16 * per_row < lay["stage"] <= 16 * (per_row + 3 * 16)
        assert lay["x"] == 3 * lay["stage"]
        assert lay["sx"] - lay["x"] == (in_f if i8 else 2 * in_f)
        assert lay["xs"] - lay["sx"] == (in_f // 16 * 4 if i8 else 0)
        assert lay["part"] - lay["xs"] == in_f // 16 * 2
        assert lay["total"] - lay["part"] == 3 * 8 * 16 * 4
        assert all(v % 16 == 0 for v in lay.values())


@pytest.mark.parametrize("kind,out_f,in_f", (
    ("q4_k", 2048, 2048), ("q6_k", 2048, 384), ("q2_k", 2000, 2048),
    ("q3_k", 2048, 0), ("q6_k", 0, 2048), ("q6_k", 2048, 131072 + 128)))
def test_plan_refuses_other_shapes(kind, out_f, in_f):
    """A kind of another body, in_f or out_f off the grid (every in_f that
    is a multiple of 256 has a plan: tests/test_torch_windows.py)."""
    with pytest.raises(ValueError):
        qm.rowmv_plan(kind, out_f, in_f, True)


class _FakeLib:
    """Records each entry point's arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _record_launches(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(_build, "entry",
                        lambda source, name, argtypes: (lib, getattr(lib, name)))
    monkeypatch.setattr(_build, "load", lambda source, sigs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    return lib


@pytest.mark.parametrize("stacked", (False, True))
@pytest.mark.parametrize("i8", (True, False))
@pytest.mark.parametrize("kind", qm.ROWMV_KINDS)
def test_wrapper_launches_once_with_the_plan(monkeypatch, kind, i8, stacked):
    """One launch (no prep launch) with the plan's grid, stages and shared
    memory, the variant, out_f and in_f; y (1, out_f) is its one
    allocation. Stacked (K17b): the layer index's pointer and the
    per-layer element counts follow."""
    lib = _record_launches(monkeypatch)
    out_f, in_f, L = 256, 512, 2
    qt = MAKERS[kind](np.random.default_rng(0), (L if stacked else 1) * out_f,
                      in_f)
    li = None
    if stacked:
        qt = qm.QTensor(kind=kind, shape=(out_f, in_f), data={
            n: a.view(L, out_f, *a.shape[1:]) for n, a in qt.data.items()})
        li = torch.ones(1, dtype=torch.int32)
    x = torch.zeros(in_f, dtype=torch.bfloat16)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: made.append(a) or empty(*a, **k))
    launch = qm._q6k_launch if kind == "q6_k" else qm._q23k_launch
    y = launch(x, qt, i8, "K17b" if stacked else "K2", li)
    assert y.shape == (1, out_f) and y.dtype == torch.bfloat16
    assert len(made) == 1
    plan = qm.rowmv_plan(kind, out_f, in_f, i8)
    name = "k2_q6k_matvec" if kind == "q6_k" else "k12_q23k_matvec"
    assert [n for n, _ in lib.calls] == [name]
    args = lib.calls[0][1]
    off = 5  # K2: ql, qh, scale, x, y; K12: q3, qs, hmask, scale, min, x, y
    if kind != "q6_k":
        off = 7
        assert args[0] == int(kind == "q3_k")
        assert (args[2] is None) == (kind == "q2_k")  # hmask: q3_k only
        assert (args[4] is None) == (kind == "q3_k")  # min: q2_k only
    assert args[off:off + 6] == (out_f, in_f, int(i8), plan.grid,
                                 plan.stages, plan.smem)
    stack = args[off + 6:off + 12]
    if stacked:
        assert stack[0] == li.data_ptr()
        assert stack[1] == qt.data["ql" if kind == "q6_k" else "qs"][0].numel()
    else:
        assert stack == (None, 0, 0, 0, 0, 0)


def _pair(t, out_f, in_f, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((out_f, in_f)) * 0.1).astype(np.float32)
    raw = quants.quantize(w, t)
    return (jlinear.from_gguf(raw, t, (out_f, in_f), packed=True),
            tlinear.from_gguf(raw, t, (out_f, in_f), packed=True))


@pytest.mark.parametrize("t", (GGMLType.Q6_K, GGMLType.Q2_K, GGMLType.Q3_K),
                         ids=lambda t: t.name)
@pytest.mark.parametrize("in_f", (1024, 2048))
def test_bf16_x_bodies_match_jax(monkeypatch, t, in_f):
    """KCPP_MM_I8=0 at in_f >= 512: both packages take the bf16-activation
    T=1 body (`_q6k_row_kernel`, `_q2k_row_kernel`, `_q3k_row_kernel`;
    the port's plain K2 / K12 bf16 versions), the exact dot against JAX's
    magic-number kernel, which subtracts a bf16-rounded group sum: within
    2e-2 of max |y|, the tolerance of test_matvec_plain_matches_jax's bf16
    variant. The variable is read at the call, in both dispatches."""
    monkeypatch.setenv("KCPP_MM_I8", "0")
    jq, tq = _pair(t, 256, in_f)
    x = torch.from_numpy((np.random.default_rng(1).standard_normal(
        (1, in_f)) * 0.5).astype(np.float32)).bfloat16()
    want = np.asarray(jqm.matmul_packed(
        jnp.asarray(x.float().numpy(), jnp.bfloat16), jq).astype(jnp.float32))
    _build.launches.clear()
    got = qm.matmul_packed(x, tq)
    assert sum(_build.launches.values()) == 0  # the plain version
    fn = qm.q6k_matvec_plain if t == GGMLType.Q6_K else qm.q23k_matvec_plain
    assert torch.equal(got, fn(x[0], tq, False))  # the bf16 body
    assert not torch.equal(got, fn(x[0], tq, True))
    got = got.float().numpy()
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


def test_trace_tool_finds_its_anchors():
    """`tools/trace_q4k.py --kernel K2` stamps csrc/rowmv.cuh at six
    anchors; an edit of the source that moves one makes it raise on the
    card, so hold them here."""
    import os

    from koboldcpp_tpu_torch.tools import trace_q4k

    with open(os.path.join(_build.CSRC, "rowmv.cuh")) as f:
        src = trace_q4k.instrumented(f.read(), trace_q4k._ROWMV_STAMPS)
    assert src.count("TRACE(") == len(trace_q4k._ROWMV_STAMPS) + 1
