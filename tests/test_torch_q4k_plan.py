"""`q4k_plan`, the tiling of the int8-activation K1 / K7 / K17a body
(csrc/q4k_matvec.cu), on the CPU: at every (T, out_f, in_f) that
`matmul_packed` sends to K1 / K7 with int8 activations (the
TinyLlama-1.1B's projections and head, the committed fixtures' in_f-512
projection, 7B-, 8B- and 70B-class widths, every T the dispatch's
`_q45_i8` admits), the persistent grid takes every 16-row tile exactly
once, the K steps give every superblock to exactly one warp, the shared
memory fits a block and holds the T x in_f x codes, nothing of the
summation order depends on T, and a shape the kernel does not take
raises. Then the wrapper, driven with CPU tensors and a recording library
in place of the CUDA one: one launch per matvec with the plan's grid and
shared memory, and y its only allocation."""
from __future__ import annotations

import pytest
import torch

from koboldcpp_tpu_torch.models.synthetic import rand_q4k, rand_q5k
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import quant_matmul as qm

# (out_f, in_f): the 1.1B's wqkv, w_gateup, wo, w_down and output head; the
# fixtures' ffn_down (their other projections have in_f 256: bf16 x);
# Llama-2-7B, Llama-3-8B and Llama-2/3-70B projections and heads
SHAPES = ((2560, 2048), (11264, 2048), (2048, 2048), (2048, 5632),
          (32000, 2048), (256, 512),
          (12288, 4096), (22016, 4096), (4096, 4096), (4096, 11008),
          (6144, 4096), (28672, 4096), (4096, 14336), (128256, 4096),
          (10240, 8192), (57344, 8192), (8192, 8192), (8192, 28672),
          (128256, 8192))
SMS = 132


def _i8_ts(in_f: int) -> list[int]:
    """The T the dispatch sends to K1 (T=1) / K7 with int8 activations."""
    return [T for T in range(1, 9) if in_f >= 512 and qm._q45_i8(in_f, T)]


def _blocks_tiles(plan) -> list[list[int]]:
    """The tiles each block of the persistent grid walks."""
    return [list(range(b, plan.tiles, plan.grid)) for b in range(plan.grid)]


def test_every_shape_has_an_int8_call():
    """The widest in_f reach K1 at T=1 only; the 1.1B's every T."""
    assert _i8_ts(28672) == [1] and _i8_ts(14336) == [1, 2]
    assert _i8_ts(2048) == list(range(1, 9))
    assert _i8_ts(5632) == list(range(1, 9))


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("out_f,in_f", SHAPES)
def test_plan_covers_rows_and_superblocks(out_f, in_f, q5):
    plans = {T: qm.q4k_plan(T, out_f, in_f, q5) for T in _i8_ts(in_f)}
    assert plans
    nsb = in_f // 256
    for T, plan in plans.items():
        # 16-row tiles, each taken by exactly one block, every block busy
        assert plan.rows == 16 and plan.tiles * plan.rows == out_f
        walked = sorted(t for ts in _blocks_tiles(plan) for t in ts)
        assert walked == list(range(plan.tiles))
        assert all(_blocks_tiles(plan))
        assert 1 <= plan.grid <= min(plan.tiles, 2 * SMS)
        assert plan.grid % 2 == 0  # clusters of two blocks share the prep
        # K step k gives superblock 8k + w to warp w: each exactly once
        taken = [8 * k + w for k in range(plan.ksteps) for w in range(8)
                 if 8 * k + w < nsb]
        assert taken == list(range(nsb))
        assert (plan.ksteps - 1) * 8 < nsb <= plan.ksteps * 8
        assert plan.stages == 4
        # the shared memory fits a block (and two where the grid says so)
        assert plan.smem == qm.q4k_layout(q5, T, in_f)["total"] <= qm.SMEM_MAX
        if plan.grid > SMS:
            assert 2 * (plan.smem + 1024) <= 233472
    # the order of every (row, token)'s sums: the same at every T
    assert len({(p.rows, p.tiles, p.ksteps, p.stages)
                for p in plans.values()}) == 1


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("T", range(1, 9))
def test_layout_holds_the_x_codes(T, q5):
    """The x image holds T x in_f codes (rows of in_f + 64 bytes), the
    scales one float2 per group and token pair, the group sums T x in_f/32
    bf16, every region 16-byte aligned, at the widest in_f the dispatch
    sends at this T."""
    in_f = max(f for f in (512, 2048, 4096, 5632, 8192, 11008, 14336, 28672)
               if T in _i8_ts(f))
    lay = qm.q4k_layout(q5, T, in_f)
    assert lay["prep"] - lay["x"] == T * (in_f + 64) >= T * in_f
    assert lay["sums"] - lay["prep"] == (in_f // 32) * -(-T // 2) * 8
    assert lay["part"] - lay["sums"] == T * (in_f // 32) * 2
    assert lay["total"] - lay["part"] >= 2 * 8 * 16 * 8 * 4
    assert lay["x"] == 4 * lay["stage"]
    assert all(v % 16 == 0 for v in lay.values())
    assert lay["total"] <= qm.SMEM_MAX


@pytest.mark.parametrize("T,out_f,in_f", (
    (0, 2048, 2048), (9, 2048, 2048), (1, 2048, 384), (1, 2000, 2048),
    (1, 2048, 0), (8, 2048, 24576), (2, 2048, 131072)))
def test_plan_refuses_other_shapes(T, out_f, in_f):
    """A T or width the kernel does not take; at T >= 2 an x too wide for
    a block (the dispatch's `_q45_i8` sends none: x goes in windows at T = 1
    only, tests/test_torch_windows.py)."""
    with pytest.raises(ValueError):
        qm.q4k_plan(T, out_f, in_f)


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("in_f", (131072, 262144))
def test_plan_takes_t1_widths_in_windows(in_f, q5):
    """T = 1 at a width whose x does not fit a block: x in windows of kwin
    K steps, the widest that lets two blocks share an SM; each window's
    codes fit (rows of its columns + 64 bytes)."""
    plan = qm.q4k_plan(1, 2048, in_f, q5)
    assert 1 <= plan.kwin < plan.ksteps == in_f // 2048
    cols = plan.kwin * 2048
    assert plan.smem == qm.q4k_layout(q5, 1, cols)["total"] <= qm.SMEM_MAX
    assert 2 * (plan.smem + 1024) <= 233472 and plan.grid == 128
    # one K step more would not have fit two blocks an SM
    wider = qm.q4k_layout(q5, 1, cols + 2048)["total"]
    assert 2 * (wider + 1024) > 233472


class _FakeLib:
    """Records each entry point's arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.mark.parametrize("maker,T", ((rand_q4k, 1), (rand_q4k, 8),
                                     (rand_q5k, 3)))
def test_wrapper_launches_once_with_the_plan(monkeypatch, maker, T):
    """The int8 body: one launch (no prep launch) with the plan's grid and
    shared memory, T, out_f and in_f; y (T, out_f) is its one
    allocation."""
    import numpy as np

    lib = _FakeLib()
    monkeypatch.setattr(_build, "entry",
                        lambda source, name, argtypes: (lib, getattr(lib, name)))
    monkeypatch.setattr(_build, "load", lambda source, sigs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    out_f, in_f = 256, 512
    qt = maker(np.random.default_rng(0), out_f, in_f)
    x = torch.zeros((T, in_f), dtype=torch.bfloat16)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: made.append(a) or empty(*a, **k))
    y = qm._q4k_launch(x, qt, True, "K7")
    assert y.shape == (T, out_f) and y.dtype == torch.bfloat16
    assert len(made) == 1
    plan = qm.q4k_plan(T, out_f, in_f, qt.kind == "q5_k")
    assert [name for name, _ in lib.calls] == ["k1_q4k_i8"]
    args = lib.calls[0][1]
    assert args[6:11] == (T, out_f, in_f, plan.grid, plan.smem)
    assert (args[1] is None) == (qt.kind == "q4_k")  # qh: q5_k only


def test_trace_tool_finds_its_anchors():
    """`tools/trace_q4k.py` stamps the kernel source at six anchors; an
    edit of the source that moves one makes it raise on the card, so hold
    them here."""
    import os

    from koboldcpp_tpu_torch.ops import _build
    from koboldcpp_tpu_torch.tools import trace_q4k

    with open(os.path.join(_build.CSRC, "q4k_matvec.cu")) as f:
        src = trace_q4k.instrumented(f.read())
    assert src.count("TRACE(") == len(trace_q4k._STAMPS) + 1
