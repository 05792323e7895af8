"""`sbq_plan`, the tiling of K14 (csrc/q4k_sbq.cu, the KCPP_SBQ=1 q4_k /
q5_k matvec at 2 <= T <= 16), and `ffn_plan`, that of K15a
(csrc/ffn_fused.cu, the fused q4_k FFN at 2 <= T <= 8), on the CPU: at
the TinyLlama-1.1B's, the fixtures' and 7B- to 405B-class shapes and every
T the dispatch sends, the persistent grid takes every 16-row tile exactly
once (K14: the two blocks of a cluster the two tiles of a pair, as many
each), the K steps give every superblock to exactly one warp, K14's
windows of x cover every column once, the shared memory fits a block (two
where the grid says so), nothing of the summation order depends on T, and
a shape the kernel does not take raises. Then the wrappers, driven with
tensors that report a CUDA device and a recording library in place of the
CUDA one: one launch each with the plan's arguments, and K14's y its only
allocation; and the trace tool's anchors in both sources."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from koboldcpp_tpu_torch.models.synthetic import rand_q4k, rand_q5k
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import ffn_fused as ff
from koboldcpp_tpu_torch.ops import quant_matmul as qm

# (out_f, in_f) that reach K14 (in_f >= 2048): the 1.1B's wqkv, w_gateup,
# wo, w_down and head; Llama-2-7B and Llama-3-8B projections and heads;
# Llama-3-70B's wqkv, w_gateup and w_down; Llama-3.1-405B's wo, w_gateup
# and w_down
SBQ_SHAPES = ((2560, 2048), (11264, 2048), (2048, 2048), (2048, 5632),
              (32000, 2048),
              (12288, 4096), (22016, 4096), (4096, 4096), (4096, 11008),
              (6144, 4096), (28672, 4096), (4096, 14336), (128256, 4096),
              (10240, 8192), (57344, 8192), (8192, 28672),
              (16384, 16384), (106496, 16384), (16384, 53248))
# (C, F): the 1.1B's FFN, the committed fixtures' (hidden 256, ffn 512),
# Llama-2-7B's and Llama-3-8B's
FFN_SHAPES = ((2048, 5632), (256, 512), (4096, 11008), (4096, 14336))
SMS = 132
SMEM_PER_SM = 233472


def _units_tiles(tiles: int, units: int) -> list[list[int]]:
    """The tiles each block of a persistent grid of `units` walks."""
    return [list(range(u, tiles, units)) for u in range(units)]


def _pair_tiles(tiles: int, grid: int) -> list[list[int]]:
    """The tiles each block of K14's grid walks: cluster p takes the pairs
    of tiles p, p + grid / 2, ..., its block r tile 2 * pair + r of each."""
    return [[2 * q + b % 2 for q in range(b // 2, tiles // 2, grid // 2)]
            for b in range(grid)]


def test_sbq_takes_every_t_at_the_1_1b_widths():
    """Every T of 2..16 at the 1.1B's widths, x whole; at the widest
    in_f too, through x's windows."""
    for in_f in (2048, 5632):
        for T in range(2, 17):
            for q5 in (False, True):
                plan = qm.sbq_plan(T, 2048, in_f, q5)
                assert plan.kwin == plan.ksteps
    for in_f in (14336, 16384, 28672, 53248, 131072):
        for T in range(2, 17):
            assert qm.sbq_plan(T, 4096, in_f).kwin >= 1


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("out_f,in_f", SBQ_SHAPES)
def test_sbq_plan_covers_rows_and_superblocks(out_f, in_f, q5):
    plans = {T: qm.sbq_plan(T, out_f, in_f, q5) for T in range(2, 17)}
    nsb = in_f // 256
    for T, plan in plans.items():
        assert plan.ntiles_n == (2 if T > 8 else 1)
        assert plan.rows == 16 and plan.tiles * plan.rows == out_f
        # both blocks of a cluster walk as many tiles (they meet at every
        # window's barriers), and every tile is walked once
        walks = _pair_tiles(plan.tiles, plan.grid)
        assert sorted(t for ts in walks for t in ts) == list(range(plan.tiles))
        assert all(walks)
        assert all(len(walks[b]) == len(walks[b ^ 1])
                   for b in range(plan.grid))
        assert plan.grid % 2 == 0 and plan.grid >= 2  # clusters of two
        assert plan.grid <= plan.tiles
        assert plan.grid <= 2 * SMS
        if q5 and plan.ntiles_n == 2:  # the two-tile q5_k body's registers
            assert plan.grid <= SMS
        taken = [8 * k + w for k in range(plan.ksteps) for w in range(8)
                 if 8 * k + w < nsb]
        assert taken == list(range(nsb))
        # the windows of x: kwin K steps each, the last one narrower,
        # every column once; the prep's (token, group) tasks below 2^13
        assert 1 <= plan.kwin <= plan.ksteps
        cols = min(in_f, plan.kwin * 8 * 256)
        wins = [(c, min(cols, in_f - c)) for c in range(0, in_f, cols)]
        assert len(wins) == -(-plan.ksteps // plan.kwin)
        assert sum(w for _, w in wins) == in_f
        assert all(w % 256 == 0 for _, w in wins)
        assert T * (cols // 32) < 8192
        assert plan.stages in (3, 4)
        lay = qm.sbq_layout(q5, T, cols, plan.stages)
        assert plan.smem == lay["total"] <= qm.SMEM_MAX
        if plan.grid > SMS:
            assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    # the order of every (row, token)'s sums: tile, K step, warp and
    # superblock are the same at every T (the windows do not move it)
    assert len({(p.rows, p.tiles, p.ksteps) for p in plans.values()}) == 1
    # x whole at the 1.1B's widths; in windows where 16 tokens' codes of
    # every column do not fit (a 7B-class w_down and wider)
    if in_f <= 5632:
        assert all(p.kwin == p.ksteps for p in plans.values())
    if in_f >= 11008:
        assert plans[16].kwin < plans[16].ksteps
    assert plans[2].kwin == plans[2].ksteps


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("T", range(2, 17))
def test_sbq_layout_holds_the_x_codes(T, q5):
    """The x image holds T x cols codes (rows of cols + 64 bytes), the
    scales one float2 per 128-column segment and token pair, the group sums
    T x cols/32 bf16, the partial sums a float per (token of each N tile,
    warp, row), every region 16-byte aligned, at the 1.1B's widest in_f,
    at 14336 and at one K step's window (2048 columns)."""
    for cols in (2048, 5632, 14336):
        for stages in (3, 4):
            lay = qm.sbq_layout(q5, T, cols, stages)
            assert lay["prep"] - lay["x"] == T * (cols + 64)
            assert lay["sums"] - lay["prep"] == (cols // 128) * -(-T // 2) * 8
            assert lay["part"] - lay["sums"] == T * (cols // 32) * 2
            assert lay["total"] - lay["part"] == \
                (16 if T > 8 else 8) * (8 * 16 + 4) * 4
            assert lay["x"] == stages * lay["stage"]
            assert lay["stage"] == 16 * (1024 + 240 + (272 if q5 else 0))
            assert all(v % 16 == 0 for v in lay.values())


@pytest.mark.parametrize("T,out_f,in_f", (
    (1, 2048, 2048), (17, 2048, 2048), (2, 2048, 384), (2, 2000, 2048),
    (2, 2048, 0), (16, 2048, 16000), (2, 2016, 131072)))
def test_sbq_plan_refuses_other_shapes(T, out_f, in_f):
    with pytest.raises(ValueError):
        qm.sbq_plan(T, out_f, in_f)


@pytest.mark.parametrize("q5", (False, True))
@pytest.mark.parametrize("T", (2, 6, 8, 9, 16))
def test_sbq_plan_takes_a_70b_w_down(T, q5):
    """Llama-3-70B's w_down (8192, 28672): 16 tokens' codes of every column
    (460 KB) do not fit a block, so x goes in windows; T = 6 and up no
    longer fit x whole either."""
    plan = qm.sbq_plan(T, 8192, 28672, q5)
    assert plan.ksteps == 14 and plan.tiles == 512
    assert (plan.kwin < plan.ksteps) == (T >= 6)
    cols = min(28672, plan.kwin * 2048)
    assert T * (cols + 64) <= plan.smem <= qm.SMEM_MAX


@pytest.mark.parametrize("C,F", FFN_SHAPES)
def test_ffn_plan_covers_both_phases(C, F):
    plans = {T: ff.ffn_plan(T, C, F) for T in range(2, 9)}
    for T, plan in plans.items():
        assert plan.tiles1 * 16 == 2 * F and plan.tiles3 * 16 == C
        for tiles, ksteps, in_f in ((plan.tiles1, plan.ksteps1, C),
                                    (plan.tiles3, plan.ksteps3, F)):
            walks = _units_tiles(tiles, plan.grid)
            assert sorted(t for ts in walks for t in ts) == list(range(tiles))
            nsb = in_f // 256
            taken = [8 * k + w for k in range(ksteps) for w in range(8)
                     if 8 * k + w < nsb]
            assert taken == list(range(nsb))
        # every block resident (a cooperative launch): at most two an SM,
        # two only where the shared memory allows
        assert plan.stages in (3, 4)
        assert 1 <= plan.grid <= max(plan.tiles1, plan.tiles3)
        assert plan.grid <= 2 * SMS
        assert plan.smem == ff.ffn_layout(T, C, plan.stages)["total"]
        assert plan.smem <= 232448
        if plan.grid > SMS:
            assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
        lay = ff.ffn_layout(T, C, plan.stages)
        assert lay["xi"] == plan.stages * lay["stage"]
        assert lay["xs"] - lay["xi"] == T * (2 * C + 16)
        assert lay["part"] - lay["xs"] == T * (C // 32) * 2
        assert all(v % 16 == 0 for v in lay.values())
    # tiles and K steps: the same at every T
    assert len({(p.tiles1, p.ksteps1, p.tiles3, p.ksteps3)
                for p in plans.values()}) == 1
    # a card of fewer SMs gets a grid that stays resident
    assert ff.ffn_plan(8, C, F, sms=114).grid <= 2 * 114


@pytest.mark.parametrize("T,C,F", ((0, 2048, 5632), (9, 2048, 5632),
                                   (2, 2000, 5632), (2, 2048, 5600),
                                   (2, 0, 512)))
def test_ffn_plan_refuses_other_shapes(T, C, F):
    with pytest.raises(ValueError):
        ff.ffn_plan(T, C, F)


class _FakeLib:
    """Records each entry point's arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _fake_build(monkeypatch) -> _FakeLib:
    lib = _FakeLib()
    monkeypatch.setattr(_build, "entry",
                        lambda source, name, argtypes: (lib, getattr(lib, name)))
    monkeypatch.setattr(_build, "load", lambda source, sigs: lib)
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    return lib


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel's branch (the recording library stands in for the kernel)."""
    is_cuda = True


@pytest.mark.parametrize("maker,T,in_f", ((rand_q4k, 2, 2048),
                                          (rand_q4k, 16, 2048),
                                          (rand_q5k, 9, 2048),
                                          (rand_q4k, 16, 28672)))
def test_sbq_wrapper_launches_once_with_the_plan(monkeypatch, maker, T,
                                                 in_f):
    """One launch (no prep launch) with the plan's grid, stages, window and
    shared memory; y (T, out_f) is its one allocation; one count."""
    lib = _fake_build(monkeypatch)
    monkeypatch.setattr(_build, "launches", type(_build.launches)())
    out_f = 256
    qt = maker(np.random.default_rng(0), out_f, in_f)
    x = torch.zeros((T, in_f), dtype=torch.bfloat16).as_subclass(_OnCard)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: made.append(a) or empty(*a, **k))
    y = qm.q4k_matvec_sbq(x, qt)
    assert y.shape == (T, out_f) and y.dtype == torch.bfloat16
    assert len(made) == 1
    plan = qm.sbq_plan(T, out_f, in_f, qt.kind == "q5_k")
    assert [name for name, _ in lib.calls] == ["k14_sbq"]
    args = lib.calls[0][1]
    assert args[7:14] == (T, out_f, in_f, plan.grid, plan.stages, plan.kwin,
                          plan.smem)
    assert (args[1] is None) == (qt.kind == "q4_k")  # qh: q5_k only
    assert dict(_build.launches) == {
        "K14" if qt.kind == "q4_k" else "K14.q5_k": 1}


@pytest.mark.parametrize("T", (1, 2, 8))
def test_ffn_wrapper_launches_once(monkeypatch, T):
    """K15b at T = 1, K15a above, each with `ffn_plan`'s grid, stages,
    shared memory and window: one launch each."""
    lib = _fake_build(monkeypatch)
    C, F = 256, 512
    rng = np.random.default_rng(1)
    gu, dn = rand_q4k(rng, 2 * F, C), rand_q4k(rng, C, F)
    x = torch.zeros((T, C), dtype=torch.bfloat16)
    y = ff._ffn_launch(x, gu, dn, 100)
    assert y.shape == (T, C) and y.dtype == torch.bfloat16
    assert len(lib.calls) == 1
    name, args = lib.calls[0]
    plan = ff.ffn_plan(T, C, F, 100)
    assert name == "k15_ffn" and args[12:14] == (C, F)
    assert args[11:18] == (T, C, F, plan.grid, plan.stages, plan.smem,
                           plan.kwin)


@pytest.mark.parametrize("source,stamps", (("q4k_sbq.cu", "_SBQ_STAMPS"),
                                           ("ffn_fused.cu", "_FFN_STAMPS")))
def test_trace_tool_finds_its_anchors(source, stamps):
    """`tools/trace_q4k.py --kernel K14 | K15a` stamps the kernel source at
    its anchors; an edit of the source that moves one makes it raise on the
    card, so hold them here."""
    from koboldcpp_tpu_torch.tools import trace_q4k

    with open(os.path.join(_build.CSRC, source)) as f:
        src = trace_q4k.instrumented(f.read(), getattr(trace_q4k, stamps))
    assert src.count("TRACE(") == len(getattr(trace_q4k, stamps)) + 1
