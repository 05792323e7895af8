"""x in windows: the T=1 matvec plans (`q4k_plan` for K1 / K17a,
`rowmv_plan` for K2 / K12 / K17b) and K15's `ffn_plan` at widths whose x
does not fit a block whole, on the CPU. Every in_f that is a multiple of
256 up to 262144 has a plan for every kind and body, the same plan as
before wherever x fits whole (kwin == ksteps); `ffn_plan` takes every
shape the JAX tile rule `_tiles` takes; the windows cover the K steps once;
the plain prep of x over the plan's windows, concatenated, is its prep over
the whole of x (each group's codes, scale and sum depend on its columns
alone), which is why a windowed call is the same bits as a whole one.
Then K15b's T = 1 plan, and the expanded layouts' kinds (q6_k_i8f /
q3_k_n4 / q2_k_n4) as `rowmv_plan` kinds: tiling, layout and the
wrapper's one launch."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from koboldcpp_tpu_torch.models.synthetic import _MAKERS
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import ffn_fused as ff
from koboldcpp_tpu_torch.ops import quant_matmul as qm

SMS = 132
SMEM_PER_SM = 233472
# every body of the T=1 matvecs: (plan kind, int8 x, scale group); q4_k /
# q5_k are `q4k_plan`'s, the rest `rowmv_plan`'s
BODIES = ([("q4_k", True, 0), ("q5_k", True, 0)]
          + [(k, i8, 0) for k in qm.ROWMV_KINDS + ("q8_0",)
             for i8 in (True, False)]
          + [(k, True, G) for k in qm.IQ_KINDS for G in (8, 16, 32)])


def _ids(b):
    kind, i8, G = b
    return f"{kind}-G{G}" if G else f"{kind}-{'i8' if i8 else 'bf16'}"


def _plan(body, out_f, in_f, kwin=0):
    kind, i8, G = body
    if kind in ("q4_k", "q5_k"):
        return qm.q4k_plan(1, out_f, in_f, kind == "q5_k", kwin)
    return qm.rowmv_plan(kind, out_f, in_f, i8, G, kwin)


def _span(kind: str) -> int:
    return 256 if kind in ("q4_k", "q5_k") else qm.rowmv_span(kind)


def _layout_total(body, cols, plan) -> int:
    kind, i8, G = body
    if kind in ("q4_k", "q5_k"):
        return qm.q4k_layout(kind == "q5_k", 1, cols)["total"]
    return qm.rowmv_layout(kind, cols, i8, plan.stages, G,
                           plan.xf32)["total"]


def _whole_fits(body, in_f) -> bool:
    """Whether x fits a block whole at some ring depth (the plan before
    windows took exactly these widths)."""
    kind, i8, G = body
    if kind in ("q4_k", "q5_k"):
        return qm.q4k_layout(kind == "q5_k", 1, in_f)["total"] <= qm.SMEM_MAX
    depths = qm.ROWMV_STAGES if kind in qm.ROWMV_KINDS else qm.ROWMVG_STAGES
    return min(qm.rowmv_layout(kind, in_f, i8, s, G)["total"]
               for s in depths) <= qm.SMEM_MAX


def _windows(plan, in_f: int, span: int) -> list[tuple[int, int]]:
    """(first column, columns) of each window of a tile's K steps."""
    step = qm.ROWMV_KS * span  # columns of one K step
    return [(k * step, min(plan.kwin * step, in_f - k * step))
            for k in range(0, plan.ksteps, plan.kwin)]


@pytest.mark.parametrize("body", BODIES, ids=_ids)
def test_every_width_has_a_plan(body):
    """Every in_f that is a multiple of 256 up to 262144 (out_f 256): a
    plan that fits a block, x whole (kwin == ksteps) wherever it fit
    before, else windows."""
    kind, i8, G = body
    for in_f in range(256, 262144 + 1, 256):
        if kind in qm.IQ_KINDS and in_f < 32 * G:
            continue  # the dispatch sends these to K13
        plan = _plan(body, 256, in_f)
        assert plan.ksteps == -(-(in_f // _span(kind)) // 8)
        assert 1 <= plan.kwin <= plan.ksteps
        assert plan.smem <= qm.SMEM_MAX
        assert (plan.kwin == plan.ksteps) == _whole_fits(body, in_f)


@pytest.mark.parametrize("in_f", (131072, 262144))
@pytest.mark.parametrize("body", BODIES, ids=_ids)
def test_wide_x_goes_in_windows(body, in_f):
    """At in_f 131072 and 262144: x whole where it fits a block (q8_0's
    int8 body and the IQ kinds at G = 16, 32 up to ~131K-174K), else
    windows of kwin K steps that start on K-step (so group) boundaries and
    cover every column once, the widest that keeps the plan's blocks an
    SM; the shared memory is a window's."""
    kind, i8, G = body
    plan = _plan(body, 4096, in_f)
    span = _span(kind)
    wins = _windows(plan, in_f, span)
    assert (plan.kwin == plan.ksteps) == _whole_fits(body, in_f)
    assert len(wins) > 1 or plan.kwin == plan.ksteps
    assert in_f < 262144 or len(wins) > 1
    assert sum(c for _, c in wins) == in_f
    assert all(c0 % (8 * span) == 0 and c > 0 for c0, c in wins)
    cols = wins[0][1]
    assert plan.smem == _layout_total(body, cols, plan)
    per_sm = 2 if plan.grid > SMS else 1
    assert per_sm * (plan.smem + 1024) <= SMEM_PER_SM
    assert plan.grid == min(plan.tiles, per_sm * SMS)


@pytest.mark.parametrize("body", BODIES, ids=_ids)
def test_forced_window(body):
    """The plan function's own `kwin` forces a window at a width that fits
    whole (as the card's bit-equality check does): the same tiling, the
    window's shared memory; kwin == ksteps is x whole."""
    kind, i8, G = body
    whole = _plan(body, 8192, 16384)
    assert whole.kwin == whole.ksteps > 3
    win = _plan(body, 8192, 16384, kwin=3)
    assert (win.rows, win.tiles, win.ksteps) == (whole.rows, whole.tiles,
                                                 whole.ksteps)
    assert win.kwin == 3
    assert win.smem == _layout_total(body, 3 * 8 * _span(kind), win)
    assert _plan(body, 8192, 16384, kwin=whole.ksteps) == whole
    with pytest.raises(ValueError):
        _plan(body, 8192, 16384, kwin=whole.ksteps + 1)


@pytest.mark.parametrize("body", BODIES + [("ffn", True, 32)], ids=_ids)
def test_windowed_prep_is_exact(body):
    """The plain prep of x (codes, scales and bf16 sums per group; bf16
    x: the sums) over the plan's windows, concatenated, equals its prep
    over the whole of x, at in_f 131072 (K15: its group sums per 32
    columns over the windows of a C = 26880, T = 3 FFN)."""
    kind, i8, G = body
    rng = np.random.default_rng(3)
    if kind == "ffn":
        T, C = 3, 26880
        plan = ff.ffn_plan(T, C, 1024)
        assert plan.kwin < plan.ksteps1
        x = torch.from_numpy(rng.standard_normal((T, C)).astype(
            np.float32)).bfloat16()
        wins = [(c0, min(plan.kwin * 2048, C - c0))
                for c0 in range(0, C, plan.kwin * 2048)]
        got = torch.cat([qm._group_sums(x[:, c0:c0 + c].contiguous(), 32)
                         for c0, c in wins], dim=1)
        assert torch.equal(got, qm._group_sums(x, 32))
        return
    in_f = 131072
    plan = _plan(body, 256, in_f)
    group = 32 if kind in ("q4_k", "q5_k", "q8_0") else G or 16
    x = torch.from_numpy(rng.standard_normal(in_f).astype(
        np.float32)).bfloat16()
    whole = qm.act_prep_plain(x, group, i8)
    parts = [qm.act_prep_plain(x[c0:c0 + c].contiguous(), group, i8)
             for c0, c in _windows(plan, in_f, _span(kind))]
    for i, w in enumerate(whole):
        if w is None:
            assert all(p[i] is None for p in parts)
        else:
            assert torch.equal(torch.cat([p[i] for p in parts]), w)


def test_ffn_plan_takes_what_tiles_takes():
    """Every (T, C, F) with T 1..8, C up to 64K in steps of 1024 and F up
    to 8192 in steps of 256 that the JAX tile rule `_tiles` takes has a
    plan (x in windows where T tokens of it do not fit), x whole wherever
    it fits."""
    n = 0
    for T in range(1, 9):
        for C in range(1024, 65536 + 1, 1024):
            for F in range(256, 8192 + 1, 256):
                if ff._tiles(T, C, F) is None:
                    continue
                plan = ff.ffn_plan(T, C, F)
                n += 1
                assert 1 <= plan.kwin <= plan.ksteps1
                cols = min(C, plan.kwin * 2048)
                assert plan.smem == ff.ffn_layout(T, cols, plan.stages, F)[
                    "total"] <= qm.SMEM_MAX
                whole = min(ff.ffn_layout(T, C, s, F)["total"]
                            for s in (3, 4))
                assert (plan.kwin == plan.ksteps1) == (whole <= qm.SMEM_MAX)
    assert n > 5000


def test_k15b_plan_at_the_1_1b():
    """K15b's T = 1 plan over the 1.1B's FFN: K15a's tiling (the same tiles
    and K steps as at T = 2), x whole, a persistent grid of two blocks an
    SM, one image region for x (C columns) and then phase 3's a (F)."""
    C, F = 2048, 5632
    plan = ff.ffn_plan(1, C, F)
    assert (plan.tiles1, plan.ksteps1, plan.tiles3, plan.ksteps3) == (
        704, 1, 128, 3)
    two = ff.ffn_plan(2, C, F)
    assert (two.tiles1, two.ksteps1, two.tiles3, two.ksteps3) == (
        plan.tiles1, plan.ksteps1, plan.tiles3, plan.ksteps3)
    assert plan.kwin == plan.ksteps1 and plan.grid == 2 * SMS
    lay = ff.ffn_layout(1, C, plan.stages, F)
    assert plan.smem == lay["total"] and lay["xs"] - lay["xi"] == 2 * F + 16
    assert lay["part"] - lay["xs"] == F // 32 * 2
    assert ff.ffn_layout(2, C, plan.stages, F) == ff.ffn_layout(
        2, C, plan.stages)  # K15a: x only
    assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    assert ff.ffn_plan(1, C, F, sms=114).grid <= 2 * 114


# the 1.1B's five shapes and the fixtures' (in_f 256, 512)
X_SHAPES = ((2560, 2048), (11264, 2048), (2048, 2048), (2048, 5632),
            (32000, 2048), (512, 256), (256, 512))


@pytest.mark.parametrize("out_f,in_f", X_SHAPES)
@pytest.mark.parametrize("kind", qm.ROWMV_X_KINDS)
def test_expanded_plan(kind, out_f, in_f):
    """The expanded kinds on rowmv.cuh's body: 16-row tiles taken once,
    every superblock to one warp, a ring of 3-4 stages, x whole (in_f near
    10K at most: `_expanded_fits`), int8 x only, no window."""
    plan = qm.rowmv_plan(kind, out_f, in_f, True)
    assert plan.rows == 16 and plan.tiles * 16 == out_f
    blocks = [list(range(b, plan.tiles, plan.grid)) for b in range(plan.grid)]
    assert sorted(t for ts in blocks for t in ts) == list(range(plan.tiles))
    nsb = in_f // 256
    assert [8 * k + w for k in range(plan.ksteps) for w in range(8)
            if 8 * k + w < nsb] == list(range(nsb))
    assert plan.stages in (3, 4) and plan.kwin == plan.ksteps
    assert plan.smem == qm.rowmv_layout(kind, in_f, True,
                                        plan.stages)["total"]
    if plan.grid > SMS:
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    with pytest.raises(ValueError):
        qm.rowmv_plan(kind, out_f, in_f, False)
    if plan.ksteps > 1:
        with pytest.raises(ValueError):
            qm.rowmv_plan(kind, out_f, in_f, True, kwin=1)


@pytest.mark.parametrize("kind", qm.ROWMV_X_KINDS)
def test_expanded_layout(kind):
    """A stage holds 16 rows x 8 superblocks of the values (q6_k_i8f 256 B
    a superblock row, the n4 kinds 128), the scales (32) and q2_k_n4's
    mins (32), each row pitch 16 bytes past its 8 superblocks; then x's
    int8 codes, sx, xs and the partial sums."""
    per = {"q6_k_i8f": (256, 32), "q3_k_n4": (128, 32),
           "q2_k_n4": (128, 32, 32)}[kind]
    for in_f in (256, 2048, 5632):
        lay = qm.rowmv_layout(kind, in_f, True, 4)
        assert lay["stage"] == 16 * sum(8 * b + 16 for b in per)
        assert lay["x"] == 4 * lay["stage"]
        assert lay["sx"] - lay["x"] == in_f
        assert lay["xs"] - lay["sx"] == in_f // 16 * 4
        assert lay["part"] - lay["xs"] == in_f // 16 * 2
        assert all(v % 16 == 0 for v in lay.values())


class _FakeLib:
    """Records each entry point's arguments; returns success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


class _OnCard(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so that a wrapper takes its
    kernel's branch (the recording library stands in for the kernel)."""
    is_cuda = True


@pytest.mark.parametrize("kind", qm.ROWMV_X_KINDS)
def test_expanded_wrapper_launches_once(monkeypatch, kind):
    """One launch of rowmv.cuh's body (no prep launch) with the plan's
    grid, stages, shared memory and window, the kind's values, scale and
    (q2_k_n4) min; y (1, out_f) is its one allocation; one count."""
    lib = _FakeLib()
    monkeypatch.setattr(_build, "entry",
                        lambda source, name, argtypes: (lib, getattr(lib, name)))
    monkeypatch.setattr(_build, "stream_ptr", lambda: 0)
    monkeypatch.setattr(_build, "launches", type(_build.launches)())
    out_f, in_f = 256, 2048
    qt = _MAKERS[kind](np.random.default_rng(0), out_f, in_f)
    x = torch.zeros(in_f, dtype=torch.bfloat16).as_subclass(_OnCard)
    made = []
    empty = torch.empty
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **k: made.append(a) or empty(*a, **k))
    y = qm.kq_expanded_matvec(x, qt)
    assert y.shape == (1, out_f) and len(made) == 1
    plan = qm.rowmv_plan(kind, out_f, in_f, True)
    assert [n for n, _ in lib.calls] == ["k12_expanded_matvec"]
    args = lib.calls[0][1]
    assert args[0] == qm.ROWMV_X_KINDS.index(kind)
    values = qt.data["q" if kind == "q6_k_i8f" else "n4"]
    assert args[1] == values.data_ptr()
    assert args[2] == qt.data["scale"].data_ptr()
    assert (args[3] is None) == (kind != "q2_k_n4")
    assert plan.kwin == plan.ksteps  # x whole: the entry takes no window
    assert args[6:11] == (out_f, in_f, plan.grid, plan.stages, plan.smem)
    assert dict(_build.launches) == {f"K12.{kind}": 1}
