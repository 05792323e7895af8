"""`rowmv_plan` for the K2.q8_0 / K12.iq / K17b body (csrc/rowmv_g.cuh: the
q8_0 T=1 matvec with int8 or bf16 activations, the four IQ kinds' at scale
groups G = 8, 16, 32), on the CPU: at the TinyLlama-1.1B's shapes, the
committed fixtures' and 7B-, 70B- and 405B-class ones, the persistent grid
takes every 16-row tile exactly once, the K steps give every span (a
superblock; q8_0: 128 columns) to exactly one warp, the shared memory fits
a block (two where the grid counts on two an SM), nothing of the summation
order depends on the ring's depth, the grid or q8_0's activation variant,
every in_f that `matmul_packed` can send (multiples of 256 up to 64K) is
taken, and a shape the kernel does not take raises. Then the wrapper,
driven with CPU tensors and a recording library in place of the CUDA one:
one launch per matvec (no prep launch) with the plan's grid, stages and
shared memory, y its only allocation, stacked (K17b) and not; and the
trace tool's anchors in the body."""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from koboldcpp_tpu_torch.models.synthetic import rand_iq, rand_q8_0
from koboldcpp_tpu_torch.ops import _build
from koboldcpp_tpu_torch.ops import quant_matmul as qm

torch.set_num_threads(1)

# (out_f, in_f): the 1.1B's wqkv, w_gateup, wo, w_down and head; the
# fixtures' projections and heads and the IQ `wk`; a 7B's w_gateup and
# w_down; a 70B's w_gateup, w_down and 128256-row head; a 405B's w_down
SHAPES = ((2560, 2048), (11264, 2048), (2048, 2048), (2048, 5632),
          (32000, 2048), (512, 256), (256, 256), (256, 512), (768, 256),
          (1024, 256), (256, 1024), (256, 2048), (22016, 4096),
          (4096, 11008), (57344, 8192), (8192, 28672), (128256, 8192),
          (16384, 53248))
# (kind, G, int8 activations): every body of rowmv_g.cuh
VARIANTS = (("q8_0", 0, True), ("q8_0", 0, False),
            *((k, G, True) for k in qm.IQ_KINDS for G in (8, 16, 32)))
SMS = 132
SMEM_PER_SM = 233472


def _ids(v):
    kind, G, i8 = v
    return f"{kind}-G{G}" if G else f"{kind}-{'i8' if i8 else 'bf16'}"


def _blocks_tiles(plan) -> list[list[int]]:
    """The tiles each block of the persistent grid walks."""
    return [list(range(b, plan.tiles, plan.grid)) for b in range(plan.grid)]


def _takes(kind: str, G: int, in_f: int) -> bool:
    """Whether the dispatch sends a T=1 call of this in_f to the body: q8_0
    at every in_f, an IQ kind from in_f 32 G up."""
    return kind == "q8_0" or in_f >= 32 * G


# every (shape, variant) the dispatch sends to the body
PLAN_CASES = [(shape, v) for shape in SHAPES for v in VARIANTS
              if _takes(v[0], v[1], shape[1])]


@pytest.mark.parametrize("shape,variant", PLAN_CASES,
                         ids=[f"{o}x{i}-{_ids(v)}" for (o, i), v in PLAN_CASES])
def test_plan_covers_rows_and_spans(shape, variant):
    (out_f, in_f), (kind, G, i8) = shape, variant
    plan = qm.rowmv_plan(kind, out_f, in_f, i8, G)
    span = qm.rowmv_span(kind)
    nsp = in_f // span
    # 16-row tiles, each taken by exactly one block, every block busy
    assert plan.rows == 16 and plan.tiles * plan.rows == out_f
    walked = sorted(t for ts in _blocks_tiles(plan) for t in ts)
    assert walked == list(range(plan.tiles))
    assert all(_blocks_tiles(plan))
    assert 1 <= plan.grid <= min(plan.tiles, 2 * SMS)
    # K step k gives span 8k + w to warp w: each exactly once
    taken = [8 * k + w for k in range(plan.ksteps) for w in range(8)
             if 8 * k + w < nsp]
    assert taken == list(range(nsp))
    assert (plan.ksteps - 1) * 8 < nsp <= plan.ksteps * 8
    # a q8_0 span is 4 groups of 32, an IQ span a superblock of 256 / G
    assert span * (plan.ksteps - 1) * 8 < in_f <= span * plan.ksteps * 8
    # the ring keeps a stage in flight while one is read
    assert plan.stages in (2, 3, 4)
    lay = qm.rowmv_layout(kind, in_f, i8, plan.stages, G, plan.xf32)
    assert plan.smem == lay["total"] <= qm.SMEM_MAX
    if plan.grid > SMS:
        assert 2 * (plan.smem + 1024) <= SMEM_PER_SM
    # a deeper ring would have cost the second block of an SM
    if plan.stages < 4 and plan.grid > SMS:
        deeper = qm.rowmv_layout(kind, in_f, i8, plan.stages + 1, G)["total"]
        assert 2 * (deeper + 1024) > SMEM_PER_SM
    # x as f32: q8_0's bf16 body only, where bf16 x would get the same
    # blocks an SM and ring (so not where two blocks of it miss an SM); at
    # the 1.1B's widths always
    assert plan.xf32 <= (kind == "q8_0" and not i8)
    if kind == "q8_0" and not i8 and not plan.xf32:
        f32 = qm.rowmv_layout(kind, in_f, i8, plan.stages, 0, True)["total"]
        assert 2 * (f32 + 1024) > SMEM_PER_SM
        assert in_f > 5632
    # the order of every row's sums: the same for q8_0's two bodies
    if kind == "q8_0":
        other = qm.rowmv_plan(kind, out_f, in_f, not i8)
        assert (other.rows, other.tiles, other.ksteps) == (
            plan.rows, plan.tiles, plan.ksteps)


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_plan_takes_every_width_the_dispatch_sends(variant):
    """Every in_f that is a multiple of 256 up to 64K (a 405B-class w_down
    is 53248 wide) has a plan, its K steps a function of in_f alone."""
    kind, G, i8 = variant
    for in_f in range(256, 65536 + 1, 256):
        if _takes(kind, G, in_f):
            plan = qm.rowmv_plan(kind, 256, in_f, i8, G)
            assert plan.ksteps == -(-(in_f // qm.rowmv_span(kind)) // 8)


@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_layout_holds_x_and_the_sums(variant):
    """The ring's stages (16 rows x 8 spans of each field, each row pitch 16
    bytes past its 8 spans), x prepped (in_f codes, or bf16 x at 80 bytes a
    32-column group), sx per group (int8 only), iq1p's xs and code sums per
    group and the partial sums, each region 16-byte aligned."""
    kind, G, i8 = variant
    per_row = {"q8_0": 128 + 8, "iq2p": 64 + 32, "iq3px": 64 + 64,
               "iq3ps": 64 + 64, "iq1p": 64}[kind] * 8
    Gs = G or 32
    per_row += 0 if kind == "q8_0" else 8 * 512 // Gs * (
        2 if kind == "iq1p" else 1)
    nfield = {"q8_0": 2, "iq2p": 3, "iq3px": 4, "iq3ps": 4, "iq1p": 3}[kind]
    for in_f in (256, 2048, 5632, 28672):
        if not _takes(kind, Gs, in_f):
            continue
        lay = qm.rowmv_layout(kind, in_f, i8, 3, G)
        ng = in_f // Gs
        assert lay["stage"] == 16 * (per_row + 16 * nfield)
        assert lay["x"] == 3 * lay["stage"]
        assert lay["sx"] - lay["x"] == (in_f if i8 else in_f // 32 * 80)
        assert lay["xs"] - lay["sx"] == (ng * 4 if i8 else 0)
        assert lay["xc"] - lay["xs"] == (ng * 2 if kind == "iq1p" else 0)
        assert lay["part"] - lay["xc"] == (ng * 4 if kind == "iq1p" else 0)
        assert lay["total"] - lay["part"] == 2 * 8 * 16 * 4
        assert all(v % 16 == 0 for v in lay.values())


@pytest.mark.parametrize("kind,out_f,in_f,i8,G", (
    ("q8_0", 2048, 384, True, 0), ("q8_0", 2000, 2048, True, 0),
    ("q8_0", 2048, 0, False, 0), ("iq2p", 2048, 2048, True, 12),
    ("iq1p", 2048, 2048, False, 32), ("iq3px", 0, 2048, True, 32),
    ("q8_0", 2048, 262144 + 128, False, 0),
    ("iq1p", 2048, 262144 + 64, True, 8),
    ("q4_k", 2048, 2048, True, 0)))
def test_plan_refuses_other_shapes(kind, out_f, in_f, i8, G):
    """in_f not a multiple of 256 (a wide x goes in windows:
    tests/test_torch_windows.py), out_f not of 64, a G the IQ kinds do not
    have, bf16 x for an IQ kind, and a kind of another body raise."""
    with pytest.raises(ValueError):
        qm.rowmv_plan(kind, out_f, in_f, i8, G)


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
@pytest.mark.parametrize("variant", VARIANTS, ids=_ids)
def test_wrapper_launches_once_with_the_plan(monkeypatch, variant, stacked):
    """One launch (no prep launch) with the plan's grid, stages and shared
    memory, out_f and in_f (q8_0: the variant; IQ: the kind and G); y (1,
    out_f) is its one allocation. Stacked (K17b): the layer index's pointer
    and the per-layer element counts of codes, hmask, sg, scale and min
    follow."""
    kind, G, i8 = variant
    lib = _record_launches(monkeypatch)
    out_f, in_f, L = 256, 512, 2
    if not _takes(kind, G, in_f):
        in_f = 32 * G
    rows = (L if stacked else 1) * out_f
    qt = (rand_q8_0(np.random.default_rng(0), rows, in_f) if kind == "q8_0"
          else rand_iq(np.random.default_rng(0), rows, in_f, kind=kind,
                       group=G))
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
    what = "K17b" if stacked else "K12"
    y = (qm._q8_0_launch(x, qt, i8, what, li) if kind == "q8_0"
         else qm._iq_launch(x, qt, what, li))
    assert y.shape == (1, out_f) and y.dtype == torch.bfloat16
    assert len(made) == 1
    plan = qm.rowmv_plan(kind, out_f, in_f, i8, G)
    name = "k2_q8_0_matvec" if kind == "q8_0" else "k12_iq_matvec"
    assert [n for n, _ in lib.calls] == [name]
    args = lib.calls[0][1]
    if kind == "q8_0":  # q, scale, x, y, out_f, in_f, x mode, grid, ...
        assert plan.xf32 == (not i8)
        assert args[4:10] == (out_f, in_f, 1 if i8 else 2, plan.grid,
                              plan.stages, plan.smem)
        stack = args[10:16]
        fields = ("q", None, None, "scale", None)
    else:  # kind, qs, hmask, sg, scale, min, x, y, out_f, in_f, G, grid, ...
        assert args[0] == qm.IQ_KINDS.index(kind)
        assert (args[2] is None) == ("hmask" not in qt.data)
        assert (args[3] is None) == ("sg" not in qt.data)
        assert (args[5] is None) == (kind != "iq1p")
        assert args[8:14] == (out_f, in_f, G, plan.grid, plan.stages,
                              plan.smem)
        stack = args[14:20]
        fields = ("qs", "hmask", "sg", "scale", "min")
    if stacked:
        assert stack[0] == li.data_ptr()
        assert stack[1:] == tuple(
            qt.data[n][0].numel() if n in qt.data else 0 for n in fields)
    else:
        assert stack == (None, 0, 0, 0, 0, 0)


def test_trace_tool_finds_its_anchors():
    """`tools/trace_q4k.py --kernel K2.q8_0` (and the K12.iq kernels) stamps
    csrc/rowmv_g.cuh at rowmv.cuh's six anchors; an edit of the source that
    moves one makes it raise on the card, so hold them here."""
    from koboldcpp_tpu_torch.tools import trace_q4k

    with open(os.path.join(_build.CSRC, "rowmv_g.cuh")) as f:
        src = trace_q4k.instrumented(f.read(), trace_q4k._ROWMV_STAMPS)
    assert src.count("TRACE(") == len(trace_q4k._ROWMV_STAMPS) + 1
