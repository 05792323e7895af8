"""Fused dequant+matmul for packed q2_k / q3_k / q4_k / q5_k / q6_k / q8_0,
native IQ (iq2p / iq3px / iq3ps / iq1p) and the opt-in q4_k_i8 / q6_k_i8f /
q3_k_n4 / q2_k_n4 QTensors.

Hand-written CUDA kernels (csrc/), each with its plain PyTorch version
beside it. A wrapper takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.

  K1  q4k_matvec    T=1 q4_k/q5_k     (csrc/q4k_matvec.cu; JAX
                                       `_packed_matvec_q4k`; int8 x: one
                                       launch that preps x itself, tiled
                                       by `q4k_plan`)
  K7  q4k_matvec_t  2<=T<=8 q4_k/q5_k (csrc/q4k_matvec.cu; the same JAX
                                       function, `_i8_t` bodies: batched
                                       decode; K1's int8 body)
  K14 q4k_matvec_sbq 2<=T<=16 q4_k/   (csrc/q4k_sbq.cu; JAX
                     q5_k, KCPP_SBQ=1  `_packed_matvec_q4k_sbq`: int8
                                       activations per 128 columns, the
                                       integer sub-scales in int32 dots;
                                       K7's design, one launch, tiled by
                                       `sbq_plan`)
  K2  q6k_matvec    T=1 q6_k          (csrc/q6k_matvec.cu; JAX
      q8_0_matvec   T=1 q8_0           `_packed_matvec`; csrc/q8_0_matvec.cu:
                                       int8 activations, or bf16 ones under
                                       KCPP_MM_I8=0; one launch that preps
                                       x itself, tiled by `rowmv_plan`,
                                       body csrc/rowmv.cuh, q8_0's
                                       csrc/rowmv_g.cuh)
  K12 q23k_matvec   T=1 q2_k/q3_k     (csrc/q23k_matvec.cu; the same JAX
                                       function, `_q2k/_q3k_row_kernel(_i8)`;
                                       K2's body and plan)
      iq_matvec     T=1 IQ kinds      (csrc/iq_matvec.cu; the same JAX
                                       function, `_iq2p/_iq3p/_iq1p_row_
                                       kernel_i8`; K2.q8_0's body and plan)
      kq_expanded_matvec T=1 q6_k_i8f / (csrc/kq_expanded_matvec.cu; the
                     q3_k_n4 / q2_k_n4 same JAX function, `_q6k_i8f_row_
                                       kernel`, `_q3k/_q2k_n4_row_kernel`)
  K3  kq_matmul     the other T       (csrc/kq_matmul.cu; JAX
  K13                                  `_packed_matmul_2d`; K13 names its
                                       q2_k/q3_k, IQ and q4_k_i8 bodies;
                                       q4_k_i8 takes it at every T; two
                                       variants, the tiling from
                                       `kq_plan`; K3.q4_k_magic its
                                       magic-number q4_k body under
                                       KCPP_Q4K_2D=magic)
  K17a q4k_matvec_stacked T=1 q4_k/    (csrc/q4k_matvec.cu with a layer
                     q5_k, layer li    index; JAX `_packed_matvec_q4k_
                     of stacked fields stacked`: K1's bodies)
  K17b matvec_stacked T=1 q6_k/q8_0/   (K2's and K12's sources with a layer
                     q2_k/q3_k/IQ,     index; JAX `_packed_matvec_stacked`)
                     layer li

Launch counters (ops/_build.launches): "K1", "K7", "K2" and "K3" count the
q4_k / q6_k bodies they have counted since they were ported, and so do
"K17a" and "K17b"; every other
kind's body has a counter of its own, "<id>.<kind>" ("K1.q5_k", "K7.q5_k",
"K2.q8_0", "K3.q5_k", "K3.q8_0", "K12.q2_k", "K12.q3_k", "K13.q2_k",
"K13.q3_k", and "K12.<kind>" / "K13.<kind>" for the four IQ kinds); K14
counts q4_k as "K14" and q5_k as "K14.q5_k"; the opt-in bodies count as
"K12.q6_k_i8f", "K12.q3_k_n4", "K12.q2_k_n4", "K13.q4_k_i8",
"K2.q8_0_bf16" and "K3.q4_k_magic".

`matmul_packed(x, qt)` returns None when the JAX dispatch would decline the
shape (out_f or in_f not a multiple of 256, an in_f too wide for any 2-D
tile or for an expanded kind's T=1 scratch, or an expanded kind without its
dense fields at T > 1); callers then take the dequant path in
ops/linear.py. It reads KCPP_SBQ, KCPP_MM_I8, KCPP_Q4K_I8, KCPP_Q4K_DECODE,
KCPP_Q4K_2D and KCPP_PALLAS_MM at every call and KCPP_MATVEC_MAX_T at
import, as the JAX dispatch reads them (`matmul_packed` says what each
selects). `matmul_packed_stacked(x, qt, li)` is its
counterpart for a layer-stacked QTensor (the scan decode path's
`LayerRef`): K17a / K17b, or None where JAX's declines.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from . import _build
from .linear import (EXPANDED, IQ_KINDS, QTensor, iq_group, iq_values,
                     n4_values, q2k_values, q3k_values, q4k_values,
                     q5k_values, q6k_values)

VMEM_BUDGET = 13 * 1024 * 1024  # the JAX 2-D kernel's tile budget (see below)
# the JAX row tiles of its q4_k / q5_k matvec (`_q4k_matvec_rt`, at their
# defaults)
ROW_TILE, DECODE_ROW_TILE = 256, 512
# the T cap of the matvecs where the q4_k / q5_k activations stay bf16
# (KCPP_MATVEC_MAX_T), read at import as the JAX module reads it
MATVEC_MAX_T = int(os.environ.get("KCPP_MATVEC_MAX_T", "4"))


def pallas_on() -> bool:
    """KCPP_PALLAS_MM (read at every call): "0" sends every packed matmul
    to K3 / K13, where the JAX package takes its XLA dequant path (bf16
    weights, f32 accumulation: the same function), and turns K14 / K15
    off."""
    return os.environ.get("KCPP_PALLAS_MM", "1") != "0"


def _decode_on() -> bool:
    """KCPP_Q4K_DECODE (read at every call): anything but "1" turns every
    matvec off (K1, K7, K2, K12, K14, K17a / b); their calls go to K3 /
    K13, as the JAX dispatch sends them to its 2-D kernel."""
    return os.environ.get("KCPP_Q4K_DECODE", "1") == "1"


def _magic() -> bool:
    """KCPP_Q4K_2D=magic (read at every call): K3's q4_k calls take the
    magic-number body (K3.q4_k_magic), as JAX takes `_q4k_magic_kernel`."""
    return os.environ.get("KCPP_Q4K_2D", "sexp") == "magic"


def _q4k_matvec_rt(kind: str, out_f: int, in_f: int, T: int, i8: bool,
                   raw: bool) -> int | None:
    """The JAX `_q4k_matvec_rt`: its q4_k / q5_k matvec's row tile within
    the VMEM budget, or None (the JAX dispatch then takes its 2-D
    kernel). The port reads it where it extends K7's bf16 body past T = 8
    (KCPP_MATVEC_MAX_T > 8)."""
    GS, C2 = in_f // 64, in_f // 2
    n_qfields = 2 if kind == "q5_k" else 1
    scratch_b = (2 * T * GS * C2 if (i8 or raw) else 2 * 2 * T * GS * C2 * 2)
    budget = VMEM_BUDGET - scratch_b
    for cand in (DECODE_ROW_TILE, ROW_TILE, 128):
        if (out_f % cand == 0 and 2 * cand * (n_qfields * C2 + 8 * GS)
                + 6 * cand * C2 <= budget):
            return cand
    return None


# the layer index and the five per-layer element counts of the stacked
# entry points (STACKED_PARAMS, csrc/common.cuh)
_SIG_STACK = [_build.P] + [_build.LL] * 5
_FIELD_DTYPES = {"qs2": torch.uint8, "ql": torch.uint8, "qh": torch.uint8,
                 "qs": torch.uint8, "hmask": torch.uint8, "sg": torch.uint8,
                 "n4": torch.uint8,
                 "q": torch.int8, "scale": torch.bfloat16,
                 "min": torch.bfloat16, "sc": torch.uint8,
                 "d": torch.float32}
# kind -> (kq_matmul.cu KIND, the packed weight fields w0, w1 and w2 (None:
# not read), the affine term's group width (0: no affine term; None: the
# IQ kind's scale group G))
_K3_KINDS = {"q4_k": (0, "qs2", None, None, 32),
             "q6_k": (1, "ql", "qh", None, 16),
             "q5_k": (2, "qs2", "qh", None, 32), "q8_0": (3, "q", None, None, 0),
             "q2_k": (4, "qs", None, None, 16),
             "q3_k": (5, "qs", "hmask", None, 16),
             "iq2p": (6, "qs", None, "sg", 0),
             "iq3px": (7, "qs", "hmask", "sg", 0),
             "iq3ps": (8, "qs", "hmask", "sg", 0),
             "iq1p": (9, "qs", None, None, None),
             "q4_k_i8": (10, "q", None, None, 32)}
_KQ_MAGIC = 11  # kq_matmul.cu's magic-number q4_k body (K3.q4_k_magic)
_LOWBIT = ("q2_k", "q3_k")  # the kinds of K12 / K13 besides the IQ kinds
_K13_KINDS = _LOWBIT + IQ_KINDS + ("q4_k_i8",)


def _ptr(t: torch.Tensor | None):
    return t.data_ptr() if t is not None else None


def _count(kid: str, qt: QTensor) -> None:
    """One launch of kernel `kid`'s body for qt's kind (see the module
    docstring for the counter names)."""
    _build.launches[kid if qt.kind in ("q4_k", "q6_k")
                    else f"{kid}.{qt.kind}"] += 1


def _stack_args(qt: QTensor, names, li: torch.Tensor | None) -> list:
    """The stacked entry points' layer arguments: li's device pointer and
    the per-layer element count of each weight field in `names` (0 where
    absent or None), or a null pointer and zeros for one layer's fields."""
    if li is None:
        return [None] + [0] * 5
    counts = [qt.data[n][0].numel() if n in qt.data else 0 for n in names]
    return [li.data_ptr()] + counts + [0] * (5 - len(counts))


def _check_stacked(x: torch.Tensor, qt: QTensor, li: torch.Tensor,
                   what: str) -> None:
    """A stacked kernel takes a one-element int32 layer index on x's device
    and fields that all carry the same leading layer axis."""
    if li.dtype != torch.int32 or li.numel() != 1 or li.device != x.device:
        raise ValueError(f"{what} takes the layer index as a one-element "
                         f"int32 tensor on {x.device}")
    if len({t.shape[0] for t in qt.data.values()}) != 1 \
            or any(t.dim() < 2 for t in qt.data.values()):
        raise ValueError(f"{what} takes fields with one leading layer axis")


def layer_of(qt: QTensor, li: int) -> QTensor:
    """Layer li of a layer-stacked QTensor, as views (no copy)."""
    return QTensor(kind=qt.kind, shape=qt.shape,
                   data={n: a[li] for n, a in qt.data.items()})


def _check_operands(x: torch.Tensor, qt: QTensor, what: str) -> None:
    """The kernels take raw pointers: every operand must be a contiguous
    tensor of the expected dtype on x's device."""
    out_f, in_f = qt.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.shape[-1] != in_f or in_f % 256 or out_f % 64:
        raise ValueError(f"{what} takes a contiguous bf16 x of width in_f, "
                         "in_f % 256 == 0 and out_f % 64 == 0")
    for name, t in qt.data.items():
        if t.device != x.device or t.dtype != _FIELD_DTYPES[name] \
                or not t.is_contiguous():
            raise ValueError(f"{what}: field {name} must be a contiguous "
                             f"{_FIELD_DTYPES[name]} tensor on {x.device}")


# ---------------------------------------------------------------------------
# activation prep shared by K1/K2 (the port of `_i8_prep` / `_group_sums`)
# ---------------------------------------------------------------------------

def act_prep_plain(x: torch.Tensor, group: int, quant: bool):
    """x (in_f,) bf16 -> (xq int8 | None, sx f32 | None, xsum bf16) per
    `group` consecutive columns: the bf16-rounded f32 sum, and int8 codes
    rint(x * (127 / amax)) with amax clamped at 1e-20 and scale amax/127."""
    xf = x.float().reshape(-1, group)
    xsum = xf.sum(dim=1).to(torch.bfloat16)
    if not quant:
        return None, None, xsum
    a = xf.abs().amax(dim=1).clamp_min(1e-20)
    # divided by a tensor: IEEE division, as the kernels' prep divides (a
    # Python number would divide as a product with its reciprocal)
    c127 = a.new_tensor(127.0)
    xq = torch.round(xf * (c127 / a)[:, None]).to(torch.int8).reshape(-1)
    return xq, a / c127, xsum


# ---------------------------------------------------------------------------
# K1: q4_k/q5_k T=1 matvec; K7: q4_k/q5_k 2<=T<=8 batched matvec (one kernel
# template)
# ---------------------------------------------------------------------------

def q4k_matvec_t_plain(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """x (T, in_f) bf16 -> (T, out_f) bf16, row by row, for a q4_k or q5_k
    QTensor (codes 0..15 or 0..31). i8: int8 activations per token and
    32-col group (`_q4k_decode_kernel_i8(_t)`, `_q5k_decode_kernel_i8(_t)`);
    else the exact f32 dot with bf16 x (`_q4k_decode_kernel`,
    `_q5k_decode_kernel`). Each row is computed alone, so row t equals the
    T=1 result for x[t]."""
    out_f, in_f = qt.shape
    ng = in_f // 32
    q = (q4k_values(qt.data["qs2"]) if qt.kind == "q4_k"
         else q5k_values(qt.data["qs2"], qt.data["qh"])).reshape(out_f, ng, 32)
    s = qt.data["scale"].float()
    m = qt.data["min"].float()
    rows = []
    for xt in x.reshape(-1, in_f):
        xq, sx, xsum = act_prep_plain(xt, 32, i8)
        if i8:
            p = (q.int() * xq.int().reshape(ng, 32)).sum(dim=2)  # exact int32
            t = (p.float() * sx * s).sum(dim=1)
        else:
            p = (q.float() * xt.float().reshape(ng, 32)).sum(dim=2)
            t = (s * p).sum(dim=1)
        rows.append(t - (m * xsum.float()).sum(dim=1))
    return torch.stack(rows).to(torch.bfloat16)


def q4k_matvec_plain(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16 (see q4k_matvec_t_plain)."""
    return q4k_matvec_t_plain(x[None], qt, i8)


class Q4kPlan(NamedTuple):
    """How the int8-activation K1 / K7 / K17a body tiles one call
    (csrc/q4k_matvec.cu): 16-row tiles (`tiles` of them) walked by a
    persistent grid of `grid` blocks of 8 warps; each K step is a stage of
    8 superblocks, one per warp, `stages` of them in a cp.async ring;
    `smem` bytes of dynamic shared memory (the ring, the x codes of T
    tokens, their (sx, xs) pairs, the tile's partial sums); x held in
    windows of `kwin` K steps (`kwin == ksteps`: x whole, prepped once;
    less, at T = 1 only, where x does not fit a block: each window prepped
    anew at its first K step of every tile)."""
    rows: int
    tiles: int
    ksteps: int
    stages: int
    smem: int
    grid: int
    kwin: int


Q4K_ROWS = 16        # rows per tile (the mma M)
Q4K_KS = 8           # superblocks per K step: one per warp
Q4K_STAGES = 4
Q4K_MAX_T = 8        # tokens per call (the mma N)
SMEM_MAX = 232448    # the H100's shared memory per block (227 KB)
_SMEM_PER_SM = 233472  # per SM (228 KB), 1 KB of which each block reserves


def q4k_layout(q5: bool, T: int, in_f: int) -> dict[str, int]:
    """The int8 body's shared memory, byte offsets (`i8_layout` in the
    source): 4 stages of 16 rows x 8 superblocks (per row the codes in
    1024 B, the scales and mins in 272, q5_k's bit plane in 272), then the
    x codes of T tokens in rows of in_f + 64 bytes (in_f: x's columns, or
    those of its window), a float2 of scales sx per 32-column group and
    token pair, the bf16 group sums xs (T x in_f/32), and the partial sums
    (per token the 8 warps' values of 16 rows and 16 bytes of padding:
    8.25 KB)."""
    stage = Q4K_ROWS * (Q4K_KS * 128 + 2 * Q4K_KS * 16 + 16
                        + (Q4K_KS * 32 + 16 if q5 else 0))
    x = Q4K_STAGES * stage
    prep = x + T * (in_f + 64)
    sums = prep + (in_f // 32) * ((T + 1) // 2) * 8
    part = sums + T * (in_f // 32) * 2
    return {"stage": stage, "x": x, "prep": prep, "sums": sums, "part": part,
            "total": part + 2 * Q4K_MAX_T * (Q4K_KS * Q4K_ROWS + 4) * 4}


def widest(fits, hi: int) -> int:
    """The largest k in 1..hi with fits(k), where fits holds up to some k
    and fails above it (a window's shared memory grows with its width), or
    0 where none fits."""
    lo = 0
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    return lo


def _window_order(fits, configs, ksteps: int, kwin: int, windows: bool):
    """(kwin, config) of a plan: the forced window in the first config it
    fits; else x whole in the first config it fits; else (windows) the
    widest window in the first config any fits. None: nothing fits."""
    if kwin:
        return next(((kwin, c) for c in configs if fits(kwin, c)), None)
    for c in configs:
        if fits(ksteps, c):
            return ksteps, c
    for c in configs if windows else ():
        kw = widest(lambda k: fits(k, c), ksteps - 1)
        if kw:
            return kw, c
    return None


@functools.lru_cache(maxsize=4096)
def q4k_plan(T: int, out_f: int, in_f: int, q5: bool = False,
             kwin: int = 0) -> Q4kPlan:
    """The tiling of the int8-activation K1 / K7 / K17a body for x (T,
    in_f) and an (out_f, in_f) q4_k (q5: q5_k) weight. Raises ValueError
    for a shape the kernel does not take (T outside 1..8, in_f not a
    multiple of 256, out_f not a multiple of 64, or at T >= 2 more shared
    memory than a block has: the dispatch's `_q45_i8` sends no such T).

    Every block needs all T tokens of x prepped (at T >= 2 the two blocks
    of a cluster share the work), so the grid is persistent: as many
    blocks as fit two to an SM (one where the shared memory allows one
    only), never more than the tiles, an even number (out_f / 16 tiles are
    a multiple of 4). x is whole wherever it fits; at T = 1 a wider x goes
    in windows of `kwin` K steps, the widest that fits two blocks an SM,
    else one (any in_f: a window of one K step is 2048 columns). kwin
    forces a window (T = 1; kwin = ksteps is x whole). The tile, the K step
    and the warp that takes each superblock depend on in_f alone, never on
    T, and x's groups are prepped alike in a window and whole, so a (row,
    token) is summed in the same order, of the same values, at every T and
    window."""
    if not 1 <= T <= Q4K_MAX_T or in_f <= 0 or in_f % KQ_K_STEP \
            or out_f <= 0 or out_f % 64:
        raise ValueError(f"K1 / K7 take 1 <= T <= {Q4K_MAX_T}, in_f % 256 "
                         f"== 0 and out_f % 64 == 0, not T={T} "
                         f"({out_f}, {in_f})")
    tiles = out_f // Q4K_ROWS
    ksteps = -(-(in_f // KQ_K_STEP) // Q4K_KS)
    if kwin < 0 or kwin > ksteps or (T > 1 and 0 < kwin < ksteps):
        raise ValueError(f"K1 / K7: a window of {kwin} of {ksteps} K steps "
                         f"at T={T} (windows: T = 1 only)")
    def smem(kw):
        return q4k_layout(q5, T, min(in_f, kw * Q4K_KS * KQ_K_STEP))["total"]

    def fits(kw, per_sm):
        return smem(kw) <= SMEM_MAX \
            and per_sm * (smem(kw) + 1024) <= _SMEM_PER_SM

    got = _window_order(fits, (2, 1), ksteps, kwin, T == 1)
    if got:
        kw, per_sm = got
        return Q4kPlan(Q4K_ROWS, tiles, ksteps, Q4K_STAGES, smem(kw),
                       min(tiles, per_sm * _SMS), kw)
    raise ValueError(f"K1 / K7: T={T} x in_f={in_f} needs more shared memory "
                     f"than a block has ({SMEM_MAX} bytes)")


_SIG_Q4K_I8 = [_build.P] * 6 + [_build.I] * 5 + _SIG_STACK + [_build.I,
                                                                _build.P]
_SIG_Q4K_BF16 = [_build.P] * 7 + [_build.I] * 3 + _SIG_STACK + [_build.P]


def _q4k_launch(x2: torch.Tensor, qt: QTensor, i8: bool, what: str,
                li: torch.Tensor | None = None, kwin: int = 0):
    """One launch for x2 (T, in_f) on the card, the int8 body prepping its
    own activations (`q4k_plan`; kwin: a window of x the plan is forced
    to); the bf16 body takes a group-sum launch first. li: layer li of
    stacked fields (K17a)."""
    T, in_f = x2.shape
    out_f = qt.shape[0]
    _check_operands(x2, qt, what)
    d = qt.data
    y = torch.empty((T, out_f), dtype=torch.bfloat16, device=x2.device)
    st = _build.stream_ptr()
    stack = _stack_args(qt, ("qs2", "qh", "scale", "min"), li)
    if i8:
        plan = q4k_plan(T, out_f, in_f, qt.kind == "q5_k", kwin)
        if any(t.data_ptr() % 16 for t in (x2, *d.values())):
            raise ValueError(f"{what} takes 16-byte aligned x and fields")
        lib, fn = _build.entry("q4k_matvec", "k1_q4k_i8", _SIG_Q4K_I8)
        _build.check(lib, fn(
            d["qs2"].data_ptr(), _ptr(d.get("qh")),  # qh: the q5_k bit plane
            d["scale"].data_ptr(), d["min"].data_ptr(), x2.data_ptr(),
            y.data_ptr(), T, out_f, in_f, plan.grid, plan.smem, *stack,
            plan.kwin, st), what)
        return y
    lib = _build.load("q4k_matvec", {
        "k1_q4k_sums": [_build.P, _build.P, _build.I, _build.P],
        "k7_q4k_bf16": _SIG_Q4K_BF16})
    xsum = torch.empty(T * in_f // 32, dtype=torch.bfloat16, device=x2.device)
    _build.check(lib, lib.k1_q4k_sums(x2.data_ptr(), xsum.data_ptr(),
                                      T * in_f, st), f"{what} sums")
    _build.check(lib, lib.k7_q4k_bf16(
        d["qs2"].data_ptr(), _ptr(d.get("qh")), d["scale"].data_ptr(),
        d["min"].data_ptr(), x2.data_ptr(), xsum.data_ptr(), y.data_ptr(), T,
        out_f, in_f, *stack, st), what)
    return y


def q4k_matvec(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """K1 wrapper (q4_k or q5_k). x (in_f,) bf16 contiguous -> (1, out_f)
    bf16."""
    if not x.is_cuda:
        return q4k_matvec_plain(x, qt, i8)
    y = _q4k_launch(x[None], qt, i8, "K1")
    _count("K1", qt)
    return y


def q4k_matvec_t(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """K7 wrapper (q4_k or q5_k). x (T, in_f) bf16 contiguous, 2 <= T <= 8
    (any T >= 2 for the bf16 body: KCPP_MATVEC_MAX_T) -> (T, out_f) bf16;
    row t equals K1 on x[t] bit for bit."""
    if not x.is_cuda:
        return q4k_matvec_t_plain(x, qt, i8)
    if x.dim() != 2 or not 2 <= x.shape[0] <= (8 if i8 else 65535 * 8):
        raise ValueError("K7 takes x of shape (T, in_f) with 2 <= T <= 8 "
                         "(int8 activations) or 2 <= T (bf16)")
    y = _q4k_launch(x, qt, i8, "K7")
    _count("K7", qt)
    return y


# ---------------------------------------------------------------------------
# K14: q4_k/q5_k 2<=T<=16 batched matvec over the superblock factors
# (KCPP_SBQ=1)
# ---------------------------------------------------------------------------

SBQ_SEG = 128  # columns per int8 activation scale (one superblock half)


def sbq_prep_plain(x: torch.Tensor):
    """x (T, in_f) bf16 -> (xq int8 (T, in_f), sx f32 (T, in_f/128), xsum
    bf16 (T, in_f/32)) as `_sbq_prep`: codes rint(x * (127 / amax)) per
    128-column segment (logical cols 128k..128k+127, one plane of one
    superblock) with amax clamped at 1e-20, scale amax / 127, and the
    bf16-rounded f32 sums of x per 32 columns."""
    T, in_f = x.shape
    xf = x.float().reshape(T, in_f // SBQ_SEG, SBQ_SEG)
    a = xf.abs().amax(dim=2).clamp_min(1e-20)
    c127 = a.new_tensor(127.0)  # IEEE division, as in act_prep_plain
    xq = torch.round(xf * (c127 / a)[..., None]).to(torch.int8)
    return xq.reshape(T, in_f), a / c127, _group_sums(x, 32)


def q4k_matvec_sbq_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (T, in_f) bf16 -> (T, out_f) bf16 for a q4_k or q5_k QTensor with
    sc / d (`_q4k_decode_kernel_sbq`, `_q5k_decode_kernel_sbq`): per token
    t and 128-column segment k, the exact integer dot P_tk = sum_c sc_g(c)
    q_c xq_tc (the sub-scale folded into the int32 product), then y_t =
    sum_s d_s (P_t,2s sx_t,2s + P_t,2s+1 sx_t,2s+1) - sum_g m_g xs_tg over
    superblocks s and 32-column groups g. The products are exact in float64
    (|P| < 2^25), so this matmul repeats the integer sums."""
    out_f, in_f = qt.shape
    T = x.shape[0]
    nseg = in_f // SBQ_SEG
    d = qt.data
    q = (q4k_values(d["qs2"]) if qt.kind == "q4_k"
         else q5k_values(d["qs2"], d["qh"])).reshape(out_f, -1, 32)
    w = (q.double() * d["sc"].double()[..., None]).reshape(
        out_f, nseg, SBQ_SEG).transpose(0, 1)              # (nseg, R, 128)
    xq, sx, xsum = sbq_prep_plain(x)
    xs = xq.double().reshape(T, nseg, SBQ_SEG).permute(1, 2, 0)  # (nseg,128,T)
    p = torch.bmm(w, xs).float()                           # (nseg, R, T)
    va = (p.permute(2, 1, 0) * sx[:, None, :]).reshape(T, out_f, -1, 2)
    t = (va.sum(dim=3) * d["d"][None]).sum(dim=2)          # (T, R)
    t = t - torch.matmul(xsum.float(), d["min"].float().t())
    return t.to(torch.bfloat16)


class SbqPlan(NamedTuple):
    """How the K14 body tiles one call (csrc/q4k_sbq.cu): 16-row tiles
    (`tiles` of them) walked by a persistent grid of `grid` blocks of 8
    warps, in clusters of two that share the activation prep and take the
    two tiles of each pair of tiles their cluster walks; each K step is a
    stage of 8 superblocks, one per warp, `stages` of them in a cp.async
    ring; `ntiles_n` mma N tiles of 8 tokens sharing each A fragment; x
    held in windows of `kwin` K steps (`kwin == ksteps`: x whole, quantized
    once; less where T tokens' codes of every column do not fit a block:
    each window quantized anew at its first K step of every tile); `smem`
    bytes of dynamic shared memory (the ring, a window's x codes of T
    tokens, their scales per segment and sums per group, the tile's
    partial sums)."""
    rows: int
    tiles: int
    ksteps: int
    stages: int
    ntiles_n: int
    kwin: int
    smem: int
    grid: int


SBQ_MAX_T = 16
SBQ_TOKENS = 8  # tokens per mma N tile
# a stage row of K14's factors: sc (8 B per superblock), d (4 B), min
# (16 B), then 16 B of padding
_SBQ_SIDE_PITCH = Q4K_KS * 28 + 16
# the ring depths and blocks per SM K14's and K15a's plans try, in order
RING_FITS = ((4, 2), (3, 2), (4, 1), (3, 1))


def sbq_layout(q5: bool, T: int, cols: int, stages: int) -> dict[str, int]:
    """K14's shared memory, byte offsets (`sbq_layout` in the source):
    `stages` stages of 16 rows x 8 superblocks (per row the codes in 1024
    B, the factors in 240, q5_k's bit plane in 272), then the x codes of T
    tokens over a window of `cols` columns in rows of cols + 64 bytes, a
    float2 of scales sx per 128-column segment and token pair, the bf16
    group sums xs (T x cols/32), and the partial sums (per token of 8, or
    at T > 8 of 16, the 8 warps' values of 16 rows and 16 bytes of
    padding)."""
    stage = Q4K_ROWS * (Q4K_KS * 128 + _SBQ_SIDE_PITCH
                        + (Q4K_KS * 32 + 16 if q5 else 0))
    x = stages * stage
    prep = x + T * (cols + 64)
    sums = prep + (cols // SBQ_SEG) * ((T + 1) // 2) * 8
    part = sums + T * (cols // 32) * 2
    tokens = 2 * SBQ_TOKENS if T > SBQ_TOKENS else SBQ_TOKENS
    return {"stage": stage, "x": x, "prep": prep, "sums": sums, "part": part,
            "total": part + tokens * (Q4K_KS * Q4K_ROWS + 4) * 4}


@functools.lru_cache(maxsize=4096)
def sbq_plan(T: int, out_f: int, in_f: int, q5: bool = False) -> SbqPlan:
    """The tiling of K14 for x (T, in_f) and an (out_f, in_f) q4_k (q5:
    q5_k) weight. Raises ValueError for a shape the kernel does not take
    (T outside 2..16, in_f not a multiple of 256, out_f not a multiple of
    64); every other width fits, through x's windows.

    The grid is persistent, as K7's (`q4k_plan`): x whole where it fits,
    at the first of 4 stages and two blocks an SM, 3 stages and two, 4 or
    3 stages and one (q5_k's two-tile body: one block, its registers);
    else the same order with the widest window of x that fits. Never more
    blocks than tiles, an even number. The window's float-reciprocal
    prep needs T * cols / 32 < 8192, which a block's shared memory
    implies. The tile, the K step and the warp that takes each superblock
    depend on in_f alone, never on T (nor do the windows change the
    order): a (row, token) is summed in the same order at every T."""
    if not 2 <= T <= SBQ_MAX_T or in_f <= 0 or in_f % KQ_K_STEP \
            or out_f <= 0 or out_f % 64:
        raise ValueError(f"K14 takes 2 <= T <= {SBQ_MAX_T}, in_f % 256 == "
                         f"0 and out_f % 64 == 0, not T={T} ({out_f}, {in_f})")
    tiles = out_f // Q4K_ROWS
    ksteps = -(-(in_f // KQ_K_STEP) // Q4K_KS)
    fits = [(stages, per_sm) for stages, per_sm in RING_FITS
            if not (q5 and T > SBQ_TOKENS and per_sm > 1)]
    for kwins in ((ksteps,), range(ksteps - 1, 0, -1)):
        for stages, per_sm in fits:
            for kwin in kwins:
                cols = min(in_f, kwin * Q4K_KS * KQ_K_STEP)
                smem = sbq_layout(q5, T, cols, stages)["total"]
                if per_sm * (smem + 1024) <= _SMEM_PER_SM \
                        and smem <= SMEM_MAX and T * (cols // 32) < 8192:
                    return SbqPlan(Q4K_ROWS, tiles, ksteps, stages,
                                   2 if T > SBQ_TOKENS else 1, kwin, smem,
                                   min(tiles, per_sm * _SMS))
    raise ValueError(f"K14: T={T} x in_f={in_f} does not fit a block "
                     f"({smem} bytes of shared memory, {SMEM_MAX} at most)")


_SIG_SBQ = [_build.P] * 7 + [_build.I] * 7 + [_build.P]


def q4k_matvec_sbq(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K14 wrapper (q4_k or q5_k with sc / d). x (T, in_f) bf16 contiguous,
    2 <= T <= 16 -> (T, out_f) bf16; each row depends on its token alone.
    One launch (`sbq_plan`), y its one allocation."""
    if not x.is_cuda:
        return q4k_matvec_sbq_plain(x, qt)
    if x.dim() != 2 or not 2 <= x.shape[0] <= SBQ_MAX_T \
            or qt.kind not in ("q4_k", "q5_k") \
            or "sc" not in qt.data or "d" not in qt.data:
        raise ValueError("K14 takes x (T, in_f) with 2 <= T <= 16 and a "
                         "q4_k / q5_k weight with sc and d")
    T, in_f = x.shape
    out_f = qt.shape[0]
    _check_operands(x, qt, "K14")
    d = qt.data
    if any(t.data_ptr() % 16 for t in (x, *d.values())):
        raise ValueError("K14 takes 16-byte aligned x and fields")
    plan = sbq_plan(T, out_f, in_f, qt.kind == "q5_k")
    y = torch.empty((T, out_f), dtype=torch.bfloat16, device=x.device)
    lib, fn = _build.entry("q4k_sbq", "k14_sbq", _SIG_SBQ)
    _build.check(lib, fn(
        d["qs2"].data_ptr(), _ptr(d.get("qh")), d["sc"].data_ptr(),
        d["d"].data_ptr(), d["min"].data_ptr(), x.data_ptr(), y.data_ptr(),
        T, out_f, in_f, plan.grid, plan.stages, plan.kwin, plan.smem,
        _build.stream_ptr()), "K14")
    _count("K14", qt)
    return y


def _sbq(qt: QTensor, T: int) -> bool:
    """The JAX dispatch's K14 rule (`matmul_packed`, quant_matmul.py:2102-
    2113): KCPP_SBQ=1, q4_k / q5_k with its superblock factors, 2 <= T <=
    16, in_f a multiple of 256 and at least 2048. Read at every call, as
    JAX reads it."""
    in_f = qt.shape[1]
    return (os.environ.get("KCPP_SBQ", "0") == "1"
            and qt.kind in ("q4_k", "q5_k") and 2 <= T <= 16
            and in_f % 256 == 0 and in_f >= 2048
            and "sc" in qt.data and "d" in qt.data)


# ---------------------------------------------------------------------------
# K2 / K12: the tiling of the T=1 row matvec body (csrc/rowmv.cuh)
# ---------------------------------------------------------------------------

class RowmvPlan(NamedTuple):
    """How the K2 / K12 / K17b bodies (csrc/rowmv.cuh, csrc/rowmv_g.cuh)
    tile one call: 16-row tiles (`tiles` of them) walked by a persistent
    grid of `grid` blocks of 8 warps; each K step is a stage of 8 spans
    (superblocks; q8_0: 128 columns), one per warp, `stages` of them in a
    cp.async ring; `smem` bytes of dynamic shared memory (the ring, x
    prepped, the tile's partial sums); xf32: q8_0's bf16 body keeps x as
    f32 in shared memory; x held in windows of `kwin` K steps (`kwin ==
    ksteps`: x whole, prepped once; less where x does not fit a block:
    each window prepped anew at its first K step of every tile)."""
    rows: int
    tiles: int
    ksteps: int
    stages: int
    smem: int
    grid: int
    xf32: bool = False
    kwin: int = 0


ROWMV_KINDS = ("q6_k", "q2_k", "q3_k")  # RK_Q6, RK_Q2, RK_Q3 in rowmv.cuh
# the expanded layouts' kinds (KCPP_KQ_LAYOUT=expanded): RK_X6, RK_X3, RK_X2
# in rowmv.cuh, int8 x only
ROWMV_X_KINDS = ("q6_k_i8f", "q3_k_n4", "q2_k_n4")
ROWMVG_KINDS = ("q8_0",) + IQ_KINDS      # GK_Q8, GK_IQ2, ... in rowmv_g.cuh
ROWMV_KS = 8             # spans per K step: one per warp
ROWMV_STAGES = (4, 3)    # the ring's depths, the deepest that fits first
ROWMVG_STAGES = (4, 3, 2)  # rowmv_g.cuh's (2: the widest x in_f)
# bytes per superblock row of the codes (ql / qs), the second code field
# (qh / hmask), the scales and q2_k's mins
_ROWMV_FIELDS = {"q6_k": (128, 64, 32, 0), "q2_k": (64, 0, 32, 32),
                 "q3_k": (64, 32, 32, 0), "q6_k_i8f": (256, 0, 32, 0),
                 "q3_k_n4": (128, 0, 32, 0), "q2_k_n4": (128, 0, 32, 32)}


def rowmv_span(kind: str) -> int:
    """Columns of a warp's span: a superblock, or 128 for q8_0 (its 16-row
    stage of 8 superblocks would take 35 KB)."""
    return 128 if kind == "q8_0" else 256


def _rowmv_fields(kind: str, group: int) -> tuple[int, ...]:
    """Bytes per span row of each field a stage holds, in the source's
    order: rowmv.cuh's codes, second code field, scales, mins; rowmv_g.cuh's
    codes (q8_0 q, IQ qs), hmask, sg, scales, mins (0: no such field)."""
    if kind in _ROWMV_FIELDS:
        return _ROWMV_FIELDS[kind]
    sc = rowmv_span(kind) // group * 2
    return {"q8_0": (128, 0, 0, sc, 0), "iq2p": (64, 0, 32, sc, 0),
            "iq3px": (64, 32, 32, sc, 0), "iq3ps": (64, 32, 32, sc, 0),
            "iq1p": (64, 0, 0, sc, sc)}[kind]


def _rowmv_group(kind: str, group: int) -> int:
    """The scale group of a call: q6_k / q2_k / q3_k and the expanded
    kinds 16, q8_0 32, an IQ kind's G (8, 16 or 32)."""
    if kind in ROWMV_KINDS + ROWMV_X_KINDS:
        return 16
    if kind == "q8_0":
        return 32
    if group not in (8, 16, 32):
        raise ValueError(f"K12.iq takes G = 8, 16 or 32, not {group}")
    return group


def rowmv_layout(kind: str, in_f: int, i8: bool, stages: int,
                 group: int = 0, xf32: bool = False) -> dict[str, int]:
    """The body's shared memory, byte offsets (`rm_layout` / `rg_layout` in
    the sources): `stages` stages of 16 rows x 8 spans of each field, every
    field's row pitch 16 bytes past its 8 spans; then x prepped (in_f: x's
    columns, or those of its window; int8
    codes: in_f bytes; bf16 x: 2 in_f; rowmv_g.cuh's bf16 x, or bf16 x as
    f32: each 32-column group at a pitch 16 bytes past its 64 or 128), the
    f32 scales sx per group (int8
    only), the bf16 group sums xs (rowmv.cuh: every kind; rowmv_g.cuh:
    iq1p's, with its int32 code sums xc), and the tile's partial sums
    (rowmv.cuh [3][8 warps][16 rows] f32, rowmv_g.cuh [2][8][16])."""
    G = _rowmv_group(kind, group)
    ng = in_f // G
    stage = Q4K_ROWS * sum(ROWMV_KS * b + 16
                           for b in _rowmv_fields(kind, G) if b)
    x = stages * stage
    if kind in ROWMV_KINDS + ROWMV_X_KINDS:
        sx = x + (in_f if i8 else 2 * in_f)
        xs = sx + (ng * 4 if i8 else 0)
        part = xs + ng * 2
        return {"stage": stage, "x": x, "sx": sx, "xs": xs, "part": part,
                "total": part + 3 * ROWMV_KS * Q4K_ROWS * 4}
    sx = x + (in_f if i8 else in_f // 32 * (32 * (4 if xf32 else 2) + 16))
    xs = sx + (ng * 4 if i8 else 0)
    xc = xs + (ng * 2 if kind == "iq1p" else 0)
    part = xc + (ng * 4 if kind == "iq1p" else 0)
    return {"stage": stage, "x": x, "sx": sx, "xs": xs, "xc": xc,
            "part": part, "total": part + 2 * ROWMV_KS * Q4K_ROWS * 4}


@functools.lru_cache(maxsize=4096)
def rowmv_plan(kind: str, out_f: int, in_f: int, i8: bool,
               group: int = 0, kwin: int = 0) -> RowmvPlan:
    """The tiling of the K2 / K12 / K17b bodies for x (in_f,) and an (out_f,
    in_f) weight of `kind` (q6_k, q2_k, q3_k and the expanded kinds:
    rowmv.cuh; q8_0 and the IQ kinds at scale group `group`: rowmv_g.cuh),
    with int8 (i8) or bf16 activations (the IQ and expanded kinds: int8
    only). Raises ValueError for a shape the kernel does not take (in_f not
    a multiple of 256, out_f not a multiple of 64).

    Every block preps x, so the grid is persistent: as many blocks as fit
    two to an SM (one where the shared memory allows one only), never more
    than the tiles. The ring takes the most stages (4, else 3; rowmv_g.cuh
    also 2) that keep that count. x is whole wherever it fits (in_f up to
    ~67K-174K by kind and body); a wider x goes in windows of `kwin` K
    steps, the widest that fits in the same order of blocks an SM and ring
    depths (the expanded kinds keep x whole: `_expanded_fits` bounds their
    in_f near 10K). kwin forces a window (kwin = ksteps is x whole).
    q8_0's bf16 body keeps x as f32 (xf32) where that fits the same count
    and depth. The tile, the K step and the warp that takes each span
    depend on in_f alone, and x's groups are prepped alike in a window and
    whole, so a row is summed in the same order, of the same values,
    whatever the ring's depth, the grid, x's format and its window."""
    if kind not in ROWMV_KINDS + ROWMV_X_KINDS + ROWMVG_KINDS:
        raise ValueError(f"K2 / K12 serve "
                         f"{ROWMV_KINDS + ROWMV_X_KINDS + ROWMVG_KINDS}, "
                         f"not {kind}")
    if in_f <= 0 or in_f % 256 or out_f <= 0 or out_f % 64:
        raise ValueError(f"K2 / K12 take in_f % 256 == 0 and out_f % 64 == "
                         f"0, not ({out_f}, {in_f})")
    if kind in IQ_KINDS + ROWMV_X_KINDS and not i8:
        raise ValueError(f"K12 takes int8 activations only for {kind}")
    rowmv = kind in ROWMV_KINDS + ROWMV_X_KINDS
    depths = ROWMV_STAGES if rowmv else ROWMVG_STAGES
    span = rowmv_span(kind)
    tiles = out_f // Q4K_ROWS
    ksteps = -(-(in_f // span) // ROWMV_KS)
    if kwin < 0 or kwin > ksteps \
            or (kind in ROWMV_X_KINDS and 0 < kwin < ksteps):
        raise ValueError(f"K2 / K12: a window of {kwin} of {ksteps} K "
                         f"steps for {kind}")
    def smem(kw, stages, xf32=False):
        return rowmv_layout(kind, min(in_f, kw * ROWMV_KS * span), i8,
                            stages, group, xf32)["total"]

    def fits(kw, config, xf32=False):
        per_sm, stages = config
        need = smem(kw, stages, xf32)
        return need <= SMEM_MAX and per_sm * (need + 1024) <= _SMEM_PER_SM

    configs = [(per_sm, stages) for per_sm in (2, 1) for stages in depths]
    got = _window_order(fits, configs, ksteps, kwin,
                        kind not in ROWMV_X_KINDS)
    if got is None:
        raise ValueError(f"K2 / K12: in_f={in_f} needs "
                         f"{smem(ksteps, depths[-1])} bytes of shared "
                         f"memory, more than {SMEM_MAX}")
    kw, (per_sm, stages) = got
    xf32 = kind == "q8_0" and not i8 and fits(kw, (per_sm, stages), True)
    return RowmvPlan(Q4K_ROWS, tiles, ksteps, stages, smem(kw, stages, xf32),
                     min(tiles, per_sm * _SMS), xf32, kw)


def _rowmv_checked(x: torch.Tensor, qt: QTensor, i8: bool, what: str,
                   kwin: int = 0) -> RowmvPlan:
    """The plan of a K2 / K12 / K17b launch (kwin: a window of x it is
    forced to), its operands checked."""
    out_f, in_f = qt.shape
    _check_operands(x[None], qt, what)
    plan = rowmv_plan(qt.kind, out_f, in_f, i8,
                      iq_group(qt) if qt.kind in IQ_KINDS else 0, kwin)
    if any(t.data_ptr() % 16 for t in (x, *qt.data.values())):
        raise ValueError(f"{what} takes 16-byte aligned x and fields")
    return plan


# ---------------------------------------------------------------------------
# K2: q6_k T=1 matvec
# ---------------------------------------------------------------------------

def q6k_matvec_plain(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16. i8: int8 activations per 16-col
    group (`_q6k_row_kernel_i8`); else the exact f32 dot with bf16 x. The
    -32 offset is an exact group-sum term over bf16 group sums."""
    out_f, in_f = qt.shape
    ng = in_f // 16
    v = q6k_values(qt.data["ql"], qt.data["qh"]).reshape(out_f, ng, 16)
    s = qt.data["scale"].float()
    xq, sx, xsum = act_prep_plain(x, 16, i8)
    if i8:
        p = (v * xq.int().reshape(ng, 16)).sum(dim=2)  # exact int32
        t = (p.float() * sx * s).sum(dim=1)
    else:
        p = (v.float() * x.float().reshape(ng, 16)).sum(dim=2)
        t = (s * p).sum(dim=1)
    t = t - 32.0 * (xsum.float() * s).sum(dim=1)
    return t.to(torch.bfloat16).reshape(1, out_f)


def q6k_matvec(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """K2 wrapper. x (in_f,) bf16 contiguous -> (1, out_f) bf16."""
    if not x.is_cuda:
        return q6k_matvec_plain(x, qt, i8)
    y = _q6k_launch(x, qt, i8, "K2")
    _build.launches["K2"] += 1
    return y


_SIG_K2 = [_build.P] * 5 + [_build.I] * 6 + _SIG_STACK + [_build.I,
                                                            _build.P]


def _q6k_launch(x: torch.Tensor, qt: QTensor, i8: bool, what: str,
                li: torch.Tensor | None = None,
                kwin: int = 0) -> torch.Tensor:
    """One launch for x (in_f,) on the card, the body prepping its own
    activations (`rowmv_plan`). li: layer li of stacked fields (K17b)."""
    out_f, in_f = qt.shape
    plan = _rowmv_checked(x, qt, i8, what, kwin)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=x.device)
    d = qt.data
    lib, fn = _build.entry("q6k_matvec", "k2_q6k_matvec", _SIG_K2)
    _build.check(lib, fn(
        d["ql"].data_ptr(), d["qh"].data_ptr(), d["scale"].data_ptr(),
        x.data_ptr(), y.data_ptr(), out_f, in_f, int(i8), plan.grid,
        plan.stages, plan.smem, *_stack_args(qt, ("ql", "qh", "scale"), li),
        plan.kwin, _build.stream_ptr()), what)
    return y


# ---------------------------------------------------------------------------
# K2.q8_0: q8_0 T=1 matvec
# ---------------------------------------------------------------------------

def _q8_0_order_sum(v: torch.Tensor) -> torch.Tensor:
    """(R, ng) f32 group terms -> (R,) f32 summed in K2.q8_0's order
    (csrc/rowmv_g.cuh): per row and group i of the 4 in each span, warp w
    adds the terms of groups 4sp + i of its spans sp = 8k + w in turn from
    0, K step by K step; each warp then adds (i 0 + i 1) + (i 2 + i 3), and
    the 8 warps' sums meet in warp order. Groups past ng add nothing."""
    R, ng = v.shape
    per_step = ROWMV_KS * 4  # groups of one K step: 8 spans of 4
    v = torch.nn.functional.pad(v, (0, -ng % per_step)).reshape(
        R, -1, ROWMV_KS, 4)  # (row, K step, warp, i)
    acc = torch.zeros((R, ROWMV_KS, 4), dtype=v.dtype, device=v.device)
    for k in range(v.shape[1]):
        acc = acc + v[:, k]
    warp = (acc[:, :, 0] + acc[:, :, 1]) + (acc[:, :, 2] + acc[:, :, 3])
    t = warp[:, 0]
    for w in range(1, ROWMV_KS):
        t = t + warp[:, w]
    return t


def q8_0_matvec_plain(x: torch.Tensor, qt: QTensor,
                      i8: bool = True) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16 per 32-col group g with scale s_g,
    y = sum_g P_g * s_g in the kernel's fixed order (`_q8_0_order_sum`), so
    K2.q8_0 matches this bit for bit. i8 (`_q8_0_row_kernel_i8`): int8
    activations, each term (exact int32 dot * sx_g) * s_g. bf16
    (`_q8_0_row_kernel`, KCPP_MM_I8=0): P_g = the f32 sum of the exact
    products x_c * q_c, added in column order from 0, as the kernel adds
    them; each term P_g * s_g."""
    out_f, in_f = qt.shape
    ng = in_f // 32
    q = qt.data["q"].reshape(out_f, ng, 32)
    if i8:
        xq, sx, _ = act_prep_plain(x, 32, True)
        p = (q.int() * xq.int().reshape(ng, 32)).sum(dim=2)  # exact int32
        v = p.float() * sx * qt.data["scale"].float()
    else:
        xf, qf = x.float().reshape(ng, 32), q.float()
        p = torch.zeros((out_f, ng), dtype=torch.float32, device=x.device)
        for c in range(32):
            p = p + qf[:, :, c] * xf[:, c]  # each product exact in f32
        v = p * qt.data["scale"].float()
    return _q8_0_order_sum(v).to(torch.bfloat16).reshape(1, out_f)


def q8_0_matvec(x: torch.Tensor, qt: QTensor, i8: bool = True) -> torch.Tensor:
    """K2.q8_0 wrapper (i8; K2.q8_0_bf16 for bf16 activations). x (in_f,)
    bf16 contiguous -> (1, out_f) bf16."""
    if not x.is_cuda:
        return q8_0_matvec_plain(x, qt, i8)
    y = _q8_0_launch(x, qt, i8, "K2.q8_0")
    if i8:
        _count("K2", qt)
    else:
        _build.launches["K2.q8_0_bf16"] += 1
    return y


_SIG_K2Q8 = [_build.P] * 4 + [_build.I] * 6 + _SIG_STACK + [_build.I,
                                                              _build.P]


def _q8_0_launch(x: torch.Tensor, qt: QTensor, i8: bool, what: str,
                 li: torch.Tensor | None = None,
                 kwin: int = 0) -> torch.Tensor:
    """One launch for x (in_f,) on the card, the body prepping its own
    activations (`rowmv_plan`). li: layer li of stacked fields (K17b)."""
    out_f, in_f = qt.shape
    plan = _rowmv_checked(x, qt, i8, what, kwin)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=x.device)
    d = qt.data
    lib, fn = _build.entry("q8_0_matvec", "k2_q8_0_matvec", _SIG_K2Q8)
    _build.check(lib, fn(
        d["q"].data_ptr(), d["scale"].data_ptr(), x.data_ptr(), y.data_ptr(),
        out_f, in_f, 1 if i8 else 2 if plan.xf32 else 0, plan.grid,
        plan.stages, plan.smem,
        *_stack_args(qt, ("q", None, None, "scale"), li), plan.kwin,
        _build.stream_ptr()), what)
    return y


# ---------------------------------------------------------------------------
# K12: q2_k / q3_k T=1 matvec
# ---------------------------------------------------------------------------

def q23k_matvec_plain(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16 for a q2_k or q3_k QTensor, per
    16-col group g with scale s_g (and q2_k's min m_g) and bf16 group sum
    xs_g. i8 (`_q2k_row_kernel_i8`, `_q3k_row_kernel_i8`): int8 activations
    per group, exact int32 dots P_g with the codes (q2 0..3, q3 0..7), y =
    sum_g P_g sx_g s_g - sum_g xs_g m_g (q2_k) or - 4 sum_g xs_g s_g
    (q3_k). bf16 (`_q2k_row_kernel`, `_q3k_row_kernel`): the exact f32 dot
    with the magic-number value over its power of two (q2 + 4, q3 + 8), so
    the constant lands on the rounded group sum as in JAX: y = sum_g s_g
    P_g - 4 sum_g xs_g s_g - sum_g xs_g m_g (q2_k) or - 12 sum_g xs_g s_g
    (q3_k)."""
    out_f, in_f = qt.shape
    ng = in_f // 16
    d = qt.data
    v = (q2k_values(d["qs"]) if qt.kind == "q2_k"
         else q3k_values(d["qs"], d["hmask"])).int().reshape(out_f, ng, 16)
    s = d["scale"].float()
    xq, sx, xsum = act_prep_plain(x, 16, i8)
    xs = (xsum.float() * s).sum(dim=1)
    if i8:
        p = (v * xq.int().reshape(ng, 16)).sum(dim=2)  # exact int32
        t = (p.float() * sx * s).sum(dim=1)
        t = t - 4.0 * xs if qt.kind == "q3_k" else t
    else:
        off = 4 if qt.kind == "q2_k" else 8
        p = ((v + off).float() * x.float().reshape(ng, 16)).sum(dim=2)
        t = (s * p).sum(dim=1) - (4.0 if qt.kind == "q2_k" else 12.0) * xs
    if qt.kind == "q2_k":
        t = t - (xsum.float() * d["min"].float()).sum(dim=1)
    return t.to(torch.bfloat16).reshape(1, out_f)


def q23k_matvec(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """K12 wrapper (q2_k or q3_k). x (in_f,) bf16 contiguous -> (1, out_f)
    bf16."""
    if not x.is_cuda:
        return q23k_matvec_plain(x, qt, i8)
    if qt.kind not in _LOWBIT:
        raise ValueError(f"K12 serves q2_k and q3_k, not {qt.kind}")
    y = _q23k_launch(x, qt, i8, "K12")
    _count("K12", qt)
    return y


_SIG_K12 = [_build.I] + [_build.P] * 6 + [_build.I] * 6 + _SIG_STACK \
    + [_build.I, _build.P]


def _q23k_launch(x: torch.Tensor, qt: QTensor, i8: bool, what: str,
                 li: torch.Tensor | None = None,
                 kwin: int = 0) -> torch.Tensor:
    """As _q6k_launch, for q2_k (qs, scale, min) and q3_k (qs, hmask,
    scale)."""
    out_f, in_f = qt.shape
    plan = _rowmv_checked(x, qt, i8, what, kwin)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=x.device)
    d = qt.data
    lib, fn = _build.entry("q23k_matvec", "k12_q23k_matvec", _SIG_K12)
    _build.check(lib, fn(
        int(qt.kind == "q3_k"), d["qs"].data_ptr(), _ptr(d.get("hmask")),
        d["scale"].data_ptr(), _ptr(d.get("min")), x.data_ptr(),
        y.data_ptr(), out_f, in_f, int(i8), plan.grid, plan.stages,
        plan.smem, *_stack_args(qt, ("qs", "hmask", "scale", "min"), li),
        plan.kwin, _build.stream_ptr()), what)
    return y


# ---------------------------------------------------------------------------
# K12.iq: the IQ kinds' T=1 matvec
# ---------------------------------------------------------------------------

def iq_matvec_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16 for an IQ QTensor of scale group G
    (`_iq2p_row_kernel_i8`, `_iq3p_row_kernel_i8`, `_iq1p_row_kernel_i8`):
    int8 activations per group of G columns, exact int32 dots P_g with the
    signed values, y = sum_g P_g sx_g s_g, and for iq1p - sum_g xs_g m_g
    over the bf16 group sums xs."""
    out_f, in_f = qt.shape
    G = iq_group(qt)
    ng = in_f // G
    v = iq_values(qt).reshape(out_f, ng, G)
    xq, sx, xsum = act_prep_plain(x, G, True)
    p = (v * xq.int().reshape(ng, G)).sum(dim=2)  # exact int32
    t = (p.float() * sx * qt.data["scale"].float()).sum(dim=1)
    if qt.kind == "iq1p":
        t = t - (xsum.float() * qt.data["min"].float()).sum(dim=1)
    return t.to(torch.bfloat16).reshape(1, out_f)


def iq_matvec(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K12.iq wrapper. x (in_f,) bf16 contiguous -> (1, out_f) bf16."""
    if not x.is_cuda:
        return iq_matvec_plain(x, qt)
    if qt.kind not in IQ_KINDS:
        raise ValueError(f"K12.iq serves the IQ kinds, not {qt.kind}")
    y = _iq_launch(x, qt, "K12")
    _count("K12", qt)
    return y


_SIG_K12IQ = [_build.I] + [_build.P] * 7 + [_build.I] * 6 + _SIG_STACK \
    + [_build.I, _build.P]


def _iq_launch(x: torch.Tensor, qt: QTensor, what: str,
               li: torch.Tensor | None = None,
               kwin: int = 0) -> torch.Tensor:
    """As _q8_0_launch, for an IQ kind (qs, hmask, sg, scale, min as the
    kind has them) at its scale group G."""
    out_f, in_f = qt.shape
    plan = _rowmv_checked(x, qt, True, what, kwin)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=x.device)
    d = qt.data
    lib, fn = _build.entry("iq_matvec", "k12_iq_matvec", _SIG_K12IQ)
    _build.check(lib, fn(
        IQ_KINDS.index(qt.kind), d["qs"].data_ptr(), _ptr(d.get("hmask")),
        _ptr(d.get("sg")), d["scale"].data_ptr(), _ptr(d.get("min")),
        x.data_ptr(), y.data_ptr(), out_f, in_f, iq_group(qt), plan.grid,
        plan.stages, plan.smem,
        *_stack_args(qt, ("qs", "hmask", "sg", "scale", "min"), li),
        plan.kwin, _build.stream_ptr()), what)
    return y


# ---------------------------------------------------------------------------
# K12 expanded: the T=1 matvec of q6_k_i8f / q3_k_n4 / q2_k_n4
# (KCPP_KQ_LAYOUT=expanded)
# ---------------------------------------------------------------------------

def expanded_codes(qt: QTensor) -> torch.Tensor:
    """(out_f, in_f) int32 logical-order codes of an expanded QTensor:
    q6_k_i8f's signed values q6-32, the n4 kinds' codes (q3 0..7, q2
    0..3)."""
    return (qt.data["q"] if qt.kind == "q6_k_i8f"
            else n4_values(qt.data["n4"])).int()


def kq_expanded_matvec_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16 for q6_k_i8f / q3_k_n4 / q2_k_n4
    (`_q6k_i8f_row_kernel`, `_q3k_n4_row_kernel`, `_q2k_n4_row_kernel`):
    int8 activations per 16-col group g (codes rint(x * (127 / a_g)), sx_g
    = a_g / 127), exact int32 dots P_g with the codes, y = sum_g P_g sx_g
    s_g, minus 4 sum_g xs_g s_g (q3_k_n4) or sum_g xs_g m_g (q2_k_n4) in
    f32 over the bf16-rounded group sums xs. The JAX n4 bodies quantize
    the two halves of x apart; their groups are the same 16 columns."""
    out_f, in_f = qt.shape
    ng = in_f // 16
    v = expanded_codes(qt).reshape(out_f, ng, 16)
    s = qt.data["scale"].float()
    xq, sx, xsum = act_prep_plain(x, 16, True)
    p = (v * xq.int().reshape(ng, 16)).sum(dim=2)  # exact int32
    t = (p.float() * sx * s).sum(dim=1)
    if qt.kind == "q3_k_n4":
        t = t - 4.0 * (xsum.float() * s).sum(dim=1)
    elif qt.kind == "q2_k_n4":
        t = t - (xsum.float() * qt.data["min"].float()).sum(dim=1)
    return t.to(torch.bfloat16).reshape(1, out_f)


def kq_expanded_matvec(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K12 expanded wrapper. x (in_f,) bf16 contiguous -> (1, out_f) bf16.
    One launch of rowmv.cuh's body (`rowmv_plan`), which preps its own x;
    y its one allocation."""
    if not x.is_cuda:
        return kq_expanded_matvec_plain(x, qt)
    out_f, in_f = qt.shape
    if qt.kind not in ROWMV_X_KINDS:
        raise ValueError(f"K12 expanded serves {ROWMV_X_KINDS}, not "
                         f"{qt.kind}")
    plan = _rowmv_checked(x, qt, True, "K12")
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=x.device)
    d = qt.data
    lib, fn = _build.entry("kq_expanded_matvec", "k12_expanded_matvec",
                           _SIG_K12X)
    _build.check(lib, fn(
        ROWMV_X_KINDS.index(qt.kind),
        (d["q"] if qt.kind == "q6_k_i8f" else d["n4"]).data_ptr(),
        d["scale"].data_ptr(), _ptr(d.get("min")), x.data_ptr(),
        y.data_ptr(), out_f, in_f, plan.grid, plan.stages, plan.smem,
        _build.stream_ptr()), "K12")
    _count("K12", qt)
    return y


_SIG_K12X = [_build.I] + [_build.P] * 5 + [_build.I] * 5 + [_build.P]


# ---------------------------------------------------------------------------
# K3: q4_k / q5_k / q6_k / q8_0 tiled matmul (prefill); K13: its q2_k /
# q3_k, IQ and q4_k_i8 bodies
# ---------------------------------------------------------------------------

def _group_sums(x: torch.Tensor, group: int) -> torch.Tensor:
    """(T, in_f) -> (T, in_f/group) bf16 of the f32 sums (XLA glue in JAX)."""
    T, in_f = x.shape
    return x.float().reshape(T, in_f // group, group).sum(-1).to(torch.bfloat16)


def kq_dequant_bf16(qt: QTensor) -> torch.Tensor:
    """The weight K3 / K13 feeds its product: bf16(q * scale), q the raw
    code (q4_k nibble 0..15, q5_k value 0..31, q6_k value 0..63, q8_0 int8,
    q2_k 0..3, q3_k 0..7, q4_k_i8 the int8 code 0..15) or an IQ kind's
    signed value, as `_q4k_kernel` / `_q5k_kernel` / `_q6k_kernel` /
    `_q8_0_kernel` / `_q2k_kernel` / `_q3k_kernel` / `_iq2p_kernel` /
    `_iq3p_kernel` / `_iq1p_kernel` / `_q4k_i8_kernel` (JAX
    multiplies the bf16 value by the bf16 expanded scale, so for |v| up to
    62 the product rounds)."""
    out_f, in_f = qt.shape
    d = qt.data
    if qt.kind in IQ_KINDS:
        q = iq_values(qt).float().reshape(out_f, -1, iq_group(qt))
    elif qt.kind == "q6_k":
        q = q6k_values(d["ql"], d["qh"]).float().reshape(out_f, -1, 16)
    elif qt.kind in _LOWBIT:
        q = (q2k_values(d["qs"]) if qt.kind == "q2_k"
             else q3k_values(d["qs"], d["hmask"])).float().reshape(
                 out_f, -1, 16)
    else:
        q = (q4k_values(d["qs2"]) if qt.kind == "q4_k"
             else q5k_values(d["qs2"], d["qh"]) if qt.kind == "q5_k"
             else d["q"]).float().reshape(out_f, -1, 32)
    w = q * qt.data["scale"].float()[..., None]
    return w.reshape(out_f, in_f).to(torch.bfloat16)


def kq_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (T, in_f) bf16 -> (T, out_f) bf16; f32 accumulation. The affine
    term over bf16 group sums: - min (q4_k, q5_k, q4_k_i8 per 32 cols; q2_k
    per 16; iq1p per G), - 32 * scale (q6_k), - 4 * scale (q3_k)."""
    w = kq_dequant_bf16(qt).float()
    acc = torch.matmul(x.float(), w.t())
    group = _affine_group(qt)
    if "min" in qt.data:
        acc = acc - torch.matmul(_group_sums(x, group).float(),
                                 qt.data["min"].float().t())
    elif group:
        acc = acc - (32.0 if qt.kind == "q6_k" else 4.0) * torch.matmul(
            _group_sums(x, group).float(), qt.data["scale"].float().t())
    return acc.to(torch.bfloat16)


def kq_matmul_magic_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K3.q4_k_magic's plain version, `_q4k_magic_kernel` (KCPP_Q4K_2D=
    magic): x (T, in_f) bf16 -> (T, out_f) bf16 for a q4_k QTensor, w = s n
    taken as 0.125 bf16(s (128 + 8 n)) - 16 s: the f32 product with the
    bf16 weights bf16(s (128 + 8 n)) (one rounding of an exact product,
    where `sexp` rounds s n), times 0.125, less 16 xsum . s and xsum . min
    over the bf16 group sums of 32 columns."""
    out_f, in_f = qt.shape
    n = q4k_values(qt.data["qs2"]).float().reshape(out_f, -1, 32)
    s = qt.data["scale"].float()
    w = (s[..., None] * (128.0 + 8.0 * n)).reshape(out_f, in_f)
    acc = torch.matmul(x.float(), w.to(torch.bfloat16).float().t()) * 0.125
    xs = _group_sums(x, 32).float()
    acc = acc - 16.0 * torch.matmul(xs, s.t())
    acc = acc - torch.matmul(xs, qt.data["min"].float().t())
    return acc.to(torch.bfloat16)


def _affine_group(qt: QTensor) -> int:
    """The group width of kq_matmul's affine term (0: none)."""
    group = _K3_KINDS[qt.kind][4]
    return iq_group(qt) if group is None else group


class KqPlan(NamedTuple):
    """How `kq_matmul` tiles one call (csrc/kq_matmul.cu): the variant
    ("swap": mma.sync with the tokens as N, T <= 8; "wgmma": warpgroup
    MMA, T > 8), the output tile (rows: weight rows per block; tokens:
    tokens per block), the K split (parts of a block that each take every
    split-th superblock, added in a fixed order at the end) and the grid
    (out_f / rows, ceil(T / tokens))."""
    variant: str
    rows: int
    tokens: int
    split: int
    grid: tuple[int, int]


# the kernel's K step: one 256-column superblock, which every packed field
# covers in whole 16-byte pieces
KQ_K_STEP = 256
KQ_SWAP_MAX_T = 8  # the swapped-operand variant's tokens (mma.sync N)
_SMS = 132  # the H100's SMs: the plan's grid-fill target
_KQ_VARIANTS = ("swap", "wgmma")


# the kinds whose per-superblock shared memory (a 192- or 256-byte code
# image per row, or iq1p's 8-column scales and mins) leaves room for no
# second 64-row group in a K-split block
_KQ_WIDE_KINDS = ("q6_k", "q8_0", "q4_k_i8", "iq1p")


def kq_split(out_f: int, in_f: int) -> int:
    """The wgmma variant's K split: 1 where out_f / 64 row tiles fill the
    card, else 2 warpgroup parts per tile where the superblock count is
    even (a split of 4 lost more at T = 512 on the 1.1B's 2048- and
    2560-row weights than it gained at T <= 128). A function of the
    weight's shape alone, so a row's sums run in the same order at every
    T."""
    return 1 if out_f // 64 >= _SMS or (in_f // KQ_K_STEP) % 2 else 2


@functools.lru_cache(maxsize=4096)
def kq_plan(kind: str, T: int, out_f: int, in_f: int, grp: int = 0) -> KqPlan:
    """The tiling of K3 / K13 for x (T, in_f) and an (out_f, in_f) weight of
    `kind` (grp: an IQ kind's scale group). Raises ValueError for a shape
    the kernel does not take.

    T <= 8 takes the swapped-operand variant: 16 weight rows per block, the
    K split across 4 warps. Larger T takes the wgmma variant with
    `kq_split`'s split. Split: 64 x 64 tiles up to T = 128, then 64 x 128
    (`_KQ_WIDE_KINDS`) or 128 rows of 64 / 128 tokens (128 while the
    blocks still fill half the card). Unsplit: 64-token tiles up to T = 64
    or while out_f / 64 tiles of 128 tokens would leave SMs idle, 128
    otherwise; 128 weight rows where that still fills the card, 64
    otherwise (the shapes measured fastest on the H100; PERF.md).
    The splits do not depend on T, and the tile shapes only regroup
    independent rows and columns, so within a variant row t of y is the
    same whatever T is."""
    if kind not in _K3_KINDS:
        raise ValueError(f"kq_matmul serves {tuple(_K3_KINDS)}, not {kind}")
    if T < 1 or in_f <= 0 or in_f % KQ_K_STEP or out_f <= 0 or out_f % 64:
        raise ValueError(f"kq_matmul takes T >= 1, in_f % 256 == 0 and "
                         f"out_f % 64 == 0, not T={T} ({out_f}, {in_f})")
    if kind in IQ_KINDS and grp not in (8, 16, 32):
        raise ValueError(f"{kind}: scale group {grp} is not 8, 16 or 32")
    if T <= KQ_SWAP_MAX_T:
        return KqPlan("swap", 16, KQ_SWAP_MAX_T, 4, (out_f // 16, 1))
    split = kq_split(out_f, in_f)
    if split > 1:
        # small T: the most blocks; large T: a wider tile, less x re-read
        # (two 64-row groups where the kind's superblock slots leave room)
        rows, tokens = 64, 64
        if T > 128:
            if kind in _KQ_WIDE_KINDS:
                tokens = 128
            else:
                rows = 128
                tokens = 128 if (out_f // 128) * -(-T // 128) > _SMS // 2 \
                    else 64
    else:
        tokens = 128 if T > 64 and (out_f // 64) * -(-T // 128) >= _SMS \
            else 64
        rows = 128 if (out_f % 128 == 0
                       and (out_f // 128) * -(-T // tokens) >= _SMS) else 64
    n_tiles = -(-T // tokens)
    if n_tiles > 65535:
        raise ValueError(f"kq_matmul: T={T} needs more than 65535 tiles")
    return KqPlan("wgmma", rows, tokens, split, (out_f // rows, n_tiles))


def kq_matmul(x: torch.Tensor, qt: QTensor,
              magic: bool = False) -> torch.Tensor:
    """K3 / K13 wrapper. x (T, in_f) bf16 contiguous -> (T, out_f) bf16.
    Two launches, counted once: the prep kernel (x with its columns
    permuted per superblock, the affine term's group sums) and the matmul
    `kq_plan` picks. magic: a q4_k weight through the magic-number body
    (K3.q4_k_magic, `kq_matmul_magic_plain`)."""
    if magic and qt.kind != "q4_k":
        raise ValueError(f"K3.q4_k_magic takes q4_k, not {qt.kind}")
    if not x.is_cuda:
        return (kq_matmul_magic_plain if magic else kq_matmul_plain)(x, qt)
    out_f, in_f = qt.shape
    T = x.shape[0]
    what = "K13" if qt.kind in _K13_KINDS else "K3"
    _check_operands(x, qt, what)
    G = iq_group(qt) if qt.kind in IQ_KINDS else 0
    plan = kq_plan(qt.kind, T, out_f, in_f, G)
    if any(t.data_ptr() % 16 for t in (x, *qt.data.values())):
        raise ValueError(f"{what} takes 16-byte aligned x and fields")
    lib = _build.load("kq_matmul", {
        "k3_kq_matmul": [_build.I] + [_build.P] * 9 + [_build.I] * 10
        + [_build.P]})
    d = qt.data
    kind, w0, w1, w2, _ = _K3_KINDS[qt.kind]
    kind = _KQ_MAGIC if magic else kind
    group = _affine_group(qt)
    xp = torch.empty_like(x)
    xs = None
    if group:
        na = 2 if qt.kind == "iq1p" else 1  # affine k16 steps per superblock
        xs = torch.empty(((in_f // KQ_K_STEP) * na * -(-T // 8) * 128,),
                         dtype=torch.bfloat16, device=x.device)
    y = torch.empty((T, out_f), dtype=torch.bfloat16, device=x.device)
    _build.check(lib, lib.k3_kq_matmul(
        kind, x.data_ptr(), xp.data_ptr(), _ptr(xs), d[w0].data_ptr(),
        _ptr(d[w1] if w1 else None), _ptr(d[w2] if w2 else None),
        d["scale"].data_ptr(), _ptr(d.get("min")), y.data_ptr(), T, out_f,
        in_f, G, _KQ_VARIANTS.index(plan.variant), plan.rows, plan.tokens,
        plan.split, *plan.grid, _build.stream_ptr()), what)
    if magic:
        _build.launches["K3.q4_k_magic"] += 1
    else:
        _count(what, qt)
    return y


# ---------------------------------------------------------------------------
# dispatch (mirrors quant_matmul.py:2041-2177 of the JAX package for
# q2_k/q3_k/q4_k/q5_k/q6_k/q8_0, the IQ kinds and the opt-in kinds, with
# KCPP_SBQ, KCPP_MM_I8 and KCPP_Q4K_I8 read as it reads them)
# ---------------------------------------------------------------------------

# the fields without which the JAX dispatch declines a kind (`_FIELD_LISTS`
# in the port's names)
_OPT_IN_FIELDS = {"q4_k_i8": ("q", "scale", "min"),
                  "q6_k_i8f": ("q", "scale"), "q3_k_n4": ("n4", "scale"),
                  "q2_k_n4": ("n4", "scale", "min")}
# the fields of the dense kind an expanded kind re-dispatches to at T > 1
_DENSE_FIELDS = {"q6_k": ("ql", "qh", "scale"),
                 "q3_k": ("qs", "hmask", "scale"),
                 "q2_k": ("qs", "scale", "min")}


def _mm_i8(kind: str, in_f: int) -> bool:
    """The JAX `_mm_i8`: int8 activations for the q8_0 / q6_k / q2_k / q3_k
    T=1 bodies unless KCPP_MM_I8=0; q6_k / q2_k / q3_k from in_f 512 up."""
    if kind in ("q6_k", "q2_k", "q3_k") and in_f < 512:
        return False
    return os.environ.get("KCPP_MM_I8", "1") == "1"


def _q45_i8(in_f: int, T: int) -> bool:
    """The JAX `i8_q45`: int8 activations for q4_k / q5_k (K1 / K7) from
    in_f 512 up, while T * (in_f/64) * (in_f/2) <= 4 Mi, unless
    KCPP_Q4K_I8=0."""
    return (in_f >= 512 and os.environ.get("KCPP_Q4K_I8", "1") == "1"
            and (T == 1 or T * (in_f // 64) * (in_f // 2) <= 4 * 1024 * 1024))


def _expanded_fits(kind: str, in_f: int) -> bool:
    """The JAX T=1 scratch bound of the expanded bodies: (in_f/16, in_f)
    int8 for q6_k_i8f, 2 x (in_f/32, in_f/2) for the n4 kinds, at least 8
    rows."""
    if kind == "q6_k_i8f":
        return (in_f // 16) * in_f <= 6 * 1024 * 1024 and in_f // 16 >= 8
    return (in_f // 32) * (in_f // 2) <= 3 * 1024 * 1024 and in_f // 32 >= 8


def matmul_packed(x: torch.Tensor, qt: QTensor) -> torch.Tensor | None:
    """Route x (..., in_f) through the kernel the JAX package would pick, or
    return None where it declines (see the module docstring).

    T=1: q4_k/q5_k take K1 (int8 activations for in_f >= 512 unless
    KCPP_Q4K_I8=0: `_q4k/_q5k_decode_kernel_i8`; bf16 otherwise:
    `_q4k/_q5k_decode_kernel`), q6_k takes K2 (`_q6k_row_kernel_i8` from
    in_f 512 up unless KCPP_MM_I8=0, else `_q6k_row_kernel`), q2_k/q3_k
    take K12 (`_q2k/_q3k_row_kernel_i8` / `_q2k/_q3k_row_kernel`, the same
    rule), q8_0 takes K2.q8_0 (`_q8_0_row_kernel_i8`, every in_f) or
    K2.q8_0_bf16 under KCPP_MM_I8=0 (`_q8_0_row_kernel`), the IQ kinds
    take K12.iq (`_iq2p/_iq3p/_iq1p_row_kernel_i8`) where in_f >= 32 G for
    their scale group G and K13 below that (JAX's row kernels need 8
    scratch sublanes; there is no bf16 K12.iq), the expanded kinds take
    K12 expanded (`_q6k_i8f_row_kernel`, `_q3k/_q2k_n4_row_kernel`) where
    their scratch fits (`_expanded_fits`) and decline otherwise.
    At T > 1 the expanded kinds run as their dense kind when they carry
    its fields and decline otherwise; q4_k_i8 takes K13 at every T
    (`_q4k_i8_kernel`: JAX has no q4_k_i8 matvec, and K14 / K15 decline
    it).
    Under KCPP_SBQ=1, q4_k/q5_k at 2 <= T <= 16 with in_f >= 2048 take K14
    (`_q4k/_q5k_decode_kernel_sbq`; `_sbq`) ahead of every other branch.
    q4_k/q5_k at 2 <= T <= 8 take K7 (int8, under `_q45_i8`:
    `_q4k/_q5k_decode_kernel_i8_t`) or at T <= 4 the bf16 variant. Every
    other shape goes to K3 (`_q4k_kernel`, `_q5k_kernel`, `_q6k_kernel`,
    `_q8_0_kernel`; K13: `_q2k_kernel`, `_q3k_kernel`, `_iq2p_kernel`,
    `_iq3p_kernel`, `_iq1p_kernel`, `_q4k_i8_kernel`); q6_k, q8_0, q2_k,
    q3_k and the IQ kinds thus take K3 / K13 at every T > 1, the batched
    decode step included. The TPU-only VMEM row-tile checks that can also
    send a T=1 call to the 2-D kernel are not mirrored, but where
    KCPP_MATVEC_MAX_T lifts the bf16 q4_k / q5_k cap past K7's 8 tokens,
    K7's bf16 body serves what the JAX `_q4k_matvec_rt` admits and K3 the
    rest.

    The launcher's kernel-selection variables, read where the JAX dispatch
    reads them: KCPP_MATVEC_MAX_T (at import) caps every matvec's T where
    the activations are not int8 (the default 4; K7's int8 body keeps 8);
    KCPP_Q4K_DECODE other than "1" turns every matvec off (K3 / K13 take
    T = 1 too, in their swap form); KCPP_Q4K_2D=magic sends K3's q4_k
    calls to its magic-number body; KCPP_PALLAS_MM=0 sends every call to
    K3 / K13 (an expanded kind as its dense kind, where it carries its
    fields). KCPP_Q4K_RAW_X picks between two JAX bodies of one function
    (tests/test_torch_kernel_vars.py), both K1's bf16 body."""
    out_f, in_f = qt.shape
    if out_f % 256 or in_f % 256:
        return None
    if any(n not in qt.data for n in _OPT_IN_FIELDS.get(qt.kind, ())):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_f).to(torch.bfloat16).contiguous()
    T = x2.shape[0]
    q45 = qt.kind in ("q4_k", "q5_k")
    pallas = pallas_on()
    if qt.kind in EXPANDED:
        if T == 1 and pallas:
            if not _expanded_fits(qt.kind, in_f):
                return None
            return kq_expanded_matvec(x2[0], qt).reshape(*lead, out_f)
        dense_kind = EXPANDED[qt.kind]
        if any(n not in qt.data for n in _DENSE_FIELDS[dense_kind]):
            return None
        return matmul_packed(x, QTensor(kind=dense_kind, shape=qt.shape,
                                        data=qt.data,
                                        whole_in_f=qt.whole_in_f))
    decode = pallas and _decode_on()
    if decode and _sbq(qt, T):
        return q4k_matvec_sbq(x2, qt).reshape(*lead, out_f)
    # a row-parallel shard takes the activation variant of its whole weight
    act_in = qt.whole_in_f or in_f
    i8 = q45 and _q45_i8(act_in, T)
    # the JAX `max_t`: 8 for int8 q4_k / q5_k activations, else the cap
    matvec = decode and T <= (8 if i8 else MATVEC_MAX_T)
    if matvec and T == 1 and qt.kind in IQ_KINDS:
        if in_f >= 32 * iq_group(qt):
            return iq_matvec(x2[0], qt).reshape(*lead, out_f)
    elif matvec and T == 1 and qt.kind != "q4_k_i8":
        if qt.kind == "q8_0":
            y = q8_0_matvec(x2[0], qt, i8=_mm_i8(qt.kind, act_in))
        elif q45:
            y = q4k_matvec(x2[0], qt, i8=i8)
        else:
            fn = q23k_matvec if qt.kind in _LOWBIT else q6k_matvec
            y = fn(x2[0], qt, i8=_mm_i8(qt.kind, act_in))
        return y.reshape(*lead, out_f)
    elif matvec and q45 and (T <= 8 or _q4k_matvec_rt(
            qt.kind, out_f, in_f, T, False, False) is not None):
        return q4k_matvec_t(x2, qt, i8).reshape(*lead, out_f)
    # ultra-wide in_f: even the JAX package's smallest 2-D tile does not fit
    # its VMEM budget, and it takes the dequant path instead
    if 12 * 128 * (in_f // 2) + 4 * 64 * (in_f // 2) > VMEM_BUDGET + 1024 * 1024:
        return None
    return kq_matmul(x2, qt, magic=qt.kind == "q4_k" and _magic()
                     ).reshape(*lead, out_f)


# ---------------------------------------------------------------------------
# K17a / K17b: the T=1 matvecs over layer li of a layer-stacked QTensor (the
# scan decode path's `LayerRef`)
# ---------------------------------------------------------------------------

# the kinds of K17b: K2's and K12's bodies
_K17B_KINDS = ("q6_k", "q8_0") + _LOWBIT + IQ_KINDS


def q4k_matvec_stacked_plain(x: torch.Tensor, qt: QTensor, li,
                             i8: bool) -> torch.Tensor:
    """K1's plain version on layer li (an int or a one-element tensor) of
    the stacked fields."""
    return q4k_matvec_plain(x, layer_of(qt, int(li)), i8)


def q4k_matvec_stacked(x: torch.Tensor, qt: QTensor, li: torch.Tensor,
                       i8: bool) -> torch.Tensor:
    """K17a wrapper (q4_k or q5_k). x (in_f,) bf16 contiguous; qt's fields
    carry a leading layer axis; li the layer as a one-element int32 tensor
    on x's device (read by the kernel, never by the host) -> (1, out_f)
    bf16, equal to K1 on layer li bit for bit."""
    if not x.is_cuda:
        return q4k_matvec_stacked_plain(x, qt, li, i8)
    _check_stacked(x, qt, li, "K17a")
    y = _q4k_launch(x[None], qt, i8, "K17a", li)
    _count("K17a", qt)
    return y


def matvec_stacked_plain(x: torch.Tensor, qt: QTensor, li,
                         i8: bool) -> torch.Tensor:
    """The per-layer plain version (K2, K2.q8_0, K12, K12.iq) on layer li
    (an int or a one-element tensor) of the stacked fields."""
    layer = layer_of(qt, int(li))
    if qt.kind == "q6_k":
        return q6k_matvec_plain(x, layer, i8)
    if qt.kind == "q8_0":
        return q8_0_matvec_plain(x, layer, i8)
    if qt.kind in _LOWBIT:
        return q23k_matvec_plain(x, layer, i8)
    return iq_matvec_plain(x, layer)


def matvec_stacked(x: torch.Tensor, qt: QTensor, li: torch.Tensor,
                   i8: bool) -> torch.Tensor:
    """K17b wrapper (q6_k, q8_0, q2_k, q3_k and the IQ kinds; i8 is ignored
    for the IQ kinds, whose bodies take int8 activations only). As
    q4k_matvec_stacked, for K2's and K12's bodies."""
    if qt.kind not in _K17B_KINDS:
        raise ValueError(f"K17b serves {_K17B_KINDS}, not {qt.kind}")
    if not x.is_cuda:
        return matvec_stacked_plain(x, qt, li, i8)
    _check_stacked(x, qt, li, "K17b")
    if qt.kind == "q6_k":
        y = _q6k_launch(x, qt, i8, "K17b", li)
    elif qt.kind == "q8_0":
        y = _q8_0_launch(x, qt, i8, "K17b", li)
    elif qt.kind in _LOWBIT:
        y = _q23k_launch(x, qt, i8, "K17b", li)
    else:
        y = _iq_launch(x, qt, "K17b", li)
    if qt.kind == "q8_0" and not i8:
        _build.launches["K17b.q8_0_bf16"] += 1
    else:
        _count("K17b", qt)
    return y


def matmul_packed_stacked(x: torch.Tensor, qt: QTensor,
                          li: torch.Tensor) -> torch.Tensor | None:
    """Route x (..., in_f) through the stacked kernel the JAX
    `matmul_packed_stacked` would pick for layer li of the layer-stacked qt
    (fields with a leading layer axis, shape the per-layer (out, in)), or
    return None where it declines; `LayerRef.take()` then serves the layer
    through `matmul_packed`.

    Declines: out_f or in_f not a multiple of 256, more than one token,
    q4_k / q5_k with in_f < 512, q5_k under KCPP_Q4K_I8=0, an IQ kind with
    in_f < 32 G, and the kinds no stacked kernel serves: dense, q4_k_i8 and
    the expanded kinds (the JAX function raises ValueError on an expanded
    kind, which reaches `_packed_matvec_stacked` without a branch; the port
    declines it, as the JAX docstring promises). q4_k / q5_k take K17a
    (int8 activations unless KCPP_Q4K_I8=0, then q4_k's bf16 body); q6_k,
    q8_0, q2_k, q3_k and the IQ kinds take K17b with `_mm_i8`'s variant.
    It also declines under KCPP_Q4K_DECODE other than "1" or
    KCPP_PALLAS_MM=0, as JAX's does. The TPU kernel's VMEM row-tile rule,
    which can decline an ultra-wide q4_k in_f, is not read: K17a serves
    every width, with K1's result on the layer."""
    out_f, in_f = qt.shape
    if out_f % 256 or in_f % 256 or not (pallas_on() and _decode_on()):
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_f)
    if x2.shape[0] != 1:
        return None
    x1 = x2[0].to(torch.bfloat16).contiguous()
    if qt.kind in ("q4_k", "q5_k"):
        i8 = os.environ.get("KCPP_Q4K_I8", "1") == "1"
        if in_f < 512 or (not i8 and qt.kind == "q5_k"):
            return None
        return q4k_matvec_stacked(x1, qt, li, i8).reshape(*lead, out_f)
    if qt.kind in _K17B_KINDS and (qt.kind not in IQ_KINDS
                                   or in_f >= 32 * iq_group(qt)):
        return matvec_stacked(x1, qt, li, _mm_i8(
            qt.kind, qt.whole_in_f or in_f)).reshape(
            *lead, out_f)
    return None
