"""The FFN megakernel: gate/up matvec, SwiGLU and down matvec of a q4_k
SwiGLU FFN in one launch (K15), opt-in under KCPP_FFN_FUSED=1.

Port of koboldcpp_tpu/ops/ffn_fused.py. `ffn_fused(x, w_gateup, w_down)`
returns None exactly where the JAX function declines (env unset, a kind
other than q4_k, more than FUSED_MAX_T tokens, shapes that do not pair up
or are not multiples of 256, no row tile within the JAX kernel's VMEM
budget: the same shape arithmetic, `_tiles`), and otherwise runs K15b
(T = 1, the JAX `_ffn_fused_call`: magic-number row math) or K15a (2 <= T
<= FUSED_MAX_T, `_ffn_fused_call_2d`: the 2-D math), both on the tensor
cores and tiled by `ffn_plan`, through `ffn_fused_call`, csrc/ffn_fused.cu
on a CUDA tensor and the plain PyTorch version beside it on a CPU tensor.
Counters: "K15b" and "K15a" (ops/_build.launches).
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple

import torch

from . import _build
from .linear import QTensor, q4k_values
from .quant_matmul import (_FIELD_DTYPES, _SMEM_PER_SM, _SMS, Q4K_KS,
                           Q4K_ROWS, RING_FITS, SMEM_MAX, _group_sums,
                           _window_order, kq_dequant_bf16, pallas_on)

_VMEM_BUDGET = 12 * 1024 * 1024  # the JAX kernel's VMEM budget (shape rule)
# the JAX default of KCPP_FFN_FUSED_MAX_T, which the port does not read:
# K15a is built for T <= 8
FUSED_MAX_T = 8
_FIELDS = ("qs2", "scale", "min")


def _enabled() -> bool:
    return os.environ.get("KCPP_FFN_FUSED", "0") == "1"


def _tiles(T: int, C: int, F: int) -> tuple[int, int] | None:
    """The (gate/up, down) row tiles the JAX function picks, or None where
    none fits its VMEM budget (it then declines the FFN)."""
    if T == 1:
        def vmem_use(rtg, rtd):
            return (2 * (rtg * C // 2 + rtd * F // 2)
                    + 2 * 2 * 4 * (C // 64 * rtg + F // 64 * rtd) // 2
                    + 2 * F * 4
                    + 2 * (F // 64) * (F // 2) * 2
                    + 2 * (C // 64) * (C // 2) * 2 * 2)
    else:
        def vmem_use(rtg, rtd):
            wb = (rtg * (C // 2 + 2 * (C // 64) * 2 + (C // 32) * 2)
                  + rtd * (F // 2 + 2 * (F // 64) * 2 + (F // 32) * 2))
            scratch = T * 2 * F * 4 + 2 * T * (F // 2) * 2 + T * (F // 32) * 2
            xops = 2 * T * (C // 2) * 2 + T * (C // 32) * 2
            return 2 * wb + scratch + xops
    for cg in (512, 256):
        for cd in (512, 256):
            if (2 * F) % cg == 0 and C % cd == 0 and \
                    vmem_use(cg, cd) <= _VMEM_BUDGET:
                return cg, cd
    return None


def ffn_fused(x: torch.Tensor, w_gateup: QTensor, w_down: QTensor):
    """SwiGLU FFN of x (..., C) at T <= FUSED_MAX_T tokens through K15 (T=1:
    K15b, T>1: K15a), or None where the JAX `ffn_fused` declines."""
    if not (_enabled() and pallas_on()):
        return None
    if not (isinstance(w_gateup, QTensor) and isinstance(w_down, QTensor)):
        return None
    if w_gateup.kind != "q4_k" or w_down.kind != "q4_k":
        return None
    if any(n not in w_gateup.data or n not in w_down.data for n in _FIELDS):
        return None
    lead = x.shape[:-1]
    C = x.shape[-1]
    T = 1
    for n in lead:
        T *= n
    if T > FUSED_MAX_T:
        return None
    F2out, Cg = w_gateup.shape
    Cd, F = w_down.shape
    if Cg != C or Cd != C or F2out != 2 * F:
        return None
    if C % 256 or F % 256 or _tiles(T, C, F) is None:
        return None
    y = ffn_fused_call(x.reshape(T, C).to(torch.bfloat16).contiguous(),
                       w_gateup, w_down)
    return y.reshape(*lead, C)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _magic_rows(a: torch.Tensor, xs: torch.Tensor, qt: QTensor
                ) -> torch.Tensor:
    """`_q4k_row_math` at T=1: a (in_f,) f32 (bf16 values), xs (in_f/32,)
    bf16 group sums -> (out_f,) f32 = 1/8 sum_g s_g P_g - 16 sum_g s_g xs_g
    - sum_g m_g xs_g, P_g = sum_c (128 + 8 q_c) a_c in f32."""
    out_f, in_f = qt.shape
    q = q4k_values(qt.data["qs2"]).reshape(out_f, -1, 32)
    p = ((128.0 + 8.0 * q.float()) * a.reshape(-1, 32)).sum(dim=2)
    s = qt.data["scale"].float()
    xsf = xs.float()
    return (0.125 * (p * s).sum(dim=1) - 16.0 * (s * xsf).sum(dim=1)
            - (qt.data["min"].float() * xsf).sum(dim=1))


def _rows_2d(a: torch.Tensor, xs: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """`_ffn_kernel_2d`'s product: a (T, in_f) f32 (bf16 values), xs (T,
    in_f/32) bf16 -> (T, out_f) f32 = a . bf16(q s)^T - xs . min^T."""
    w = kq_dequant_bf16(qt).float()
    return (torch.matmul(a, w.t())
            - torch.matmul(xs.float(), qt.data["min"].float().t()))


def ffn_fused_plain(x: torch.Tensor, w_gateup: QTensor,
                    w_down: QTensor) -> torch.Tensor:
    """x (T, C) bf16 -> (T, C) bf16. Gate/up stay f32 into a = u * g *
    sigmoid(g); down multiplies bf16(a), with group sums bf16(sum a) of the
    f32 a. T = 1 (K15b): the magic-number row math in both phases, the
    offset of down taken over bf16(a) as JAX's P-dots take it; T > 1
    (K15a): the 2-D math."""
    T, C = x.shape
    F = w_down.shape[1]
    xs = _group_sums(x, 32)
    if T == 1:
        gu = _magic_rows(x[0].float(), xs[0], w_gateup)[None]
    else:
        gu = _rows_2d(x.float(), xs, w_gateup)
    g, u = gu[:, :F], gu[:, F:]
    a = u * g * torch.sigmoid(g)
    ab = a.to(torch.bfloat16).float()
    xsd = a.reshape(T, -1, 32).sum(dim=2).to(torch.bfloat16)
    if T == 1:
        y = _magic_rows(ab[0], xsd[0], w_down)[None]
    else:
        y = _rows_2d(ab, xsd, w_down)
    return y.to(torch.bfloat16)


# ---------------------------------------------------------------------------
# K15a's tiling and the kernel's wrapper
# ---------------------------------------------------------------------------

class FfnPlan(NamedTuple):
    """How K15 tiles one call (csrc/ffn_fused.cu; K15b at T = 1, K15a
    above): one cooperative grid of `grid` blocks of 8 warps, all resident,
    walks the gate/up weight's `tiles1` 16-row tiles of `ksteps1` K steps
    (8 superblocks, one per warp), then the down weight's `tiles3` of
    `ksteps3`, through one cp.async ring of `stages` stages; `smem` bytes
    of dynamic shared memory (the ring, x and its group sums, a tile's
    partial sums); x held in windows of `kwin` K steps of phase 1
    (`kwin == ksteps1`: x whole, prepped once; less where T tokens of x do
    not fit a block: each window prepped anew at its first K step of every
    phase-1 tile)."""
    tiles1: int
    ksteps1: int
    tiles3: int
    ksteps3: int
    stages: int
    smem: int
    grid: int
    kwin: int


def ffn_layout(T: int, C: int, stages: int, F: int = 0) -> dict[str, int]:
    """K15's shared memory, byte offsets (`ffn_layout` in the source):
    `stages` stages of 16 rows x 8 superblocks (per row the codes in 1024
    B, the scales and mins in 272), x in B-fragment order (per token 2C
    bytes and 16 of padding; C: x's columns, or those of its window), x's
    bf16 group sums (T x C/32), the partial sums (per token of 8 the 8
    warps' values of 16 rows and 16 bytes of padding, twice: the products
    and the min term). At T = 1 (K15b) the x image and its sums then hold
    phase 3's bf16(a) of F columns and its sums: each region the larger."""
    stage = Q4K_ROWS * (Q4K_KS * 128 + 2 * Q4K_KS * 16 + 16)
    xi = stages * stage
    cols = max(C, F) if T == 1 else C
    xs = xi + T * (2 * cols + 16)
    part = xs + T * (cols // 32) * 2
    return {"stage": stage, "xi": xi, "xs": xs, "part": part,
            "total": part + 2 * FUSED_MAX_T * (Q4K_KS * Q4K_ROWS + 4) * 4}


@functools.lru_cache(maxsize=16384)
def ffn_plan(T: int, C: int, F: int, sms: int = _SMS,
             kwin: int = 0) -> FfnPlan:
    """K15's tiling for x (T, C), a (2F, C) gate/up and a (C, F) down
    weight on a card of `sms` SMs (K15b at T = 1, K15a above). Raises
    ValueError for a shape the kernel does not take (T outside
    1..FUSED_MAX_T, C or F not a multiple of 256).

    A persistent grid, never more blocks than the larger phase has tiles:
    the first of 4 stages and two blocks an SM (the kernel's registers
    allow two), 3 stages and two, 4 or 3 stages and one whose shared
    memory fits. x is whole wherever it fits; a wider x (C beyond ~19K at
    T = 8, ~50K at T = 3) goes in windows of `kwin` K steps of phase 1,
    the widest that fits in the same order of ring depths and blocks an
    SM, so every shape `_tiles` takes has a plan. kwin forces a window
    (kwin = ksteps1 is x whole). The tile, the K step and the warp that
    takes each superblock depend on (C, F) alone, never on T, and x's
    groups are prepped alike in a window and whole."""
    if not 1 <= T <= FUSED_MAX_T or C <= 0 or F <= 0 or C % 256 or F % 256:
        raise ValueError(f"K15 takes 1 <= T <= {FUSED_MAX_T} and C, F "
                         f"multiples of 256, not T={T}, C={C}, F={F}")
    ksteps1 = -(-(C // 256) // Q4K_KS)
    if kwin < 0 or kwin > ksteps1:
        raise ValueError(f"K15: a window of {kwin} of {ksteps1} K steps")
    tiles1, tiles3 = 2 * F // Q4K_ROWS, C // Q4K_ROWS

    def smem(kw, stages):
        return ffn_layout(T, min(C, kw * Q4K_KS * 256), stages, F)["total"]

    def fits(kw, config):
        stages, per_sm = config
        need = smem(kw, stages)
        return per_sm * (need + 1024) <= _SMEM_PER_SM and need <= SMEM_MAX

    got = _window_order(fits, RING_FITS, ksteps1, kwin, True)
    if got is None:
        raise ValueError(f"K15: C={C} at T={T} does not fit a block")
    kw, (stages, per_sm) = got
    return FfnPlan(tiles1, ksteps1, tiles3, -(-(F // 256) // Q4K_KS), stages,
                   smem(kw, stages), min(max(tiles1, tiles3), per_sm * sms),
                   kw)


_SIG_K15 = [_build.P] * 11 + [_build.I] * 7 + [_build.P]


def ffn_fused_call(x: torch.Tensor, w_gateup: QTensor,
                   w_down: QTensor) -> torch.Tensor:
    """K15 wrapper. x (T, C) bf16 contiguous, 1 <= T <= FUSED_MAX_T, q4_k
    w_gateup (2F, C) and w_down (C, F) -> (T, C) bf16. One cooperative
    launch (`ffn_plan`): K15b at T = 1, K15a above."""
    if not x.is_cuda:
        return ffn_fused_plain(x, w_gateup, w_down)
    y = _ffn_launch(x, w_gateup, w_down, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    _build.launches["K15b" if x.shape[0] == 1 else "K15a"] += 1
    return y


def _ffn_launch(x: torch.Tensor, w_gateup: QTensor, w_down: QTensor,
                sms: int, kwin: int = 0) -> torch.Tensor:
    """One K15 launch on x's device, the grid for a card of `sms` SMs
    (kwin: a window `ffn_plan` is forced to); y and the scratch its
    allocations."""
    T, C = x.shape
    F = w_down.shape[1]
    if not 1 <= T <= FUSED_MAX_T or x.dtype != torch.bfloat16 \
            or not x.is_contiguous() or C % 256 or F % 256 \
            or w_gateup.shape != (2 * F, C) or w_down.shape != (C, F):
        raise ValueError("K15 takes a contiguous bf16 x (T, C), 1 <= T <= 8, "
                         "q4_k w_gateup (2F, C) and w_down (C, F), C and F "
                         "multiples of 256")
    for qt in (w_gateup, w_down):
        if qt.kind != "q4_k":
            raise ValueError(f"K15 serves q4_k, not {qt.kind}")
        for name in _FIELDS:
            t = qt.data[name]
            if t.device != x.device or t.dtype != _FIELD_DTYPES[name] \
                    or not t.is_contiguous() or t.data_ptr() % 16:
                raise ValueError(f"K15: field {name} must be a contiguous, "
                                 f"16-byte aligned {_FIELD_DTYPES[name]} "
                                 f"tensor on {x.device}")
    dev = x.device
    g, dn = w_gateup.data, w_down.data
    plan = ffn_plan(T, C, F, sms, kwin)
    y = torch.empty((T, C), dtype=torch.bfloat16, device=dev)
    gu = torch.empty(T * 2 * F, dtype=torch.float32, device=dev)
    abf = torch.empty(T * F, dtype=torch.bfloat16, device=dev)
    dxs = torch.empty(T * (F // 32), dtype=torch.bfloat16, device=dev)
    what = "K15b" if T == 1 else "K15a"
    lib, fn = _build.entry("ffn_fused", "k15_ffn", _SIG_K15)
    _build.check(lib, fn(
        g["qs2"].data_ptr(), g["scale"].data_ptr(), g["min"].data_ptr(),
        dn["qs2"].data_ptr(), dn["scale"].data_ptr(), dn["min"].data_ptr(),
        x.data_ptr(), gu.data_ptr(), abf.data_ptr(), dxs.data_ptr(),
        y.data_ptr(), T, C, F, plan.grid, plan.stages, plan.smem, plan.kwin,
        _build.stream_ptr()), what)
    return y
