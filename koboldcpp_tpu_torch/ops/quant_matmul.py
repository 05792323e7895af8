"""Fused dequant+matmul for packed q4_k / q6_k QTensors.

Three hand-written CUDA kernels (csrc/), each with its plain PyTorch version
beside it. A wrapper takes the plain version only for a CPU tensor; for a
CUDA tensor it launches the kernel or raises.

  K1  q4k_matvec  T=1 q4_k  (csrc/q4k_matvec.cu; JAX `_packed_matvec_q4k`)
  K2  q6k_matvec  T=1 q6_k  (csrc/q6k_matvec.cu; JAX `_packed_matvec`)
  K3  kq_matmul   T>8       (csrc/kq_matmul.cu; JAX `_packed_matmul_2d`)

`matmul_packed(x, qt)` returns None when the JAX dispatch would decline the
shape (out_f or in_f not a multiple of 256, or an in_f too wide for any
2-D tile); callers then take the dequant path in ops/linear.py.
"""
from __future__ import annotations

import torch

from . import _build
from .linear import QTensor, q4k_values, q6k_values

VMEM_BUDGET = 13 * 1024 * 1024  # the JAX 2-D kernel's tile budget (see below)

_SIG_MATVEC = [_build.P] * 8 + [_build.I] * 3 + [_build.P]
_SIG_PREP = [_build.P] * 4 + [_build.I] * 2 + [_build.P]
_FIELD_DTYPES = {"qs2": torch.uint8, "ql": torch.uint8, "qh": torch.uint8,
                 "scale": torch.bfloat16, "min": torch.bfloat16}


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
    xq = torch.round(xf * (127.0 / a)[:, None]).to(torch.int8).reshape(-1)
    return xq, a / 127.0, xsum


# ---------------------------------------------------------------------------
# K1: q4_k T=1 matvec
# ---------------------------------------------------------------------------

def q4k_matvec_plain(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """x (in_f,) bf16 -> (1, out_f) bf16. i8: int8 activations per 32-col
    group (`_q4k_decode_kernel_i8`); else the exact f32 dot with bf16 x."""
    out_f, in_f = qt.shape
    ng = in_f // 32
    q = q4k_values(qt.data["qs2"]).reshape(out_f, ng, 32)
    s = qt.data["scale"].float()
    m = qt.data["min"].float()
    xq, sx, xsum = act_prep_plain(x, 32, i8)
    if i8:
        p = (q.int() * xq.int().reshape(ng, 32)).sum(dim=2)  # exact int32
        t = (p.float() * sx * s).sum(dim=1)
    else:
        p = (q.float() * x.float().reshape(ng, 32)).sum(dim=2)
        t = (s * p).sum(dim=1)
    t = t - (m * xsum.float()).sum(dim=1)
    return t.to(torch.bfloat16).reshape(1, out_f)


def q4k_matvec(x: torch.Tensor, qt: QTensor, i8: bool) -> torch.Tensor:
    """K1 wrapper. x (in_f,) bf16 contiguous -> (1, out_f) bf16."""
    if not x.is_cuda:
        return q4k_matvec_plain(x, qt, i8)
    out_f, in_f = qt.shape
    _check_operands(x[None], qt, "K1")
    lib = _build.load("q4k_matvec", {"k1_q4k_prep": _SIG_PREP,
                                     "k1_q4k_matvec": _SIG_MATVEC})
    dev = x.device
    xq = torch.empty(in_f, dtype=torch.int8, device=dev)
    sx = torch.empty(in_f // 32, dtype=torch.float32, device=dev)
    xsum = torch.empty(in_f // 32, dtype=torch.bfloat16, device=dev)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=dev)
    st = _build.stream_ptr()
    _build.check(lib, lib.k1_q4k_prep(x.data_ptr(), xq.data_ptr(),
                                      sx.data_ptr(), xsum.data_ptr(),
                                      in_f, int(i8), st), "K1 prep")
    d = qt.data
    _build.check(lib, lib.k1_q4k_matvec(
        d["qs2"].data_ptr(), d["scale"].data_ptr(), d["min"].data_ptr(),
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), xsum.data_ptr(),
        y.data_ptr(), out_f, in_f, int(i8), st), "K1")
    _build.launches["K1"] += 1
    return y


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
    out_f, in_f = qt.shape
    _check_operands(x[None], qt, "K2")
    lib = _build.load("q6k_matvec", {"k2_q6k_prep": _SIG_PREP,
                                     "k2_q6k_matvec": _SIG_MATVEC})
    dev = x.device
    xq = torch.empty(in_f, dtype=torch.int8, device=dev)
    sx = torch.empty(in_f // 16, dtype=torch.float32, device=dev)
    xsum = torch.empty(in_f // 16, dtype=torch.bfloat16, device=dev)
    y = torch.empty((1, out_f), dtype=torch.bfloat16, device=dev)
    st = _build.stream_ptr()
    _build.check(lib, lib.k2_q6k_prep(x.data_ptr(), xq.data_ptr(),
                                      sx.data_ptr(), xsum.data_ptr(),
                                      in_f, int(i8), st), "K2 prep")
    d = qt.data
    _build.check(lib, lib.k2_q6k_matvec(
        d["ql"].data_ptr(), d["qh"].data_ptr(), d["scale"].data_ptr(),
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), xsum.data_ptr(),
        y.data_ptr(), out_f, in_f, int(i8), st), "K2")
    _build.launches["K2"] += 1
    return y


# ---------------------------------------------------------------------------
# K3: q4_k / q6_k tiled matmul (prefill)
# ---------------------------------------------------------------------------

def _group_sums(x: torch.Tensor, group: int) -> torch.Tensor:
    """(T, in_f) -> (T, in_f/group) bf16 of the f32 sums (XLA glue in JAX)."""
    T, in_f = x.shape
    return x.float().reshape(T, in_f // group, group).sum(-1).to(torch.bfloat16)


def kq_dequant_bf16(qt: QTensor) -> torch.Tensor:
    """The weight K3 feeds its product: bf16(q * scale), q the raw code
    (q4_k nibble 0..15, q6_k value 0..63), as `_q4k_kernel`/`_q6k_kernel`."""
    out_f, in_f = qt.shape
    if qt.kind == "q4_k":
        q = q4k_values(qt.data["qs2"]).float().reshape(out_f, -1, 32)
    else:
        q = q6k_values(qt.data["ql"], qt.data["qh"]).float().reshape(
            out_f, -1, 16)
    w = q * qt.data["scale"].float()[..., None]
    return w.reshape(out_f, in_f).to(torch.bfloat16)


def kq_matmul_plain(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """x (T, in_f) bf16 -> (T, out_f) bf16; f32 accumulation."""
    w = kq_dequant_bf16(qt).float()
    acc = torch.matmul(x.float(), w.t())
    if qt.kind == "q4_k":
        acc = acc - torch.matmul(_group_sums(x, 32).float(),
                                 qt.data["min"].float().t())
    else:
        acc = acc - 32.0 * torch.matmul(_group_sums(x, 16).float(),
                                        qt.data["scale"].float().t())
    return acc.to(torch.bfloat16)


def kq_matmul(x: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """K3 wrapper. x (T, in_f) bf16 contiguous -> (T, out_f) bf16."""
    if not x.is_cuda:
        return kq_matmul_plain(x, qt)
    out_f, in_f = qt.shape
    T = x.shape[0]
    _check_operands(x, qt, "K3")
    lib = _build.load("kq_matmul", {
        "k3_kq_matmul": [_build.I] + [_build.P] * 7 + [_build.I] * 3
        + [_build.P]})
    d = qt.data
    if qt.kind == "q4_k":
        kind, w0, w1, mn = 0, d["qs2"], None, d["min"]
        xs = _group_sums(x, 32)
    else:
        kind, w0, w1, mn = 1, d["ql"], d["qh"], None
        xs = _group_sums(x, 16)
    y = torch.empty((T, out_f), dtype=torch.bfloat16, device=x.device)
    _build.check(lib, lib.k3_kq_matmul(
        kind, x.data_ptr(), xs.data_ptr(), w0.data_ptr(),
        w1.data_ptr() if w1 is not None else None, d["scale"].data_ptr(),
        mn.data_ptr() if mn is not None else None, y.data_ptr(),
        T, out_f, in_f, _build.stream_ptr()), "K3")
    _build.launches["K3"] += 1
    return y


# ---------------------------------------------------------------------------
# dispatch (mirrors quant_matmul.py:2041-2177 of the JAX package for
# q4_k/q6_k at its default settings)
# ---------------------------------------------------------------------------

def matmul_packed(x: torch.Tensor, qt: QTensor) -> torch.Tensor | None:
    """Route x (..., in_f) through the kernel the JAX package would pick, or
    return None where it declines. The variants follow JAX: int8
    activations for in_f >= 512 and bf16 below (K1/K2); the 2-D kernel (K3)
    for T > 8, and for q6_k at any T > 1. The TPU-only VMEM row-tile
    checks that can also send a T=1 call to the 2-D kernel are not mirrored."""
    out_f, in_f = qt.shape
    if out_f % 256 or in_f % 256:
        return None
    lead = x.shape[:-1]
    x2 = x.reshape(-1, in_f).to(torch.bfloat16).contiguous()
    T = x2.shape[0]
    if T == 1:
        fn = q4k_matvec if qt.kind == "q4_k" else q6k_matvec
        return fn(x2[0], qt, i8=in_f >= 512).reshape(*lead, out_f)
    if qt.kind == "q4_k":
        i8 = T * (in_f // 64) * (in_f // 2) <= 4 * 1024 * 1024 and in_f >= 512
        if T <= (8 if i8 else 4):
            raise NotImplementedError(
                f"q4_k matvec at T={T} is kernel K7 (batched decode), "
                "which is not ported yet")
    # ultra-wide in_f: even the JAX package's smallest 2-D tile does not fit
    # its VMEM budget, and it takes the dequant path instead
    if 12 * 128 * (in_f // 2) + 4 * 64 * (in_f // 2) > VMEM_BUDGET + 1024 * 1024:
        return None
    return kq_matmul(x2, qt).reshape(*lead, out_f)
