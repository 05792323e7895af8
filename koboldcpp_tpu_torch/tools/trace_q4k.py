"""Timeline of one int8 K1 / K7 launch (csrc/q4k_matvec.cu), of one K2 /
K12 launch (csrc/rowmv.cuh), of one K2.q8_0 / K12.iq launch
(csrc/rowmv_g.cuh), of one K14 launch (csrc/q4k_sbq.cu) or of one K15a
launch (csrc/ffn_fused.cu; K15b at T = 1 too), block by block.

    python3 koboldcpp_tpu_torch/tools/trace_q4k.py [--kernel K1|K2|K12.q2_k|
        K12.q3_k|K2.q8_0|K12.iq2p|K12.iq3px|K12.iq3ps|K12.iq1p|K14|K15a|
        K15b]
        [--bf16] [--group G]

Builds a copy of the kernel source with `%globaltimer` stamps that thread 0
of every block writes at the kernel's phase boundaries (start; the weight
ring's first stages issued; the activation prep done; each iteration's
stage ready and its products done; the end), into the git-ignored build
directory, and launches it once per case on weights drawn from one seed
(an L2-clean read of 256 MB first, as the decode step finds its weights
out of the L2). Prints per case the span of the launch and the mean and
largest time of each phase over the blocks. The stamps cost a store each;
the times are those of the instrumented copy, not of the kernel itself.
K1 (default): the 1.1B's five shapes at T = 1 and the head at T = 8; K2
(q6_k) / K12.q2_k / K12.q3_k / K2.q8_0: the five at T = 1, int8 x, or
bf16 x with --bf16; K12.iq2p / iq3px / iq3ps / iq1p: the five at T = 1,
scale group --group (default 32); K14 (q4_k): the five at T = 2, 8 and 16; K15a: the 1.1B's FFN at T
= 2 and 8, with the two grid barriers' waits and phase 2 (stage waits then
count the phase-1 tiles' and the phase-3 tiles' alike); K15b: the same at
T = 1. Needs the card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

# (name, out_f, in_f, T): the 1.1B's projections and head at T = 1, the
# head at T = 8
CASES = (("wqkv", 2560, 2048, 1), ("w_gateup", 11264, 2048, 1),
         ("wo", 2048, 2048, 1), ("w_down", 2048, 5632, 1),
         ("output", 32000, 2048, 1), ("output", 32000, 2048, 8))
SBQ_CASES = tuple((name, o, i, T) for name, o, i, _ in CASES[:5]
                  for T in (2, 8, 16))
# K15a: (name, C, F, T), the 1.1B's FFN
FFN_CASES = (("ffn", 2048, 5632, 2), ("ffn", 2048, 5632, 8))
FFN_T1_CASES = (("ffn", 2048, 5632, 1),)
SLOTS = 64  # stamps per block: 0 start, 1 SM, 2 ring issued, 3 prep done,
# 4 + 2i stage i ready, 5 + 2i stage i's products done, 62 end

_HEAD = r'''#include "common.cuh"
__device__ unsigned long long* g_trace;
#define TRACE(slot) if (threadIdx.x == 0 && (slot) < 63) { \
  unsigned long long tt; \
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(tt) :: "memory"); \
  g_trace[blockIdx.x * 64 + (slot)] = tt; }
KCPP_API int q4k_set_trace(void* p) {
  return (int)cudaMemcpyToSymbol(g_trace, &p, sizeof(p)); }
'''
# (anchor in the source, stamp inserted before (False) or after (True) it)
# for K1 (csrc/q4k_matvec.cu); K2 / K12 (csrc/rowmv.cuh) differ in two
_STAMPS = (
    ("    extern __shared__ __align__(16) uint8_t smem[];\n", True,
     "    TRACE(0); if (threadIdx.x == 0) { unsigned sm; "
     "asm(\"mov.u32 %0, %%smid;\" : \"=r\"(sm)); "
     "g_trace[blockIdx.x * 64 + 1] = sm; }\n"),
    ("    // activation prep, part 2, while the first stages arrive", False,
     "    TRACE(2);\n"),
    ("    // general body: this thread's C rows gid", False, "    TRACE(3);\n"),
    ("        cp_async_wait<I8_STAGES - 2>();\n        __syncthreads();\n",
     True, "        TRACE(4 + 2 * it);\n"),
    ("        if (ks == ksteps - 1) {", False, "        TRACE(5 + 2 * it);\n"),
    ("    cp_async_wait<0>();\n}", False, "    TRACE(62);\n"),
)
_ROWMV_STAMPS = (
    _STAMPS[:2]
    + (("    // lane (gid, tig) combines row myrow of the tile", False,
        "    TRACE(3);\n"),
       ("        cp_async_wait_n(stages - 2);\n        __syncthreads();\n",
        True, "        TRACE(4 + 2 * it);\n"))
    + _STAMPS[4:])
# K14 (csrc/q4k_sbq.cu): K2's anchors but the body's
_SBQ_STAMPS = (
    _ROWMV_STAMPS[:2]
    + (("    // body: this thread's C rows gid", False, "    TRACE(3);\n"),)
    + _ROWMV_STAMPS[3:])
# K15a (csrc/ffn_fused.cu): 2 ring issued, 3 x's sums done, 58-61 phase 2
# (before / after the first barrier, its work done, after the second)
_FFN_STAMPS = (
    _STAMPS[0],
    ("    for (int base = 0; base < nxt; base += 8 * FFN_THREADS) {\n", False,
     "    TRACE(2);\n"),
    ("    // phase 2 between the barriers", False, "    TRACE(3);\n"),
    ("    auto phase2 = [&]() {\n", True, "        TRACE(58);\n"),
    ("        const int ngf = F / 32;\n", False, "        TRACE(59);\n"),
    ("            if (lane == 0) dxs[i] = f2bf(s);\n        }\n", True,
     "        TRACE(60);\n"),
    ("    };\n\n    // this thread's C rows", False, "        TRACE(61);\n"),
    _ROWMV_STAMPS[3],
    ("        if (ks == (p3 ? ks3 : ks1) - 1) {", False,
     "        TRACE(5 + 2 * it);\n"),
    _STAMPS[5],
)
# the K2 / K12 kernels: (kind, source, entry point); rowmv.cuh's body, and
# rowmv_g.cuh's with the same anchors
_ROWMV = {"K2": ("q6_k", "q6k_matvec", "k2_q6k_matvec"),
          "K12.q2_k": ("q2_k", "q23k_matvec", "k12_q23k_matvec"),
          "K12.q3_k": ("q3_k", "q23k_matvec", "k12_q23k_matvec"),
          "K2.q8_0": ("q8_0", "q8_0_matvec", "k2_q8_0_matvec"),
          **{f"K12.{k}": (k, "iq_matvec", "k12_iq_matvec")
             for k in ("iq2p", "iq3px", "iq3ps", "iq1p")}}


def instrumented(src: str, stamps=_STAMPS) -> str:
    """The kernel source with the stamps; raises if an anchor moved."""
    src = src.replace('#include "common.cuh"\n', _HEAD, 1)
    for anchor, after, stamp in stamps:
        i = src.find(anchor)
        if i < 0:
            raise RuntimeError(f"trace_q4k: anchor not found: {anchor!r}")
        i += len(anchor) if after else 0
        src = src[:i] + stamp + src[i:]
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="K1",
                    choices=("K1", *_ROWMV, "K14", "K15a", "K15b"))
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--group", type=int, default=32, choices=(8, 16, 32))
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_q4k: no CUDA device available")
    from koboldcpp_tpu_torch.models.synthetic import _MAKERS, rand_iq
    from koboldcpp_tpu_torch.ops import _build
    from koboldcpp_tpu_torch.ops import ffn_fused as ff
    from koboldcpp_tpu_torch.ops import quant_matmul as qm

    out = os.path.join(_build.BUILD_ROOT, "trace")
    os.makedirs(out, exist_ok=True)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    stack = [None, 0, 0, 0, 0, 0]
    if args.kernel in ("K1", "K14", "K15a", "K15b"):
        source, stamps, entry, cases, argtypes = {
            "K1": ("q4k_matvec", _STAMPS, "k1_q4k_i8", CASES,
                   [P] * 6 + [I] * 5 + [P] + [LL] * 5 + [I, P]),
            "K14": ("q4k_sbq", _SBQ_STAMPS, "k14_sbq", SBQ_CASES,
                    qm._SIG_SBQ),
            "K15a": ("ffn_fused", _FFN_STAMPS, "k15_ffn", FFN_CASES,
                     ff._SIG_K15),
            "K15b": ("ffn_fused", _FFN_STAMPS, "k15_ffn",
                     FFN_T1_CASES, ff._SIG_K15)}[args.kernel]
        kind = "q4_k"
        with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
            src = instrumented(f.read(), stamps)
        cu = os.path.join(out, f"{source}_trace.cu")
    else:
        kind, source, entry = _ROWMV[args.kernel]
        cases = CASES[:5]
        # the instrumented body beside a copy of the source that includes
        # it, which the compiler finds before csrc/'s (a directory per body:
        # rowmv_g.cuh includes rowmv.cuh, which must be csrc/'s)
        header = ("rowmv.cuh" if kind in ("q6_k", "q2_k", "q3_k")
                  else "rowmv_g.cuh")
        out = os.path.join(out, header.split(".")[0])
        os.makedirs(out, exist_ok=True)
        with open(os.path.join(_build.CSRC, header)) as f:
            body = instrumented(f.read(), _ROWMV_STAMPS)
        with open(os.path.join(out, header), "w") as f:
            f.write(body)
        with open(os.path.join(_build.CSRC, f"{source}.cu")) as f:
            src = f.read()
        cu = os.path.join(out, f"{source}_trace.cu")
        argtypes = {"q6_k": qm._SIG_K2, "q2_k": qm._SIG_K12,
                    "q3_k": qm._SIG_K12, "q8_0": qm._SIG_K2Q8}.get(
                        kind, qm._SIG_K12IQ)
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    subprocess.check_call([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                           _build.CSRC, "-o", so, cu])
    lib = ctypes.CDLL(so)
    fn = getattr(lib, entry)
    fn.argtypes = argtypes
    lib.q4k_set_trace.argtypes = [P]
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    clean = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device=dev)
    print(_build_card(), f"{args.kernel}", "bf16 x" if args.bf16 else "",
          f"G={args.group}" if args.kernel.startswith("K12.iq") else "",
          flush=True)
    for name, out_f, in_f, T in cases:
        if args.kernel in ("K15a", "K15b"):  # out_f, in_f: C, F
            C, F = out_f, in_f
            gu = _MAKERS[kind](rng, 2 * F, C, dev)
            dn = _MAKERS[kind](rng, C, F, dev)
            in_f = C
        else:
            qt = (_MAKERS[kind](rng, out_f, in_f, dev)
                  if kind not in qm.IQ_KINDS
                  else rand_iq(rng, out_f, in_f, dev, kind, args.group))
        x = torch.from_numpy(rng.standard_normal((T, in_f)).astype(
            np.float32)).to(dev).bfloat16()
        y = torch.empty((T, out_f), dtype=torch.bfloat16, device=dev)
        st = torch.cuda.current_stream().cuda_stream
        if args.kernel == "K1":
            d = qt.data
            plan = qm.q4k_plan(T, out_f, in_f, False)
            call = [d["qs2"].data_ptr(), None, d["scale"].data_ptr(),
                    d["min"].data_ptr(), x.data_ptr(), y.data_ptr(), T,
                    out_f, in_f, plan.grid, plan.smem, *stack, plan.kwin,
                    st]
        elif args.kernel == "K14":
            d = qt.data
            plan = qm.sbq_plan(T, out_f, in_f, False)
            call = [d["qs2"].data_ptr(), None, d["sc"].data_ptr(),
                    d["d"].data_ptr(), d["min"].data_ptr(), x.data_ptr(),
                    y.data_ptr(), T, out_f, in_f, plan.grid, plan.stages,
                    plan.kwin, plan.smem, st]
        elif args.kernel in ("K15a", "K15b"):
            plan = ff.ffn_plan(T, C, F, torch.cuda.get_device_properties(
                dev).multi_processor_count)
            scratch = (torch.empty(T * 2 * F, dtype=torch.float32, device=dev),
                       torch.empty(T * F, dtype=torch.bfloat16, device=dev),
                       torch.empty(T * F // 32, dtype=torch.bfloat16,
                                   device=dev))
            g, dd = gu.data, dn.data
            call = [g["qs2"].data_ptr(), g["scale"].data_ptr(),
                    g["min"].data_ptr(), dd["qs2"].data_ptr(),
                    dd["scale"].data_ptr(), dd["min"].data_ptr(),
                    x.data_ptr(), *(t.data_ptr() for t in scratch),
                    y.data_ptr(), T, C, F, plan.grid, plan.stages, plan.smem,
                    plan.kwin, st]
        elif kind in qm.IQ_KINDS:
            d = qt.data
            plan = qm.rowmv_plan(kind, out_f, in_f, True, args.group)
            call = [qm.IQ_KINDS.index(kind), d["qs"].data_ptr(),
                    qm._ptr(d.get("hmask")), qm._ptr(d.get("sg")),
                    d["scale"].data_ptr(), qm._ptr(d.get("min")),
                    x.data_ptr(), y.data_ptr(), out_f, in_f, args.group,
                    plan.grid, plan.stages, plan.smem, *stack, plan.kwin, st]
        else:
            d = qt.data
            plan = qm.rowmv_plan(kind, out_f, in_f, not args.bf16)
            # K2.q8_0's x mode: 1 int8, 0 bf16, 2 bf16 kept as f32
            xmode = 1 if not args.bf16 else 2 if plan.xf32 else 0
            rest = [x.data_ptr(), y.data_ptr(), out_f, in_f, xmode,
                    plan.grid, plan.stages, plan.smem, *stack, plan.kwin, st]
            call = ([d["ql"].data_ptr(), d["qh"].data_ptr(),
                     d["scale"].data_ptr()] if kind == "q6_k" else
                    [d["q"].data_ptr(), d["scale"].data_ptr()]
                    if kind == "q8_0" else
                    [int(kind == "q3_k"), d["qs"].data_ptr(),
                     qm._ptr(d.get("hmask")), d["scale"].data_ptr(),
                     qm._ptr(d.get("min"))]) + rest
        buf = torch.zeros(plan.grid * SLOTS, dtype=torch.int64, device=dev)
        if lib.q4k_set_trace(buf.data_ptr()) != 0:
            raise RuntimeError("trace_q4k: cannot set the stamp buffer")
        for _ in range(3):
            clean.sum()  # read-only: the L2 holds no weight, no dirty line
            buf.zero_()
            err = fn(*call)
            if err:
                raise RuntimeError(f"trace_q4k: launch error {err}")
            torch.cuda.synchronize()
        b = buf.view(plan.grid, SLOTS).cpu().numpy().astype(np.int64)
        t0 = b[:, 0].min()
        ring, prep = b[:, 2] - b[:, 0], b[:, 3] - b[:, 2]
        waits, prods = [], []
        prev = b[:, 3]
        for i in range(27 if args.kernel in ("K15a", "K15b") else 28):
            ready, done = b[:, 4 + 2 * i], b[:, 5 + 2 * i]
            ok = ready > 0
            if not ok.any():
                break
            waits.append((ready - prev)[ok])
            prods.append((done - ready)[ok])
            prev = np.where(ok, done, prev)
        tail = b[:, 62] - prev
        w, p = np.concatenate(waits), np.concatenate(prods)
        if args.kernel in ("K15a", "K15b"):
            tiles = (f"{plan.tiles1} + {plan.tiles3} tiles, {plan.ksteps1} "
                     f"+ {plan.ksteps3} K steps")
            print(f"  phase 2 per block (mean / max us): first barrier "
                  f"{(b[:, 59] - b[:, 58]).mean() / 1e3:.2f} / "
                  f"{(b[:, 59] - b[:, 58]).max() / 1e3:.2f}, SwiGLU "
                  f"{(b[:, 60] - b[:, 59]).mean() / 1e3:.2f} / "
                  f"{(b[:, 60] - b[:, 59]).max() / 1e3:.2f}, second barrier "
                  f"{(b[:, 61] - b[:, 60]).mean() / 1e3:.2f} / "
                  f"{(b[:, 61] - b[:, 60]).max() / 1e3:.2f}; phase 1 span "
                  f"{(b[:, 58].max() - t0) / 1e3:.2f}, phase 3 span "
                  f"{(b[:, 62].max() - b[:, 61].min()) / 1e3:.2f}",
                  flush=True)
        else:
            tiles = f"{plan.tiles} tiles, {plan.ksteps} K steps"
        print(f"{name} {out_f}x{in_f} T={T}: grid {plan.grid}, "
              f"{tiles}; span "
              f"{(b[:, 62].max() - t0) / 1e3:.2f} us; per block (mean / "
              f"max us): ring issued {ring.mean() / 1e3:.2f} / "
              f"{ring.max() / 1e3:.2f}, prep {prep.mean() / 1e3:.2f} / "
              f"{prep.max() / 1e3:.2f}; per iteration ({len(p)}): stage "
              f"wait and the last tile's sums {w.mean() / 1e3:.2f} / "
              f"{w.max() / 1e3:.2f}, products {p.mean() / 1e3:.2f} / "
              f"{p.max() / 1e3:.2f}; end {tail.mean() / 1e3:.2f}",
              flush=True)
    return 0


def _build_card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


if __name__ == "__main__":
    sys.exit(main())
