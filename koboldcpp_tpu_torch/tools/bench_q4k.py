"""Device-alone times of the q4_k / q5_k matvecs K1, K7 and K17a, of the
q6_k / q2_k / q3_k matvecs K2, K12.q2_k and K12.q3_k (int8 and bf16
activations), of the KCPP_KQ_LAYOUT=expanded matvecs K12.q6_k_i8f /
q3_k_n4 / q2_k_n4 (int8), of the q8_0 matvecs K2.q8_0 and K2.q8_0_bf16
and the IQ matvecs K12.iq2p / iq3px / iq3ps / iq1p (G = 32; iq2p also
G = 16, iq1p G = 8), of the KCPP_SBQ=1 matvecs K14 and K14.q5_k and of
the KCPP_FFN_FUSED=1 FFN K15b (T = 1) and K15a at the TinyLlama-1.1B's
shapes, beside one PyTorch call computing the same function (cuBLAS over
the dequantized bf16 weight; for K15 cuBLAS gate/up, silu * up, cuBLAS
down) and the bytes bound.

    python3 koboldcpp_tpu_torch/tools/bench_q4k.py [--root DIR]
        [--label NAME] [--check] [--kernels K2,K12.q2_k,...]

--root: the checkout whose `koboldcpp_tpu_torch` is timed (default: the
one this file lies in), so that two commits can be compared on one card:
run the script once per tree, alternating (parent, change, change,
parent), in one run on the card. --check: also hold every case to its
plain version (2^-7 of max |ref|; K2.q8_0 and K2.q8_0_bf16 bit for
bit), K7's rows to K1 on each row alone,
K17a to K1 on the layer, K14's rows at T = 2 and 8 to its rows of the same
tokens at T = 16 and K15a's at T = 2 to those at T = 8, bit for bit, and
fail on a mismatch. --kernels: time only these (default: all; K1,
K1.q5_k, K7, K7.q5_k, K17a, K2, K12.q2_k, K12.q3_k, K12.q6_k_i8f,
K12.q3_k_n4, K12.q2_k_n4, K2.q8_0, K2.q8_0_bf16, K12.iq2p, K12.iq3px,
K12.iq3ps, K12.iq1p, K14, K14.q5_k, K15b, K15a);
each kernel's weights come from a seed of its own, so a subset times the
same weights as a full run (K7 at T = 8 and K14 time the same weights at
one seed).

A case's time is that of CUDA-graph replays of the call over enough
copies of its weight (96 MB or more, at least two) that each call finds
its weight out of the 50 MB L2, as the decode step does (it streams
every weight from HBM once), divided by the calls: neither the host's
launch time nor a flush's L2 write-backs are counted. Prints a JSON line
per case, then the sums per kernel and class (K1 / K7 / K17a: T = 1;
2-8; 8; K2 / K12: T = 1 int8, T = 1 bf16 x; K2.q8_0 / K12.iq: T = 1 per
G; K14: T = 2, 8, 16; K15b: T = 1; K15a: T = 2, 8), each beside the
library's and the
bound's; the card's name and
power limit first.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# the 1.1B's four layer projections and its output head
SHAPES = (("wqkv", (2560, 2048)), ("w_gateup", (11264, 2048)),
          ("wo", (2048, 2048)), ("w_down", (2048, 5632)),
          ("output", (32000, 2048)))
STACKED_L = 4
Q4K_KERNELS = ("K1", "K1.q5_k", "K7", "K7.q5_k", "K17a")
# the q6_k / q2_k / q3_k T=1 matvecs and their kinds, then the expanded
# layouts' (int8 only)
ROWMV_KERNELS = (("K2", "q6_k"), ("K12.q2_k", "q2_k"), ("K12.q3_k", "q3_k"),
                 ("K12.q6_k_i8f", "q6_k_i8f"), ("K12.q3_k_n4", "q3_k_n4"),
                 ("K12.q2_k_n4", "q2_k_n4"))
# the q8_0 / IQ T=1 matvecs (csrc/rowmv_g.cuh): (kernel, kind, scale groups,
# int8 activations)
GRP_KERNELS = (("K2.q8_0", "q8_0", (32,), True),
               ("K2.q8_0_bf16", "q8_0", (32,), False),
               ("K12.iq2p", "iq2p", (32, 16), True),
               ("K12.iq3px", "iq3px", (32,), True),
               ("K12.iq3ps", "iq3ps", (32,), True),
               ("K12.iq1p", "iq1p", (32, 8), True))
SBQ_KERNELS = ("K14", "K14.q5_k")
SBQ_T = (2, 8, 16)
FFN_T = (1, 2, 8)  # K15b at T = 1, K15a above


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--kernels", default=",".join(
        Q4K_KERNELS + tuple(k for k, _ in ROWMV_KERNELS)
        + tuple(k for k, *_ in GRP_KERNELS) + SBQ_KERNELS
        + ("K15b", "K15a")))
    args = ap.parse_args()
    want = set(args.kernels.split(","))
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("bench_q4k: no CUDA device available")
    from koboldcpp_tpu_torch.models.synthetic import (
        _MAKERS, rand_iq, rand_q2k, rand_q3k, rand_q4k, rand_q5k, rand_q6k,
        rand_q8_0)
    from koboldcpp_tpu_torch.ops import ffn_fused as ff
    from koboldcpp_tpu_torch.ops import quant_matmul as qm
    from koboldcpp_tpu_torch.ops.linear import QTensor, dequant

    dev = torch.device("cuda", 0)
    label = args.label or root
    print(f"bench_q4k {label}: {_card()}; torch {torch.__version__}",
          flush=True)

    def rot_ms(calls, reps: int = 10) -> float:
        """Device time of one call: graph replays of calls[0](),
        calls[1](), ... (one per weight copy) over their number."""
        for c in calls:
            c()
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for c in calls:
                c()
        g.replay()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            g.replay()
        b.record()
        b.synchronize()
        del g
        return a.elapsed_time(b) / (reps * len(calls))

    def copies(nbytes_one: int) -> int:
        return max(2, -(-96 * 2 ** 20 // nbytes_one))

    def nbytes(*ts) -> int:
        return sum(t.numel() * t.element_size() for t in ts)

    def check(ok: bool, what: str) -> None:
        if not ok:
            raise RuntimeError(f"bench_q4k check failed: {what}")

    sums: dict = {}
    rng = np.random.default_rng(0)
    for kid, maker in (("K1", rand_q4k), ("K1.q5_k", rand_q5k),
                       ("K7", rand_q4k), ("K7.q5_k", rand_q5k),
                       ("K17a", rand_q4k)):
        if kid not in want:
            continue
        for name, (out_f, in_f) in SHAPES:
            stacked = kid == "K17a"
            qt = maker(rng, (STACKED_L if stacked else 1) * out_f, in_f, dev)
            if stacked:
                qt = QTensor(kind=qt.kind, shape=(out_f, in_f), data={
                    n: a.view(STACKED_L, out_f, *a.shape[1:])
                    for n, a in qt.data.items()})
                ids = torch.arange(STACKED_L, dtype=torch.int32, device=dev)
                li = STACKED_L - 1
                layer = qm.layer_of(qt, li)
            else:
                layer = qt
            w = dequant(layer)
            wb = nbytes(*layer.data.values())
            qts = [qt] + [QTensor(kind=qt.kind, shape=qt.shape, data={
                n: a.clone() for n, a in qt.data.items()})
                for _ in range(copies(wb) - 1)]  # the bytes a call reads
            ws = [w] + [w.clone() for _ in range(copies(nbytes(w)) - 1)]
            for T in ((2, 4, 8) if kid.startswith("K7") else (1,)):
                x = torch.from_numpy(rng.standard_normal((T, in_f)).astype(
                    np.float32)).to(dev).bfloat16()
                if kid.startswith("K7"):
                    calls = [lambda x=x, q=q: qm.q4k_matvec_t(x, q, True)
                             for q in qts]
                elif stacked:
                    calls = [lambda x=x, q=q, idx=ids[li:li + 1]:
                             qm.q4k_matvec_stacked(x[0], q, idx, True)
                             for q in qts]
                else:
                    calls = [lambda x=x, q=q: qm.q4k_matvec(x[0], q, True)
                             for q in qts]
                if args.check:
                    y = calls[0]()
                    ref = qm.q4k_matvec_t_plain(x, layer, True)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    tol = 2 ** -7 * ref.float().abs().max().item()
                    check(err <= tol, f"{kid} {name} T={T}: error {err} > "
                          f"{tol}")
                    for t in range(T):
                        alone = qm.q4k_matvec(x[t], layer, True)
                        check(torch.equal(y[t:t + 1], alone),
                              f"{kid} {name} T={T}: row {t} differs from K1 "
                              "on it alone")
                bound = (wb + nbytes(x) + T * out_f * 2) / HBM_BYTES_PER_S * 1e3
                k_ms = rot_ms(calls)
                lib_ms = rot_ms([lambda x=x, w=w_: torch.matmul(x, w.t())
                                 for w_ in ws])
                print(json.dumps({"tree": label, "kernel": kid,
                                  "case": f"{name} {out_f}x{in_f}", "T": T,
                                  "dev_ms": k_ms, "library_dev_ms": lib_ms,
                                  "bound_ms": bound}), flush=True)
                s = sums.setdefault((kid, "T=1" if T == 1 else "T=2-8"),
                                    [0.0, 0.0, 0.0, 0])
                s[0] += k_ms
                s[1] += lib_ms
                s[2] += bound
                s[3] += 1
                if T == 8:
                    s8 = sums.setdefault((kid, "T=8"), [0.0, 0.0, 0.0, 0])
                    for i, v in enumerate((k_ms, lib_ms, bound, 1)):
                        s8[i] += v
            del w, ws, qt, qts, layer
            torch.cuda.empty_cache()
    makers = {"q6_k": rand_q6k, "q2_k": rand_q2k, "q3_k": rand_q3k}
    for n, (kid, kind) in enumerate(ROWMV_KERNELS):
        if kid not in want:
            continue
        rng = np.random.default_rng(1 + n)
        expanded = kind not in makers
        fn, plain = ((qm.q6k_matvec, qm.q6k_matvec_plain) if kind == "q6_k"
                     else (lambda x, q, i8: qm.kq_expanded_matvec(x, q),
                           lambda x, q, i8: qm.kq_expanded_matvec_plain(x, q))
                     if expanded
                     else (qm.q23k_matvec, qm.q23k_matvec_plain))
        for name, (out_f, in_f) in SHAPES:
            qt = (_MAKERS if expanded else makers)[kind](rng, out_f, in_f,
                                                         dev)
            w = dequant(qt)
            # the fields the kernel reads (an expanded QTensor also carries
            # its dense kind's, for T > 1)
            wb = nbytes(*(a for n_, a in qt.data.items()
                          if not expanded or n_ in ("q", "n4", "scale",
                                                    "min")))
            qts = [qt] + [QTensor(kind=qt.kind, shape=qt.shape, data={
                n_: a.clone() for n_, a in qt.data.items()})
                for _ in range(copies(wb) - 1)]
            ws = [w] + [w.clone() for _ in range(copies(nbytes(w)) - 1)]
            x = torch.from_numpy(rng.standard_normal((1, in_f)).astype(
                np.float32)).to(dev).bfloat16()
            lib_ms = rot_ms([lambda w=w_: torch.matmul(x, w.t())
                             for w_ in ws])
            bound = (wb + nbytes(x) + out_f * 2) / HBM_BYTES_PER_S * 1e3
            for i8 in ((True,) if expanded else (True, False)):
                variant = "int8" if i8 else "bf16 x"
                calls = [lambda q=q, i8=i8: fn(x[0], q, i8) for q in qts]
                if args.check:
                    y = calls[0]()
                    ref = plain(x[0], qt, i8)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    tol = 2 ** -7 * ref.float().abs().max().item()
                    check(err <= tol, f"{kid} {name} {variant}: error "
                          f"{err} > {tol}")
                k_ms = rot_ms(calls)
                print(json.dumps({"tree": label, "kernel": kid,
                                  "case": f"{name} {out_f}x{in_f}", "T": 1,
                                  "variant": variant, "dev_ms": k_ms,
                                  "library_dev_ms": lib_ms,
                                  "bound_ms": bound}), flush=True)
                s = sums.setdefault((kid, f"T=1 {variant}"),
                                    [0.0, 0.0, 0.0, 0])
                for i, v in enumerate((k_ms, lib_ms, bound, 1)):
                    s[i] += v
            del w, ws, qt, qts
            torch.cuda.empty_cache()
    def add(key, k_ms, lib_ms, bound):
        s = sums.setdefault(key, [0.0, 0.0, 0.0, 0])
        for i, v in enumerate((k_ms, lib_ms, bound, 1)):
            s[i] += v

    # K2.q8_0 / K2.q8_0_bf16 and K12.iq at each scale group; one seed per
    # (kind, G), so both q8_0 bodies time the same weights
    for kid, kind, groups, i8 in GRP_KERNELS:
        if kid not in want:
            continue
        for G in groups:
            rng = np.random.default_rng(
                30 + 3 * (("q8_0",) + qm.IQ_KINDS).index(kind) + G // 16)
            for name, (out_f, in_f) in SHAPES:
                qt = (rand_q8_0(rng, out_f, in_f, dev) if kind == "q8_0"
                      else rand_iq(rng, out_f, in_f, dev, kind, G))
                w = dequant(qt)
                wb = nbytes(*qt.data.values())
                qts = [qt] + [QTensor(kind=qt.kind, shape=qt.shape, data={
                    n_: a.clone() for n_, a in qt.data.items()})
                    for _ in range(copies(wb) - 1)]
                ws = [w] + [w.clone() for _ in range(copies(nbytes(w)) - 1)]
                x = torch.from_numpy(rng.standard_normal((1, in_f)).astype(
                    np.float32)).to(dev).bfloat16()
                if kind == "q8_0":
                    calls = [lambda q=q: qm.q8_0_matvec(x[0], q, i8)
                             for q in qts]
                    plain = lambda: qm.q8_0_matvec_plain(x[0], qt, i8)
                else:
                    calls = [lambda q=q: qm.iq_matvec(x[0], q) for q in qts]
                    plain = lambda: qm.iq_matvec_plain(x[0], qt)
                if args.check:
                    y = calls[0]()
                    ref = plain()
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    tol = (0.0 if kind == "q8_0"
                           else 2 ** -7 * ref.float().abs().max().item())
                    check(err <= tol, f"{kid} G={G} {name}: error {err} > "
                          f"{tol}")
                lib_ms = rot_ms([lambda w=w_: torch.matmul(x, w.t())
                                 for w_ in ws])
                bound = (wb + nbytes(x) + out_f * 2) / HBM_BYTES_PER_S * 1e3
                k_ms = rot_ms(calls)
                print(json.dumps({"tree": label, "kernel": kid,
                                  "case": f"G={G} {name} {out_f}x{in_f}",
                                  "T": 1, "dev_ms": k_ms,
                                  "library_dev_ms": lib_ms,
                                  "bound_ms": bound}), flush=True)
                add((kid, f"T=1 G={G}"), k_ms, lib_ms, bound)
                del w, ws, qt, qts
                torch.cuda.empty_cache()

    # K14 / K14.q5_k at T = 2, 8, 16 on the prefixes of one x, and K7 at
    # T = 8 on the same q4_k weights and x (the sbq fields are K14's only)
    for n, kid in enumerate(SBQ_KERNELS):
        if kid not in want and not (kid == "K14" and "K7" in want):
            continue
        rng = np.random.default_rng(10 + n)
        maker = rand_q4k if kid == "K14" else rand_q5k
        for name, (out_f, in_f) in SHAPES:
            qt = maker(rng, out_f, in_f, dev)
            w = dequant(qt)
            wb = nbytes(*(t for n_, t in qt.data.items() if n_ != "scale"))
            qts = [qt] + [QTensor(kind=qt.kind, shape=qt.shape, data={
                n_: a.clone() for n_, a in qt.data.items()})
                for _ in range(copies(wb) - 1)]
            ws = [w] + [w.clone() for _ in range(copies(nbytes(w)) - 1)]
            xmax = torch.from_numpy(rng.standard_normal(
                (max(SBQ_T), in_f)).astype(np.float32)).to(dev).bfloat16()
            ys = {}
            for T in SBQ_T:
                x = xmax[:T].contiguous()
                lib_ms = rot_ms([lambda x=x, w=w_: torch.matmul(x, w.t())
                                 for w_ in ws])
                if kid in want:
                    calls = [lambda x=x, q=q: qm.q4k_matvec_sbq(x, q)
                             for q in qts]
                    if args.check:
                        y = ys[T] = calls[0]()
                        ref = qm.q4k_matvec_sbq_plain(x, qt)
                        torch.cuda.synchronize()
                        err = (y.float() - ref.float()).abs().max().item()
                        tol = 2 ** -7 * ref.float().abs().max().item()
                        check(err <= tol, f"{kid} {name} T={T}: error {err} "
                              f"> {tol}")
                        if T == max(SBQ_T):
                            for t0, y0 in ys.items():
                                check(torch.equal(y0, y[:t0]),
                                      f"{kid} {name}: rows at T={t0} differ "
                                      f"from those at T={T}")
                    bound = (wb + nbytes(x) + T * out_f * 2) \
                        / HBM_BYTES_PER_S * 1e3
                    k_ms = rot_ms(calls)
                    print(json.dumps({"tree": label, "kernel": kid,
                                      "case": f"{name} {out_f}x{in_f}",
                                      "T": T, "dev_ms": k_ms,
                                      "library_dev_ms": lib_ms,
                                      "bound_ms": bound}), flush=True)
                    add((kid, f"T={T}"), k_ms, lib_ms, bound)
                    add((kid, "T=2+8+16"), k_ms, lib_ms, bound)
                if kid == "K14" and T == 8 and "K7" in want:
                    # K7's fields: the codes, scales and mins of the same
                    # weights
                    k7b = nbytes(*(t for n_, t in qt.data.items()
                                   if n_ not in ("sc", "d")))
                    k_ms = rot_ms([lambda x=x, q=q: qm.q4k_matvec_t(x, q, True)
                                   for q in qts])
                    bound = (k7b + nbytes(x) + T * out_f * 2) \
                        / HBM_BYTES_PER_S * 1e3
                    print(json.dumps({"tree": label, "kernel": "K7",
                                      "case": f"{name} {out_f}x{in_f} "
                                      "(K14's weights)", "T": T,
                                      "dev_ms": k_ms, "library_dev_ms": lib_ms,
                                      "bound_ms": bound}), flush=True)
                    add(("K7", "T=8 on K14's weights"), k_ms, lib_ms, bound)
            del w, ws, qt, qts
            torch.cuda.empty_cache()
    if "K15a" in want or "K15b" in want:
        # the 1.1B's FFN: w_gateup (2F, C), w_down (C, F)
        rng = np.random.default_rng(20)
        C, F = 2048, 5632
        gu, dn = rand_q4k(rng, 2 * F, C, dev), rand_q4k(rng, C, F, dev)
        fb = [n_ for n_ in gu.data if n_ not in ("sc", "d")]
        wb = nbytes(*(gu.data[n_] for n_ in fb), *(dn.data[n_] for n_ in fb))
        pairs = [(gu, dn)] + [tuple(QTensor(kind=q.kind, shape=q.shape, data={
            n_: a.clone() for n_, a in q.data.items()}) for q in (gu, dn))
            for _ in range(copies(wb) - 1)]
        wg, wd = dequant(gu), dequant(dn)
        wpairs = [(wg, wd)] + [(wg.clone(), wd.clone()) for _ in range(
            copies(nbytes(wg, wd)) - 1)]

        def library(x, wg, wd):
            h = torch.matmul(x, wg.t())
            return torch.matmul(torch.nn.functional.silu(h[:, :F])
                                * h[:, F:], wd.t())

        xmax = torch.from_numpy(rng.standard_normal(
            (max(FFN_T), C)).astype(np.float32)).to(dev).bfloat16()
        ys = {}
        for T in FFN_T:
            kid = "K15b" if T == 1 else "K15a"
            if kid not in want:
                continue
            x = xmax[:T].contiguous()
            calls = [lambda x=x, p=p: ff.ffn_fused_call(x, *p) for p in pairs]
            if args.check:
                y = calls[0]()
                ref = ff.ffn_fused_plain(x, gu, dn)
                torch.cuda.synchronize()
                err = (y.float() - ref.float()).abs().max().item()
                tol = 2 ** -7 * ref.float().abs().max().item()
                check(err <= tol, f"{kid} T={T}: error {err} > {tol}")
                if T > 1:
                    ys[T] = y
                    for t0, y0 in ys.items():
                        check(torch.equal(y0, y[:t0]), f"K15a: rows at "
                              f"T={t0} differ from those at T={T}")
            k_ms = rot_ms(calls)
            lib_ms = rot_ms([lambda x=x, p=p: library(x, *p)
                             for p in wpairs])
            bound = (wb + nbytes(x) + T * C * 2) / HBM_BYTES_PER_S * 1e3
            print(json.dumps({"tree": label, "kernel": kid,
                              "case": f"w_gateup {2 * F}x{C} + w_down "
                              f"{C}x{F}", "T": T, "dev_ms": k_ms,
                              "library_dev_ms": lib_ms, "bound_ms": bound}),
                  flush=True)
            add((kid, f"T={T}"), k_ms, lib_ms, bound)
            if T > 1:
                add(("K15a", "T=2+8"), k_ms, lib_ms, bound)
        del pairs, wpairs, wg, wd
        torch.cuda.empty_cache()
    for (kid, cls), (k, lib, bound, n) in sums.items():
        print(f"{label} {kid} {cls} ({n} cases), device alone: kernel "
              f"{k:.4f} ms, library {lib:.4f} ms = {k / lib:.2f}x, bound "
              f"{bound:.4f} ms = kernel / bound {k / bound:.2f}x", flush=True)
    print(json.dumps({"tree": label, "sums": {
        f"{kid} {cls}": {"dev_ms": k, "library_dev_ms": lib, "bound_ms": b,
                         "cases": n}
        for (kid, cls), (k, lib, b, n) in sums.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
