"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

1. builds every kernel of koboldcpp_tpu_torch/csrc/ (one nvcc per source,
   all at once) and prints the build time and the card's name and power
   limit;
2. holds each kernel against its plain PyTorch version on the card at the
   TinyLlama-1.1B shapes, with the max error against its stated tolerance
   and the times of the kernel, the plain version, one PyTorch library call
   computing the same function, and the least time the card could take;
3. serves a synthetic TinyLlama-1.1B q4_k model through Engine: a ~300
   token prompt (prefill through K3), 128 greedy tokens (K1 and K5), the
   same prompt again (fast-forward) and a prompt that forces a context
   shift, and checks that K1, K3 and K5 ran;
4. serves tests/fixtures/refgguf/tiny-q4_k_m.gguf over HTTP in-process and
   checks that K2 ran, and that the fixture's logits on the card agree with
   the reference runtime's goldens;
5. prints one {"kernels": [...]} line, then the {"ok": true, ...} line.

Any failed check raises, so the script exits nonzero. It exits nonzero,
printing no result, when no GPU is present.
"""
from __future__ import annotations

import asyncio
import json
import os
import socket
import sys
import threading
import time
import urllib.request

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device available")

from koboldcpp_tpu_torch.device import card_info  # noqa: E402
from koboldcpp_tpu_torch.engine import Engine, GenParams  # noqa: E402
from koboldcpp_tpu_torch.models import llama  # noqa: E402
from koboldcpp_tpu_torch.models.loader import load_model  # noqa: E402
from koboldcpp_tpu_torch.models.synthetic import (  # noqa: E402
    TINYLLAMA_1_1B, rand_q4k, rand_q6k, synthetic_model)
from koboldcpp_tpu_torch.kv.cache import init_cache  # noqa: E402
from koboldcpp_tpu_torch.ops import _build, flash_decode  # noqa: E402
from koboldcpp_tpu_torch.ops import quant_matmul as qm  # noqa: E402
from koboldcpp_tpu_torch.ops.linear import dequant  # noqa: E402
from koboldcpp_tpu_torch.sampling import SamplerParams  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_FLOPS = 989e12        # H100 SXM dense bf16 tensor-core peak
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf")

KERNELS = {
    "K1": ("q4k_matvec", "koboldcpp_tpu_torch/csrc/q4k_matvec.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1349"),
    "K2": ("q6k_matvec", "koboldcpp_tpu_torch/csrc/q6k_matvec.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1489"),
    "K3": ("kq_matmul", "koboldcpp_tpu_torch/csrc/kq_matmul.cu",
           "koboldcpp_tpu/ops/quant_matmul.py:1631"),
    "K5": ("flash_decode", "koboldcpp_tpu_torch/csrc/flash_decode.cu",
           "koboldcpp_tpu/ops/flash_decode.py:248"),
}
CASES: dict[str, list[dict]] = {k: [] for k in KERNELS}

_flush = None


def _time_ms(fn, reps: int = 20) -> float:
    """Median device time of one call, L2 flushed before each call (the
    decode loop streams every weight from HBM once per token)."""
    global _flush
    if _flush is None:
        _flush = torch.empty(256 * 1024 * 1024, dtype=torch.uint8, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        _flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound_ms(nbytes: int, flops: int = 0) -> tuple[float, str]:
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = flops / BF16_FLOPS * 1e3
    return (tf, "operations") if tf > tb else (tb, "bytes")


def _check(ok: bool, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def _record(kid: str, what: str, err: float, tol: float, kernel, plain,
            library, nbytes: int, flops: int = 0) -> None:
    _check(err <= tol, f"{kid} {what}: max error {err} > {tol}")
    bound, by = _bound_ms(nbytes, flops)
    case = {"case": what, "max_abs_err": err, "tol": tol,
            "ms": _time_ms(kernel), "plain_ms": _time_ms(plain, 5),
            "library_ms": _time_ms(library), "bound_ms": bound,
            "bound_by": by}
    CASES[kid].append(case)
    print(f"{kid} {what}: max_abs_err {err:.3g} (tol {tol:.3g}) "
          f"kernel {case['ms']:.4f} ms, plain {case['plain_ms']:.4f} ms, "
          f"library {case['library_ms']:.4f} ms, bound {bound:.4f} ms "
          f"({by})", flush=True)


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# 2. kernels against their plain versions at the 1.1B shapes
# ---------------------------------------------------------------------------

def phase_matvec(rng) -> None:
    C, F, V = 2048, 5632, 32000
    shapes = {"wqkv": (2560, C), "w_gateup": (2 * F, C), "wo": (C, C),
              "w_down": (C, F), "output": (V, C),
              # the served Q4_K_M fixture's shapes (bf16 variant below 512)
              "fixture wqkv": (512, 256), "fixture wo": (256, 256),
              "fixture ffn_down": (256, 512), "fixture output": (512, 256)}
    for kid, maker, wrapper, plain, names in (
            ("K1", rand_q4k, qm.q4k_matvec, qm.q4k_matvec_plain,
             ("wqkv", "w_gateup", "wo", "w_down", "output", "fixture wqkv",
              "fixture wo")),
            ("K2", rand_q6k, qm.q6k_matvec, qm.q6k_matvec_plain,
             ("output", "w_down", "fixture output", "fixture ffn_down"))):
        for name in names:
            out_f, in_f = shapes[name]
            qt = maker(rng, out_f, in_f, DEV)
            x = torch.from_numpy(rng.standard_normal(in_f).astype(
                np.float32)).to(DEV).bfloat16()
            i8 = in_f >= 512
            y = wrapper(x, qt, i8)
            ref = plain(x, qt, i8)
            torch.cuda.synchronize()
            # int8 group dots are exact on both sides (bf16 variant: f32
            # dots of the same values); f32 sums in another order, bf16
            # output: one bf16 rounding step of the largest |y|
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2 ** -7 * ref.float().abs().max().item()
            w = dequant(qt)
            xr = x.view(1, in_f)
            _record(kid, f"{name} {out_f}x{in_f} T=1", err, tol,
                    lambda: wrapper(x, qt, i8), lambda: plain(x, qt, i8),
                    lambda: torch.matmul(xr, w.t()),
                    _nbytes(*qt.data.values(), x) + out_f * 2)
            del w


def phase_kq_matmul(rng) -> None:
    for name, (out_f, in_f) in (("w_gateup", (11264, 2048)),
                                ("w_down", (2048, 5632))):
        for kind, maker in (("q4_k", rand_q4k), ("q6_k", rand_q6k)):
            qt = maker(rng, out_f, in_f, DEV)
            w = dequant(qt)
            for T in (16, 512):
                x = torch.from_numpy((rng.standard_normal((T, in_f)) * 0.5)
                                     .astype(np.float32)).to(DEV).bfloat16()
                y = qm.kq_matmul(x, qt)
                ref = qm.kq_matmul_plain(x, qt)
                torch.cuda.synchronize()
                # same bf16 weights and group sums, f32 accumulation in
                # another order, bf16 output: one rounding step of max |y|
                err = (y.float() - ref.float()).abs().max().item()
                tol = 2 ** -7 * ref.float().abs().max().item()
                _record("K3", f"{kind} {name} {out_f}x{in_f} T={T}", err, tol,
                        lambda: qm.kq_matmul(x, qt),
                        lambda: qm.kq_matmul_plain(x, qt),
                        lambda: torch.matmul(x, w.t()),
                        _nbytes(*qt.data.values(), x) + T * out_f * 2,
                        2 * T * in_f * out_f)
            del w


def phase_flash_decode(rng) -> None:
    # the 1.1B shape at four positions with nearly flat scores; then peaked
    # scores (see _peak) at two of them, and B=2 at head_dim 128 (an 8B-class
    # GQA shape) with one live and one dead (pos < 0) sequence
    for B, S, H, Hkv, D, positions, peaked in (
            [(1, 2048, 32, 4, 64, (p,), False) for p in (0, 1, 700, 2047)]
            + [(1, 2048, 32, 4, 64, (p,), True) for p in (700, 2047)]
            + [(2, 4096, 32, 8, 128, (3000, -1), True)]):
        _flash_decode_case(rng, B, S, H, Hkv, D, positions, peaked)


def _peak(rng, q, kc, positions, G: int) -> None:
    """Make a few rows dominate the softmax, so that a row read or missed
    by mistake moves the output by far more than rounding can. Each kv
    group's query heads share a direction u (score of a row c*u ~ c); the
    rows around the first two and the last 256-row split boundaries below
    the history end, and the last history row, get c in [8, 9]; the global
    maximum (c = 9.5) sits in the last split; the row at pos (stale before
    this step's write) and the one after it get c = 11 and must not be
    read. The other rows score ~N(0, 0.7^2)."""
    B, H, D = q.shape
    S, Hkv = kc.shape[1], H // G
    u = torch.nn.functional.normalize(
        torch.from_numpy(rng.standard_normal((B, Hkv, D)).astype(np.float32)),
        dim=-1).to(q.device)
    q.copy_((D ** 0.5 * u).repeat_interleave(G, 1) + q.float())
    kv = kc.view(B, S, Hkv, D)
    for b, p in enumerate(positions):
        n_hist = p if p >= 0 else S
        last = (n_hist - 1) // 256 * 256
        read = sorted({r for j in {256, 512, last} if 0 < j < n_hist
                       for r in (j - 1, j)} | {n_hist - 1})
        for r, c in zip(read, np.linspace(8.0, 9.0, len(read))):
            kv[b, r] = c * u[b]
        kv[b, (last + n_hist) // 2] = 9.5 * u[b]
        for r in (p, p + 1) if p >= 0 else ():
            if r < S:
                kv[b, r] = 11.0 * u[b]


def _flash_decode_case(rng, B, S, H, Hkv, D, positions, peaked) -> None:
    KD = Hkv * D
    scale = D ** -0.5

    def t(shape, s=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(
            np.float32)).to(DEV).bfloat16()

    kc0, vc0 = t((B, S, KD), 0.5), t((B, S, KD), 0.5)
    q, kn, vn = t((B, H, D)), t((B, Hkv, D)), t((B, Hkv, D))
    if peaked:
        _peak(rng, q, kc0, positions, H // Hkv)
    pos = torch.tensor(positions, dtype=torch.int32, device=DEV)
    kc, vc = kc0.clone(), vc0.clone()
    out, _, _ = flash_decode.decode_attention_batched(
        q, kn, vn, kc, vc, pos, H, Hkv, scale)
    kr, vr = kc0.clone(), vc0.clone()
    ref = flash_decode.decode_attention_plain(q, kn, vn, kr, vr, pos, H, Hkv,
                                              scale)
    # W = sum_s p_s |v_s| / l per output element: the same softmax over |V|
    w = flash_decode.decode_attention_plain(q, kn, vn.abs(), kc0.clone(),
                                            vc0.abs(), pos, H, Hkv, scale)
    torch.cuda.synchronize()
    what = (f"B={B} S={S} H={H} Hkv={Hkv} D={D} pos={positions}"
            + (" peaked" if peaked else ""))
    # the cache row at pos is this step's K/V, every other row unchanged
    want_k, want_v = kc0.clone(), vc0.clone()
    for b, p in enumerate(positions):
        if 0 <= p < S:
            want_k[b, p] = kn[b].reshape(KD)
            want_v[b, p] = vn[b].reshape(KD)
    _check(torch.equal(kc, want_k) and torch.equal(vc, want_v),
           f"K5 {what}: the cache is not the old one plus the rows at pos")
    _check(torch.equal(kc, kr) and torch.equal(vc, vr),
           f"K5 {what}: kernel and plain caches differ")
    # each p is rounded to bf16 (2^-8 relative) against another running max
    # on each side, so output element d moves by at most 2^-7 * W_d; 5% more
    # for f32 sums and exp in another order. Checked element by element.
    tol_el = 2 ** -7 * 1.05 * w
    diff = (out - ref).abs()
    ratio = diff / tol_el.clamp_min(1e-30)
    worst = ratio.max().item()
    _check(worst <= 1.0, f"K5 {what}: max |err| / elementwise tol {worst}")
    err = diff.max().item()
    tol = tol_el.flatten()[diff.argmax()].item()
    print(f"K5 {what}: worst |err| / (2^-7 * 1.05 * W) {worst:.3g}",
          flush=True)
    # library: SDPA over the rows each query attends: the live prefix of the
    # updated cache (history + this row), or for a dead sequence (pos < 0)
    # every cache row plus this step's row
    ql = q.view(B, H, 1, D)
    if B == 1 and positions[0] >= 0:
        n = positions[0] + 1
        kq = want_k[:, :n].view(B, n, Hkv, D).transpose(1, 2)
        vq = want_v[:, :n].view(B, n, Hkv, D).transpose(1, 2)
        mask = None
    else:
        kq = torch.cat([want_k, kn.reshape(B, 1, KD)], 1).view(
            B, S + 1, Hkv, D).transpose(1, 2)
        vq = torch.cat([want_v, vn.reshape(B, 1, KD)], 1).view(
            B, S + 1, Hkv, D).transpose(1, 2)
        cols = torch.arange(S + 1, device=DEV)
        mask = torch.stack([cols <= p if p >= 0 else cols >= 0
                            for p in positions])[:, None, None, :]
    hist_rows = sum(min(p, S) if p >= 0 else S for p in positions)
    n_written = sum(0 <= p < S for p in positions)
    _record("K5", what, err, tol,
            lambda: flash_decode.decode_attention_batched(
                q, kn, vn, kc, vc, pos, H, Hkv, scale),
            lambda: flash_decode.decode_attention_plain(
                q, kn, vn, kr, vr, pos, H, Hkv, scale),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                ql, kq, vq, attn_mask=mask, scale=scale, enable_gqa=True),
            2 * hist_rows * KD * 2 + _nbytes(q, kn, vn, pos) + B * H * D * 4
            + 2 * n_written * KD * 2)


# ---------------------------------------------------------------------------
# 3. end to end: synthetic TinyLlama-1.1B q4_k served through Engine
# ---------------------------------------------------------------------------

def phase_end_to_end(card: str) -> dict:
    model = synthetic_model(TINYLLAMA_1_1B, "q4_k", seed=0, device=DEV)
    eng = Engine(model, max_context=2048, device=DEV)
    gp = GenParams(max_length=128, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
    rng = np.random.default_rng(1)
    prompt = [1] + rng.integers(3, 32000, size=299).tolist()
    # warm-up; the repeat takes the fast-forward path, whose first call
    # builds the native helper library (native/, make) outside the timings
    for _ in range(2):
        eng.generate(prompt[:40], GenParams(max_length=40, bypass_eos=True,
                                            sampler=gp.sampler))
    eng.reset_context()

    _build.launches.clear()
    r1 = eng.generate(prompt, gp)
    t1 = eng.last_timings
    r2 = eng.generate(prompt, gp)
    t2 = eng.last_timings
    # history scrolled: the gap [10, 60) drops out of the middle
    shifted = prompt[:10] + prompt[60:] + r2.tokens[:8]
    r3 = eng.generate(shifted, GenParams(max_length=16, bypass_eos=True,
                                         sampler=gp.sampler))
    t3 = eng.last_timings
    counts = dict(_build.launches)

    _check(len(r1.tokens) == 128 and r2.tokens == r1.tokens,
           "greedy decode is not repeatable")
    # fast-forward: the repeat re-evaluates only the last prompt token
    _check(t1.prompt_tokens == 300 and t2.prompt_tokens == 1, (t1, t2))
    _check(t3.prompt_tokens <= 9 and len(r3.tokens) == 16,
           f"context shift did not reuse the cache: {t3}")
    for k in ("K1", "K3", "K5"):
        _check(counts.get(k, 0) > 0, f"{k} did not run on the main path")
    with torch.inference_mode():
        logits = eng._eval_chunk([5], len(eng.context_tokens))
    _check(logits.shape == (32000,) and bool(torch.isfinite(logits).all()),
           "logits are not finite (32000,)")
    idle = _decode_idle_share(eng, prompt, gp.sampler)
    print(f"end to end (synthetic TinyLlama-1.1B q4_k, {card}): prefill "
          f"{t1.prompt_tokens} tokens {t1.prompt_tps:.1f} tok/s "
          f"({t1.prompt_time * 1e3:.1f} ms), decode {t1.gen_tokens} tokens "
          f"{t1.gen_tps:.1f} tok/s ({t1.gen_time * 1e3:.1f} ms); "
          f"fast-forward repeat: {t2.prompt_tokens} prompt token "
          f"({t2.prompt_time * 1e3:.2f} ms), decode {t2.gen_tps:.1f} tok/s; "
          f"context shift re-evaluated {t3.prompt_tokens} tokens; "
          f"launches {counts}", flush=True)
    print(f"greedy decode, 64 tokens under torch.profiler: {idle}",
          flush=True)
    del eng, model
    torch.cuda.empty_cache()
    return counts


def _decode_idle_share(eng: Engine, prompt: list[int], sampler) -> str:
    """Device busy time (sum of kernel times, one stream) against the wall
    time of a fast-forwarded request that decodes 64 greedy tokens."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng.generate(prompt, GenParams(max_length=8, sampler=sampler))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(prompt, GenParams(max_length=64, bypass_eos=True,
                                       sampler=sampler))
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device-side rows only: an op's row repeats its kernels' time
    rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for t, _ in rows)
    if busy_us <= 0:
        return "device time not measured (the profiler saw no kernels)"
    top = ", ".join(f"{k[:40]} {t / 1e3:.2f} ms"
                    for t, k in sorted(rows, reverse=True)[:6])
    return (f"wall {wall_us / 1e3:.1f} ms, device busy {busy_us / 1e3:.1f} "
            f"ms, idle share {1 - busy_us / wall_us:.3f}; top: {top}")


# ---------------------------------------------------------------------------
# 4. the Q4_K_M fixture served over HTTP, and its logits against goldens
# ---------------------------------------------------------------------------

def _post(port: int, path: str, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def phase_served_fixture() -> dict:
    from aiohttp import web

    from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

    model = load_model(os.path.join(FIX, "tiny-q4_k_m.gguf"), device=DEV)
    eng = Engine(model, max_context=512, device=DEV)
    loop = asyncio.new_event_loop()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    runner = web.AppRunner(make_app(eng, ServerSettings(model_name="tiny")))
    loop.run_until_complete(runner.setup())
    loop.run_until_complete(web.TCPSite(runner, "127.0.0.1", port).start())
    thread = threading.Thread(target=loop.run_forever, daemon=True)
    thread.start()
    try:
        body = {"prompt": "The gradient of a function, e.g. f(x), points",
                "max_length": 24, "temperature": 0, "rep_pen": 1.0}
        _build.launches.clear()
        a = _post(port, "/api/v1/generate", body)["results"][0]["text"]
        b = _post(port, "/api/v1/generate", body)["results"][0]["text"]
        c = _post(port, "/v1/completions", {"prompt": "Once upon",
                                            "max_tokens": 8,
                                            "temperature": 0})
        counts = dict(_build.launches)
    finally:
        asyncio.run_coroutine_threadsafe(runner.cleanup(), loop).result(30)
        loop.call_soon_threadsafe(loop.stop)
        thread.join(30)
        loop.close()
    _check(a == b and a != "", f"temperature-0 replies differ: {a!r} {b!r}")
    _check(c["object"] == "text_completion" and c["choices"][0]["text"] != "",
           f"bad /v1/completions reply {c}")
    _check(counts.get("K2", 0) > 0, "K2 did not run on the served fixture")
    print(f"served fixture: /api/v1/generate x2 identical ({a!r}); "
          f"/v1/completions {c['choices'][0]['text']!r}; launches {counts}",
          flush=True)

    # the fixture's logits on the card against the reference runtime's
    manifest = json.load(open(os.path.join(FIX, "manifest.json")))
    toks = torch.tensor([manifest["tokens"]], device=DEV)
    m32 = load_model(os.path.join(FIX, "tiny-q4_k_m.gguf"),
                     dtype=torch.float32, device=DEV)
    cache = init_cache(m32.cfg.n_layers, 1, 64, m32.cfg.n_kv_heads,
                       m32.cfg.head_dim, dtype=torch.float32, device=DEV)
    with torch.inference_mode():
        logits, _ = llama.forward(m32.params, m32.cfg, toks,
                                  torch.arange(toks.shape[1], device=DEV)[None],
                                  cache)
    golden = np.load(os.path.join(FIX, "logits-q4_k_m.npy"))
    err = float(np.abs(logits[0].float().cpu().numpy() - golden).max())
    # tests/test_ref_gguf_fixtures.py's q4_k_m tolerance
    _check(err <= 4e-2, f"fixture logits off the goldens by {err}")
    print(f"fixture logits vs reference goldens: max abs err {err:.4g} "
          f"(tol 4e-2)", flush=True)
    return counts


def main() -> int:
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {_build.build_seconds:.1f} s "
          f"({', '.join(_build.SOURCES)})", flush=True)
    card = card_info()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    rng = np.random.default_rng(0)
    phase_matvec(rng)
    phase_kq_matmul(rng)
    phase_flash_decode(rng)
    torch.cuda.synchronize()
    global _flush
    _flush = None
    torch.cuda.empty_cache()

    e2e = phase_end_to_end(card)
    served = phase_served_fixture()

    kernels = []
    for kid, (name, source, replaces) in KERNELS.items():
        cases = CASES[kid]
        kernels.append({
            "name": f"{kid} {name}", "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": e2e.get(kid, 0) + served.get(kid, 0),
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            # times summed over the phase's cases, one call of each
            "ms": sum(c["ms"] for c in cases),
            "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": sum(c["bound_ms"] for c in cases),
            "bound_by": ("operations" if any(c["bound_by"] == "operations"
                                             for c in cases) else "bytes"),
            "library_ms": sum(c["library_ms"] for c in cases)})
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
