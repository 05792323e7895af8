"""Profile the scan decode path (layer-stacked weights over a pooled cache:
K17a and K17c in every layer) or the unrolled forward (per-layer weights
over the slot cache: K1 and K5) at B=1, and print the per-op device time of
a decode step and the device's idle share. The port of tools/profile_scan.py
of the JAX package, on the synthetic TinyLlama-1.1B q4_k.

Usage: python -m koboldcpp_tpu_torch.tools.profile_scan [scan|unroll]
           [--steps N] [--device cpu]

Without --device it runs on the card and raises where there is none;
`--device cpu` runs the plain PyTorch versions and reports host op times
only (a CPU run measures no device). As in the JAX tool, the decode starts
at position 64 over an empty cache from token 7 and takes N greedy tokens
(default 64); a first run warms up, a second runs under torch.profiler.
"""
from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..kv.cache import init_cache, init_pool_cache
from ..models import llama
from ..models.config import ModelConfig
from ..models.synthetic import TINYLLAMA_1_1B, synthetic_params

MAX_SEQ = 1024
START_POS = 64
TOKEN0 = 7


def decode_n(mode: str, cfg: ModelConfig, n: int, device, params=None,
             start_pos: int = START_POS) -> list[int]:
    """n greedy single-token steps from TOKEN0 at start_pos over an empty
    cache: "scan" through `forward_stacked` over `init_pool_cache(L, 1,
    MAX_SEQ)` (params stacked here unless they already are), "unroll"
    through `forward` over `init_cache`. params default to the synthetic
    q4_k model of cfg (seed 0). Returns the n tokens."""
    dev = resolve_device(device)
    if params is None:
        params = synthetic_params(cfg, "q4_k", seed=0, device=dev)
    shape = (cfg.n_layers, 1, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    if mode == "scan":
        if "layers_stacked" not in params:
            params = llama.stack_layers(params)
        if "layers_stacked" not in params:
            raise ValueError("the layers do not stack (mixed kinds)")
        cache, fwd = init_pool_cache(*shape, device=dev), llama.forward_stacked
    elif mode == "unroll":
        cache, fwd = init_cache(*shape, device=dev), llama.forward
    else:
        raise ValueError(f"mode is scan or unroll, not {mode!r}")
    tok = torch.full((1, 1), TOKEN0, dtype=torch.int64, device=dev)
    out = []
    with torch.inference_mode():
        for i in range(n):
            pos = torch.full((1, 1), start_pos + i, dtype=torch.int64,
                             device=dev)
            logits, cache = fwd(params, cfg, tok, pos, cache, last_only=True)
            tok = logits[:, -1].argmax(dim=-1, keepdim=True)
            out.append(tok)
    return torch.cat(out, dim=1)[0].tolist()


def device_rows(prof) -> dict[str, tuple[float, int]]:
    """{kernel name: (device microseconds, launches)} of a finished
    torch.profiler session: the device rows of `key_averages()`, read from
    the raw Kineto events without building every host op's event tree
    first (that takes ~25 s for a 32-token window of the 1.1B)."""
    from torch.autograd import DeviceType

    rows: dict[str, tuple[float, int]] = {}
    for e in prof.profiler.kineto_results.events():
        if (e.device_type() != DeviceType.CUDA
                or getattr(e, "is_hidden_event", lambda: False)()
                or getattr(e, "is_user_annotation", lambda: False)()):
            continue
        us, count = rows.get(e.name(), (0.0, 0))
        rows[e.name()] = (us + e.duration_ns() / 1e3, count + 1)
    return rows


def profile(mode: str, cfg: ModelConfig, n: int, device,
            params=None) -> dict:
    """decode_n once to warm up, then once under torch.profiler. Returns
    {"wall_ms", "busy_ms" (None on the CPU), "idle_share" (None on the
    CPU), "ops": [(name, us per step, launches per step), ...] by time},
    device kernels on the card, host ops on the CPU."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = resolve_device(device)
    if params is None:
        params = synthetic_params(cfg, "q4_k", seed=0, device=dev)
    if mode == "scan" and "layers_stacked" not in params:
        params = llama.stack_layers(params)
    cuda = dev.type == "cuda"
    decode_n(mode, cfg, n, dev, params)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with torch_profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode_n(mode, cfg, n, dev, params)
        if cuda:
            torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    if cuda:
        rows = [(us, c, k) for k, (us, c) in device_rows(prof).items()]
    else:
        rows = [(e.self_cpu_time_total, e.count, e.key)
                for e in prof.key_averages()]
    rows.sort(reverse=True)
    busy_ms = sum(t for t, _, _ in rows) / 1e3 if cuda else None
    return {"wall_ms": wall_ms, "busy_ms": busy_ms,
            "idle_share": (1 - busy_ms / wall_ms
                           if cuda and busy_ms > 0 else None),
            "ops": [(k, t / n, c / n) for t, c, k in rows]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", nargs="?", default="scan",
                    choices=("scan", "unroll"))
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cpu for the plain PyTorch path (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = profile(args.mode, TINYLLAMA_1_1B, args.steps, dev)
    where = (f"device kernels, {torch.cuda.get_device_name(dev)}"
             if dev.type == "cuda" else "host ops on the CPU; no device")
    total = sum(t for _, t, _ in res["ops"])
    print(f"== {args.mode}: {where}, per decode step over {args.steps} "
          f"steps (op total {total:.1f} us/step, wall "
          f"{res['wall_ms'] / args.steps:.1f} ms/step) ==")
    for name, us, cnt in res["ops"][:60]:
        print(f"{us:9.1f} us  {100 * us / max(total, 1e-9):5.1f}%  "
              f"n={cnt:7.2f}  {name[:100]}")
    idle = res["idle_share"]
    print("device idle share: "
          + (f"{idle:.3f} (busy {res['busy_ms']:.1f} ms of wall "
             f"{res['wall_ms']:.1f} ms)" if idle is not None
             else "not measured (no device)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
