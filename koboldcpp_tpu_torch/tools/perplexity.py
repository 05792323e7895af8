"""Perplexity of a GGUF model over a text (wikitext-2 style), on the port.

Counterpart of tools/perplexity.py (the JAX package's; llama.cpp's
perplexity example): non-overlapping n_ctx windows, BOS at each window's
start, the NLL of the second half of each window gathered on the device.
Each window runs `models/llama.py: forward` from position 0 over a fresh
cache: on the card its quantized products go through K3 and its
attention through K4 (flash prefill, as the engine takes it: the chunk
is the whole context).

Usage:
  python -m koboldcpp_tpu_torch.tools.perplexity model.gguf --file wiki.txt \\
      [--ctx 512] [--device cpu]
"""
from __future__ import annotations

import argparse
import math

import torch


def window_nll(model, window: list[int]) -> torch.Tensor:
    """The NLL of each next token of one window, (n_ctx - 1,) f32 on the
    model's device: a forward from position 0 over a fresh cache (with
    flash prefill where the engine takes it: on the card, K4's head
    shapes, no ALiBi, whole tiles), the log-softmax and the gather on the
    device."""
    from ..kv.cache import init_cache
    from ..models import llama
    from ..ops import flash_prefill

    cfg, dev = model.cfg, model.device
    n = len(window)
    flash = (dev.type == "cuda" and flash_prefill.supported(cfg.head_dim)
             and not cfg.use_alibi and n % flash_prefill.TILE == 0)
    cache = init_cache(cfg.n_layers, 1, n, cfg.n_kv_heads, cfg.head_dim,
                       device=dev)
    toks = torch.tensor([window], dtype=torch.int64, device=dev)
    pos = torch.arange(n, device=dev)[None]
    with torch.inference_mode():
        logits, _ = llama.forward(model.params, cfg, toks, pos, cache,
                                  flash_prefill=flash)
        lp = torch.log_softmax(logits[0].float(), dim=-1)
        return -lp[:-1].gather(1, toks[0, 1:, None])[:, 0]


def perplexity(model, text: str | list[int], n_ctx: int = 512,
               verbose: bool = True) -> float:
    """exp(mean NLL) over the second half of each full n_ctx window of
    `text` (a string, or its token ids)."""
    tk = model.tokenizer
    tokens = tk.encode(text) if isinstance(text, str) else list(text)
    n_chunks = len(tokens) // n_ctx
    if n_chunks == 0:
        raise ValueError(f"need at least {n_ctx} tokens, got {len(tokens)}")
    first_eval = max(1, min(512, n_ctx // 2))
    bos = tk.vocab.bos_id if tk is not None else -1
    total_nll = 0.0
    total_cnt = 0
    for ci in range(n_chunks):
        chunk = tokens[ci * n_ctx:(ci + 1) * n_ctx]
        chunk[0] = bos if bos >= 0 else chunk[0]
        sel = window_nll(model, chunk).cpu().numpy()[first_eval - 1:]
        total_nll += float(sel.sum())
        total_cnt += len(sel)
        if verbose:
            print(f"[{ci + 1}/{n_chunks}] ppl so far: "
                  f"{math.exp(total_nll / total_cnt):.4f}", flush=True)
    return math.exp(total_nll / total_cnt)


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Compute the perplexity of a GGUF model")
    ap.add_argument("model")
    ap.add_argument("--file", required=True, help="text file (e.g. wikitext-2)")
    ap.add_argument("--ctx", type=int, default=512)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    from ..models.loader import load_model

    model = load_model(args.model, device=args.device)
    with open(args.file, errors="replace") as f:
        text = f.read()
    ppl = perplexity(model, text, n_ctx=args.ctx)
    print(f"Final perplexity: {ppl:.4f}")
    return ppl


if __name__ == "__main__":
    main()
