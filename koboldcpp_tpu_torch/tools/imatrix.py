"""Importance-matrix collection on the port (llama.cpp's imatrix example).

Counterpart of tools/imatrix.py (the JAX package's): the calibration text
runs through `models/llama.py: forward` over unpacked f32 weights with
the hook of `ops/linear.py` (`ActivationCollector`) accumulating each
linear weight's per-column sum(x^2); the statistics are divided by the
rows seen. Output: an .npz of {gguf_tensor_name: (in_features,) f32}, and
optionally llama.cpp's binary imatrix file.

Usage:
  python -m koboldcpp_tpu_torch.tools.imatrix model.gguf calib.txt \\
      -o model.imatrix.npz [--bin model.imatrix] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch


def build_name_map(params: dict) -> dict[int, str]:
    """id(QTensor) -> canonical GGUF tensor name (llama family). Fused
    projections map to their first component; expand_names() fans the
    collected stats back out to every fused member."""
    m: dict[int, str] = {}

    def put(qt, name):
        if qt is not None and hasattr(qt, "data"):
            m[id(qt)] = name

    put(params.get("output"), "output.weight")
    for i, layer in enumerate(params.get("layers", [])):
        p = f"blk.{i}."
        put(layer.get("wq"), p + "attn_q.weight")
        put(layer.get("wk"), p + "attn_k.weight")
        put(layer.get("wv"), p + "attn_v.weight")
        put(layer.get("wqkv"), p + "attn_q.weight")  # shared input stats
        put(layer.get("wo"), p + "attn_output.weight")
        put(layer.get("w_gate"), p + "ffn_gate.weight")
        put(layer.get("w_up"), p + "ffn_up.weight")
        put(layer.get("w_gateup"), p + "ffn_gate.weight")
        put(layer.get("w_down"), p + "ffn_down.weight")
        put(layer.get("ffn_gate_exps"), p + "ffn_gate_exps.weight")
        put(layer.get("ffn_up_exps"), p + "ffn_up_exps.weight")
        put(layer.get("ffn_down_exps"), p + "ffn_down_exps.weight")
    return m


def expand_names(weights: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Fused projections share input activations: copy attn_q stats to
    attn_k/attn_v, ffn_gate stats to ffn_up (when absent)."""
    out = dict(weights)
    for name, w in list(weights.items()):
        if name.endswith("attn_q.weight"):
            for alt in ("attn_k.weight", "attn_v.weight"):
                out.setdefault(name.replace("attn_q.weight", alt), w)
        if name.endswith("ffn_gate.weight"):
            out.setdefault(name.replace("ffn_gate.weight", "ffn_up.weight"), w)
        if name.endswith("ffn_gate_exps.weight"):
            out.setdefault(
                name.replace("ffn_gate_exps.weight", "ffn_up_exps.weight"), w)
    return out


def collect(model_path: str, text: str, chunk: int = 512,
            max_chunks: int = 64, device=None) -> dict[str, np.ndarray]:
    """The mean squared activation of every linear weight's input columns
    over up to max_chunks windows of `chunk` tokens, each from position 0
    over a fresh f32 cache."""
    from ..kv.cache import init_cache
    from ..models import llama
    from ..models.loader import load_model
    from ..ops import linear

    model = load_model(model_path, packed=False, dtype=torch.float32,
                       device=device)
    cfg, dev = model.cfg, model.device
    ids = model.tokenizer.encode(text)
    n_chunks = min(max_chunks, max(1, len(ids) // chunk))
    collector = linear.ActivationCollector(build_name_map(model.params))
    linear._COLLECTOR = collector
    try:
        for ci in range(n_chunks):
            seg = ids[ci * chunk:(ci + 1) * chunk]
            if len(seg) < 8:
                break
            toks = torch.tensor([seg], dtype=torch.int64, device=dev)
            pos = torch.arange(len(seg), device=dev)[None]
            cache = init_cache(cfg.n_layers, 1, len(seg), cfg.n_kv_heads,
                               cfg.head_dim, dtype=torch.float32, device=dev)
            with torch.inference_mode():
                llama.forward(model.params, cfg, toks, pos, cache)
            print(f"chunk {ci + 1}/{n_chunks}", flush=True)
    finally:
        linear._COLLECTOR = None
    return expand_names(collector.weights())


def write_llamacpp_imatrix(path: str, weights: dict[str, np.ndarray],
                           dataset: str = "local-calibration") -> None:
    """llama.cpp's binary imatrix format (its quantize tool's
    load_imatrix): i32 n_entries, then per entry [i32 len, name, i32
    ncall, i32 nval, f32 * nval], then [i32 last_call, i32 len, dataset]."""
    import struct

    with open(path, "wb") as fh:
        fh.write(struct.pack("<i", len(weights)))
        for name, vals in weights.items():
            v = np.ascontiguousarray(np.asarray(vals, dtype=np.float32).ravel())
            nb = name.encode()
            # ncall=0: values stored as-is (quant_weights are per-tensor
            # scale-invariant, so the sum-vs-mean distinction is immaterial)
            fh.write(struct.pack("<i", len(nb)) + nb)
            fh.write(struct.pack("<ii", 0, v.size))
            fh.write(v.tobytes())
        db = dataset.encode()
        fh.write(struct.pack("<ii", 1, len(db)) + db)


def main(argv=None):
    ap = argparse.ArgumentParser(description="Collect an importance matrix")
    ap.add_argument("model")
    ap.add_argument("calib", help="calibration text file")
    ap.add_argument("-o", "--output", required=True, help="output .npz")
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    ap.add_argument("--bin", default="",
                    help="also write llama.cpp binary imatrix to this path")
    args = ap.parse_args(argv)
    text = open(args.calib, encoding="utf-8", errors="ignore").read()
    weights = collect(args.model, text, args.chunk, args.chunks, args.device)
    np.savez_compressed(args.output, **weights)
    print(f"wrote {args.output}: {len(weights)} tensors")
    if args.bin:
        write_llamacpp_imatrix(args.bin, weights)
        print(f"wrote {args.bin} (llama.cpp imatrix format)")
    return weights


if __name__ == "__main__":
    main()
