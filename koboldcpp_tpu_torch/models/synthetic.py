"""Synthetic model builders for benches and smoke runs (no weights on disk).

Port of koboldcpp_tpu/models/synthetic.py: packed QTensors are built
directly from seeded random bytes + small scales, drawing the same field
values from the same numpy seed as the JAX builders, minus the TPU-only
sidecar fields. Byte-layout-identical to GGUF-loaded weights, so kernels
see the real memory traffic.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..gguf.constants import QK_K
from ..ops.linear import QTensor, _bf16, _u8, dense
from .config import ModelConfig

TINYLLAMA_1_1B = ModelConfig(
    arch="llama", name="tinyllama-1.1b-synthetic",
    vocab_size=32000, hidden_size=2048, n_layers=22, n_heads=32, n_kv_heads=4,
    head_dim=64, intermediate_size=5632, max_position_embeddings=2048,
    rope_theta=10000.0, rope_dim=64,
)


def _rand_dense(rng, shape, device, scale=0.02,
                dtype=torch.bfloat16) -> QTensor:
    return dense((rng.standard_normal(shape) * scale).astype(np.float32),
                 dtype=dtype, device=device)


def rand_q4k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    """Synthetic Q4_K with the real scale structure (d per superblock x
    6-bit integer sub-scales)."""
    nsb = in_f // QK_K
    qs2 = rng.integers(0, 256, size=(out_f, in_f // 2), dtype=np.uint8)
    d = (rng.random((out_f, nsb), dtype=np.float32) * 6.3e-5)
    dmin = (rng.random((out_f, nsb), dtype=np.float32) * 6.3e-5)
    sc = rng.integers(0, 64, size=(out_f, nsb, 8)).astype(np.int32)
    mn6 = rng.integers(0, 64, size=(out_f, nsb, 8)).astype(np.int32)
    scale = (d[:, :, None] * sc).reshape(out_f, nsb * 8).astype(np.float32)
    mn = (dmin[:, :, None] * mn6).reshape(out_f, nsb * 8).astype(np.float32)
    return QTensor(kind="q4_k", shape=(out_f, in_f), data={
        "qs2": _u8(qs2, device),
        "scale": _bf16(scale, device),
        "min": _bf16(mn, device),
    })


def rand_q6k(rng, out_f: int, in_f: int, device="cpu") -> QTensor:
    nsb = in_f // QK_K
    ql = rng.integers(0, 256, size=(out_f, nsb * 128), dtype=np.uint8)
    qh = rng.integers(0, 256, size=(out_f, nsb * 64), dtype=np.uint8)
    scale = (rng.random((out_f, nsb * 16), dtype=np.float32)
             * 0.002).astype(np.float32)
    return QTensor(kind="q6_k", shape=(out_f, in_f), data={
        "ql": _u8(ql, device),
        "qh": _u8(qh, device),
        "scale": _bf16(scale, device),
    })


_MAKERS = {"q4_k": rand_q4k, "q6_k": rand_q6k}


def synthetic_params(cfg: ModelConfig, kind: str = "q4_k", seed: int = 0,
                     device=None) -> dict:
    """A full llama params dict with synthetic weights on `device` (default
    cuda). kind: "dense" | "q4_k" | "q6_k" for the big matmul weights
    (embeddings and norms stay dense, as the GGUF loader keeps them)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    C, F = cfg.hidden_size, cfg.intermediate_size
    qdim = cfg.n_heads * cfg.head_dim
    kvdim = cfg.n_kv_heads * cfg.head_dim

    def big(out_f, in_f):
        if kind == "dense" or in_f % QK_K or out_f % 8:
            return _rand_dense(rng, (out_f, in_f), dev)
        return _MAKERS[kind](rng, out_f, in_f, dev)

    def norm():
        return torch.from_numpy(
            np.ones(C, np.float32)
            + rng.standard_normal(C).astype(np.float32) * 0.01).to(dev)

    params: dict = {
        "tok_embd": _rand_dense(rng, (cfg.vocab_size, C), dev),
        "output_norm": norm(),
        "output": big(cfg.vocab_size, C),
        "layers": [],
    }
    fused = kind != "dense"  # match the loader's fused-projection layout
    for _ in range(cfg.n_layers):
        layer = {
            "attn_norm": norm(),
            "wo": big(C, qdim),
            "ffn_norm": norm(),
            "w_down": big(C, F),
        }
        if fused:
            layer["wqkv"] = big(qdim + 2 * kvdim, C)
            layer["w_gateup"] = big(2 * F, C)
        else:
            layer.update(wq=big(qdim, C), wk=big(kvdim, C), wv=big(kvdim, C),
                         w_gate=big(F, C), w_up=big(F, C))
        params["layers"].append(layer)
    return params


def synthetic_model(cfg: ModelConfig, kind: str = "q4_k", seed: int = 0,
                    device=None):
    """A servable Model: synthetic_params plus a placeholder vocabulary of
    `tok{i}` pieces (the JAX bench's served-model tokenizer)."""
    from ..tokenizers import Tokenizer
    from ..tokenizers.vocab import vocab_from_metadata
    from .loader import Model

    dev = resolve_device(device)
    md = {"tokenizer.ggml.model": "gpt2",
          "tokenizer.ggml.tokens": [f"tok{i}" for i in range(cfg.vocab_size)],
          "tokenizer.ggml.token_type": np.full(cfg.vocab_size, 1, np.int32),
          "tokenizer.ggml.bos_token_id": np.uint32(1),
          "tokenizer.ggml.eos_token_id": np.uint32(2),
          "tokenizer.ggml.add_bos_token": False}
    return Model(cfg, synthetic_params(cfg, kind, seed, dev),
                 Tokenizer(vocab_from_metadata(md)), dev)
