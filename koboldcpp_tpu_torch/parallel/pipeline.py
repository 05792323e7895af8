"""Pipeline parallelism: layer stages over a mesh axis with microbatches.

Port of koboldcpp_tpu/parallel/pipeline.py. Each rank of the `pp` axis
holds L / n consecutive layers of the stacked params (models/llama.py
`stack_layers`) and the same layers of the KV cache, for the whole batch.
The batch splits into M microbatches that flow through the stages on the
GPipe tick schedule: at tick t stage s runs microbatch t - s (when there
is one) and hands its activations to stage s + 1 by `comm.ppermute`; n +
M - 1 ticks drain the pipe, and the last stage's activations are
broadcast, so every rank computes the same logits. The stages run
models/llama.py's layer code on each layer's views (`_take_layer`), so
the packed projections go to the port's kernels; attention writes the
cache and runs the plain attention over it, the JAX pipeline's function.
"""
from __future__ import annotations

import math

import torch

from ..kv.cache import KVCache
from ..models import llama
from . import comm


def stage_range(n_layers: int, n: int, stage: int) -> tuple[int, int]:
    """Layers [l0, l1) of `stage` of n (n must divide n_layers)."""
    if n_layers % n:
        raise ValueError(f"--pipeline {n} must divide n_layers {n_layers}")
    per = n_layers // n
    return stage * per, (stage + 1) * per


def shard_stacked_for_pp(params: dict, cache: KVCache, mesh,
                         axis: str = "pp"):
    """This rank's stage of stack_layers() params (layers_stacked cut to
    its layers; everything else whole) and of a per-layer cache (its
    layers' tensors)."""
    g = mesh.group(axis)
    st = params["layers_stacked"]
    l0, l1 = stage_range(st["attn_norm"].shape[0], g.size, g.index)

    def cut(v):
        if isinstance(v, llama.linear.QTensor):
            return llama.linear.QTensor(
                kind=v.kind, shape=v.shape,
                data={n: a[l0:l1] for n, a in v.data.items()})
        return v[l0:l1]
    out = dict(params)
    out["layers_stacked"] = {k: cut(v) for k, v in st.items()}
    return out, KVCache(k=list(cache.k[l0:l1]), v=list(cache.v[l0:l1]),
                        heads=cache.heads)


def pipeline_forward(params: dict, cfg, tokens: torch.Tensor,
                     positions: torch.Tensor, cache: KVCache, mesh,
                     axis: str = "pp", microbatches: int | None = None,
                     last_only: bool = False):
    """Stacked-layer forward with the layers stage-sharded over `axis`.

    params / cache: this rank's stage (`shard_stacked_for_pp`); tokens /
    positions: (B, T), whole on every rank, B divisible by `microbatches`
    (default the axis size). Returns (logits f32, the same on every rank:
    of every row, or of the last with last_only; the stage cache, updated
    in place for every microbatch)."""
    g = mesh.group(axis)
    n, s = g.size, g.index
    M = microbatches or n
    B, T = tokens.shape
    if B % M:
        raise ValueError(f"batch {B} must divide into {M} microbatches")
    Bm = B // M
    st = params["layers_stacked"]
    layers = [llama._take_layer(st, li)
              for li in range(st["attn_norm"].shape[0])]
    S = cache.max_seq
    H = cfg.hidden_size
    dev = tokens.device
    emb = params["tok_embd"]
    dt = (emb.data["w"] if isinstance(emb, llama.linear.QTensor)
          else emb).dtype  # the activations' dtype

    def stage(h, mb: int):
        r = slice(mb * Bm, (mb + 1) * Bm)
        view = KVCache(k=[x[r] for x in cache.k], v=[x[r] for x in cache.v],
                       heads=cache.heads)
        pos = positions[r]
        plain = llama._PlainAttention(cfg, pos, S)

        def attend(li, q, k, v, scale, local):
            llama.kv_write(view, li, pos, k, v)
            ck, cv = llama.kv_read(view, li)
            return plain(q, ck, cv, scale, local)
        return llama.layers_body(params, cfg, h, pos, attend, layers)

    send = torch.zeros(Bm, T, H, dtype=dt, device=dev)
    out = torch.zeros(M, Bm, T, H, dtype=dt, device=dev)
    perm = [(i, i + 1) for i in range(n - 1)]  # stage s -> s + 1, no wrap
    for t in range(n + M - 1):
        recv = comm.ppermute(send, g, perm)
        mb = t - s
        if 0 <= mb < M:
            h_in = (llama.embed(params, cfg, tokens[mb * Bm:(mb + 1) * Bm],
                                positions[mb * Bm:(mb + 1) * Bm])
                    if s == 0 else recv)
            send = stage(h_in, mb)
            if s == n - 1:
                out[mb] = send
        else:
            send = torch.zeros_like(send)
    out = comm.broadcast(out, g, n - 1)  # only the last stage's is real
    x = out.reshape(B, T, H)
    return llama.head(params, cfg, x, last_only), cache


def microbatches_for(batch: int, n: int) -> int:
    """The serving microbatch count M = gcd(B, stages) (one microbatch for
    a single stream: its decode is stage-sequential)."""
    return math.gcd(batch, n)
