"""RWKV6 ("Finch") forward pass in PyTorch.

Port of koboldcpp_tpu/models/rwkv6.py (the reference's build_rwkv6,
llm_build_rwkv6_time_mix / channel_mix and the ggml_rwkv_wkv recurrence:
out[t,j] = sum_i r[t,i] (first[i] k[t,i] v[t,j] + S[i,j]);
S[i,j] = w[t,i] S[i,j] + k[t,i] v[t,j]):
- the 5-way data-dependent token-shift lerp through the w1 / w2
  bottleneck, the decay exp(-exp(.)) through decay_w1 / decay_w2;
- the WKV recurrence in f32, one torch op a row (S = w S + k v^T, kept
  where the row is padding), stepping only through the last valid row
  (`scan_rows`); its outputs r . S (each row's state before its step)
  and the `first` bonus (r . (first * k)) v, batched over the chunk;
- the per-head group norm (eps GROUP_NORM_EPS) then the full-width
  affine ln_x, gated by silu(g);
- token-shift carries from the last valid row; halving the residual
  every `rescale_every` layers (cfg.extras).

Under tensor parallelism (params["tp"], parallel/sharding.py) a rank holds
the time mix of its heads (r, k, v, g, the decay, `first`, ln_x and its
heads' WKV state) and its columns of the channel mix; wo and cv are
summed over tp, and the head's vocab rows gathered.
The projections go through `linear.matmul` (K1 / K2 at T = 1, K7 / K3
above); w1 (out 5 E), decay_w1 and decay_w2 fail the dispatch's
multiple-of-256 rule, as in JAX, and take the dequant path. The
recurrence is `lax.scan` in JAX, with no Pallas kernel: plain torch ops
here.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kv.recurrent import (RWKVState, init_rwkv_state, last_valid_row,
                            scan_rows, shifted)
from ..ops import linear
from ..ops.norms import layer_norm
from ..parallel.sharding import head_logits, matmul, reduce
from .config import ModelConfig
from .loader import tensor_readers

Params = dict[str, Any]

GROUP_NORM_EPS = 64e-5  # ggml_norm's eps in the time-mix head norm


def init_state(cfg: ModelConfig, batch: int, device="cpu") -> RWKVState:
    return init_rwkv_state(cfg.n_layers, batch, cfg.hidden_size,
                           cfg.n_heads, cfg.head_dim, device=device)


def wkv_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             w: torch.Tensor, first: torch.Tensor, S: torch.Tensor,
             valid: torch.Tensor, scan: tuple[int, bool]) -> torch.Tensor:
    """The WKV recurrence over a chunk: r, k, v, w (B, T, H, D) f32, first
    (H, D), S (B, H, D, D) the state, updated in place. Returns y (B, T,
    H, D) f32."""
    T = r.shape[1]
    n, gated = scan
    kv = k[..., :, None] * v[..., None, :]  # (B, T, H, D, D)
    s = S
    before = []
    for t in range(n):
        before.append(s)
        s_new = torch.addcmul(kv[:, t], w[:, t, ..., None], s)
        s = torch.where(valid[:, t, None, None, None], s_new, s) \
            if gated else s_new
    states = torch.stack(before + [s] * (T - n), dim=1)  # before each row
    S.copy_(s)
    y = torch.einsum("bthij,bthi->bthj", states, r)
    return y + (r * first * k).sum(dim=-1, keepdim=True) * v


def _time_mix(xn: torch.Tensor, layer: Params, cfg: ModelConfig,
              shift: torch.Tensor, wkv: torch.Tensor, valid: torch.Tensor,
              scan: tuple[int, bool]) -> torch.Tensor:
    """xn (B, T, C) the normed input; shift (B, C) the previous row; wkv
    (B, H, D, D) the state of the H heads this rank runs, updated in
    place. Returns the output projection (this rank's part of it under
    tensor parallelism)."""
    B, T, C = xn.shape
    H, D = cfg.n_heads, cfg.head_dim
    sx = shifted(xn, shift) - xn

    xxx = xn + sx * layer["lerp_x"]
    z = torch.tanh(linear.matmul(xxx, layer["w1"]).float())
    z = z.reshape(B, T, 5, -1)
    m = torch.einsum("btge,gce->gbtc", z, layer["w2"].float())
    mw, mk, mv, mr, mg = (m[i].to(xn.dtype) for i in range(5))
    xw = xn + sx * (mw + layer["lerp_w"])
    xk = xn + sx * (mk + layer["lerp_k"])
    xv = xn + sx * (mv + layer["lerp_v"])
    xr = xn + sx * (mr + layer["lerp_r"])
    xg = xn + sx * (mg + layer["lerp_g"])

    r = matmul(xr, layer["wr"]).float().reshape(B, T, H, D)
    k = matmul(xk, layer["wk"]).float().reshape(B, T, H, D)
    v = matmul(xv, layer["wv"]).float().reshape(B, T, H, D)
    g = F.silu(matmul(xg, layer["wg"]).float())
    w = (layer["decay"].float()
         + matmul(torch.tanh(
             linear.matmul(xw, layer["decay_w1"]).float()).to(xn.dtype),
             layer["decay_w2"]).float())
    w = torch.exp(-torch.exp(w)).reshape(B, T, H, D)

    y = wkv_scan(r, k, v, w, layer["first"].float(), wkv, valid, scan)
    # per-head norm over D, then the full-width affine ln_x
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = ((y - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(B, T, H * D)
    y = y * layer["ln_x"].float() + layer["ln_x_b"].float()
    return matmul((y * g).to(xn.dtype), layer["wo"])


def _channel_mix(xn: torch.Tensor, layer: Params, shift: torch.Tensor,
                 params: Params) -> torch.Tensor:
    """The channel mix (cv's product summed over tensor-parallel ranks
    under params["tp"])."""
    sx = shifted(xn, shift) - xn
    xk = xn + sx * layer["c_lerp_k"]
    xr = xn + sx * layer["c_lerp_r"]
    r = torch.sigmoid(linear.matmul(xr, layer["cr"]).float())
    k = torch.square(torch.relu(
        matmul(xk, layer["ck"]).float())).to(xn.dtype)
    return (r * reduce(params, matmul(k, layer["cv"])).float()).to(xn.dtype)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: RWKVState,
            last_only: bool = False,
            last_index: torch.Tensor | None = None):
    """tokens, positions: (B, T) int; rows with position < 0 are padding
    (right-padded) and do not advance the state, which is updated in
    place. Returns (logits f32, cache)."""
    B = tokens.shape[0]
    valid = positions >= 0
    n_valid = valid.sum(dim=1)
    scan = scan_rows(valid)
    eps = cfg.rms_norm_eps
    rescale = cfg.extras.get("rescale_every", 0) if cfg.extras else 0

    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    x = layer_norm(x, params["tok_norm"], params["tok_norm_b"], eps)
    for li, layer in enumerate(params["layers"]):
        xn = layer_norm(x, layer["attn_norm"], layer["attn_norm_b"], eps)
        out = reduce(params, _time_mix(xn, layer, cfg, cache.att_shift[li],
                                       cache.wkv[li], valid, scan))
        x = x + out.to(x.dtype)
        cache.att_shift[li].copy_(last_valid_row(xn, n_valid))
        xn = layer_norm(x, layer["attn_norm_2"], layer["attn_norm_2_b"], eps)
        x = x + _channel_mix(xn, layer, cache.ffn_shift[li],
                             params).to(x.dtype)
        cache.ffn_shift[li].copy_(last_valid_row(xn, n_valid))
        if rescale and (li + 1) % rescale == 0:
            x = x * torch.tensor(0.5, dtype=x.dtype, device=x.device)

    if last_index is not None:
        x = x[torch.arange(B, device=x.device), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = layer_norm(x, params["output_norm"], params["output_norm_b"], eps)
    logits = head_logits(params, x)
    return logits, cache


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params` (the RWKV6 tensor names): projections packed
    where their type packs, the lerp / decay vectors flat f32, w2 (5, C,
    E) and first (H, D) f32, the embedding dense (and the head when the
    file ties it)."""
    qt, dense = tensor_readers(reader, packed, dtype, device)
    names = set(reader.tensors)
    tok_embd = qt("token_embd.weight", pack=False)
    params: Params = {
        "tok_embd": tok_embd,
        "tok_norm": dense("token_embd_norm.weight"),
        "tok_norm_b": dense("token_embd_norm.bias"),
        "output_norm": dense("output_norm.weight"),
        "output_norm_b": dense("output_norm.bias"),
        "output": qt("output.weight") if "output.weight" in names
        else tok_embd,
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        params["layers"].append({
            "attn_norm": dense(p + "attn_norm.weight"),
            "attn_norm_b": dense(p + "attn_norm.bias"),
            "attn_norm_2": dense(p + "attn_norm_2.weight"),
            "attn_norm_2_b": dense(p + "attn_norm_2.bias"),
            **{f"lerp_{g}": dense(p + f"time_mix_lerp_{g}.weight", flat=True)
               for g in "xwkvrg"},
            "w1": qt(p + "time_mix_w1.weight"),
            "w2": dense(p + "time_mix_w2.weight"),  # (5, C, E)
            "first": dense(p + "time_mix_first.weight"),  # (H, D)
            "decay": dense(p + "time_mix_decay.weight", flat=True),
            "decay_w1": qt(p + "time_mix_decay_w1.weight"),
            "decay_w2": qt(p + "time_mix_decay_w2.weight"),
            "wk": qt(p + "time_mix_key.weight"),
            "wv": qt(p + "time_mix_value.weight"),
            "wr": qt(p + "time_mix_receptance.weight"),
            "wg": qt(p + "time_mix_gate.weight"),
            "ln_x": dense(p + "time_mix_ln.weight"),
            "ln_x_b": dense(p + "time_mix_ln.bias"),
            "wo": qt(p + "time_mix_output.weight"),
            "c_lerp_k": dense(p + "channel_mix_lerp_k.weight", flat=True),
            "c_lerp_r": dense(p + "channel_mix_lerp_r.weight", flat=True),
            "ck": qt(p + "channel_mix_key.weight"),
            "cr": qt(p + "channel_mix_receptance.weight"),
            "cv": qt(p + "channel_mix_value.weight"),
        })
    return params
