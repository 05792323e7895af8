"""RWKV v4 ("Raven" / "Pile") forward pass in PyTorch.

Port of koboldcpp_tpu/models/rwkv4.py (the reference's legacy rwkv
runtime, otherarch/rwkv_v3.cpp: rwkv_att, rwkv_att_wkv, rwkv_ffn,
rwkv_carry_x). Per layer the state is 5 vectors of n_embd: the token-shift
carries of the time-mix and channel-mix branches (the last normalized
row each) and the numerically stabilised WKV accumulators aa / bb / pp
(pp the running max exponent, from -1e30). time_decay arrives from the
file already as -exp(w) (the converter's transform), so it is added as
is, as rwkv_att_wkv's `ww = pp + time_decay`.

The accumulators step in f32 one row at a time (kept where the row is
padding), only through the last valid row (`scan_rows`); each row's
output (e1 aa + e2 v) / (e1 bb + e2), from the accumulators before its
step, is batched over the chunk. Under tensor parallelism (params["tp"],
parallel/sharding.py) a rank holds the time mix of its channels (r, k,
v, the decay, `first` and their aa / bb / pp: `cfg.extras[
"wkv_channels"]`) and its columns of the channel mix; wo and cv are
summed over tp, and the head's vocab rows gathered. The projections go
through `linear.matmul` (a legacy file's q8_0 / q4_0 / q5_1 tensors
through K2 / K1 at T = 1 and K3 above); the recurrence is `lax.scan` in
JAX, with no Pallas kernel: plain torch ops here.
"""
from __future__ import annotations

from typing import Any

import torch

from ..kv.recurrent import (RWKV4State, init_rwkv4_state, last_valid_row,
                            scan_rows, shifted)
from ..ops import linear
from ..ops.norms import layer_norm
from ..parallel.sharding import head_logits, matmul, reduce
from .config import ModelConfig
from .loader import tensor_readers

Params = dict[str, Any]

LN_EPS = 1e-5  # ggml_v3_norm's eps


def init_state(cfg: ModelConfig, batch: int, device="cpu") -> RWKV4State:
    return init_rwkv4_state(cfg.n_layers, batch, cfg.hidden_size,
                            device=device,
                            wkv_width=(cfg.extras or {}).get("wkv_channels"))


def _mix(xn: torch.Tensor, x_prev: torch.Tensor,
         t: torch.Tensor) -> torch.Tensor:
    """x time_mix + x_prev (1 - time_mix)."""
    return xn * t + x_prev * (1.0 - t)


def wkv4_scan(k: torch.Tensor, v: torch.Tensor, first: torch.Tensor,
              decay: torch.Tensor, aa: torch.Tensor, bb: torch.Tensor,
              pp: torch.Tensor, valid: torch.Tensor,
              scan: tuple[int, bool]) -> torch.Tensor:
    """The stabilised WKV recurrence over a chunk: k, v (B, T, C) f32;
    first, decay (C,); aa, bb, pp (B, C) the accumulators, updated in
    place. Returns wkv (B, T, C) f32."""
    T = k.shape[1]
    n, gated = scan
    a, b, p = aa, bb, pp
    before = []
    for t in range(n):
        before.append((a, b, p))
        k_t, v_t = k[:, t], v[:, t]
        ww = p + decay
        qq = torch.maximum(ww, k_t)
        e1 = torch.exp(ww - qq)
        e2 = torch.exp(k_t - qq)
        na, nb = e1 * a + e2 * v_t, e1 * b + e2
        if gated:
            keep = valid[:, t, None]
            na, nb = torch.where(keep, na, a), torch.where(keep, nb, b)
            qq = torch.where(keep, qq, p)
        a, b, p = na, nb, qq
    before += [(a, b, p)] * (T - n)
    A, Bs, P = (torch.stack(s, dim=1) for s in zip(*before))
    aa.copy_(a)
    bb.copy_(b)
    pp.copy_(p)
    ww = first + k
    qq = torch.maximum(P, ww)
    e1 = torch.exp(P - qq)
    e2 = torch.exp(ww - qq)
    return (e1 * A + e2 * v) / (e1 * Bs + e2)


def _time_mix(xn, layer, shift, aa, bb, pp, valid, scan):
    """xn (B, T, C) the ln1-normed input; shift / aa / bb / pp (B, C),
    the accumulators updated in place. Returns the output projection of
    r * wkv."""
    x_prev = shifted(xn, shift)
    xk = _mix(xn, x_prev, layer["tm_k"])
    xv = _mix(xn, x_prev, layer["tm_v"])
    xr = _mix(xn, x_prev, layer["tm_r"])
    r = torch.sigmoid(matmul(xr, layer["wr"]).float())
    k = matmul(xk, layer["wk"]).float()
    v = matmul(xv, layer["wv"]).float()
    wkv = wkv4_scan(k, v, layer["first"].float(), layer["decay"].float(),
                    aa, bb, pp, valid, scan)
    return matmul((r * wkv).to(xn.dtype), layer["wo"])


def _channel_mix(xn, layer, shift, params):
    """rwkv_ffn: r = sigmoid(rw xr); k = relu(kw xk)^2; out = r (vw k)
    (vw k summed over tensor-parallel ranks under params["tp"])."""
    x_prev = shifted(xn, shift)
    xk = _mix(xn, x_prev, layer["cm_k"])
    xr = _mix(xn, x_prev, layer["cm_r"])
    r = torch.sigmoid(linear.matmul(xr, layer["cr"]).float())
    k = torch.square(torch.relu(
        matmul(xk, layer["ck"]).float())).to(xn.dtype)
    return (r * reduce(params, matmul(k, layer["cv"])).float()).to(xn.dtype)


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: RWKV4State,
            last_only: bool = False,
            last_index: torch.Tensor | None = None):
    """tokens, positions: (B, T) int; rows with position < 0 are padding
    (right-padded) and do not advance the state, which is updated in
    place. Returns (logits f32, cache)."""
    B = tokens.shape[0]
    valid = positions >= 0
    n_valid = valid.sum(dim=1)
    scan = scan_rows(valid)
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    # ln0 once on the embedding
    x = layer_norm(x, params["tok_norm"], params["tok_norm_b"], LN_EPS)
    for li, layer in enumerate(params["layers"]):
        xn = layer_norm(x, layer["ln1"], layer["ln1_b"], LN_EPS)
        out = reduce(params, _time_mix(xn, layer, cache.att_shift[li],
                                       cache.aa[li], cache.bb[li],
                                       cache.pp[li], valid, scan))
        x = x + out.to(x.dtype)
        cache.att_shift[li].copy_(last_valid_row(xn, n_valid))
        xn = layer_norm(x, layer["ln2"], layer["ln2_b"], LN_EPS)
        x = x + _channel_mix(xn, layer, cache.ffn_shift[li],
                             params).to(x.dtype)
        cache.ffn_shift[li].copy_(last_valid_row(xn, n_valid))

    if last_index is not None:
        x = x[torch.arange(B, device=x.device), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = layer_norm(x, params["output_norm"], params["output_norm_b"], LN_EPS)
    logits = head_logits(params, x)
    return logits, cache


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params` over `gguf/legacy.py`'s LegacyRwkvReader (the
    .bin names translated to RWKV6-style GGUF names)."""
    qt, dense = tensor_readers(reader, packed, dtype, device)
    params: Params = {
        "tok_embd": qt("token_embd.weight", pack=False),
        "tok_norm": dense("token_embd_norm.weight"),
        "tok_norm_b": dense("token_embd_norm.bias"),
        "output_norm": dense("output_norm.weight"),
        "output_norm_b": dense("output_norm.bias"),
        "output": qt("output.weight"),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        params["layers"].append({
            "ln1": dense(p + "attn_norm.weight"),
            "ln1_b": dense(p + "attn_norm.bias"),
            "ln2": dense(p + "attn_norm_2.weight"),
            "ln2_b": dense(p + "attn_norm_2.bias"),
            "tm_k": dense(p + "time_mix_lerp_k.weight", flat=True),
            "tm_v": dense(p + "time_mix_lerp_v.weight", flat=True),
            "tm_r": dense(p + "time_mix_lerp_r.weight", flat=True),
            "first": dense(p + "time_mix_first.weight", flat=True),
            "decay": dense(p + "time_mix_decay.weight", flat=True),
            "wk": qt(p + "time_mix_key.weight"),
            "wv": qt(p + "time_mix_value.weight"),
            "wr": qt(p + "time_mix_receptance.weight"),
            "wo": qt(p + "time_mix_output.weight"),
            "cm_k": dense(p + "channel_mix_lerp_k.weight", flat=True),
            "cm_r": dense(p + "channel_mix_lerp_r.weight", flat=True),
            "ck": qt(p + "channel_mix_key.weight"),
            "cr": qt(p + "channel_mix_receptance.weight"),
            "cv": qt(p + "channel_mix_value.weight"),
        })
    return params
