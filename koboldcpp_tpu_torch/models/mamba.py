"""Mamba (selective state-space model) forward pass in PyTorch.

Port of koboldcpp_tpu/models/mamba.py (the reference's llm_build_mamba with
the ggml_ssm_conv / ggml_ssm_scan ops: softplus(dt) inside the scan, ssm_a
stored as -exp(A_log) by the converter):
- the depthwise causal conv is the same K shifted-slice sums in the
  activations' dtype, with the inputs of padding rows (position < 0)
  zeroed first and the new conv state taken at the last valid row;
- FalconMamba's `ssm_dt_b_c_rms` RMS-normalizes dt, B and C;
- the selective scan runs in f32, one torch op a row (h = h dA + dB x,
  kept where the row is padding); y = h C and the rest are batched over
  the chunk. The loop stops after the last valid row (`scan_rows`): the
  rows past it keep the state, and their outputs come from the final
  state in one product.

The projections go through `linear.matmul`, so q4_k / q5_k `ssm_in` /
`ssm_out` reach K1 at T = 1 and K7 / K3 above, q6_k / q8_0 ones K2 / K3;
`ssm_x` (out 2 dt_rank + 2 d_state rows) and `ssm_dt` (in dt_rank) fail
the dispatch's multiple-of-256 rule, as in JAX, and take the dequant
path. No Pallas kernel exists here in JAX (the scan is `lax.scan`), and
the port writes none: the recurrence is plain torch ops. Under tensor
parallelism only the head shards (its vocab rows, gathered), as the JAX
`shard_params` shards only `output` here.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..kv.recurrent import MambaState, init_mamba_state, scan_rows
from ..ops import linear
from ..ops.norms import rms_norm
from ..parallel.sharding import head_logits
from .config import ModelConfig
from .loader import tensor_readers

Params = dict[str, Any]


def init_state(cfg: ModelConfig, batch: int, device="cpu") -> MambaState:
    return init_mamba_state(cfg.n_layers, batch, cfg.ssm_d_inner,
                            cfg.ssm_d_conv, cfg.ssm_d_state, device=device)


def _conv(xs: torch.Tensor, layer: Params, conv_state: torch.Tensor,
          valid: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """The depthwise causal conv over the chunk xs (B, T, d_inner), in
    xs's dtype, then silu in f32 -> (B, T, d_inner) f32. Writes the new
    conv state (the K - 1 inputs ending at the last valid row) into
    conv_state (B, d_inner, K - 1) in place."""
    T = xs.shape[1]
    K = layer["ssm_conv1d"].shape[-1]
    xs = torch.where(valid[..., None], xs, torch.zeros((), dtype=xs.dtype,
                                                       device=xs.device))
    conv_x = torch.cat([conv_state.to(xs.dtype), xs.transpose(1, 2)], dim=-1)
    w = layer["ssm_conv1d"].to(conv_x.dtype)  # (d_inner, K)
    y = w[None, :, 0, None] * conv_x[..., 0:T]
    for k in range(1, K):
        y = y + w[None, :, k, None] * conv_x[..., k:k + T]
    y = y + layer["ssm_conv1d_b"].to(y.dtype)[None, :, None]
    idx = n_valid[:, None] + torch.arange(K - 1, device=xs.device)[None, :]
    conv_state.copy_(torch.gather(conv_x, 2, idx[:, None, :].expand(
        -1, conv_x.shape[1], -1)))
    return F.silu(y.float()).transpose(1, 2)


def selective_scan(dA: torch.Tensor, dBx: torch.Tensor, Cm: torch.Tensor,
                   h: torch.Tensor, valid: torch.Tensor,
                   scan: tuple[int, bool]) -> torch.Tensor:
    """The selective scan over a chunk: h_t = h dA_t + dBx_t (dA, dBx (B,
    T, d_inner, N) f32), kept where the row is padding, y_t = h_t . C_t
    (Cm (B, T, N)); h (B, d_inner, N) the state, updated in place. Returns
    y (B, T, d_inner) f32."""
    n, gated = scan
    s = h
    hs = []
    for t in range(n):
        s_new = torch.addcmul(dBx[:, t], s, dA[:, t])
        s = torch.where(valid[:, t, None, None], s_new, s) if gated else s_new
        hs.append(s)
    ys = []
    if n:
        ys.append(torch.einsum("btdn,btn->btd", torch.stack(hs, dim=1),
                               Cm[:, :n]))
    if n < dA.shape[1]:  # rows past the last valid one: the final state
        ys.append(torch.einsum("bdn,btn->btd", s, Cm[:, n:]))
    h.copy_(s)
    return ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)


def _mixer(x: torch.Tensor, layer: Params, cfg: ModelConfig,
           conv_state: torch.Tensor, ssm_state: torch.Tensor,
           valid: torch.Tensor, n_valid: torch.Tensor,
           scan: tuple[int, bool]) -> torch.Tensor:
    """One Mamba mixer over a chunk x (B, T, C); conv_state (B, d_inner,
    K - 1) and ssm_state (B, d_inner, N) are updated in place. Returns the
    output projection (B, T, C)."""
    d_inner, d_state = cfg.ssm_d_inner, cfg.ssm_d_state
    dt_rank = cfg.ssm_dt_rank
    xz = linear.matmul(x, layer["ssm_in"])  # (B, T, 2 d_inner)
    xc = _conv(xz[..., :d_inner], layer, conv_state, valid, n_valid)
    z = xz[..., d_inner:]

    x_db = linear.matmul(xc.to(x.dtype), layer["ssm_x"]).float()
    dt = x_db[..., :dt_rank]
    Bm = x_db[..., dt_rank:dt_rank + d_state]
    Cm = x_db[..., dt_rank + d_state:]
    if cfg.ssm_dt_b_c_rms:  # FalconMamba
        ones = torch.ones((), dtype=torch.float32, device=x.device)
        eps = cfg.rms_norm_eps
        dt = rms_norm(dt, ones.expand(dt_rank), eps)
        Bm = rms_norm(Bm, ones.expand(d_state), eps)
        Cm = rms_norm(Cm, ones.expand(d_state), eps)
    dt = (linear.matmul(dt.to(x.dtype), layer["ssm_dt"]).float()
          + layer["ssm_dt_b"].float())
    dt = F.softplus(dt)  # (B, T, d_inner)

    A = layer["ssm_a"].float()  # (d_inner, N), already -exp(A_log)
    dA = torch.exp(dt[..., None] * A)  # (B, T, d_inner, N)
    dBx = (dt * xc)[..., None] * Bm[:, :, None, :]
    y = selective_scan(dA, dBx, Cm, ssm_state, valid, scan)
    y = y + xc * layer["ssm_d"].float()[None, None]
    y = y * F.silu(z.float())
    return linear.matmul(y.to(x.dtype), layer["ssm_out"])


def forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            positions: torch.Tensor, cache: MambaState,
            last_only: bool = False,
            last_index: torch.Tensor | None = None):
    """tokens, positions: (B, T) int; rows with position < 0 are padding
    (right-padded) and do not advance the state. The state is updated in
    place. Returns (logits f32, cache)."""
    B = tokens.shape[0]
    valid = positions >= 0
    n_valid = valid.sum(dim=1)
    scan = scan_rows(valid)
    emb_w = params["tok_embd"]
    x = (emb_w.data["w"] if isinstance(emb_w, linear.QTensor) else emb_w)[tokens]
    for li, layer in enumerate(params["layers"]):
        h = rms_norm(x, layer["attn_norm"], cfg.rms_norm_eps)
        out = _mixer(h, layer, cfg, cache.conv[li], cache.ssm[li], valid,
                     n_valid, scan)
        x = x + out.to(x.dtype)
    if last_index is not None:
        x = x[torch.arange(B, device=x.device), last_index][:, None, :]
    elif last_only:
        x = x[:, -1:, :]
    x = rms_norm(x, params["output_norm"], cfg.rms_norm_eps)
    logits = head_logits(params, x)  # vocab rows gathered under tp
    return logits, cache


def load_params(reader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    """The JAX `load_params` (the mamba tensor names): 2-D projections
    packed where their type packs, the embedding dense in the load dtype
    (also the head when the file ties it), conv / A / D / biases and norms
    f32."""
    qt, dense = tensor_readers(reader, packed, dtype, device)
    names = set(reader.tensors)
    tok_embd = qt("token_embd.weight", pack=False)
    params: Params = {
        "tok_embd": tok_embd,
        "output_norm": dense("output_norm.weight"),
        "output": qt("output.weight") if "output.weight" in names
        else tok_embd,
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        params["layers"].append({
            "attn_norm": dense(p + "attn_norm.weight"),
            "ssm_in": qt(p + "ssm_in.weight"),
            "ssm_conv1d": dense(p + "ssm_conv1d.weight"),
            "ssm_conv1d_b": dense(p + "ssm_conv1d.bias"),
            "ssm_x": qt(p + "ssm_x.weight"),
            "ssm_dt": qt(p + "ssm_dt.weight"),
            "ssm_dt_b": dense(p + "ssm_dt.bias"),
            "ssm_a": dense(p + "ssm_a"),
            "ssm_d": dense(p + "ssm_d"),
            "ssm_out": qt(p + "ssm_out.weight"),
        })
    return params
