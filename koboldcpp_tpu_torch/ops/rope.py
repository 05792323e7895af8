"""Rotary position embeddings, ggml conventions.

  - "norm": rotate adjacent element pairs (x[2i], x[2i+1])  — llama family
  - "neox": rotate split halves (x[i], x[i + d/2])          — neox/qwen/gemma...
Linear and YaRN frequency scaling supported.
"""
from __future__ import annotations

import math

import torch

from ..models.config import ModelConfig


def gradientai_rope_base(base: float, head_dim: int, n_ctx_new: int,
                         n_ctx_train: int, solar: bool = False) -> float:
    """NTK-aware automatic rope base ("GradientAI formula"):
    base' = base ^ (log(chi_new) / log(chi_train)), chi = ctx / (2*pi)."""
    if n_ctx_new <= n_ctx_train or n_ctx_train <= 0:
        return base
    chi_train = n_ctx_train / (2 * math.pi)
    chi_new = (n_ctx_new * (8.0 if solar else 1.0)) / (2 * math.pi)
    if chi_train <= 1.0:
        return base
    return float(base ** (math.log(chi_new) / math.log(chi_train)))


def rope_frequencies(cfg: ModelConfig,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    """Per-pair inverse frequencies, with linear / yarn scaling. Shape (rot/2,)
    float32. Computed on the CPU (so every device sees the same bits) and
    then moved."""
    d = cfg.rope_dim
    freqs = torch.tensor(cfg.rope_theta, dtype=torch.float32) ** (
        -torch.arange(0, d // 2, dtype=torch.float32) * 2.0 / d)
    if cfg.rope_scaling_type == "linear" and cfg.rope_scaling_factor != 1.0:
        freqs = freqs / cfg.rope_scaling_factor
    elif (cfg.rope_scaling_type == "yarn" and cfg.rope_scaling_factor != 1.0
          and cfg.rope_orig_ctx):
        lo_rot, hi_rot = 32.0, 1.0  # beta_fast/beta_slow defaults

        def corr_dim(n_rot):
            return (d * math.log(cfg.rope_orig_ctx / (n_rot * 2 * math.pi))) / (
                2 * math.log(cfg.rope_theta))
        low = max(0.0, math.floor(corr_dim(lo_rot)))
        high = min(d / 2.0 - 1, math.ceil(corr_dim(hi_rot)))
        dims = torch.arange(d // 2, dtype=torch.float32)
        ramp = torch.clamp((dims - low) / max(high - low, 1e-3), 0.0, 1.0)
        interp = freqs / cfg.rope_scaling_factor
        freqs = interp * (1 - ramp) + freqs * ramp
    return freqs.to(device)


def yarn_attn_scale(cfg: ModelConfig) -> float:
    if cfg.rope_scaling_type == "yarn" and cfg.rope_scaling_factor != 1.0:
        return float(cfg.rope_attn_factor
                     * (1.0 + 0.1 * math.log(cfg.rope_scaling_factor)))
    return 1.0


def rotate(xf: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
           rope_type: str, rot: int) -> torch.Tensor:
    """Rotate the first `rot` dims of f32 `xf` (..., D) by cos/sin
    (broadcastable to (..., rot/2)); the remaining dims pass through."""
    if rope_type == "neox":
        x1 = xf[..., : rot // 2]
        x2 = xf[..., rot // 2: rot]
        rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    else:  # "norm": adjacent pairs
        xr = xf[..., :rot].unflatten(-1, (rot // 2, 2))
        x1 = xr[..., 0]
        x2 = xr[..., 1]
        rotated = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                              dim=-1).flatten(-2)
    if rot < xf.shape[-1]:
        rotated = torch.cat([rotated, xf[..., rot:]], dim=-1)
    return rotated


def apply_rope(x: torch.Tensor, positions: torch.Tensor, freqs: torch.Tensor,
               rope_type: str = "norm", rot_dim: int | None = None,
               mscale: float = 1.0) -> torch.Tensor:
    """x: (..., T, H, D); positions: (..., T) int. Rotates first rot_dim dims."""
    rot = rot_dim or x.shape[-1]
    angles = positions[..., None].float() * freqs  # (..., T, rot/2)
    cos = (torch.cos(angles) * mscale)[..., None, :]  # (..., T, 1, rot/2)
    sin = (torch.sin(angles) * mscale)[..., None, :]
    return rotate(x.float(), cos, sin, rope_type, rot).to(x.dtype)
