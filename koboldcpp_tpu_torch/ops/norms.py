"""Normalization ops (f32 math, cast back to the input dtype)."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor,
               bias: torch.Tensor | None, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mean) ** 2, dim=-1, keepdim=True)
    out = (xf - mean) * (var + eps) ** -0.5 * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
