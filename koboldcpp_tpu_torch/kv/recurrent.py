"""Recurrent state for the SSM / RWKV models (Mamba, RWKV6, RWKV4).

Port of koboldcpp_tpu/kv/recurrent.py: llama.cpp's recurrent-mode cache
(Mamba / RWKV "(ab)use the KV cache to store the states") as fixed-shape
per-layer f32 tensors on one device. The engine keeps the reference's
reuse rule (a cached state continues only a prompt that extends its whole
context; otherwise it resets), since a recurrent state cannot be rewound
or spliced.

The fields are in the JAX dataclasses' order: a state file's `leaf{i}`
arrays (`Engine.save_state`) follow `fields()`, so the two packages read
each other's recurrent state files. The forwards update the tensors in
place.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch


def state_leaves(state) -> list[torch.Tensor]:
    """The state's tensors in field order (the state file's leaf0, ...)."""
    return [getattr(state, f.name) for f in fields(state)]


@dataclass
class MambaState:
    """conv: (L, B, d_inner, d_conv - 1) the last conv inputs; ssm: (L, B,
    d_inner, d_state) the selective-scan state. Both f32, as the reference
    forces F32 states."""

    conv: torch.Tensor
    ssm: torch.Tensor

    @property
    def batch(self) -> int:
        return self.conv.shape[1]


def init_mamba_state(n_layers: int, batch: int, d_inner: int, d_conv: int,
                     d_state: int, device="cpu") -> MambaState:
    return MambaState(
        conv=torch.zeros((n_layers, batch, d_inner, d_conv - 1),
                         dtype=torch.float32, device=device),
        ssm=torch.zeros((n_layers, batch, d_inner, d_state),
                        dtype=torch.float32, device=device))


@dataclass
class RWKVState:
    """RWKV6: the token-shift carries of the time-mix and channel-mix
    branches (each branch's last normalized row) and the per-head D x D
    WKV state."""

    att_shift: torch.Tensor  # (L, B, n_embd)
    ffn_shift: torch.Tensor  # (L, B, n_embd)
    wkv: torch.Tensor        # (L, B, H, D, D)

    @property
    def batch(self) -> int:
        return self.att_shift.shape[1]


def init_rwkv_state(n_layers: int, batch: int, n_embd: int, n_heads: int,
                    head_dim: int, device="cpu") -> RWKVState:
    def z(*shape):
        return torch.zeros((n_layers, batch) + shape, dtype=torch.float32,
                           device=device)

    return RWKVState(att_shift=z(n_embd), ffn_shift=z(n_embd),
                     wkv=z(n_heads, head_dim, head_dim))


@dataclass
class RWKV4State:
    """RWKV v4, the reference's 5 x n_embd layout per layer (ffn_xx,
    att_xx, aa, bb, pp): the two token-shift carries and the numerically
    stabilised WKV accumulators (aa numerator, bb denominator, pp the
    running max exponent, starting at -1e30)."""

    att_shift: torch.Tensor  # (L, B, n_embd)
    ffn_shift: torch.Tensor  # (L, B, n_embd)
    aa: torch.Tensor         # (L, B, n_embd)
    bb: torch.Tensor         # (L, B, n_embd)
    pp: torch.Tensor         # (L, B, n_embd)

    @property
    def batch(self) -> int:
        return self.att_shift.shape[1]


def init_rwkv4_state(n_layers: int, batch: int, n_embd: int,
                     device="cpu", wkv_width: int | None = None) -> RWKV4State:
    """wkv_width: the channels of aa / bb / pp (a tensor-parallel rank's
    share; default n_embd)."""
    w = wkv_width or n_embd

    def z(n=n_embd):
        return torch.zeros((n_layers, batch, n), dtype=torch.float32,
                           device=device)

    return RWKV4State(att_shift=z(), ffn_shift=z(), aa=z(w), bb=z(w),
                      pp=torch.full((n_layers, batch, w), -1e30,
                                    dtype=torch.float32, device=device))


def scan_rows(valid: torch.Tensor) -> tuple[int, bool]:
    """(n, gated) for a chunk's (B, T) validity mask: the recurrences step
    through rows [0, n) only, n one past the last valid row of any
    sequence (rows past it leave every state as it is, and their outputs
    come from the final state at once); gated says whether a row in
    [0, n) is padding, whose step must keep the state. One host read for
    T > 1; a single row (the decode step) is stepped and gated without
    one."""
    T = valid.shape[1]
    if T == 1:
        return 1, True
    v = valid.cpu()
    any_row = v.any(dim=0)
    if not bool(any_row.any()):
        return 0, False
    n = int(torch.nonzero(any_row).max()) + 1
    return n, not bool(v[:, :n].all())


def last_valid_row(x: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), n_valid (B,) the count of valid rows -> (B, C): row
    n_valid - 1 (row 0 when none is valid), the JAX `_last_valid_row`."""
    idx = torch.clamp(n_valid - 1, min=0).view(-1, 1, 1).expand(
        -1, 1, x.shape[-1])
    return torch.gather(x, 1, idx)[:, 0]


def shifted(xn: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The token shift: row t sees row t - 1, row 0 the carried row."""
    return torch.cat([shift[:, None, :].to(xn.dtype), xn[:, :-1]], dim=1)
