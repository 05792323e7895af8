"""Routed MoE dispatch by a sort over experts (static capacity).

Port of koboldcpp_tpu/ops/moe.py, the counterpart of the reference's
mul_mat_id row-mapping path: each (token, k) assignment goes to a bucket
of a static (E, capacity, C) layout, every expert runs one product over
its bucket, and each assignment's output is gathered back to its token.
The capacity defaults to N (dropless: a token's top-k experts are
distinct, so no expert ever takes more than N assignments); a positive
`capacity_factor` caps the buckets and drops the overflow (Switch
semantics). The JAX module shards the expert axis over a mesh's `ep` axis
with sharding constraints; under the port's expert parallelism
(parallel/sharding.py) a rank holds the experts of its range only,
`_maybe_constrain` keeps that range of an expert-major tensor, and the
caller's combine sums the ranks' shares (models/llama.py `_moe_ffn`).
"""
from __future__ import annotations

import torch


def _maybe_constrain(x: torch.Tensor, experts=None) -> torch.Tensor:
    """The JAX sharding constraint on the expert axis: the rank's experts
    (e0, e0 + n) of an expert-major x, or x whole without a range."""
    if experts is None:
        return x
    e0, n = experts
    return x[e0:e0 + n]


def expert_order(flat_e: torch.Tensor, n_experts: int):
    """The (token, k) assignments grouped by expert: flat_e (N*k,) expert
    ids -> (order, starts): order (N*k,) the stable sort of flat_e (token
    order within an expert), starts (E+1,) the first sorted index of each
    expert, then N*k."""
    order = torch.sort(flat_e, stable=True).indices
    starts = torch.searchsorted(
        flat_e[order], torch.arange(n_experts + 1, dtype=flat_e.dtype,
                                    device=flat_e.device))
    return order, starts


def dispatch_indices(topi: torch.Tensor, n_experts: int, capacity: int):
    """Flat destination slot and validity of each (token, k) assignment.

    topi: (N, k) expert ids. Returns (dest (N*k,), valid (N*k,)): dest =
    expert * capacity + the assignment's rank within its expert (in token
    order: a stable sort by expert); assignments ranked at or past the
    capacity are invalid (dropped) and take rank 0 in dest."""
    flat_e = topi.reshape(-1)
    order, starts = expert_order(flat_e, n_experts)
    rank = torch.empty_like(order)
    rank[order] = (torch.arange(flat_e.shape[0], device=flat_e.device)
                   - starts[flat_e[order]])
    valid = rank < capacity
    dest = flat_e * capacity + torch.where(valid, rank,
                                           torch.zeros_like(rank))
    return dest, valid


def _product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w^T in f32, as the JAX einsums' preferred_element_type: on the
    card a bf16 / f16 product writes its f32 accumulator (cuBLAS's f32
    output), elsewhere the product in a's dtype is cast to f32."""
    wt = w.transpose(-1, -2)
    if a.is_cuda and a.dtype in (torch.bfloat16, torch.float16):
        mm = torch.mm if a.dim() == 2 else torch.bmm
        return mm(a, wt, out_dtype=torch.float32)
    return torch.matmul(a, wt).float()


def expert_products(bx: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
                    wd: torch.Tensor, act) -> torch.Tensor:
    """A gated FFN per expert: bx (E, M, C) rows of each expert, wg / wu
    (E, F, C), wd (E, C, F) -> (E, M, C) f32 (or one expert: bx (M, C),
    wg / wu (F, C), wd (C, F)). Each product keeps f32; act(g) * u runs in
    f32 and is cast to bx's dtype before the down product, as in JAX."""
    g = _product(bx, wg)
    u = _product(bx, wu)
    return _product((act(g) * u).to(bx.dtype), wd)


def moe_ffn_ep(xt: torch.Tensor, topi: torch.Tensor, topw: torch.Tensor,
               wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor,
               act, capacity: int | None = None,
               capacity_factor: float | None = None,
               experts: tuple[int, int] | None = None) -> torch.Tensor:
    """Sorted-dispatch gated-FFN MoE (the JAX `moe_ffn_ep`).

    xt: (N, C) tokens; topi / topw: (N, k) routing; wg / wu: (E, F, C);
    wd: (E, C, F). Returns (N, C) f32: sum over k of topw * the expert's
    output, zero for a dropped assignment. experts: (e0, E) under expert
    parallelism: wg / wu / wd hold E's experts from e0 on, and the others'
    assignments give zero (the caller sums the ranks' shares)."""
    N, C = xt.shape
    k = topi.shape[1]
    E_loc = wg.shape[0]
    E = experts[1] if experts else E_loc
    if capacity is None:
        if capacity_factor is None or capacity_factor <= 0:
            capacity = N  # dropless
        else:
            capacity = min(N, max(1, int((N * k / E) * capacity_factor
                                         + 0.999)))
    dest, valid = dispatch_indices(topi, E, capacity)

    src = xt[:, None].expand(N, k, C).reshape(N * k, C)
    # invalid assignments write one spare row past the buckets (the JAX
    # scatter's mode="drop")
    safe = torch.where(valid, dest, torch.full_like(dest, E * capacity))
    buckets = torch.zeros(E * capacity + 1, C, dtype=xt.dtype,
                          device=xt.device)
    buckets[safe] = src
    # the expert-major tensors, which the JAX module places on the ep axis
    span = (experts[0], E_loc) if experts else None
    bx = _maybe_constrain(buckets[:E * capacity].reshape(E, capacity, C),
                          span)
    d_loc = expert_products(bx, wg, wu, wd, act)
    if span is None:
        d = d_loc
    else:  # the rank's experts' rows; the others' assignments give zero
        d = d_loc.new_zeros(E, capacity, C)
        d[span[0]:span[0] + E_loc] = d_loc
    d = d.reshape(E * capacity, C)

    # combine: each assignment's expert output back to its token
    y = d[dest] * (valid[:, None] * topw.reshape(-1)[:, None])
    return y.reshape(N, k, C).sum(dim=1)
