"""Params built by the JAX package, handed over as numpy arrays -> the
port's params, so both packages can be run on the same weights.

The JAX params arrive as the same nested dict/list structure with every
array already converted to numpy (e.g. `jax.tree_util.tree_map(np.asarray,
params)`); a packed weight is any object with `kind`, `shape` and `data`
attributes (the JAX QTensor after that tree_map). Only the logical fields
are kept: q4_k's plane-ordered `scale_lo`/`scale_hi` interleave back into
the logical `scale`; every TPU sidecar field is dropped.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.linear import QTensor

_KEEP = {"dense": ("w",), "q4_k": ("qs2", "min"), "q6_k": ("ql", "qh", "scale")}


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.array(a, copy=True, order="C").view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _qtensor(v: Any, device) -> QTensor:
    kind = v.kind
    if kind not in _KEEP:
        raise NotImplementedError(f"QTensor kind {kind} is not ported yet")
    data = {n: _tensor(v.data[n], device) for n in _KEEP[kind]}
    if kind == "q4_k":
        rows = v.shape[0]
        slo = _tensor(v.data["scale_lo"], device).reshape(rows, -1, 4)
        shi = _tensor(v.data["scale_hi"], device).reshape(rows, -1, 4)
        data["scale"] = torch.cat([slo, shi], dim=2).reshape(rows, -1)
    return QTensor(kind=kind, shape=tuple(v.shape), data=data)


def params_from_jax(np_params: Any, device="cpu") -> Any:
    """Convert a (numpy-leaved) JAX params tree to the port's params."""
    if hasattr(np_params, "kind") and hasattr(np_params, "data"):
        return _qtensor(np_params, device)
    if isinstance(np_params, dict):
        return {k: params_from_jax(v, device) for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_jax(v, device) for v in np_params]
    return _tensor(np_params, device)
