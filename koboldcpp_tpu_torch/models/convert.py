"""Params built by the JAX package, handed over as numpy arrays -> the
port's params, so both packages can be run on the same weights.

The JAX params arrive as the same nested dict/list structure with every
array already converted to numpy (e.g. `jax.tree_util.tree_map(np.asarray,
params)`); a packed weight is any object with `kind`, `shape` and `data`
attributes (the JAX QTensor after that tree_map). Only the logical fields
are kept: q4_k's and q5_k's plane-ordered `scale_lo`/`scale_hi` interleave
back into the logical `scale`, their `scp_lo`/`scp_hi`/`d_sbt` (where
present) into K14's logical `sc` and `d`, q5_k's `hb` (bit 0: the 5th bit of col
256s+b, bit 1: of col 256s+128+b, for byte b of superblock s) becomes the
port's `qh` bit plane; q2_k's and q3_k's raw 2-bit stream `qs2` becomes
`qs`, their plane-major `scale_p` / `min_p` go back to logical group order,
and q3_k's `hm2` (bit j of byte (2s+h, l): the 3rd bit of col
256s+128h+32j+l) becomes ggml's `hmask` (bit 4h+j of byte 32s+l); the IQ
kinds' `qs2` (already q2_k's stream order) becomes `qs`, iq2p's half-split
sign sidecar `sg` and iq3's per-byte `hs` (bits 0-3: the code's 3rd bit of
plane j, bits 4-7: its sign) become the port's hmask-ordered `sg` and
`hmask`, and their plane-major `scale_p` / `min_p` go back to logical group
order (the inverse of `pack_iq_native`'s `lg` map). The opt-in kinds:
q4_k_i8 keeps q / scale / min; q6_k_i8f its int8 q and scale, and q6_k's
ql / qh where the JAX pack carries them; q3_k_n4 / q2_k_n4 re-pair their
row-half nibbles `q` into the port's `n4` and keep scale (and min), with
q3_k's / q2_k's fields converted as above where the JAX pack carries them
(`qs2`). Every TPU sidecar field is dropped. A JAX `stack_layers` tree's
"layers_stacked" (each field with a leading layer axis) converts layer by
layer under the same rules and stacks back field by field, so it equals
the port's `stack_layers` of the converted per-layer tree. The other
architectures' trees convert by the same walk: the recurrent models'
"layers" (f32 lerp / decay / conv / A vectors, RWKV6's (5, C, E) w2), the
BERT family's and T5's "layers" / "enc_layers" / "dec_layers" (relative
bias tables, norms and biases as plain arrays), every packed weight as
above (tests/test_torch_recurrent.py, test_torch_encoders.py). The flat
CLIP / LLaVA-projector, Whisper, Stable Diffusion and TAESD trees (tensor
name -> f32 array, the JAX `load_clip` / `load_whisper` /
`init_random_sd_params` / `load_sd` / `load_taesd` params) come across as
the loaders' f32 tensors (tests/test_torch_vision.py,
test_torch_whisper.py, test_torch_sd.py, test_torch_sdxl.py).
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Any

import numpy as np
import torch

from ..ops.linear import IQ_KINDS, QTensor, _hmask_stream, n4_pack
from .synthetic import plane_major_to_logical

_KEEP = {"dense": ("w",), "q4_k": ("qs2", "min"), "q5_k": ("qs2", "min"),
         "q6_k": ("ql", "qh", "scale"), "q8_0": ("q", "scale"),
         "q2_k": (), "q3_k": (), **{k: () for k in IQ_KINDS},
         "q4_k_i8": ("q", "scale", "min"), "q6_k_i8f": ("q", "scale"),
         "q3_k_n4": ("scale",), "q2_k_n4": ("scale", "min")}


def _tensor(a: Any, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16: reinterpret the bits
        return torch.from_numpy(np.array(a, copy=True, order="C").view(np.int16)
                                ).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True, order="C")).to(device)


def _iq_fields(v: Any, device) -> dict:
    """The port's fields of a JAX iq2p / iq3px / iq3ps / iq1p QTensor."""
    rows, cols = v.shape
    nblk = cols // 128
    data = {"qs": _tensor(v.data["qs2"], device)}
    if v.kind == "iq2p":
        # bit j of sg byte e: plane j position e, bit 4+j: position e + C/8;
        # plane j position 32 blk + l is logical col 128 blk + 32 j + l
        sg = np.asarray(v.data["sg"])
        sign = np.stack([np.concatenate([(sg >> j) & 1, (sg >> (4 + j)) & 1],
                                        axis=1).reshape(rows, nblk, 32)
                         for j in range(4)], axis=2)
        data["sg"] = torch.from_numpy(_hmask_stream(sign.reshape(
            rows, cols))).to(device)
    elif v.kind != "iq1p":
        hs = np.asarray(v.data["hs"]).reshape(rows, nblk, 1, 32)
        j = np.arange(4, dtype=np.uint8)[None, None, :, None]
        for name, shift in (("hmask", 0), ("sg", 4)):
            data[name] = torch.from_numpy(_hmask_stream(
                ((hs >> (j + shift)) & 1).reshape(rows, cols))).to(device)
    n_g = np.asarray(v.data["scale_p"]).shape[1]
    m, n_p = 32 // (cols // n_g), n_g // 4
    k_idx = np.tile(np.arange(n_p), 4)
    lg = 4 * m * (k_idx // m) + m * np.repeat(np.arange(4), n_p) + k_idx % m
    inv = np.argsort(lg)
    for name, src in (("scale", "scale_p"), ("min", "min_p")):
        if src in v.data:
            data[name] = _tensor(np.asarray(v.data[src])[:, inv], device)
    return data


def _qtensor(v: Any, device) -> QTensor:
    kind = v.kind
    if kind not in _KEEP:
        raise NotImplementedError(f"QTensor kind {kind} is not ported yet")
    data = {n: _tensor(v.data[n], device) for n in _KEEP[kind]}
    if kind == "q6_k_i8f" and "ql" in v.data:
        data.update(ql=_tensor(v.data["ql"], device),
                    qh=_tensor(v.data["qh"], device))
    if kind in ("q3_k_n4", "q2_k_n4"):
        # JAX byte c holds cols c and c + in/2 of the row
        q = np.asarray(v.data["q"])
        data["n4"] = n4_pack(torch.from_numpy(np.concatenate(
            [q & 0xF, q >> 4], axis=1))).to(device)
    if kind in IQ_KINDS:
        data = _iq_fields(v, device)
    if kind in ("q4_k", "q5_k"):
        rows = v.shape[0]
        slo = _tensor(v.data["scale_lo"], device).reshape(rows, -1, 4)
        shi = _tensor(v.data["scale_hi"], device).reshape(rows, -1, 4)
        data["scale"] = torch.cat([slo, shi], dim=2).reshape(rows, -1)
        if "scp_lo" in v.data and "d_sbt" in v.data:
            # K14's raw factors: sc = 8 (sp >> 4) + (sp & 15) of the
            # plane-ordered packed sub-scales, d from (nsb, rows)
            sp = np.stack([np.asarray(v.data["scp_lo"]).reshape(rows, -1, 4),
                           np.asarray(v.data["scp_hi"]).reshape(rows, -1, 4)],
                          axis=2).astype(np.int32).reshape(rows, -1)
            data["sc"] = torch.from_numpy(
                (8 * (sp >> 4) + (sp & 15)).astype(np.uint8)).to(device)
            data["d"] = _tensor(np.asarray(v.data["d_sbt"]).T, device)
    if kind in ("q2_k", "q3_k") or (kind in ("q3_k_n4", "q2_k_n4")
                                    and "qs2" in v.data):
        data["qs"] = _tensor(v.data["qs2"], device)
        for name, src in (("scale", "scale_p"), ("min", "min_p")):
            if src in v.data:
                data[name] = _tensor(plane_major_to_logical(
                    np.asarray(v.data[src])), device)
        if kind.startswith("q3_k"):
            hm2 = np.asarray(v.data["hm2"]).reshape(v.shape[0], -1, 2, 32)
            data["hmask"] = torch.from_numpy(np.ascontiguousarray(
                hm2[:, :, 0] | (hm2[:, :, 1] << 4)).reshape(
                    v.shape[0], -1)).to(device)
    if kind == "q5_k":
        hb = np.asarray(v.data["hb"]).reshape(v.shape[0], -1, 128)
        bits = np.concatenate([hb & 1, (hb >> 1) & 1], axis=2)
        data["qh"] = torch.from_numpy(np.packbits(
            bits.reshape(v.shape[0], -1), axis=1, bitorder="little")).to(device)
    return QTensor(kind=kind, shape=tuple(v.shape), data=data)


def _stacked_qtensor(v: Any, device) -> QTensor:
    """A layer-stacked JAX QTensor, converted layer by layer and stacked."""
    n_layers = len(next(iter(v.data.values())))
    layers = [_qtensor(SimpleNamespace(
        kind=v.kind, shape=v.shape,
        data={n: np.asarray(a)[li] for n, a in v.data.items()}), device)
        for li in range(n_layers)]
    return QTensor(kind=v.kind, shape=tuple(v.shape),
                   data={n: torch.stack([q.data[n] for q in layers])
                         for n in layers[0].data})


def params_from_jax(np_params: Any, device="cpu") -> Any:
    """Convert a (numpy-leaved) JAX params tree to the port's params."""
    if hasattr(np_params, "kind") and hasattr(np_params, "data"):
        return _qtensor(np_params, device)
    if isinstance(np_params, dict):
        return {k: ({n: (_stacked_qtensor(a, device) if hasattr(a, "kind")
                         else _tensor(a, device)) for n, a in v.items()}
                    if k == "layers_stacked" else params_from_jax(v, device))
                for k, v in np_params.items()}
    if isinstance(np_params, (list, tuple)):
        return [params_from_jax(v, device) for v in np_params]
    return _tensor(np_params, device)
