"""GGUF -> device params loader.

Port of koboldcpp_tpu/models/loader.py for llama-family GGUF files: maps
llama.cpp tensor names into the params dict consumed by models/llama.py,
keeping 2-D q4_k/q6_k weights packed (QTensor) for the kernels and
row-fusing same-type q/k/v and gate/up projections into `wqkv` / `w_gateup`
(one kernel launch per group). LoRA merging and legacy GGML containers come
in a later slice.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGUFReader
from ..ops import linear
from ..tokenizers import Tokenizer
from .config import ModelConfig, config_from_metadata

Params = dict[str, Any]


def load_params(reader: GGUFReader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu") -> Params:
    names = set(reader.tensors)

    def qt(tensor_name: str, pack: bool = packed):
        info = reader.tensors[tensor_name]
        return linear.from_gguf(reader.tensor_raw(tensor_name),
                                info.ggml_type, info.shape, packed=pack,
                                dtype=dtype, device=device)

    def dense(tensor_name: str) -> torch.Tensor:
        return torch.from_numpy(np.array(
            reader.tensor_data(tensor_name), np.float32)).to(device)

    def opt(layer: dict, key: str, tensor_name: str):
        if tensor_name in names:
            layer[key] = dense(tensor_name)

    tok_embd = qt("token_embd.weight", pack=False)  # dense (token gather)
    params: Params = {
        "tok_embd": tok_embd,
        "output_norm": dense("output_norm.weight"),
        "layers": [],
    }
    if "output_norm.bias" in names:
        params["output_norm_bias"] = dense("output_norm.bias")
    if "output.weight" in names:
        params["output"] = qt("output.weight")
        if "output.bias" in names:
            params["output_bias"] = dense("output.bias")
    else:  # tied embeddings
        params["output"] = tok_embd

    def fused(names_in: list[str]):
        """Row-concatenate same-type same-width tensors into one QTensor."""
        infos = [reader.tensors[n] for n in names_in]
        if len({i.ggml_type for i in infos}) != 1:
            return None
        if len({i.shape[1] for i in infos}) != 1:
            return None
        raw = np.concatenate([reader.tensor_raw(n) for n in names_in], axis=0)
        out_rows = sum(i.shape[0] for i in infos)
        return linear.from_gguf(raw, infos[0].ggml_type,
                                (out_rows, infos[0].shape[1]), packed=packed,
                                dtype=dtype, device=device)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer: dict[str, Any] = {
            "attn_norm": dense(p + "attn_norm.weight"),
            "wo": qt(p + "attn_output.weight"),
        }
        if p + "ffn_norm.weight" in names:
            layer["ffn_norm"] = dense(p + "ffn_norm.weight")
        if p + "attn_qkv.weight" in names:  # pre-fused projection
            layer["wqkv"] = qt(p + "attn_qkv.weight")
        else:
            qkv = fused([p + "attn_q.weight", p + "attn_k.weight",
                         p + "attn_v.weight"])
            if qkv is not None:
                layer["wqkv"] = qkv
            else:
                layer["wq"] = qt(p + "attn_q.weight")
                layer["wk"] = qt(p + "attn_k.weight")
                layer["wv"] = qt(p + "attn_v.weight")
        # norms, biases and the tensors of unported branches (the forward's
        # check_supported rejects the latter by key)
        for key, tname in (("attn_post_norm", "attn_post_norm.weight"),
                           ("ffn_post_norm", "ffn_post_norm.weight"),
                           ("attn_q_norm", "attn_q_norm.weight"),
                           ("attn_k_norm", "attn_k_norm.weight"),
                           ("attn_sub_norm", "attn_sub_norm.weight"),
                           ("ffn_sub_norm", "ffn_sub_norm.weight"),
                           ("wq_scale", "attn_q.scale"),
                           ("wo_scale", "attn_output.scale"),
                           ("ffn_down_scale", "ffn_down.scale"),
                           ("ffn_norm_exps", "ffn_norm_exps.weight"),
                           ("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
                           ("bv", "attn_v.bias"), ("bqkv", "attn_qkv.bias"),
                           ("bo", "attn_output.bias"),
                           ("b_gate", "ffn_gate.bias"),
                           ("b_up", "ffn_up.bias"), ("b_down", "ffn_down.bias"),
                           ("attn_norm_bias", "attn_norm.bias"),
                           ("ffn_norm_bias", "ffn_norm.bias")):
            opt(layer, key, p + tname)
        if p + "ffn_gate_inp.weight" in names:
            layer["ffn_gate_inp"] = None  # MoE: rejected by the forward
        if p + "ffn_up.weight" in names:
            up_info = reader.tensors[p + "ffn_up.weight"]
            if (p + "ffn_gate.weight" not in names
                    and up_info.shape[0] == 2 * cfg.intermediate_size
                    and cfg.ffn_gated):
                layer["w_gateup"] = qt(p + "ffn_up.weight")  # pre-fused
            elif p + "ffn_gate.weight" in names:
                gu = None
                if p + "ffn_gate.bias" not in names:
                    gu = fused([p + "ffn_gate.weight", p + "ffn_up.weight"])
                if gu is not None:
                    layer["w_gateup"] = gu
                else:
                    layer["w_gate"] = qt(p + "ffn_gate.weight")
                    layer["w_up"] = qt(p + "ffn_up.weight")
            else:
                layer["w_up"] = qt(p + "ffn_up.weight")
            layer["w_down"] = qt(p + "ffn_down.weight")
        params["layers"].append(layer)
    return params


class Model:
    """Loaded model bundle: config + params + tokenizer, on one device."""

    def __init__(self, cfg: ModelConfig, params: Params, tokenizer: Tokenizer,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)


def load_model(path: str, packed: bool = True, dtype=torch.bfloat16,
               device: str | torch.device | None = None) -> Model:
    """Load a llama-family GGUF onto `device` (default cuda; raises without
    a GPU unless device="cpu")."""
    from ..gguf.reader import open_gguf
    from ..gguf.sniff import FileFormat, check_file_format, describe_or_raise
    from .llama import check_supported

    dev = resolve_device(device)
    fmt = check_file_format(path)
    if fmt is FileFormat.BADFORMAT:
        describe_or_raise(path)
    if fmt is not FileFormat.GGUF:
        raise NotImplementedError(
            f"{path}: {fmt.value} containers are not ported yet (GGUF only)")
    with open_gguf(path) as r:
        cfg = config_from_metadata(r.metadata)
        tokenizer = Tokenizer.from_metadata(r.metadata)
        if cfg.is_recurrent or cfg.is_embedding or cfg.is_encoder_decoder \
                or cfg.arch in ("deepseek2", "minicpm3"):
            raise NotImplementedError(
                f"architecture {cfg.arch!r} is not ported yet")
        params = load_params(r, cfg, packed=packed, dtype=dtype, device=dev)
    check_supported(params, cfg, dev)
    return Model(cfg, params, tokenizer, dev)
