"""GGUF -> device params loader.

Port of koboldcpp_tpu/models/loader.py for the decoder GGUF files
models/llama.py serves: maps llama.cpp tensor names (learned positions,
the embedding norm, norm / projection / FFN / output biases, QK-norms and
their biases, gemma2's sandwich norms, grok's post-norms, the MoE router,
qwen2moe's shared expert and the 3-D expert stacks, which load dense) into
its params dict, keeping 2-D weights packed (QTensor: q4_k, q5_k, q6_k or q8_0, the kinds
`ops/linear.from_gguf` maps the GGUF types onto) for the kernels and
row-fusing same-type q/k/v and gate/up projections into `wqkv` / `w_gateup`
(one kernel launch per group). GGUF LoRA adapters merge at load into dense
bf16 weights (`LoraAdapter`); legacy GGML / GGMF / GGJT containers and the
pre-GGUF gpt-j / gpt-neox / mpt / gpt-2 files load through
`gguf/legacy.py`'s readers. bitnet's sub-norms and per-projection scale
scalars load too, and its scaled projections stay unfused (the JAX
loader's `has_scales` rule). The other architectures load through
their modules' `load_params`, as in the JAX loader (`arch_module`):
deepseek2 / minicpm3 (models/deepseek2.py), mamba, rwkv6 and rwkv4 (the
legacy RWKV .bin files too, with their vocab sidecar), bert / nomic-bert /
jina-bert-v2 (models/bert.py), t5 and t5encoder (models/t5.py).
"""
from __future__ import annotations

import importlib
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from ..gguf import GGUFReader
from ..ops import linear
from ..tokenizers import Tokenizer
from .config import ModelConfig, config_from_metadata

Params = dict[str, Any]


class LoraAdapter:
    """GGUF LoRA adapter (llama_lora_adapter_init_internal,
    src/llama.cpp:18740-18882): general.type == "adapter", adapter.type ==
    "lora", tensor pairs `<base>.lora_a` (r, in) / `<base>.lora_b` (out,
    r), merged as W + mult * (alpha/r) * B @ A. The reference applies A / B
    at eval time; the port merges at load, as the JAX package does, so an
    adapted tensor becomes one dense weight."""

    def __init__(self, path: str, multiplier: float = 1.0):
        self.multiplier = multiplier
        self.pairs: dict[str, dict[str, np.ndarray]] = {}
        with GGUFReader(path) as r:
            md = r.metadata
            gtype = str(md.get("general.type", ""))
            if gtype != "adapter":
                raise ValueError(f"expected general.type 'adapter', got {gtype!r}")
            atype = str(md.get("adapter.type", ""))
            if atype != "lora":
                raise ValueError(f"expected adapter.type 'lora', got {atype!r}")
            a = md.get("adapter.lora.alpha", 0.0)
            self.alpha = float(a.item() if hasattr(a, "item") else a or 0.0)
            for name in r.tensors:
                if name.endswith(".lora_a"):
                    self.pairs.setdefault(name[:-7], {})["a"] = np.asarray(
                        r.tensor_data(name), np.float32)
                elif name.endswith(".lora_b"):
                    self.pairs.setdefault(name[:-7], {})["b"] = np.asarray(
                        r.tensor_data(name), np.float32)
                else:
                    raise ValueError(f"LoRA tensor {name!r} has unexpected suffix")
        for base, p in self.pairs.items():
            if "a" not in p or "b" not in p:
                raise ValueError(f"LoRA pair for {base!r} missing a component")

    def delta(self, name: str) -> np.ndarray | None:
        p = self.pairs.get(name)
        if p is None:
            return None
        a, b = p["a"], p["b"]  # (r, in), (out, r)
        rank = a.shape[0]
        scale = self.multiplier * (self.alpha / rank if self.alpha else 1.0)
        return scale * (b @ a)


def load_params(reader: GGUFReader, cfg: ModelConfig, packed: bool = True,
                dtype=torch.bfloat16, device="cpu",
                loras: list[LoraAdapter] | None = None) -> Params:
    names = set(reader.tensors)
    lora_names = set()
    for ad in loras or ():
        lora_names |= set(ad.pairs)

    def merged(tensor_name: str) -> np.ndarray:
        """The dequantized base weight plus every adapter's delta, f32."""
        info = reader.tensors[tensor_name]
        w = linear.from_gguf(reader.tensor_raw(tensor_name), info.ggml_type,
                             info.shape, packed=False, dtype=torch.float32
                             ).data["w"].numpy()
        for ad in loras or ():
            d = ad.delta(tensor_name)
            if d is not None:
                if d.shape != w.shape:
                    raise ValueError(f"LoRA delta shape {d.shape} != "
                                     f"{w.shape} for {tensor_name}")
                w = w + d
        return w

    def qt(tensor_name: str, pack: bool = packed):
        if tensor_name in lora_names:
            return linear.dense(merged(tensor_name), dtype=dtype,
                                device=device)
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
    if "position_embd.weight" in names:  # gpt2 learned positions
        params["pos_embd"] = dense("position_embd.weight")
    if "token_embd_norm.weight" in names:  # bloom embedding layer norm
        params["tok_norm"] = dense("token_embd_norm.weight")
        if "token_embd_norm.bias" in names:
            params["tok_norm_bias"] = dense("token_embd_norm.bias")
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
        if any(n in lora_names for n in names_in):
            # one dense row-concatenation of every member's merged weight
            return linear.dense(np.concatenate([merged(n) for n in names_in],
                                               axis=0),
                                dtype=dtype, device=device)
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
        # bitnet's per-projection scalar scales: fusing would merge
        # differently scaled projections, so they stay split
        has_scales = (p + "attn_q.scale" in names
                      or p + "ffn_up.scale" in names)
        if p + "attn_qkv.weight" in names:  # pre-fused projection
            layer["wqkv"] = qt(p + "attn_qkv.weight")
        else:
            qkv = None if has_scales else fused(
                [p + "attn_q.weight", p + "attn_k.weight",
                 p + "attn_v.weight"])
            if qkv is not None:
                layer["wqkv"] = qkv
            else:
                layer["wq"] = qt(p + "attn_q.weight")
                layer["wk"] = qt(p + "attn_k.weight")
                layer["wv"] = qt(p + "attn_v.weight")
        # norms, biases, bitnet's sub-norms and scales, arctic's MoE norm
        for key, tname in (("attn_post_norm", "attn_post_norm.weight"),
                           ("ffn_post_norm", "ffn_post_norm.weight"),
                           # grok's RMS post-norms on both branch outputs
                           ("attn_post_norm", "attn_output_norm.weight"),
                           ("ffn_post_norm", "layer_output_norm.weight"),
                           ("attn_q_norm", "attn_q_norm.weight"),
                           ("attn_k_norm", "attn_k_norm.weight"),
                           ("attn_q_norm_bias", "attn_q_norm.bias"),
                           ("attn_k_norm_bias", "attn_k_norm.bias"),
                           ("ffn_norm_exps", "ffn_norm_exps.weight"),
                           ("attn_sub_norm", "attn_sub_norm.weight"),
                           ("ffn_sub_norm", "ffn_sub_norm.weight"),
                           ("wq_scale", "attn_q.scale"),
                           ("wk_scale", "attn_k.scale"),
                           ("wv_scale", "attn_v.scale"),
                           ("wo_scale", "attn_output.scale"),
                           ("ffn_gate_scale", "ffn_gate.scale"),
                           ("ffn_up_scale", "ffn_up.scale"),
                           ("ffn_down_scale", "ffn_down.scale"),
                           ("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
                           ("bv", "attn_v.bias"), ("bqkv", "attn_qkv.bias"),
                           ("bo", "attn_output.bias"),
                           ("b_gate", "ffn_gate.bias"),
                           ("b_up", "ffn_up.bias"), ("b_down", "ffn_down.bias"),
                           ("attn_norm_bias", "attn_norm.bias"),
                           ("ffn_norm_bias", "ffn_norm.bias")):
            opt(layer, key, p + tname)
        if p + "ffn_gate_inp.weight" in names:  # MoE block
            layer["ffn_gate_inp"] = qt(p + "ffn_gate_inp.weight")
            # qwen2moe's shared expert (always on, sigmoid-gated)
            for key in ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp",
                        "ffn_gate_inp_shexp"):
                if p + key + ".weight" in names:
                    layer[key] = qt(p + key + ".weight")
            for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
                # the 3-D expert stacks (E, F, C) / (E, C, F) load dense in
                # the load dtype, as in JAX
                info = reader.tensors[p + key + ".weight"]
                layer[key] = linear.from_gguf(
                    reader.tensor_raw(p + key + ".weight"), info.ggml_type,
                    info.shape, packed=False, dtype=dtype, device=device)
        # the dense FFN (arctic's too, beside its residual MoE)
        if p + "ffn_up.weight" in names:
            up_info = reader.tensors[p + "ffn_up.weight"]
            if (p + "ffn_gate.weight" not in names
                    and up_info.shape[0] == 2 * cfg.intermediate_size
                    and cfg.ffn_gated):
                layer["w_gateup"] = qt(p + "ffn_up.weight")  # pre-fused
            elif p + "ffn_gate.weight" in names:
                gu = None
                if not has_scales and p + "ffn_gate.bias" not in names:
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


def tensor_readers(reader, packed: bool = True, dtype=torch.bfloat16,
                   device="cpu"):
    """(qt, dense) over a reader, as the other architectures' loaders read
    a file: qt(name, pack=packed) a 2-D weight through `linear.from_gguf`
    (packed where its type packs), dense(name, flat=False) a tensor as f32
    (flattened with flat)."""
    def qt(name: str, pack: bool = packed):
        info = reader.tensors[name]
        return linear.from_gguf(reader.tensor_raw(name), info.ggml_type,
                                info.shape, packed=pack, dtype=dtype,
                                device=device)

    def dense(name: str, flat: bool = False) -> torch.Tensor:
        a = np.array(reader.tensor_data(name), np.float32)
        return torch.from_numpy(a.reshape(-1) if flat else a).to(device)

    return qt, dense


class Model:
    """Loaded model bundle: config + params + tokenizer, on one device."""

    def __init__(self, cfg: ModelConfig, params: Params, tokenizer: Tokenizer,
                 device: torch.device | str = "cpu"):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = torch.device(device)


def _reader(path: str):
    """The reader of a GGUF (gguf-split shard sets merged) or a legacy
    pre-GGUF container (the JAX loader's routing, :264-275)."""
    from ..gguf.sniff import FileFormat, check_file_format, describe_or_raise

    describe_or_raise(path)  # a precise error for an unsupported container
    fmt = check_file_format(path)
    if fmt is FileFormat.GGUF:
        from ..gguf.reader import open_gguf

        return open_gguf(path)
    from ..gguf import legacy

    if fmt in legacy.LEGACY_OTHERARCH_FORMATS:
        return legacy.LegacyOtherArchReader(path)
    if fmt in legacy.LEGACY_RWKV_FORMATS:
        return legacy.LegacyRwkvReader(path)  # RWKV v4 .bin
    return legacy.LegacyLlamaReader(path)


def model_arch(path: str) -> str:
    """The architecture a model file holds, from its metadata alone."""
    with _reader(path) as r:
        return config_from_metadata(r.metadata).arch


def load_model(path: str, packed: bool = True, dtype=torch.bfloat16,
               device: str | torch.device | None = None,
               loras: list[tuple[str, float]] | None = None) -> Model:
    """Load a GGUF, or a legacy pre-GGUF container, onto `device` (default
    cuda; raises without a GPU unless device="cpu").
    loras: [(adapter_gguf_path, multiplier), ...] merged into the base
    weights at load (lora_filename / lora_multiplier, expose.h:132-133)."""
    from .llama import check_supported

    dev = resolve_device(device)
    adapters = [LoraAdapter(lp, mult) for lp, mult in (loras or [])]
    with _reader(path) as r:
        cfg = config_from_metadata(r.metadata)
        tokenizer = Tokenizer.from_metadata(r.metadata)
        module = arch_module(cfg.arch)
        if module is not None:
            # the other architectures' loaders (JAX :282-309); LoRA
            # adapters apply to the llama-family loader only, as in JAX
            params = module.load_params(r, cfg, packed=packed, dtype=dtype,
                                        device=dev)
            return Model(cfg, params, tokenizer, dev)
        params = load_params(r, cfg, packed=packed, dtype=dtype, device=dev,
                             loras=adapters or None)
    check_supported(params, cfg, dev)
    return Model(cfg, params, tokenizer, dev)


# the architectures with a module of their own (`load_params`, `forward`
# or `forward_embed` / `encode`); every other one is a models/llama.py
# decoder
_ARCH_MODULES = {"bert": "bert", "nomic-bert": "bert",
                 "jina-bert-v2": "bert", "t5": "t5", "t5encoder": "t5",
                 "deepseek2": "deepseek2", "minicpm3": "deepseek2",
                 "mamba": "mamba", "rwkv6": "rwkv6", "rwkv4": "rwkv4"}


def arch_module(arch: str):
    """The module serving `arch`, or None for the llama-family decoders."""
    name = _ARCH_MODULES.get(arch)
    return None if name is None else importlib.import_module(
        f".{name}", __package__)
