"""KoboldAI United backend plugin.

Port of koboldcpp_tpu/united.py; counterpart of the reference's class.py
(class.py:33-336): a `model_backend(InferenceModel)` implementation United
loads as a custom backend. The reference spawns koboldcpp in a separate
process and talks over queues; this one runs in-process: the port's Engine
is a Python object, so `_load` builds it directly (on the card, or on
`kcpp_device`) and `_raw_generate` calls it synchronously.

United's host modules (`utils`, `logger`, `modeling.inference_model`) only
exist inside a KoboldAI-United checkout; import errors surface lazily so this
module can be imported (and unit-tested) standalone.
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

model_backend_name = "KoboldCpp-TPU-Torch"
model_backend_type = "ggml"

try:  # pragma: no cover - only resolvable inside KoboldAI United
    import utils  # type: ignore
    from modeling.inference_model import (  # type: ignore
        GenerationResult, GenerationSettings, InferenceModel)
    _UNITED = True
except Exception:  # standalone import: provide a minimal stand-in base
    utils = None  # type: ignore

    class InferenceModel:  # type: ignore
        def __init__(self):
            pass

        def _get_tokenizer(self, name):
            return None

    GenerationResult = None  # type: ignore
    GenerationSettings = None  # type: ignore
    _UNITED = False


class KoboldCppException(Exception):
    """Errors raised by the backend."""


def _find_model_files(model_path: str) -> list[str]:
    try:
        files = os.listdir(model_path)
    except OSError:
        return []
    return [f for f in files
            if f.lower().endswith(".gguf")
            or ("ggml" in f.lower() and f.lower().endswith(".bin"))]


class model_backend(InferenceModel):
    def __init__(self) -> None:
        super().__init__()
        self.engine = None
        self.kcpp_ctxsize = 2048
        self.kcpp_smartcontext = False
        self.kcpp_ropescale = 0.0
        self.kcpp_ropebase = 10000.0
        self.kcpp_quantkv = 0
        self.kcpp_filename = ""
        self.kcpp_device = None  # the port's device (default the card)
        self.model_name = "GGUF_Model"

    def is_valid(self, model_name, model_path, menu_path):
        return len(_find_model_files(model_path)) > 0

    def get_requested_parameters(self, model_name, model_path, menu_path,
                                 parameters={}):
        found = _find_model_files(model_path)
        children = [{"text": f, "value": os.path.join(model_path, f)}
                    for f in found]
        default = (os.path.join(model_path, found[0]) if found else model_name)
        return [
            {"uitype": "dropdown", "unit": "string",
             "label": "GGUF DataFile Name", "id": "kcpp_filename",
             "default": default, "check": {"value": "", "check": "!="},
             "tooltip": "GGUF model file", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": "",
             "children": children},
            {"uitype": "text", "unit": "int", "label": "Max Context Size",
             "id": "kcpp_ctxsize", "default": self.kcpp_ctxsize,
             "check": {"value": "", "check": "!="},
             "tooltip": "Max Context Size", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": ""},
            {"uitype": "dropdown", "unit": "int", "label": "Smart Context",
             "id": "kcpp_smartcontext", "default": 0,
             "check": {"value": "", "check": "!="}, "multiple": False,
             "tooltip": "Legacy smart-context prompt halving", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": "",
             "children": [{"text": "False", "value": 0},
                          {"text": "True", "value": 1}]},
            {"uitype": "dropdown", "unit": "int", "label": "Quantized KV",
             "id": "kcpp_quantkv", "default": 0,
             "check": {"value": "", "check": "!="}, "multiple": False,
             "tooltip": "Q8 KV cache", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": "",
             "children": [{"text": "F16/BF16", "value": 0},
                          {"text": "Q8", "value": 1}]},
            {"uitype": "text", "unit": "float", "label": "RoPE Scale",
             "id": "kcpp_ropescale", "default": self.kcpp_ropescale,
             "check": {"value": "", "check": "!="},
             "tooltip": "RoPE frequency scale (0 = auto)", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": ""},
            {"uitype": "text", "unit": "float", "label": "RoPE Base",
             "id": "kcpp_ropebase", "default": self.kcpp_ropebase,
             "check": {"value": "", "check": "!="},
             "tooltip": "RoPE frequency base (10000 = auto)", "menu_path": "",
             "refresh_model_inputs": False, "extra_classes": ""},
        ]

    def set_input_parameters(self, parameters):
        self.kcpp_filename = parameters["kcpp_filename"]
        self.kcpp_ctxsize = int(parameters.get("kcpp_ctxsize", 2048))
        self.kcpp_smartcontext = bool(int(parameters.get("kcpp_smartcontext", 0)))
        self.kcpp_quantkv = int(parameters.get("kcpp_quantkv", 0))
        self.kcpp_ropescale = float(parameters.get("kcpp_ropescale", 0.0))
        self.kcpp_ropebase = float(parameters.get("kcpp_ropebase", 10000.0))
        self.kcpp_device = parameters.get("kcpp_device", self.kcpp_device)

    def unload(self):
        self.engine = None

    def _load(self, save_model: bool = False, initial_load: bool = False) -> None:
        from .engine.engine import Engine
        from .models.loader import load_model

        model = load_model(self.kcpp_filename, device=self.kcpp_device)
        self.engine = Engine(model, max_context=self.kcpp_ctxsize,
                             device=model.device,
                             quantkv=int(self.kcpp_quantkv),
                             use_smartcontext=self.kcpp_smartcontext)
        self.tokenizer = self._get_tokenizer("gpt2")
        self.model_name = os.path.basename(self.kcpp_filename)

    def _save_settings(self):
        pass

    def _raw_generate(self, prompt_tokens, max_new: int,
                      gen_settings=None, single_line: bool = False,
                      batch_count: int = 1, seed: Optional[int] = None,
                      **kwargs):
        if self.engine is None:
            raise KoboldCppException("model not loaded")
        import numpy as np

        from .engine.engine import GenParams
        from .sampling.samplers import SamplerParams

        sp = SamplerParams()
        if gen_settings is not None:
            sp = SamplerParams(
                temperature=float(getattr(gen_settings, "temp", 0.7)),
                top_k=int(getattr(gen_settings, "top_k", 0)),
                top_a=float(getattr(gen_settings, "top_a", 0.0)),
                top_p=float(getattr(gen_settings, "top_p", 0.92)),
                typical_p=float(getattr(gen_settings, "typical", 1.0)),
                tfs=float(getattr(gen_settings, "tfs", 1.0)),
                rep_pen=float(getattr(gen_settings, "rep_pen", 1.0)),
                rep_pen_range=int(getattr(gen_settings, "rep_pen_range", 320)),
                sampler_order=tuple(getattr(
                    gen_settings, "sampler_order", (6, 0, 1, 3, 4, 2, 5))),
                seed=-1 if seed is None else int(seed))
        # United hands token ids; decode through our own tokenizer so the
        # engine re-encodes consistently (the reference round-trips through
        # its gpt2 tokenizer the same way, class.py:301-304)
        if hasattr(prompt_tokens, "tolist"):
            prompt_tokens = prompt_tokens.tolist()
        params = GenParams(max_length=max_new, sampler=sp,
                           use_default_badwordsids=bool(kwargs.get(
                               "use_default_badwordsids", False)))
        result = self.engine.generate(list(prompt_tokens), params)
        out_tokens = np.array([result.tokens] * max(batch_count, 1))
        if _UNITED:
            return GenerationResult(
                model=self, out_batches=out_tokens,
                prompt=np.asarray(prompt_tokens),
                is_whole_generation=True, single_line=single_line)
        return result
