"""Legacy (pre-GGUF) llama container loader: GGML / GGMF / GGJT v1-v3.

Counterpart of the reference's legacy file loaders
(otherarch/llama_v3.cpp:502-650 `llama_v3_file_loader`,
llama_v2.cpp equivalents) and the retry-ladder dispatch
(expose.cpp:83-176). Exposes the same reader interface as
GGUFReader (metadata / tensors / tensor_raw / tensor_data) with tensor names
translated to GGUF names and a synthesized tokenizer metadata block, so
models/loader.load_params consumes legacy files unchanged.

Container layout (llama_v3.cpp:521-560):
  magic u32 ("ggml" = no version; "ggmf"/"ggjt" = + version u32)
  hparams: n_vocab n_embd n_mult n_head n_layer n_rot ftype  (7 x u32)
  vocab:   n_vocab x { len u32, bytes, score f32 (GGMF+ only) }
  tensors: { n_dims u32, name_len u32, type u32, ne[n_dims] u32, name,
             [GGJT: pad to 32-byte file offset], data }

Quant-format history (llama_v3.cpp:502-504):
  GGML/GGMF/GGJT v1: Q4_0/Q4_1 with f32 scales and INTERLEAVED nibbles
  GGJT v2: Q4_0/Q4_1/Q8_0 f32 scales, half-split nibbles; Q5_0/Q5_1 modern
  GGJT v3: modern layouts (== GGUF), raw bytes pass through untouched
"""
from __future__ import annotations

import mmap
import os
import struct
from typing import Any

import numpy as np

from .constants import GGML_BLOCK_SIZES, GGMLType
from .sniff import FileFormat, check_file_format

_MAGIC_GGML = 0x67676D6C

# legacy type ids share the modern enum (f32=0 f16=1 q4_0=2 q4_1=3 q5_0=6
# q5_1=7 q8_0=8); q4_2/q4_3 (4/5) were removed upstream and are rejected
_LEGACY_BLOCK_SIZES = {
    # (version_tag) -> {type: (block_elems, block_bytes)}
    "v1": {GGMLType.Q4_0: (32, 20), GGMLType.Q4_1: (32, 24)},
    "v2": {GGMLType.Q4_0: (32, 20), GGMLType.Q4_1: (32, 24),
           GGMLType.Q5_0: (32, 22), GGMLType.Q5_1: (32, 24),
           GGMLType.Q8_0: (32, 36)},
}

_NAME_MAP = {
    "tok_embeddings.weight": "token_embd.weight",
    "norm.weight": "output_norm.weight",
    "output.weight": "output.weight",
}
_LAYER_MAP = {
    "attention.wq.weight": "attn_q.weight",
    "attention.wk.weight": "attn_k.weight",
    "attention.wv.weight": "attn_v.weight",
    "attention.wo.weight": "attn_output.weight",
    "attention_norm.weight": "attn_norm.weight",
    "feed_forward.w1.weight": "ffn_gate.weight",
    "feed_forward.w2.weight": "ffn_down.weight",
    "feed_forward.w3.weight": "ffn_up.weight",
    "ffn_norm.weight": "ffn_norm.weight",
}


def translate_name(name: str) -> str:
    if name in _NAME_MAP:
        return _NAME_MAP[name]
    if name.startswith("layers."):
        _, idx, rest = name.split(".", 2)
        mapped = _LAYER_MAP.get(rest)
        if mapped:
            return f"blk.{idx}.{mapped}"
    return name


def _deq_q4_0_interleaved(raw: np.ndarray) -> np.ndarray:
    """GGML/GGJT-v1 Q4_0: f32 d + 16 nibble bytes, low=even high=odd
    (ggml_v1.c:532 dequantize_row_q4_0)."""
    blocks = raw.reshape(-1, 20)
    d = blocks[:, :4].copy().view(np.float32)  # (N, 1)
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    out = np.empty((blocks.shape[0], 32), np.float32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out * d


def _deq_q4_1_interleaved(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 24)
    d = blocks[:, :4].copy().view(np.float32)
    m = blocks[:, 4:8].copy().view(np.float32)
    qs = blocks[:, 8:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    out = np.empty((blocks.shape[0], 32), np.float32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return out * d + m


def _deq_q4_0_f32(raw: np.ndarray) -> np.ndarray:
    """GGJT-v2 Q4_0: f32 d + 16 bytes, half-split (ggml_v2.c dequantize)."""
    blocks = raw.reshape(-1, 20)
    d = blocks[:, :4].copy().view(np.float32)
    qs = blocks[:, 4:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    return np.concatenate([lo, hi], axis=1).astype(np.float32) * d


def _deq_q4_1_f32(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 24)
    d = blocks[:, :4].copy().view(np.float32)
    m = blocks[:, 4:8].copy().view(np.float32)
    qs = blocks[:, 8:]
    lo = (qs & 0x0F).astype(np.float32)
    hi = (qs >> 4).astype(np.float32)
    return np.concatenate([lo, hi], axis=1) * d + m


def _deq_q8_0_f32(raw: np.ndarray) -> np.ndarray:
    blocks = raw.reshape(-1, 36)
    d = blocks[:, :4].copy().view(np.float32)
    qs = np.ascontiguousarray(blocks[:, 4:]).view(np.int8)
    return qs.astype(np.float32) * d


_LEGACY_DEQ = {
    ("v1", GGMLType.Q4_0): _deq_q4_0_interleaved,
    ("v1", GGMLType.Q4_1): _deq_q4_1_interleaved,
    ("v2", GGMLType.Q4_0): _deq_q4_0_f32,
    ("v2", GGMLType.Q4_1): _deq_q4_1_f32,
    ("v2", GGMLType.Q8_0): _deq_q8_0_f32,
}

LEGACY_LLAMA_FORMATS = (FileFormat.GGML, FileFormat.GGHF, FileFormat.GGJT,
                        FileFormat.GGJT_2, FileFormat.GGJT_3)


class _LegacyTensor:
    __slots__ = ("name", "shape", "ggml_type", "offset", "nbytes",
                 "stored_type", "qver")

    @property
    def n_elements(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n


class LegacyLlamaReader:
    """GGUFReader-compatible view over a GGML/GGMF/GGJT llama file."""

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        fmt = check_file_format(self.path)
        if fmt not in LEGACY_LLAMA_FORMATS:
            raise ValueError(f"{self.path}: not a legacy llama container ({fmt})")
        self.file_format = fmt
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.align = fmt in (FileFormat.GGJT, FileFormat.GGJT_2, FileFormat.GGJT_3)
        self.qver = {FileFormat.GGJT_3: "v3", FileFormat.GGJT_2: "v2"}.get(fmt, "v1")
        self.has_scores = fmt != FileFormat.GGML
        self._parse()

    # -- context manager ---------------------------------------------------
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            # zero-copy tensor views still alive; pages stay mapped until GC
            pass
        self._f.close()

    # -- parsing -----------------------------------------------------------
    def _parse(self):
        mm = self._mm
        pos = 4 if self.file_format == FileFormat.GGML else 8
        n_vocab, n_embd, n_mult, n_head, n_layer, n_rot, ftype = \
            struct.unpack_from("<7I", mm, pos)
        pos += 28
        tokens: list[str] = []
        scores = np.zeros(n_vocab, np.float32)
        for i in range(n_vocab):
            (ln,) = struct.unpack_from("<I", mm, pos)
            pos += 4
            tokens.append(bytes(mm[pos:pos + ln]).decode("utf-8", errors="replace"))
            pos += ln
            if self.has_scores:
                (scores[i],) = struct.unpack_from("<f", mm, pos)
                pos += 4

        # synthesize GGUF-equivalent metadata (SPM llama vocab; byte pieces
        # in these files are literal "<0xNN>" strings like GGUF's)
        n_ff = ((2 * (4 * n_embd) // 3 + n_mult - 1) // n_mult) * n_mult
        types = np.full(n_vocab, 1, np.int32)  # NORMAL
        if n_vocab > 0:
            types[0] = 2  # UNKNOWN
        for i in (1, 2):
            if i < n_vocab:
                types[i] = 3  # CONTROL
        for i, t in enumerate(tokens):
            if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                types[i] = 6  # BYTE
        self.metadata: dict[str, Any] = {
            "general.architecture": "llama",
            "general.name": os.path.basename(self.path),
            "llama.context_length": np.uint32(2048),
            "llama.embedding_length": np.uint32(n_embd),
            "llama.block_count": np.uint32(n_layer),
            "llama.feed_forward_length": np.uint32(n_ff),
            "llama.attention.head_count": np.uint32(n_head),
            "llama.attention.head_count_kv": np.uint32(n_head),
            "llama.rope.dimension_count": np.uint32(n_rot),
            "llama.attention.layer_norm_rms_epsilon": np.float32(1e-6),
            "llama.vocab_size": np.uint32(n_vocab),
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": np.uint32(1),
            "tokenizer.ggml.eos_token_id": np.uint32(2),
            "tokenizer.ggml.unknown_token_id": np.uint32(0),
            "tokenizer.ggml.add_bos_token": True,
        }
        self.architecture = "llama"

        self.tensors: dict[str, _LegacyTensor] = {}
        end = len(mm)
        while pos < end:
            n_dims, name_len, ttype = struct.unpack_from("<3I", mm, pos)
            pos += 12
            ne = struct.unpack_from(f"<{n_dims}I", mm, pos)
            pos += 4 * n_dims
            raw_name = bytes(mm[pos:pos + name_len]).decode("utf-8")
            pos += name_len
            if self.align:
                pos = (pos + 31) & ~31
            try:
                gt = GGMLType(ttype)
            except ValueError:
                raise ValueError(
                    f"{self.path}: tensor {raw_name!r} has unsupported legacy "
                    f"type {ttype} (q4_2/q4_3-era formats were removed "
                    "upstream; re-quantize the original model)")
            t = _LegacyTensor()
            t.name = translate_name(raw_name)
            t.shape = tuple(reversed(ne))  # ne is column-major like GGUF
            t.stored_type = gt
            t.qver = self.qver
            if gt in (GGMLType.F32, GGMLType.F16):
                blk, sz = GGML_BLOCK_SIZES[gt]
            elif self.qver == "v3" or (self.qver == "v2" and gt in
                                       (GGMLType.Q5_0, GGMLType.Q5_1)):
                blk, sz = GGML_BLOCK_SIZES[gt]  # modern layout
            else:
                table = _LEGACY_BLOCK_SIZES.get(self.qver, {})
                if gt not in table:
                    raise ValueError(
                        f"{self.path}: {raw_name!r} uses {gt.name} in a "
                        f"{self.qver} container — not a valid combination")
                blk, sz = table[gt]
            t.nbytes = t.n_elements // blk * sz
            t.offset = pos
            # presented type: modern-layout tensors keep their type (packed
            # kernels apply); legacy-layout ones dequantize on read
            modern = (gt in (GGMLType.F32, GGMLType.F16) or self.qver == "v3"
                      or (self.qver == "v2" and gt in (GGMLType.Q5_0,
                                                       GGMLType.Q5_1)))
            t.ggml_type = gt if modern else GGMLType.F32
            pos += t.nbytes
            self.tensors[t.name] = t

    # -- data access -------------------------------------------------------
    def tensor_raw(self, name: str) -> np.ndarray:
        t = self.tensors[name]
        raw = np.frombuffer(self._mm, np.uint8, count=t.nbytes, offset=t.offset)
        if t.ggml_type == t.stored_type:  # modern layout passthrough
            blk, sz = GGML_BLOCK_SIZES[t.ggml_type]
            row_bytes = t.shape[-1] // blk * sz if t.shape else t.nbytes
            return raw.reshape(t.shape[:-1] + (row_bytes,))
        deq = _LEGACY_DEQ[(t.qver, t.stored_type)](raw)
        out = deq.reshape(t.shape).astype(np.float32)
        return out.view(np.uint8).reshape(t.shape[:-1] + (t.shape[-1] * 4,))

    def tensor_data(self, name: str, dtype=np.float32) -> np.ndarray:
        from . import quants

        t = self.tensors[name]
        if t.ggml_type == t.stored_type:
            raw = self.tensor_raw(name)
            return quants.dequantize(raw, t.ggml_type, dtype=dtype).reshape(t.shape)
        raw = np.frombuffer(self._mm, np.uint8, count=t.nbytes, offset=t.offset)
        return _LEGACY_DEQ[(t.qver, t.stored_type)](raw).reshape(t.shape).astype(dtype)


# ---------------------------------------------------------------------------
# otherarch legacy containers: GPT-J / GPT-NeoX "ggml"-magic .bin files
# (otherarch/gptj_v3.cpp:36-73, neox_v3.cpp:44-60)
# ---------------------------------------------------------------------------

_GPTJ_FORMATS = tuple(f for f in FileFormat if f.name.startswith("GPTJ_"))
_GPT2_FORMATS = tuple(f for f in FileFormat if f.name.startswith("GPT2_"))
_NEOX_FORMATS = (FileFormat.NEOX, FileFormat.NEOX_LEGACY)

LEGACY_OTHERARCH_FORMATS = (_GPTJ_FORMATS + _GPT2_FORMATS + _NEOX_FORMATS
                            + (FileFormat.MPT_1,))


def _gptj_name(name: str) -> list[tuple[str, str | None]]:
    """legacy name -> [(gguf_name, transform)] (gptj ln_1 doubles as both
    norms because attention and FFN read the same normed input)."""
    fixed = {
        "transformer.wte.weight": "token_embd.weight",
        "transformer.ln_f.weight": "output_norm.weight",
        "transformer.ln_f.bias": "output_norm.bias",
        "lm_head.weight": "output.weight",
        "lm_head.bias": "output.bias",
    }
    if name in fixed:
        return [(fixed[name], None)]
    import re

    m = re.match(r"transformer\.h\.(\d+)\.(.+)", name)
    if not m:
        return []
    i, rest = m.group(1), m.group(2)
    sub = {
        "ln_1.weight": [("attn_norm.weight", None), ("ffn_norm.weight", None)],
        "ln_1.bias": [("attn_norm.bias", None), ("ffn_norm.bias", None)],
        "attn.q_proj.weight": [("attn_q.weight", None)],
        "attn.k_proj.weight": [("attn_k.weight", None)],
        "attn.v_proj.weight": [("attn_v.weight", None)],
        "attn.out_proj.weight": [("attn_output.weight", None)],
        "mlp.fc_in.weight": [("ffn_up.weight", None)],
        "mlp.fc_in.bias": [("ffn_up.bias", None)],
        "mlp.fc_out.weight": [("ffn_down.weight", None)],
        "mlp.fc_out.bias": [("ffn_down.bias", None)],
    }.get(rest, [])
    return [(f"blk.{i}.{g}", t) for g, t in sub]


def _gpt2_name(name: str) -> list[tuple[str, str | None]]:
    """TF-checkpoint-style names (otherarch/gpt2_v3.cpp:209-254); weights
    were already transposed to (out, in) by the original convert script."""
    fixed = {
        "model/wte": "token_embd.weight",
        "model/wpe": "position_embd.weight",
        "model/ln_f/g": "output_norm.weight",
        "model/ln_f/b": "output_norm.bias",
        "model/lm_head": "output.weight",
    }
    if name in fixed:
        return [(fixed[name], None)]
    import re

    m = re.match(r"model/h(\d+)/(.+)", name)
    if not m:
        return []
    i, rest = m.group(1), m.group(2)
    sub = {
        "ln_1/g": "attn_norm.weight", "ln_1/b": "attn_norm.bias",
        "ln_2/g": "ffn_norm.weight", "ln_2/b": "ffn_norm.bias",
        "attn/c_attn/w": "attn_qkv.weight", "attn/c_attn/b": "attn_qkv.bias",
        "attn/c_proj/w": "attn_output.weight",
        "attn/c_proj/b": "attn_output.bias",
        "mlp/c_fc/w": "ffn_up.weight", "mlp/c_fc/b": "ffn_up.bias",
        "mlp/c_proj/w": "ffn_down.weight", "mlp/c_proj/b": "ffn_down.bias",
    }.get(rest)
    return [(f"blk.{i}.{sub}", None)] if sub else []


def _neox_name(name: str) -> list[tuple[str, str | None]]:
    fixed = {
        "gpt_neox.embed_in.weight": "token_embd.weight",
        "gpt_neox.final_layer_norm.weight": "output_norm.weight",
        "gpt_neox.final_layer_norm.bias": "output_norm.bias",
        "embed_out.weight": "output.weight",
    }
    if name in fixed:
        return [(fixed[name], None)]
    import re

    m = re.match(r"gpt_neox\.layers\.(\d+)\.(.+)", name)
    if not m:
        return []
    i, rest = m.group(1), m.group(2)
    sub = {
        "input_layernorm.weight": [("attn_norm.weight", None)],
        "input_layernorm.bias": [("attn_norm.bias", None)],
        "post_attention_layernorm.weight": [("ffn_norm.weight", None)],
        "post_attention_layernorm.bias": [("ffn_norm.bias", None)],
        "attention.query_key_value.weight": [("attn_qkv.weight", "deint_w")],
        "attention.query_key_value.bias": [("attn_qkv.bias", "deint_b")],
        "attention.dense.weight": [("attn_output.weight", None)],
        "attention.dense.bias": [("attn_output.bias", None)],
        "mlp.dense_h_to_4h.weight": [("ffn_up.weight", None)],
        "mlp.dense_h_to_4h.bias": [("ffn_up.bias", None)],
        "mlp.dense_4h_to_h.weight": [("ffn_down.weight", None)],
        "mlp.dense_4h_to_h.bias": [("ffn_down.bias", None)],
    }.get(rest, [])
    return [(f"blk.{i}.{g}", t) for g, t in sub]


def _mpt_name(name: str) -> list[tuple[str, str | None]]:
    """MPT .bin tensor names (otherarch/mpt_v3.cpp:175-194) -> GGUF names.
    wte doubles as the (tied) LM head; the loader falls back to token_embd
    when output.weight is absent, so only the embedding mapping is needed."""
    if name == "transformer.wte.weight":
        return [("token_embd.weight", None)]
    if name == "transformer.norm_f.weight":
        return [("output_norm.weight", None)]
    if not name.startswith("transformer.blocks."):
        return []
    _, _, i, rest = name.split(".", 3)
    sub = {
        "norm_1.weight": "attn_norm.weight",
        "attn.Wqkv.weight": "attn_qkv.weight",  # plain [Q;K;V] concat
        "attn.out_proj.weight": "attn_output.weight",
        "norm_2.weight": "ffn_norm.weight",
        "ffn.up_proj.weight": "ffn_up.weight",
        "ffn.down_proj.weight": "ffn_down.weight",
    }.get(rest)
    return [(f"blk.{i}.{sub}", None)] if sub else []


class LegacyOtherArchReader:
    """GGUFReader-compatible view over legacy GPT-J / GPT-NeoX .bin files.

    All tensors materialize to F32 on read (these files are small by modern
    standards and the fused NeoX QKV needs a de-interleave anyway, mirroring
    the HF converter's (head, [q,k,v], hd) split)."""

    def __init__(self, path: str | os.PathLike,
                 fmt: FileFormat | None = None):
        self.path = os.fspath(path)
        if fmt is None:
            fmt = check_file_format(self.path)
        if fmt in _GPTJ_FORMATS:
            self.arch = "gptj"
            self._map = _gptj_name
        elif fmt in _GPT2_FORMATS:
            self.arch = "gpt2"
            self._map = _gpt2_name
        elif fmt in _NEOX_FORMATS:
            self.arch = "gptneox"
            self._map = _neox_name
        elif fmt is FileFormat.MPT_1:
            self.arch = "mpt"
            self._map = _mpt_name
        else:
            raise ValueError(f"{self.path}: not a legacy gptj/neox file ({fmt})")
        self.file_format = fmt
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._parse()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def _parse(self):
        mm = self._mm
        pos = 4
        alibi_bias_max = clip_qkv = 0.0
        if self.arch == "mpt":
            # mpt_v3.cpp:50-57 — d_model max_seq_len n_heads n_layers n_vocab
            # (5 x i32), alibi_bias_max clip_qkv (2 x f32), ftype (i32)
            n_embd, n_ctx, n_head, n_layer, n_vocab = \
                struct.unpack_from("<5i", mm, pos)
            pos += 20
            alibi_bias_max, clip_qkv = struct.unpack_from("<2f", mm, pos)
            pos += 8
            (ftype,) = struct.unpack_from("<i", mm, pos)
            pos += 4
            n_rot, par_res = 0, 0
        elif self.arch == "gptj":
            n_vocab, n_ctx, n_embd, n_head, n_layer, n_rot, ftype = \
                struct.unpack_from("<7i", mm, pos)
            pos += 28
            par_res = 1  # gptj is always parallel-residual
        elif self.arch == "gpt2":
            n_vocab, n_ctx, n_embd, n_head, n_layer, ftype = \
                struct.unpack_from("<6i", mm, pos)
            pos += 24
            n_rot = 0
            par_res = 0
        else:
            n_vocab, n_ctx, n_embd, n_head, n_layer, n_rot, par_res, ftype = \
                struct.unpack_from("<8i", mm, pos)
            pos += 32
        qntvr = ftype // 1000
        self.qver = {0: "v1", 1: "v2", 2: "v3"}.get(qntvr, "v3")

        if self.arch == "mpt":  # no redundant count prefix (mpt_v3.cpp:76-83)
            count = n_vocab
        else:
            (count,) = struct.unpack_from("<I", mm, pos)
            pos += 4
        tokens: list[str] = []
        for _ in range(count):
            (ln,) = struct.unpack_from("<I", mm, pos)
            pos += 4
            tokens.append(bytes(mm[pos:pos + ln]).decode("utf-8",
                                                         errors="replace"))
            pos += ln

        self.metadata: dict[str, Any] = {
            "general.architecture": self.arch,
            "general.name": os.path.basename(self.path),
            f"{self.arch}.context_length": np.uint32(max(n_ctx, 1)),
            f"{self.arch}.embedding_length": np.uint32(n_embd),
            f"{self.arch}.block_count": np.uint32(n_layer),
            f"{self.arch}.feed_forward_length": np.uint32(4 * n_embd),
            f"{self.arch}.attention.head_count": np.uint32(n_head),
            f"{self.arch}.attention.head_count_kv": np.uint32(n_head),
            f"{self.arch}.rope.dimension_count": np.uint32(n_rot),
            f"{self.arch}.attention.layer_norm_epsilon": np.float32(1e-5),
            f"{self.arch}.vocab_size": np.uint32(len(tokens)),
            "gptneox.use_parallel_residual": bool(par_res),
            "tokenizer.ggml.model": "gpt2",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": np.full(len(tokens), 1, np.int32),
            "tokenizer.ggml.bos_token_id": np.uint32(0),
            "tokenizer.ggml.eos_token_id": np.uint32(0),
            "tokenizer.ggml.add_bos_token": False,
        }
        if self.arch == "mpt":
            self.metadata["mpt.attention.max_alibi_bias"] = \
                np.float32(alibi_bias_max)
            self.metadata["mpt.attention.clamp_kqv"] = np.float32(clip_qkv)
        self.architecture = self.arch
        self._n_head = n_head
        self._n_embd = n_embd

        self.tensors: dict[str, _LegacyTensor] = {}
        self._transforms: dict[str, str | None] = {}
        end = len(mm)
        while pos < end:
            n_dims, name_len, ttype = struct.unpack_from("<3i", mm, pos)
            pos += 12
            ne = struct.unpack_from(f"<{n_dims}i", mm, pos)
            pos += 4 * n_dims
            raw_name = bytes(mm[pos:pos + name_len]).decode("utf-8")
            pos += name_len
            gt = GGMLType(ttype)
            shape = tuple(reversed(ne))
            if gt in (GGMLType.F32, GGMLType.F16):
                blk, sz = GGML_BLOCK_SIZES[gt]
            elif self.qver == "v3" or (self.qver == "v2" and gt in
                                       (GGMLType.Q5_0, GGMLType.Q5_1)):
                blk, sz = GGML_BLOCK_SIZES[gt]
            else:
                table = _LEGACY_BLOCK_SIZES.get(self.qver, {})
                if gt not in table:
                    raise ValueError(
                        f"{self.path}: {raw_name!r} uses {gt.name} in a "
                        f"{self.qver} container")
                blk, sz = table[gt]
            n_el = 1
            for d in shape:
                n_el *= d
            nbytes = n_el // blk * sz
            for gname, transform in self._map(raw_name):
                t = _LegacyTensor()
                t.name = gname
                t.shape = shape
                t.stored_type = gt
                t.qver = self.qver
                t.nbytes = nbytes
                t.offset = pos
                t.ggml_type = GGMLType.F32  # always materialized
                self.tensors[gname] = t
                self._transforms[gname] = transform
            pos += nbytes

    def _dequant(self, t: _LegacyTensor) -> np.ndarray:
        from . import quants

        raw = np.frombuffer(self._mm, np.uint8, count=t.nbytes, offset=t.offset)
        if t.stored_type in (GGMLType.F32, GGMLType.F16) or (
                t.qver == "v3" or (t.qver == "v2" and t.stored_type in
                                   (GGMLType.Q5_0, GGMLType.Q5_1))):
            blk, sz = GGML_BLOCK_SIZES[t.stored_type]
            row_bytes = t.shape[-1] // blk * sz
            x = quants.dequantize(raw.reshape(t.shape[:-1] + (row_bytes,)),
                                  t.stored_type)
        else:
            x = _LEGACY_DEQ[(t.qver, t.stored_type)](raw)
        out = x.reshape(t.shape).astype(np.float32)
        tr = self._transforms.get(t.name)
        if tr == "deint_w":  # (3E, E) head-interleaved -> [Q;K;V]
            H, E = self._n_head, self._n_embd
            v = out.reshape(H, 3, E // H, E)
            out = np.concatenate([v[:, 0].reshape(E, E),
                                  v[:, 1].reshape(E, E),
                                  v[:, 2].reshape(E, E)], axis=0)
        elif tr == "deint_b":
            H, E = self._n_head, self._n_embd
            v = out.reshape(H, 3, E // H)
            out = np.concatenate([v[:, 0].reshape(-1), v[:, 1].reshape(-1),
                                  v[:, 2].reshape(-1)])
        return out

    def tensor_raw(self, name: str) -> np.ndarray:
        out = self._dequant(self.tensors[name])
        return out.view(np.uint8).reshape(out.shape[:-1] + (out.shape[-1] * 4,))

    def tensor_data(self, name: str, dtype=np.float32) -> np.ndarray:
        return self._dequant(self.tensors[name]).astype(dtype)


# ---------------------------------------------------------------------------
# legacy RWKV v4 .bin containers (rwkv.cpp format)
# ---------------------------------------------------------------------------

LEGACY_RWKV_FORMATS = (FileFormat.RWKV_1, FileFormat.RWKV_2)

# rwkv_type enum (otherarch/rwkv_v3.cpp:183-195) -> GGMLType;
# None = dropped upstream (Q4_1_O/Q4_2/Q4_3, ":188-190 Unsupported")
_RWKV_TYPES: list = [
    GGMLType.F32, GGMLType.F16, GGMLType.Q4_0, GGMLType.Q4_1,
    None, None, None, GGMLType.Q5_0, GGMLType.Q5_1, GGMLType.Q8_0,
]

_RWKV_NAME_MAP = {
    "emb.weight": "token_embd.weight",
    "blocks.0.ln0.weight": "token_embd_norm.weight",
    "blocks.0.ln0.bias": "token_embd_norm.bias",
    "ln_out.weight": "output_norm.weight",
    "ln_out.bias": "output_norm.bias",
    "head.weight": "output.weight",
}
_RWKV_LAYER_MAP = {
    "ln1.weight": "attn_norm.weight",
    "ln1.bias": "attn_norm.bias",
    "ln2.weight": "attn_norm_2.weight",
    "ln2.bias": "attn_norm_2.bias",
    "att.time_mix_k": "time_mix_lerp_k.weight",
    "att.time_mix_v": "time_mix_lerp_v.weight",
    "att.time_mix_r": "time_mix_lerp_r.weight",
    "att.time_first": "time_mix_first.weight",
    "att.time_decay": "time_mix_decay.weight",
    "att.key.weight": "time_mix_key.weight",
    "att.value.weight": "time_mix_value.weight",
    "att.receptance.weight": "time_mix_receptance.weight",
    "att.output.weight": "time_mix_output.weight",
    "ffn.time_mix_k": "channel_mix_lerp_k.weight",
    "ffn.time_mix_r": "channel_mix_lerp_r.weight",
    "ffn.key.weight": "channel_mix_key.weight",
    "ffn.value.weight": "channel_mix_value.weight",
    "ffn.receptance.weight": "channel_mix_receptance.weight",
}


def _rwkv_name(name: str) -> str:
    if name in _RWKV_NAME_MAP:
        return _RWKV_NAME_MAP[name]
    if name.startswith("blocks."):
        _, idx, rest = name.split(".", 2)
        mapped = _RWKV_LAYER_MAP.get(rest)
        if mapped:
            return f"blk.{idx}.{mapped}"
    return name


# byte -> GPT-2 unicode char (the `special` table in
# otherarch/rwkv_vocab.cpp:9 is exactly this mapping's
# codomain, indexed by byte value)
def _gpt2_byte_encoder() -> dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def find_rwkv_vocab_file(model_path: str, world: bool) -> str | None:
    """Locate the vocab sidecar the same way the reference does
    (executable-dir rwkv_vocab.embd / rwkv_world_vocab.embd,
    otherarch/rwkv_vocab.cpp:34,64), extended with an env override and the
    model's own directory."""
    fname = "rwkv_world_vocab.embd" if world else "rwkv_vocab.embd"
    explicit = os.environ.get("KCPP_RWKV_VOCAB_PATH")
    if explicit and os.path.isfile(explicit):
        return explicit
    for d in (os.path.dirname(os.path.abspath(model_path)),
              os.getcwd(),
              os.path.dirname(os.path.dirname(os.path.abspath(__file__)))):
        p = os.path.join(d, fname)
        if os.path.isfile(p):
            return p
    return None


def load_rwkv_vocab(path: str, world: bool) -> list[str]:
    """Parse a vocab sidecar into token strings.

    World files (read_rwkv_world_vocab, rwkv_vocab.cpp:60-89): one hex-encoded
    byte string per line, ids shifted by one behind a <<UNUSED_TOKEN>> at 0.
    Tokens are emitted repr-escaped, the convention our RWKVTokenizer/the GGUF
    converter use for byte strings.

    Pile/20B files (read_rwkv_vocab, :31-57): one GPT-2-unicode-encoded token
    per line, decoded to raw bytes via the byte decoder; emitted
    surrogateescape-decoded for the greedy legacy tokenizer."""
    tokens: list[str] = []
    if world:
        tokens.append("<<UNUSED_TOKEN>>")
        with open(path, "rb") as f:
            for line in f.read().splitlines():
                bs = bytes.fromhex(line.decode("ascii")) if line else b""
                tokens.append(repr(bs)[2:-1])
        return tokens
    dec = {c: b for b, c in _gpt2_byte_encoder().items()}
    with open(path, "rb") as f:
        for line in f.read().splitlines():
            text = line.decode("utf-8", errors="replace")
            bs = bytes(dec.get(ch, ord("?") if ord(ch) > 255 else ord(ch))
                       for ch in text)
            tokens.append(bs.decode("utf-8", errors="surrogateescape"))
    return tokens


class LegacyRwkvReader:
    """GGUFReader-compatible view over rwkv.cpp .bin files (RWKV v4).

    Container (otherarch/rwkv_v3.cpp:242-345): header
    {magic 'ggmf', version 100|101, n_vocab, n_embed, n_layer, data_type},
    then tensors {dim_count u32, key_length u32, data_type u32, width u32,
    [height u32 if 2-D], key bytes, data}.  Version 101 quant layouts equal
    modern GGUF layouts (ggml_v3), so quantized matrices pass through packed;
    version 100 is float-only (the reference's own v3 loader asserts
    quantized => version 101, :273-280).

    The vocab is NOT in the file: the reference ships rwkv_vocab.embd /
    rwkv_world_vocab.embd beside the executable and picks world when
    n_vocab > 60000 (gpttype_adapter.cpp:2031-2049).  We look beside the
    model / $KCPP_RWKV_VOCAB_PATH and synthesize tokenizer metadata."""

    def __init__(self, path: str | os.PathLike,
                 fmt: FileFormat | None = None):
        self.path = os.fspath(path)
        if fmt is None:
            fmt = check_file_format(self.path)
        if fmt not in LEGACY_RWKV_FORMATS:
            raise ValueError(f"{self.path}: not a legacy RWKV file ({fmt})")
        self.file_format = fmt
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._parse()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def _parse(self):
        mm = self._mm
        magic, version, n_vocab, n_embd, n_layer, dtype_id = \
            struct.unpack_from("<6I", mm, 0)
        pos = 24
        self._version = version

        self.tensors: dict[str, _LegacyTensor] = {}
        end = len(mm)
        while pos + 16 <= end:
            dim_count, key_length, ttype_id = struct.unpack_from("<3I", mm, pos)
            pos += 12
            (width,) = struct.unpack_from("<I", mm, pos)
            pos += 4
            if dim_count == 2:
                (height,) = struct.unpack_from("<I", mm, pos)
                pos += 4
            else:
                height = 1
            name = bytes(mm[pos:pos + key_length]).decode("utf-8")
            pos += key_length
            if ttype_id >= len(_RWKV_TYPES) or _RWKV_TYPES[ttype_id] is None:
                raise ValueError(
                    f"{self.path}: tensor {name!r} uses dropped quant type "
                    f"id {ttype_id} (Q4_1_O-era); requantize with a newer "
                    "rwkv.cpp")
            gt = _RWKV_TYPES[ttype_id]
            if gt not in (GGMLType.F32, GGMLType.F16) and version == 100:
                raise ValueError(
                    f"{self.path}: version-100 RWKV files only support "
                    "float tensors (quantized requires version 101, "
                    "rwkv_v3.cpp:273-280)")
            blk, sz = GGML_BLOCK_SIZES[gt]
            nbytes = width // blk * sz * height
            t = _LegacyTensor()
            t.name = _rwkv_name(name)
            t.shape = (height, width) if dim_count == 2 else (width,)
            t.stored_type = gt
            t.ggml_type = gt  # pass-through (v101 layouts == modern)
            t.qver = "v3"
            t.nbytes = nbytes
            t.offset = pos
            self.tensors[t.name] = t
            pos += nbytes

        world = n_vocab > 60000
        vocab_path = find_rwkv_vocab_file(self.path, world)
        tokens: list[str] = []
        if vocab_path is not None:
            tokens = load_rwkv_vocab(vocab_path, world)[:n_vocab]
        if len(tokens) < n_vocab:  # pad (or no sidecar found: id-only ops)
            tokens += [f"<unused{i}>" for i in range(len(tokens), n_vocab)]
        token_type = np.full(len(tokens), 1, np.int32)
        for special in ("<|endoftext|>", "<|padding|>", "<<UNUSED_TOKEN>>"):
            try:
                token_type[tokens.index(special)] = 3  # CONTROL
            except ValueError:
                pass

        self.architecture = "rwkv4"
        self.metadata: dict[str, Any] = {
            "general.architecture": "rwkv4",
            "general.name": os.path.basename(self.path),
            # non-GGUF context clamp mirrors the reference's 16k cap
            # (gpttype_adapter.cpp:1662-1667); RWKV state is unbounded anyway
            "rwkv4.context_length": np.uint32(16384),
            "rwkv4.embedding_length": np.uint32(n_embd),
            "rwkv4.block_count": np.uint32(n_layer),
            "rwkv4.feed_forward_length": np.uint32(4 * n_embd),
            "rwkv4.attention.head_count": np.uint32(1),
            "rwkv4.attention.head_count_kv": np.uint32(1),
            "rwkv4.attention.layer_norm_epsilon": np.float32(1e-5),
            "rwkv4.vocab_size": np.uint32(n_vocab),
            "tokenizer.ggml.model": "rwkv" if world else "kcpp_legacy_greedy",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": token_type,
            "tokenizer.ggml.bos_token_id": np.uint32(0),
            "tokenizer.ggml.eos_token_id": np.uint32(0),
            "tokenizer.ggml.unknown_token_id": np.uint32(0),
            "tokenizer.ggml.add_bos_token": False,
        }

    def tensor_raw(self, name: str) -> np.ndarray:
        t = self.tensors[name]
        raw = np.frombuffer(self._mm, np.uint8, count=t.nbytes,
                            offset=t.offset)
        blk, sz = GGML_BLOCK_SIZES[t.stored_type]
        row_bytes = t.shape[-1] // blk * sz
        return raw.reshape(t.shape[:-1] + (row_bytes,))

    def tensor_data(self, name: str, dtype=np.float32) -> np.ndarray:
        from . import quants

        t = self.tensors[name]
        x = quants.dequantize(self.tensor_raw(name), t.stored_type)
        return x.reshape(t.shape).astype(dtype)
