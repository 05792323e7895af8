"""GGUF file-format constants and quant-type registry.

Format spec derived from the GGUF container layout used by ggml
(reference: ggml/src/ggml.c:22234 `gguf_init_from_file`,
struct layouts ggml/src/ggml-common.h:144-419). This module is
an independent TPU-first implementation: types are described as (block_size,
type_size) pairs that drive vectorized numpy parsing, not C structs.
"""
from __future__ import annotations

import enum

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# Super-block size shared by all K-quants.
QK_K = 256
K_SCALE_SIZE = 12


class GGUFValueType(enum.IntEnum):
    """Metadata value types in the GGUF KV section."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor storage formats (ggml_type numbering, which GGUF reuses)."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    # 4, 5 were Q4_2/Q4_3 — removed upstream, never valid in GGUF v3 files.
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    Q4_0_4_4 = 31
    Q4_0_4_8 = 32
    Q4_0_8_8 = 33
    TQ1_0 = 34
    TQ2_0 = 35


# type -> (elements per block, bytes per block)
GGML_BLOCK_SIZES: dict[GGMLType, tuple[int, int]] = {
    GGMLType.F32: (1, 4),
    GGMLType.F16: (1, 2),
    GGMLType.BF16: (1, 2),
    GGMLType.F64: (1, 8),
    GGMLType.I8: (1, 1),
    GGMLType.I16: (1, 2),
    GGMLType.I32: (1, 4),
    GGMLType.I64: (1, 8),
    GGMLType.Q4_0: (32, 2 + 16),
    GGMLType.Q4_1: (32, 2 + 2 + 16),
    GGMLType.Q5_0: (32, 2 + 4 + 16),
    GGMLType.Q5_1: (32, 2 + 2 + 4 + 16),
    GGMLType.Q8_0: (32, 2 + 32),
    GGMLType.Q8_1: (32, 2 + 2 + 32),
    GGMLType.Q2_K: (QK_K, QK_K // 16 + QK_K // 4 + 2 + 2),
    GGMLType.Q3_K: (QK_K, QK_K // 8 + QK_K // 4 + 12 + 2),
    GGMLType.Q4_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2),
    GGMLType.Q5_K: (QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2),
    GGMLType.Q6_K: (QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2),
    GGMLType.Q8_K: (QK_K, 4 + QK_K + QK_K // 16 * 2),
    GGMLType.IQ2_XXS: (QK_K, 2 + QK_K // 4),
    GGMLType.IQ2_XS: (QK_K, 2 + QK_K // 4 + QK_K // 32),
    GGMLType.IQ3_XXS: (QK_K, 2 + QK_K // 4 + QK_K // 8),
    GGMLType.IQ1_S: (QK_K, 2 + QK_K // 8 + QK_K // 16),
    GGMLType.IQ4_NL: (32, 2 + 16),
    GGMLType.IQ3_S: (QK_K, 2 + QK_K // 4 + QK_K // 8 + QK_K // 32 + 4),
    GGMLType.IQ2_S: (QK_K, 2 + QK_K // 4 + QK_K // 16),
    GGMLType.IQ4_XS: (QK_K, 2 + 2 + QK_K // 64 + QK_K // 2),
    GGMLType.IQ1_M: (QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32),
    GGMLType.TQ1_0: (QK_K, 2 + 4 * 13),
    GGMLType.TQ2_0: (QK_K, 2 + 64),
}


def type_size(t: GGMLType) -> tuple[int, int]:
    """Return (block_size, bytes_per_block) for tensor type `t`."""
    return GGML_BLOCK_SIZES[t]


def row_nbytes(t: GGMLType, n_elements: int) -> int:
    blk, sz = GGML_BLOCK_SIZES[t]
    if n_elements % blk != 0:
        raise ValueError(f"{n_elements} elements not divisible by {t.name} block {blk}")
    return n_elements // blk * sz


# ---------------------------------------------------------------------------
# Canonical metadata keys (subset the runtime consumes; same key-name contract
# as reference gguf-py/gguf/constants.py so real GGUF files load unmodified).
# ---------------------------------------------------------------------------
class Keys:
    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        QUANTIZATION_VERSION = "general.quantization_version"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    # per-arch keys; format with arch name
    CONTEXT_LENGTH = "{arch}.context_length"
    EMBEDDING_LENGTH = "{arch}.embedding_length"
    BLOCK_COUNT = "{arch}.block_count"
    FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
    HEAD_COUNT = "{arch}.attention.head_count"
    HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
    KEY_LENGTH = "{arch}.attention.key_length"
    VALUE_LENGTH = "{arch}.attention.value_length"
    LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
    LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
    ROPE_DIMENSION_COUNT = "{arch}.rope.dimension_count"
    ROPE_FREQ_BASE = "{arch}.rope.freq_base"
    ROPE_SCALING_TYPE = "{arch}.rope.scaling.type"
    ROPE_SCALING_FACTOR = "{arch}.rope.scaling.factor"
    ROPE_SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
    ROPE_SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
    EXPERT_COUNT = "{arch}.expert_count"
    EXPERT_USED_COUNT = "{arch}.expert_used_count"
    EXPERT_FFN_LENGTH = "{arch}.expert_feed_forward_length"
    EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
    VOCAB_SIZE = "{arch}.vocab_size"
    ATTN_LOGIT_SOFTCAP = "{arch}.attn_logit_softcapping"
    FINAL_LOGIT_SOFTCAP = "{arch}.final_logit_softcapping"
    SLIDING_WINDOW = "{arch}.attention.sliding_window"

    class SSM:
        CONV_KERNEL = "{arch}.ssm.conv_kernel"
        INNER_SIZE = "{arch}.ssm.inner_size"
        STATE_SIZE = "{arch}.ssm.state_size"
        TIME_STEP_RANK = "{arch}.ssm.time_step_rank"
        DT_B_C_RMS = "{arch}.ssm.dt_b_c_rms"

    class WKV:
        HEAD_SIZE = "{arch}.wkv.head_size"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"  # "llama"(spm) | "gpt2"(bpe) | ...
        PRE = "tokenizer.ggml.pre"
        TOKENS = "tokenizer.ggml.tokens"
        SCORES = "tokenizer.ggml.scores"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        EOM_ID = "tokenizer.ggml.eom_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        CLS_ID = "tokenizer.ggml.cls_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        PRECOMPILED_CHARSMAP = "tokenizer.ggml.precompiled_charsmap"
        CHAT_TEMPLATE = "tokenizer.chat_template"


class TokenType(enum.IntEnum):
    """tokenizer.ggml.token_type values (llama_token_type numbering)."""

    UNDEFINED = 0
    NORMAL = 1
    UNKNOWN = 2
    CONTROL = 3
    USER_DEFINED = 4
    UNUSED = 5
    BYTE = 6
