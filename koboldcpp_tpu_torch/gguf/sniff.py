"""File-format sniffing: magic-byte + header-heuristic detection.

Counterpart of check_file_format (model_adapter.cpp:83-335):
identifies GGUF and the 20+ legacy pre-GGUF containers (ggml v1 'ggml',
ggmf v2 'ggmf' incl. RWKV, ggjt v1-3) so the loader can route — or, in this
round, fail with a precise message naming the detected format instead of a
generic parse error. Legacy loaders themselves are a later-round item.
"""
from __future__ import annotations

import enum
import struct


class FileFormat(enum.Enum):
    BADFORMAT = "unknown"
    GGUF = "gguf"
    GGML = "ggml v1 (legacy llama)"
    MPT_1 = "legacy MPT (ggml v1)"
    GPTJ_1 = "legacy GPT-J f16 (ggml v1)"
    GPTJ_3 = "legacy GPT-J quantized (ggml v1)"
    GPTJ_4 = "legacy GPT-J qntvr1"
    GPTJ_5 = "legacy GPT-J qntvr2"
    GPT2_1 = "legacy GPT-2 f16 (ggml v1)"
    GPT2_2 = "legacy GPT-2 quantized (ggml v1)"
    GPT2_3 = "legacy GPT-2 qntvr1"
    GPT2_4 = "legacy GPT-2 qntvr2"
    NEOX_LEGACY = "legacy GPT-NeoX (old header)"
    NEOX = "legacy GPT-NeoX"
    GGHF = "ggmf v2 (legacy llama)"
    RWKV_1 = "legacy RWKV v1"
    RWKV_2 = "legacy RWKV v2"
    GGJT = "ggjt v1 (legacy llama)"
    GGJT_2 = "ggjt v2 (legacy llama)"
    GGJT_3 = "ggjt v3 (legacy llama)"


_MAGIC_GGML = 0x67676D6C
_MAGIC_GGMF = 0x67676D66
_MAGIC_GGJT = 0x67676A74
_MAGIC_GGUF = 0x46554747


def _u32s(buf: bytes, n: int, offset: int = 0) -> list[int]:
    need = offset + 4 * n
    if len(buf) < need:
        return [0] * n
    return list(struct.unpack_from(f"<{n}I", buf, offset))


def check_file_format(path: str) -> FileFormat:
    with open(path, "rb") as f:
        head = f.read(64)
    if len(head) < 4:
        return FileFormat.BADFORMAT
    (magic,) = struct.unpack_from("<I", head, 0)

    if magic == _MAGIC_GGUF:
        return FileFormat.GGUF

    if magic == _MAGIC_GGML:  # v1: magic then raw hparams, vocab size first
        (vocab,) = struct.unpack_from("<i", head, 4)
        if vocab in (4096, 7168):  # actually d_model: MPT
            return FileFormat.MPT_1
        if vocab == 50400:  # GPT-J
            vals = _u32s(head, 6, 8)  # ctx, embd, head, layer, rot, f16
            f16 = vals[5]
            qntvr, rem = f16 // 1000, f16 % 1000
            if qntvr == 1:
                return FileFormat.GPTJ_4
            if qntvr > 1:
                return FileFormat.GPTJ_5
            if rem not in (0, 1):
                return FileFormat.GPTJ_3
            return FileFormat.GPTJ_1
        if vocab == 50257 or 49152 <= vocab <= 49157:  # GPT-2 / starcoder
            vals = _u32s(head, 5, 8)  # ctx, embd, head, layer, f16
            if vocab == 49152 and vals[:4] == [4096, 2560, 32, 32]:
                return FileFormat.NEOX  # Stablecode special case
            f16 = vals[4]
            qntvr, rem = f16 // 1000, f16 % 1000
            if qntvr == 1:
                return FileFormat.GPT2_3
            if qntvr > 1:
                return FileFormat.GPT2_4
            if rem not in (0, 1):
                return FileFormat.GPT2_2
            return FileFormat.GPT2_1
        if vocab < 31998 or vocab > 33000:  # outside llama v1 range: NeoX
            vals = _u32s(head, 7, 8)  # ctx,embd,head,layer,rot,par_res?,ftype?
            if vals[5] not in (0, 1):
                return FileFormat.NEOX_LEGACY
            return FileFormat.NEOX
        return FileFormat.GGML  # llama v1

    if magic == _MAGIC_GGMF:  # v2, or RWKV which reuses the magic
        (ver,) = struct.unpack_from("<I", head, 4)
        if ver == 100:
            return FileFormat.RWKV_1
        if ver == 101:
            return FileFormat.RWKV_2
        return FileFormat.GGHF

    if magic == _MAGIC_GGJT:
        (ver,) = struct.unpack_from("<I", head, 4)
        if ver == 1:
            return FileFormat.GGJT
        if ver == 2:
            return FileFormat.GGJT_2
        return FileFormat.GGJT_3

    return FileFormat.BADFORMAT


def describe_or_raise(path: str) -> None:
    """Raise a precise error for non-GGUF model files (loader front door)."""
    fmt = check_file_format(path)
    if fmt is FileFormat.GGUF:
        return
    if fmt is FileFormat.BADFORMAT:
        raise ValueError(f"{path}: not a recognized model file "
                         "(no GGUF or legacy ggml magic)")
    from .legacy import (LEGACY_LLAMA_FORMATS, LEGACY_OTHERARCH_FORMATS,
                         LEGACY_RWKV_FORMATS)

    if (fmt in LEGACY_LLAMA_FORMATS or fmt in LEGACY_OTHERARCH_FORMATS
            or fmt in LEGACY_RWKV_FORMATS):
        return  # loadable via gguf/legacy.py readers
    raise ValueError(
        f"{path}: detected {fmt.value} — this legacy pre-GGUF format is not "
        "supported yet; convert the model to GGUF "
        "(e.g. llama.cpp convert-legacy scripts) and retry")
