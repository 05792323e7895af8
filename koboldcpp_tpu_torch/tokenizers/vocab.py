"""Vocabulary loaded from GGUF metadata (`tokenizer.ggml.*` keys).

Counterpart of the reference's llama_vocab (reference:
src/llama-vocab.cpp; key contract gguf-py constants).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Mapping

import numpy as np

from ..gguf.constants import Keys, TokenType


@dataclass
class Vocab:
    model: str  # "llama" (spm) | "gpt2" (bpe) | "no_vocab" | ...
    pre: str
    tokens: list[str]
    scores: np.ndarray  # float32, len == n_tokens
    token_types: np.ndarray  # int32 TokenType values
    merges: list[str] = field(default_factory=list)
    bos_id: int = 1
    eos_id: int = 2
    eot_id: int = -1
    eom_id: int = -1
    unk_id: int = 0
    sep_id: int = -1
    cls_id: int = -1
    pad_id: int = -1
    add_bos: bool = True
    add_eos: bool = False
    add_space_prefix: bool = True
    remove_extra_whitespaces: bool = False
    precompiled_charsmap: bytes = b""
    chat_template: str = ""

    # derived
    token_to_id: dict[str, int] = field(default_factory=dict, repr=False)
    byte_tokens: dict[int, int] = field(default_factory=dict, repr=False)  # byte -> id
    special_ids: list[int] = field(default_factory=list, repr=False)

    def __post_init__(self):
        if not self.token_to_id:
            self.token_to_id = {t: i for i, t in enumerate(self.tokens)}
        tt = self.token_types
        for i, t in enumerate(self.tokens):
            if tt[i] == TokenType.BYTE and len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
                self.byte_tokens[int(t[3:5], 16)] = i
        self.special_ids = [i for i in range(len(self.tokens))
                            if tt[i] in (TokenType.CONTROL, TokenType.USER_DEFINED)]

    @property
    def n_tokens(self) -> int:
        return len(self.tokens)

    def is_control(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.CONTROL

    def is_byte(self, tid: int) -> bool:
        return self.token_types[tid] == TokenType.BYTE

    def is_eog(self, tid: int) -> bool:
        """End-of-generation: EOS or EOT or EOM."""
        return tid in (self.eos_id, self.eot_id, self.eom_id) and tid >= 0


def _get(md: Mapping[str, Any], key: str, default=None):
    v = md.get(key, default)
    if isinstance(v, np.generic):
        return v.item()
    return v


def vocab_from_metadata(md: Mapping[str, Any]) -> Vocab:
    T = Keys.Tokenizer
    tokens = [str(t) for t in md.get(T.TOKENS, [])]
    n = len(tokens)
    scores = np.asarray(md.get(T.SCORES, np.zeros(n, np.float32)), dtype=np.float32)
    if len(scores) < n:
        scores = np.pad(scores, (0, n - len(scores)))
    types = np.asarray(md.get(T.TOKEN_TYPE, np.full(n, int(TokenType.NORMAL), np.int32)),
                       dtype=np.int32)
    if len(types) < n:
        types = np.pad(types, (0, n - len(types)), constant_values=int(TokenType.NORMAL))
    model = str(_get(md, T.MODEL, "llama"))
    # SPM defaults add_space_prefix=True; BPE does not
    default_space_prefix = model == "llama"
    return Vocab(
        model=model,
        pre=str(_get(md, T.PRE, "default")),
        tokens=tokens,
        scores=scores,
        token_types=types,
        merges=[str(m) for m in md.get(T.MERGES, [])],
        bos_id=int(_get(md, T.BOS_ID, 1)),
        eos_id=int(_get(md, T.EOS_ID, 2)),
        eot_id=int(_get(md, T.EOT_ID, -1)),
        eom_id=int(_get(md, T.EOM_ID, -1)),
        unk_id=int(_get(md, T.UNK_ID, 0)),
        sep_id=int(_get(md, T.SEP_ID, -1)),
        cls_id=int(_get(md, T.CLS_ID, -1)),
        pad_id=int(_get(md, T.PAD_ID, -1)),
        add_bos=bool(_get(md, T.ADD_BOS, model == "llama")),
        add_eos=bool(_get(md, T.ADD_EOS, False)),
        add_space_prefix=bool(_get(md, T.ADD_SPACE_PREFIX, default_space_prefix)),
        remove_extra_whitespaces=bool(_get(md, T.REMOVE_EXTRA_WS, False)),
        precompiled_charsmap=(lambda v: v.tobytes() if hasattr(v, "tobytes")
                              else bytes(v))(_get(md, T.PRECOMPILED_CHARSMAP, b"")),
        chat_template=str(_get(md, T.CHAT_TEMPLATE, "")),
    )
