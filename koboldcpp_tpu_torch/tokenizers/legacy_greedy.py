"""Legacy greedy tokenizer (gpt_tokenize semantics) for pre-GGUF vocabs.

Counterpart of the reference's gpt_tokenize / gpt_split_words
(otherarch/utils.cpp:135-205), used by every legacy .bin
runtime (incl. RWKV pile models with the rwkv_vocab.embd sidecar,
gpttype_adapter.cpp:2046-2049): split into GPT-2-style words with an
ASCII-class regex, then per word emit the longest vocab entry matching at
each position.  Unknown single bytes are dropped, exactly like the
reference's `i++` skip (utils.cpp:199-202).

Operates on raw bytes: vocab tokens are byte strings carried through
metadata as surrogateescape-decoded text.
"""
from __future__ import annotations

import re

from .vocab import Vocab

# std::regex [[:alpha:]]/[[:digit:]] in the C locale are ASCII-only
_SPLIT = re.compile(
    rb"'s|'t|'re|'ve|'m|'ll|'d| ?[A-Za-z]+| ?[0-9]+"
    rb"| ?[^\sA-Za-z0-9]+|\s+(?!\S)|\s+")


def _token_bytes(text: str) -> bytes:
    return text.encode("utf-8", errors="surrogateescape")


class LegacyGreedyTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_bytes: list[bytes] = [_token_bytes(t) for t in vocab.tokens]
        self._to_id: dict[bytes, int] = {}
        self._max_len = 1
        for tid, bs in enumerate(self.token_bytes):
            if not bs or vocab.is_control(tid):
                continue
            if bs not in self._to_id:  # first occurrence wins (map semantics)
                self._to_id[bs] = tid
                if len(bs) > self._max_len:
                    self._max_len = len(bs)

    def encode_fragment(self, text: str) -> list[int]:
        out: list[int] = []
        data = text.encode("utf-8", errors="surrogateescape")
        for m in _SPLIT.finditer(data):
            word = m.group(0)
            i = 0
            n = len(word)
            while i < n:
                j = min(n, i + self._max_len)
                while j > i:
                    tid = self._to_id.get(word[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        break
                    j -= 1
                else:
                    i += 1  # unknown byte: dropped (utils.cpp:199-202)
        return out

    def decode_piece(self, tid: int) -> bytes:
        return self.token_bytes[tid]
