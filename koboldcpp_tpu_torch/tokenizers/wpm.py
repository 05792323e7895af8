"""WPM (BERT WordPiece) tokenizer.

Counterpart of llm_tokenizer_wpm_session (src/llama-vocab.cpp):
the GGUF BERT vocab stores word-start pieces with a U+2581 phantom-space
prefix (continuations bare), so encoding is: normalize (NFD, lowercase, drop
controls), split into words at whitespace / punctuation / CJK chars, then
greedy longest-match over "▁" + word; a word with no full cover becomes UNK.
"""
from __future__ import annotations

import unicodedata

from .vocab import Vocab

_PHANTOM = "▁"


def _is_cjk(cp: int) -> bool:
    # reference is_chinese_char (llama-vocab.cpp), incl. its 0x2B920 quirk
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B920 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


def _nfd_first(text: str) -> str:
    """The reference's single-codepoint 'NFD': each input codepoint maps to
    the FIRST codepoint of its canonical decomposition
    (unicode_cpts_normalize_nfd's range->one-cp table, src/unicode.cpp) —
    composed accents lose their combining marks, but combining marks typed
    literally in the input survive.  Python's full NFD would keep the marks
    and diverge (golden case 'café' -> '▁cafe')."""
    return "".join(unicodedata.normalize("NFD", ch)[0] for ch in text)


def preprocess(text: str) -> list[str]:
    """NFD + lowercase + split at whitespace; punctuation/ascii-symbol/CJK
    chars become single-char words."""
    words: list[str] = [""]
    for ch in _nfd_first(text):
        cp = ord(ch)
        if ch.isspace():
            if words[-1]:
                words.append("")
            continue
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            continue
        low = ch.lower()
        cat = unicodedata.category(ch)
        if cat.startswith("P") or (cp < 0x7F and cat.startswith("S")) or _is_cjk(cp):
            if words[-1]:
                words.append("")
            words[-1] = low
            words.append("")
        else:
            words[-1] += low
    if not words[-1]:
        words.pop()
    return words


class WPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.max_len = max((len(t) for t in vocab.tokens), default=1)

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for word in preprocess(text):
            if not word:
                continue
            w = _PHANTOM + word
            n = len(w)
            start_len = len(out)
            i = 0
            matched_all = True
            while i < n:
                match = False
                for j in range(min(n, i + self.max_len + 1), i, -1):
                    tid = v.token_to_id.get(w[i:j])
                    if tid is not None:
                        out.append(tid)
                        i = j
                        match = True
                        break
                if not match:
                    del out[start_len:]  # discard partial cover
                    matched_all = False
                    break
            if not matched_all or len(out) == start_len:
                if v.unk_id >= 0:
                    out.append(v.unk_id)
        return out

    def decode_piece(self, tid: int) -> bytes:
        return self.vocab.tokens[tid].replace(_PHANTOM, " ").encode("utf-8")
