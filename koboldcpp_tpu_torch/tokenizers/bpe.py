"""Byte-level BPE tokenizer (GPT-2 family) over a GGUF vocab.

Counterpart of the reference's llm_tokenizer_bpe
(src/llama-vocab.cpp:596) with per-model pretokenizer regexes.
Uses the `regex` module for \\p unicode classes.
"""
from __future__ import annotations

from functools import lru_cache

import regex

from .vocab import Vocab

# Pretokenizer regex LISTS keyed by `tokenizer.ggml.pre`, mirroring the
# reference dispatch (llm_tokenizer_bpe, src/llama-vocab.cpp:596-717 and the
# name mapping src/llama.cpp:6338-6440). Each regex in a list successively
# SPLITS every current fragment (matches carved out, gaps kept) — the
# unicode_regex_split semantics — so multi-pass lists like deepseek/starcoder
# behave exactly like the reference.
_GPT2_PRE = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"
_LLAMA3_PRE = (
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_QWEN2_PRE = (
    r"(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])"
    r"|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_GPT4O_PRE = (
    r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([^A-Z]))+(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
    r"|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))+((?=[\p{L}])([^A-Z]))*(?:'[sS]|'[tT]|'[rR][eE]|'[vV][eE]|'[mM]|'[lL][lL]|'[dD])?"
    r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
# GPT-2-with-number-split family (starcoder/refact/command-r/smollm/...)
_STARCODER_LIST = [r"\p{N}", _GPT2_PRE]
# the reference "default" (unknown-pre fallback after its loud warning)
_DEFAULT_LIST = [
    r"[\p{P}\$\+<=>\^~\|]+", _GPT2_PRE, r"\p{N}+", r"[0-9][0-9][0-9]"]
_FALCON_LIST = [
    r"[\p{P}\$\+<=>\^~\|`]+",
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
    r"[0-9][0-9][0-9]",
]
_PORO_LIST = [r" ?[^(\s|.,!?…。，、।۔،)]+"]
_DEEPSEEK_LLM_LIST = [
    r"[\r\n]",
    '\\s?[A-Za-zµÀ-ÖØ-öø-ƺƼ-ƿǄ-ʓʕ-ʯͰ-ͳͶͷͻ-ͽͿΆΈ-ΊΌΎ-ΡΣ-ϵϷ-ҁҊ-ԯԱ-ՖႠ-ჅᎠ-Ᏽᏸ-ᏽᲐ-ᲺᲽ-Ჿᴀ-ᴫᵫ-ᵷᵹ-ᶚḀ-ἕἘ-Ἕἠ-ὅὈ-Ὅὐ-ὗὙὛὝὟ-ώᾀ-ᾴᾶ-ᾼιῂ-ῄῆ-ῌῐ-ΐῖ-Ίῠ-Ῥῲ-ῴῶ-ῼℂℇℊ-ℓℕℙ-ℝℤΩℨK-ℭℯ-ℴℹℼ-ℿⅅ-ⅉⅎↃↄⰀ-ⱻⱾ-ⳤⳫ-ⳮⳲⳳꙀ-ꙭꚀ-ꚛꜢ-ꝯꝱ-ꞇꞋ-ꞎꭰ-ꮿﬀ-ﬆﬓ-ﬗＡ-Ｚａ-ｚ𐐀-𐑏𐒰-𐓓𐓘-𐓻𐲀-𐲲𐳀-𐳲𑢠-𑣟𞤀-𞥃]+',
    r"\s?[!-/:-~！-／：-～‘-‟　-。]+",
    r"\s+$",
    r"[一-龥ࠀ-一가-퟿]+",
    r"\p{N}+",
]
_DEEPSEEK_CODER_LIST = [
    r"[\r\n]", r"\s?\p{L}+", r"\s?\p{P}+", r"[一-龥ࠀ-一가-퟿]+", r"\p{N}",
]
_TEKKEN_PRE = (
    r"[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))*((?=[\p{L}])([^A-Z]))+"
    r"|[^\r\n\p{L}\p{N}]?((?=[\p{L}])([^a-z]))+((?=[\p{L}])([^A-Z]))*"
    r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n/]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)
_CHAMELEON_LIST = [
    r"<sentinel:[0-9]+>",
    r"(IMGIMG)((A|B|C|D|E|F|G|H|I){1,4})Z",
    "([\\t\\n]|    |  )",
    r"\p{N}",
    r"[\p{P}!-/:-@\[-`{-~]",
    r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)",
]

PRE_PATTERNS: dict[str, list[str]] = {
    "default": _DEFAULT_LIST,
    # gpt2 family (src/llama.cpp:6365-6372)
    "gpt2": [_GPT2_PRE], "gpt-2": [_GPT2_PRE], "phi-2": [_GPT2_PRE],
    "jina-es": [_GPT2_PRE], "jina-de": [_GPT2_PRE],
    "jina-v1-en": [_GPT2_PRE], "jina-v2-es": [_GPT2_PRE],
    "jina-v2-de": [_GPT2_PRE], "jina-v2-code": [_GPT2_PRE],
    "mpt": [_GPT2_PRE], "olmo": [_GPT2_PRE], "jais": [_GPT2_PRE],
    # llama3 family
    "llama3": [_LLAMA3_PRE], "llama-v3": [_LLAMA3_PRE],
    "llama-bpe": [_LLAMA3_PRE], "smaug-bpe": [_LLAMA3_PRE],
    "dbrx": [_LLAMA3_PRE], "falcon3": [_LLAMA3_PRE],
    "chatglm-bpe": [_LLAMA3_PRE],
    "gpt-4o": [_GPT4O_PRE],
    "falcon": _FALCON_LIST,
    "starcoder": _STARCODER_LIST, "refact": _STARCODER_LIST,
    "command-r": _STARCODER_LIST, "smollm": _STARCODER_LIST,
    "codeshell": _STARCODER_LIST, "exaone": _STARCODER_LIST,
    "qwen2": [_QWEN2_PRE], "stablelm2": [_QWEN2_PRE],
    "poro-chat": _PORO_LIST, "bloom": _PORO_LIST,
    "gpt3-finnish": _PORO_LIST,
    "viking": _PORO_LIST + [r"\p{N}"],
    "deepseek-llm": _DEEPSEEK_LLM_LIST,
    "deepseek-coder": _DEEPSEEK_CODER_LIST,
    "tekken": [_TEKKEN_PRE],
    "chameleon": _CHAMELEON_LIST,
}

# whole-word vocab hit skips the merge walk (tokenizer_ignore_merges,
# src/llama.cpp:6346,6416 / llama-vocab.cpp:777)
IGNORE_MERGES_PRE = {"llama3", "llama-v3", "llama-bpe", "tekken"}


@lru_cache(maxsize=1)
def byte_encoder() -> dict[int, str]:
    """GPT-2 byte -> printable-unicode mapping."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


@lru_cache(maxsize=1)
def byte_decoder() -> dict[str, int]:
    return {c: b for b, c in byte_encoder().items()}


class BPETokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.ranks: dict[tuple[str, str], int] = {}
        for i, m in enumerate(vocab.merges):
            a, _, b = m.partition(" ")
            self.ranks[(a, b)] = i
        pre = vocab.pre or "default"
        pats = PRE_PATTERNS.get(pre)
        if pats is None:
            # the reference hard-errors on unknown pre types
            # ("unknown pre-tokenizer type", src/llama.cpp:6441); silent
            # gpt2 fallback mis-tokenizes whole model families
            raise ValueError(
                f"unknown tokenizer.ggml.pre type {pre!r}; supported: "
                f"{sorted(PRE_PATTERNS)} (regenerate the GGUF, or pass "
                f"'default' explicitly to accept degraded tokenization)")
        self.ignore_merges = pre in IGNORE_MERGES_PRE
        self._pre = [regex.compile(p) for p in pats]
        self._enc = byte_encoder()

    def _pretokenize(self, text: str) -> list[str]:
        """unicode_regex_split semantics: each regex splits every current
        fragment; matched spans are carved out and unmatched gaps kept for
        the next regex (and as final fragments)."""
        words = [text]
        for pat in self._pre:
            nxt: list[str] = []
            for w in words:
                last = 0
                for m in pat.finditer(w):
                    if m.start() > last:
                        nxt.append(w[last:m.start()])
                    if m.group():
                        nxt.append(m.group())
                    last = m.end()
                if last < len(w):
                    nxt.append(w[last:])
            words = nxt
        return [w for w in words if w]

    def _bpe_word(self, word: str) -> list[str]:
        parts = [c for c in word]
        if len(parts) < 2:
            return parts
        while True:
            best_rank = None
            best_i = -1
            for i in range(len(parts) - 1):
                r = self.ranks.get((parts[i], parts[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank = r
                    best_i = i
            if best_rank is None:
                return parts
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]

    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        out: list[int] = []
        for word in self._pretokenize(text):
            encoded = "".join(self._enc[b] for b in word.encode("utf-8"))
            if self.ignore_merges:
                tid = v.token_to_id.get(encoded)
                if tid is not None:
                    out.append(tid)
                    continue
            for piece in self._bpe_word(encoded):
                tid = v.token_to_id.get(piece)
                if tid is not None:
                    out.append(tid)
                else:
                    # fall back to per-character lookup, then UNK
                    for ch in piece:
                        cid = v.token_to_id.get(ch)
                        if cid is not None:
                            out.append(cid)
                        elif v.unk_id >= 0:
                            out.append(v.unk_id)
        return out

    def decode_piece(self, tid: int) -> bytes:
        dec = byte_decoder()
        text = self.vocab.tokens[tid]
        try:
            return bytes(dec[c] for c in text)
        except KeyError:
            return text.encode("utf-8")
