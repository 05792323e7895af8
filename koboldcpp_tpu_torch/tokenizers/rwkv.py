"""RWKV world tokenizer: greedy longest-match over raw byte sequences.

Counterpart of llm_tokenizer_rwkv (src/llama-vocab.cpp:1429):
vocab entries are byte strings serialized with Python-repr escapes
(the converter writes repr(bytes)[2:-1], convert_hf_to_gguf.py:2854);
llama_unescape_rwkv_token reverses that. Encoding walks a byte trie taking
the longest vocab entry at each position (unigram-style greedy; ties by
length only, matching the reference's naive longest-match loop).
"""
from __future__ import annotations

from .vocab import Vocab


def unescape_rwkv_token(text: str) -> bytes:
    """Reverse repr(bytes)[2:-1]: \\xHH, \\t, \\n, \\r, \\\\, \\', \\" escapes."""
    out = bytearray()
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c == "\\" and i + 1 < n:
            e = text[i + 1]
            if e == "x" and i + 3 < n:
                try:
                    out.append(int(text[i + 2:i + 4], 16))
                    i += 4
                    continue
                except ValueError:
                    pass
            simple = {"t": 9, "n": 10, "r": 13, "\\": 92, "'": 39, '"': 34,
                      "0": 0, "a": 7, "b": 8, "f": 12, "v": 11}
            if e in simple:
                out.append(simple[e])
                i += 2
                continue
        out.extend(c.encode("utf-8"))
        i += 1
    return bytes(out)


class _TrieNode:
    __slots__ = ("children", "token_id")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_id: int = -1


class RWKVTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.token_bytes: list[bytes] = [
            unescape_rwkv_token(t) for t in vocab.tokens]
        skip = [not bs or vocab.is_control(tid)
                for tid, bs in enumerate(self.token_bytes)]
        self._native = None
        try:  # C++ trie core (native/trie_tokenizer.cpp)
            from ..utils.native import NativeTrie

            self._native = NativeTrie(self.token_bytes, skip=skip)
        except Exception:
            pass
        self.root = _TrieNode()
        for tid, bs in enumerate(self.token_bytes):
            if skip[tid]:
                continue
            node = self.root
            for b in bs:
                node = node.children.setdefault(b, _TrieNode())
            node.token_id = tid

    def encode_fragment(self, text: str) -> list[int]:
        data = text.encode("utf-8")
        if self._native is not None:
            return self._native.rwkv_encode(data)
        out: list[int] = []
        i = 0
        n = len(data)
        while i < n:
            node = self.root
            best_id = -1
            best_len = 0
            j = i
            while j < n:
                node = node.children.get(data[j])
                if node is None:
                    break
                j += 1
                if node.token_id >= 0:
                    best_id, best_len = node.token_id, j - i
            if best_id < 0:
                # unknown byte: skip (the reference advances one byte with no
                # output when nothing in the vocab matches)
                i += 1
                continue
            out.append(best_id)
            i += best_len
        return out

    def decode_piece(self, tid: int) -> bytes:
        return self.token_bytes[tid]
