"""UGM (SentencePiece unigram) tokenizer — T5 family.

Counterpart of llm_tokenizer_ugm (src/llama-vocab.cpp:1024-1369):
- normalization via the precompiled charsmap's XOR-compressed compact double
  array (XCDA) when present (bit layout per xcda_array_view, :1250-1266),
  with add-space-prefix / escape-whitespace / merge-spaces switches;
- Viterbi best-path search over a token trie, per UTF-8 code point, with an
  unknown-token penalty of (min_score - 10) and consecutive-unknown merging.
"""
from __future__ import annotations

import struct

from .vocab import TokenType, Vocab

ESCAPED_SPACE = "▁"  # U+2581 lower one-eighth block
UNKNOWN_PENALTY = 10.0


class _TrieNode:
    __slots__ = ("children", "token_id")

    def __init__(self):
        self.children: dict[int, _TrieNode] = {}
        self.token_id: int = -1


class _Xcda:
    """View over the XOR-compressed compact double array inside
    tokenizer.ggml.precompiled_charsmap."""

    def __init__(self, blob: bytes):
        (size,) = struct.unpack_from("<I", blob, 0)
        self.nodes = memoryview(blob)[4:4 + size].cast("I")
        self.replacements = blob[4 + size:]

    def _node(self, idx: int) -> int:
        if idx >= len(self.nodes):
            raise IndexError
        return self.nodes[idx]

    def base(self, idx: int) -> int:
        n = self._node(idx)
        return (n >> 10) << ((n & (1 << 9)) >> 6)

    def lcheck(self, idx: int) -> int:
        return self._node(idx) & ((1 << 31) | 0xFF)

    def leaf(self, idx: int) -> bool:
        return bool((self._node(idx) >> 8) & 1)

    def value(self, idx: int) -> int:
        return self._node(idx) & ((1 << 31) - 1)

    def longest_prefix(self, data: bytes, start: int) -> tuple[int, int]:
        """Returns (matched_len, replacement_offset) or (0, 0)."""
        best_len, best_off = 0, 0
        try:
            node = self.base(0)
            for i in range(start, len(data)):
                c = data[i]
                if c == 0:
                    break
                node ^= c
                if self.lcheck(node) != c:
                    break
                is_leaf = self.leaf(node)
                node ^= self.base(node)
                if is_leaf:
                    best_len = i - start + 1
                    best_off = self.value(node)
        except IndexError:
            pass
        return best_len, best_off

    def replacement(self, off: int) -> bytes:
        end = self.replacements.index(b"\x00", off)
        return self.replacements[off:end]


def _utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b >> 5 == 0b110:
        return 2
    if b >> 4 == 0b1110:
        return 3
    if b >> 3 == 0b11110:
        return 4
    return 1


class UGMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self.xcda = (_Xcda(vocab.precompiled_charsmap)
                     if vocab.precompiled_charsmap else None)
        self.root = _TrieNode()
        self.user_defined: set[str] = set()
        min_score = float("inf")
        tt = vocab.token_types
        for tid, text in enumerate(vocab.tokens):
            t = tt[tid]
            if t == TokenType.NORMAL:
                min_score = min(min_score, float(vocab.scores[tid]))
            if t in (TokenType.NORMAL, TokenType.USER_DEFINED, TokenType.UNUSED):
                node = self.root
                for b in text.encode("utf-8"):
                    node = node.children.setdefault(b, _TrieNode())
                node.token_id = tid
            if t == TokenType.USER_DEFINED:
                self.user_defined.add(text)
        self.unknown_score = (min_score if min_score != float("inf") else 0.0
                              ) - UNKNOWN_PENALTY
        self._ud_prefixes = sorted(self.user_defined, key=len, reverse=True)
        self._native = None
        try:  # C++ Viterbi core (native/trie_tokenizer.cpp); normalization
            # stays host-side, the native side gets pre-normalized bytes
            from ..utils.native import NativeTrie

            eff_scores = [0.0 if tt[i] == TokenType.USER_DEFINED
                          else float(vocab.scores[i])
                          for i in range(len(vocab.tokens))]
            skip = [tt[i] not in (TokenType.NORMAL, TokenType.USER_DEFINED,
                                  TokenType.UNUSED)
                    for i in range(len(vocab.tokens))]
            self._native = NativeTrie(
                [t.encode("utf-8") for t in vocab.tokens],
                scores=eff_scores, skip=skip)
        except Exception:
            pass

    # -- normalization ----------------------------------------------------
    def _normalize_prefix(self, data: bytes, off: int) -> tuple[bytes, int]:
        """Returns (normalized_bytes, consumed_input_bytes)."""
        for ud in self._ud_prefixes:
            udb = ud.encode("utf-8")
            if data.startswith(udb, off):
                return udb, len(udb)
        if self.xcda is not None:
            mlen, moff = self.xcda.longest_prefix(data, off)
            if mlen > 0:
                return self.xcda.replacement(moff), mlen
        n = min(_utf8_len(data[off]), len(data) - off)
        return data[off:off + n], n

    def normalize(self, text: str) -> bytes:
        v = self.vocab
        data = text.encode("utf-8")
        space = ESCAPED_SPACE.encode("utf-8")  # escape_whitespaces default true
        out = bytearray()
        prepend = v.add_space_prefix
        merge = v.remove_extra_whitespaces
        space_prepended = False
        in_word = False
        off = 0
        while off < len(data):
            piece, consumed = self._normalize_prefix(data, off)
            for c in piece:
                if c != 0x20:
                    if not in_word:
                        in_word = True
                        if (prepend and not space_prepended) or merge:
                            out.extend(space)
                            space_prepended = True
                    out.append(c)
                else:
                    in_word = False
                    if not merge:
                        out.extend(space)
            off += consumed
        return bytes(out)

    # -- viterbi ----------------------------------------------------------
    def encode_fragment(self, text: str) -> list[int]:
        v = self.vocab
        data = self.normalize(text)
        n = len(data)
        if n == 0:
            return []
        if self._native is not None:
            return self._native.ugm_encode(data, v.unk_id, self.unknown_score)
        NEG = float("-inf")
        # (token_id, start_offset, score)
        best: list[tuple[int, int, float]] = [(v.unk_id, 0, NEG)] * (n + 1)
        best[0] = (v.unk_id, 0, 0.0)
        off = 0
        while off < n:
            n_units = min(_utf8_len(data[off]), n - off)
            cur_score = best[off][2]
            node = self.root.children.get(data[off])
            single_cp_found = False
            j = off + 1
            while node is not None:
                if node.token_id >= 0:
                    if j - off == n_units:
                        single_cp_found = True
                    tid = node.token_id
                    ts = (0.0 if v.token_types[tid] == TokenType.USER_DEFINED
                          else float(v.scores[tid]))
                    cand = cur_score + ts
                    if cand > best[j][2]:
                        best[j] = (tid, off, cand)
                if j >= n:
                    break
                node = node.children.get(data[j])
                j += 1
            if not single_cp_found:
                cand = cur_score + self.unknown_score
                j = off + n_units
                if cand > best[j][2]:
                    best[j] = (v.unk_id, off, cand)
            off += n_units
        # backtrack, merging consecutive unknowns
        out: list[int] = []
        pos = n
        prev_unknown = False
        while True:
            tid, start, _ = best[pos]
            is_unknown = tid == v.unk_id
            if not (prev_unknown and is_unknown):
                out.append(tid)
            if start == 0:
                break
            prev_unknown = is_unknown
            pos = start
        out.reverse()
        return out

    # -- decode -----------------------------------------------------------
    def decode_piece(self, tid: int) -> bytes:
        text = self.vocab.tokens[tid]
        return text.replace(ESCAPED_SPACE, " ").encode("utf-8")
