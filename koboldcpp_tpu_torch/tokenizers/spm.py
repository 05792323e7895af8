"""SentencePiece-style (SPM) tokenizer over a GGUF vocab.

Same algorithm family as the reference's llm_tokenizer_spm
(src/llama-vocab.cpp:208): greedy highest-score bigram merging
over initial UTF-8 character symbols, with byte fallback.
"""
from __future__ import annotations

import heapq

from .vocab import Vocab

SPM_SPACE = "▁"  # ▁


class SPMTokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        self._native = None
        try:  # C++ core for long-prompt hot paths; Python fallback below
            from ..utils.native import NativeSPM

            self._native = NativeSPM(vocab.tokens, vocab.scores,
                                     vocab.byte_tokens, vocab.unk_id)
        except Exception:
            self._native = None

    def encode_fragment(self, text: str) -> list[int]:
        """Tokenize one raw-text fragment (no special-token handling here)."""
        v = self.vocab
        if not text:
            return []
        if self._native is not None:
            return self._native.encode(text)
        sym_text = [c for c in text]  # symbols start as single characters
        # linked list over symbols
        prev = list(range(-1, len(sym_text) - 1))
        nxt = list(range(1, len(sym_text) + 1))
        alive = [True] * len(sym_text)

        heap: list[tuple[float, int, str]] = []  # (-score, left, merged_text)

        def try_bigram(left: int):
            if left == -1:
                return
            right = nxt[left]
            if right >= len(sym_text):
                return
            merged = sym_text[left] + sym_text[right]
            tid = v.token_to_id.get(merged)
            if tid is not None:
                heapq.heappush(heap, (-float(v.scores[tid]), left, merged))

        for i in range(len(sym_text) - 1):
            try_bigram(i)

        while heap:
            _, left, merged = heapq.heappop(heap)
            right = nxt[left] if left < len(nxt) else len(sym_text)
            # stale entry: one side was already merged away
            if not alive[left] or right >= len(sym_text) or not alive[right]:
                continue
            if sym_text[left] + sym_text[right] != merged:
                continue
            sym_text[left] = merged
            alive[right] = False
            nxt[left] = nxt[right]
            if nxt[right] < len(sym_text):
                prev[nxt[right]] = left
            try_bigram(prev[left] if prev[left] >= 0 else -1)
            try_bigram(left)

        out: list[int] = []
        i = 0
        while i < len(sym_text):
            if alive[i]:
                self._resegment(sym_text[i], out)
            i = nxt[i] if alive[i] else i + 1
        return out

    def _resegment(self, piece: str, out: list[int]):
        v = self.vocab
        tid = v.token_to_id.get(piece)
        if tid is not None:
            out.append(tid)
            return
        # byte fallback
        ok = True
        ids = []
        for b in piece.encode("utf-8"):
            bid = v.byte_tokens.get(b)
            if bid is None:
                ok = False
                break
            ids.append(bid)
        if ok and ids:
            out.extend(ids)
        elif v.unk_id >= 0:
            out.append(v.unk_id)

    def decode_piece(self, tid: int) -> bytes:
        v = self.vocab
        if v.is_byte(tid):
            t = v.tokens[tid]
            return bytes([int(t[3:5], 16)])
        return v.tokens[tid].replace(SPM_SPACE, " ").encode("utf-8")
