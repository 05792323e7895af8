"""Tokenizer façade: special-token partitioning + model dispatch + detokenize.

Counterpart of the reference's TokenizeString/tokenizer_st_partition
(gpttype_adapter.cpp:179, src/llama-vocab.cpp fragment logic).
"""
from __future__ import annotations

from typing import Iterable

from .bpe import BPETokenizer
from .spm import SPMTokenizer, SPM_SPACE
from .rwkv import RWKVTokenizer
from .ugm import UGMTokenizer
from .vocab import Vocab, vocab_from_metadata
from .wpm import WPMTokenizer


class Tokenizer:
    def __init__(self, vocab: Vocab):
        self.vocab = vocab
        if vocab.model in ("llama", "spm"):
            self.core = SPMTokenizer(vocab)
        elif vocab.model in ("gpt2", "bpe"):
            self.core = BPETokenizer(vocab)
        elif vocab.model == "bert":
            self.core = WPMTokenizer(vocab)
        elif vocab.model == "rwkv":
            self.core = RWKVTokenizer(vocab)
        elif vocab.model == "t5":
            self.core = UGMTokenizer(vocab)
        elif vocab.model == "kcpp_legacy_greedy":
            from .legacy_greedy import LegacyGreedyTokenizer

            self.core = LegacyGreedyTokenizer(vocab)
        elif vocab.model == "no_vocab":
            self.core = None
        else:
            # default to SPM behavior for unknown models with scores, BPE with merges
            self.core = BPETokenizer(vocab) if vocab.merges else SPMTokenizer(vocab)
        # longest-first special token matching
        self._specials = sorted(
            ((vocab.tokens[i], i) for i in vocab.special_ids if vocab.tokens[i]),
            key=lambda p: -len(p[0]),
        )

    @classmethod
    def from_metadata(cls, md) -> "Tokenizer":
        return cls(vocab_from_metadata(md))

    # -- encode ------------------------------------------------------------
    def _partition(self, text: str, parse_special: bool) -> list[tuple[bool, str | int]]:
        """Split text into (is_special, fragment) pieces."""
        if not parse_special or not self._specials:
            return [(False, text)] if text else []
        frags: list[tuple[bool, str | int]] = []
        rest = [text]
        for tok_text, tid in self._specials:
            new_rest: list = []
            for frag in rest:
                if isinstance(frag, tuple):
                    new_rest.append(frag)
                    continue
                start = 0
                while True:
                    i = frag.find(tok_text, start)
                    if i < 0:
                        if frag[start:]:
                            new_rest.append(frag[start:])
                        break
                    if frag[start:i]:
                        new_rest.append(frag[start:i])
                    new_rest.append((tid,))
                    start = i + len(tok_text)
            rest = new_rest
        for frag in rest:
            if isinstance(frag, tuple):
                frags.append((True, frag[0]))
            else:
                frags.append((False, frag))
        return frags

    def encode(self, text: str, add_bos: bool | None = None,
               add_eos: bool | None = None, parse_special: bool = True) -> list[int]:
        v = self.vocab
        if self.core is None:
            return []
        add_bos = v.add_bos if add_bos is None else add_bos
        add_eos = v.add_eos if add_eos is None else add_eos
        # WPM (BERT): CLS/SEP play the bos/eos roles (llama-vocab.cpp wpm)
        bos = v.cls_id if (isinstance(self.core, WPMTokenizer)
                           and v.cls_id >= 0) else v.bos_id
        eos = v.sep_id if (isinstance(self.core, WPMTokenizer)
                           and v.sep_id >= 0) else v.eos_id
        out: list[int] = []
        if add_bos and bos >= 0:
            out.append(bos)
        is_spm = isinstance(self.core, SPMTokenizer)
        prev_special = True
        for is_special, frag in self._partition(text, parse_special):
            if is_special:
                out.append(frag)  # type: ignore[arg-type]
                prev_special = True
            else:
                raw = frag
                if is_spm:
                    if v.add_space_prefix and prev_special and raw:
                        raw = " " + raw
                    raw = raw.replace(" ", SPM_SPACE)
                out.extend(self.core.encode_fragment(raw))
                prev_special = False
        if add_eos and eos >= 0:
            out.append(eos)
        return out

    # -- decode ------------------------------------------------------------
    def decode_token_bytes(self, tid: int, skip_special: bool = True) -> bytes:
        v = self.vocab
        if skip_special and 0 <= tid < v.n_tokens and v.is_control(tid):
            return b""
        if self.core is None or not (0 <= tid < v.n_tokens):
            return b""
        return self.core.decode_piece(tid)

    def decode(self, ids: Iterable[int], skip_special: bool = True) -> str:
        buf = b"".join(self.decode_token_bytes(t, skip_special) for t in ids)
        text = buf.decode("utf-8", errors="replace")
        # SPM dummy space prefix: strip the synthetic leading space
        if isinstance(self.core, SPMTokenizer) and self.vocab.add_space_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def token_str(self, tid: int) -> str:
        """Display text of one token (streaming piece), UTF-8 lossy."""
        return self.decode_token_bytes(tid, skip_special=False).decode("utf-8", errors="replace")
