"""GBNF constrained-generation engine.

Pushdown-automaton design following the reference grammar engine's semantics
(src/llama-grammar.cpp: parser :303-587, stack advance/accept
:825+, partial-UTF8 handling), re-expressed as a clean Python automaton:

- parse(): GBNF text -> rules; alternates are flat sequences of items
  ("char" with [lo,hi] ranges, optionally negated, or "ref" rule-id);
  repetition sugar (* + ? {m,n}) desugars into auxiliary rules.
- GrammarState: a set of stacks of cursors; advancing by a code point keeps
  the stacks that can consume it. Token filtering walks each candidate's
  code points; EOS is legal iff some stack is empty.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterable


@dataclass(frozen=True)
class CharItem:
    ranges: tuple[tuple[int, int], ...]
    negated: bool = False

    def matches(self, cp: int) -> bool:
        hit = any(lo <= cp <= hi for lo, hi in self.ranges)
        return (not hit) if self.negated else hit

    def matches_range(self, lo: int, hi: int) -> bool:
        """True iff SOME codepoint in [lo, hi] matches this item."""
        if not self.negated:
            return any(a <= hi and lo <= b for a, b in self.ranges)
        # negated: matches unless [lo, hi] is fully covered by the ranges
        covered = lo
        for a, b in sorted(self.ranges):
            if a > covered:
                return True
            covered = max(covered, b + 1)
            if covered > hi:
                return False
        return covered <= hi


@dataclass(frozen=True)
class RefItem:
    rule: int


Item = CharItem | RefItem
Alt = tuple[Item, ...]


@dataclass
class Grammar:
    rules: list[list[Alt]]
    root: int
    names: dict[str, int] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# parser
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, text: str):
        self.text = text
        self.pos = 0
        self.names: dict[str, int] = {}
        self.rules: list[list[Alt] | None] = []

    # -- low-level ---------------------------------------------------------
    def error(self, msg: str):
        line = self.text.count("\n", 0, self.pos) + 1
        raise ValueError(f"GBNF parse error at line {line}: {msg}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_ws(self, newlines: bool = False):
        while self.pos < len(self.text):
            ch = self.text[self.pos]
            if ch == "#":  # comment to end of line
                while self.pos < len(self.text) and self.text[self.pos] != "\n":
                    self.pos += 1
            elif ch in " \t" or (newlines and ch in "\r\n"):
                self.pos += 1
            else:
                break

    def rule_id(self, name: str) -> int:
        if name not in self.names:
            self.names[name] = len(self.rules)
            self.rules.append(None)
        return self.names[name]

    def add_rule(self, rid: int, alts: list[Alt]):
        self.rules[rid] = alts

    def new_aux(self, alts: list[Alt]) -> int:
        rid = len(self.rules)
        self.rules.append(alts)
        return rid

    # -- grammar pieces ----------------------------------------------------
    def parse_char(self) -> int:
        ch = self.peek()
        if ch == "\\":
            self.pos += 1
            esc = self.peek()
            self.pos += 1
            if esc == "x":
                v = int(self.text[self.pos:self.pos + 2], 16)
                self.pos += 2
                return v
            if esc == "u":
                v = int(self.text[self.pos:self.pos + 4], 16)
                self.pos += 4
                return v
            if esc == "U":
                v = int(self.text[self.pos:self.pos + 8], 16)
                self.pos += 8
                return v
            table = {"t": 9, "r": 13, "n": 10, "\\": 92, '"': 34, "[": 91, "]": 93}
            if esc in table:
                return table[esc]
            self.error(f"unknown escape \\{esc}")
        if not ch:
            self.error("unexpected end of input")
        self.pos += 1
        return ord(ch)

    def parse_name(self) -> str:
        start = self.pos
        while self.peek().isalnum() or self.peek() in "-_":
            self.pos += 1
        if start == self.pos:
            self.error("expected rule name")
        return self.text[start:self.pos]

    def parse_sequence(self, rule_name: str) -> Alt:
        items: list[Item] = []
        last_start = 0  # start of the unit a repetition suffix applies to
        while True:
            self.skip_ws()
            ch = self.peek()
            last_start = len(items)
            if ch == '"':  # literal string
                self.pos += 1
                while self.peek() != '"':
                    cp = self.parse_char()
                    items.append(CharItem(((cp, cp),)))
                self.pos += 1
            elif ch == "[":  # char class
                self.pos += 1
                negated = self.peek() == "^"
                if negated:
                    self.pos += 1
                ranges: list[tuple[int, int]] = []
                while self.peek() != "]":
                    lo = self.parse_char()
                    if self.peek() == "-" and self.text[self.pos + 1:self.pos + 2] != "]":
                        self.pos += 1
                        hi = self.parse_char()
                        ranges.append((lo, hi))
                    else:
                        ranges.append((lo, lo))
                self.pos += 1
                items.append(CharItem(tuple(ranges), negated))
            elif ch == "(":  # group -> aux rule
                self.pos += 1
                rid = self.new_aux([])
                alts = self.parse_alternates(rule_name, inner=True)
                self.rules[rid] = alts
                if self.peek() != ")":
                    self.error("expected )")
                self.pos += 1
                items.append(RefItem(rid))
            elif ch == ".":  # any char
                self.pos += 1
                items.append(CharItem(((0, 0x10FFFF),)))
            elif ch and (ch.isalnum() or ch in "-_"):
                name = self.parse_name()
                items.append(RefItem(self.rule_id(name)))
            else:
                break

            # repetition suffix
            self.skip_ws()
            rep = self.peek()
            if rep and rep in "*+?{":
                unit = items[last_start:]
                if not unit:
                    self.error("repetition with no preceding item")
                del items[last_start:]
                # repetition applies to the whole preceding unit (string
                # literal / class / group / ref), like the reference parser's
                # last_sym_start tracking (src/llama-grammar.cpp parser)
                if len(unit) == 1:
                    last: Item = unit[0]
                else:
                    last = RefItem(self.new_aux([tuple(unit)]))
                if rep == "{":
                    self.pos += 1
                    self.skip_ws()
                    start = self.pos
                    while self.peek().isdigit():
                        self.pos += 1
                    mn = int(self.text[start:self.pos] or 0)
                    mx = -1
                    self.skip_ws()
                    if self.peek() == ",":
                        self.pos += 1
                        self.skip_ws()
                        start = self.pos
                        while self.peek().isdigit():
                            self.pos += 1
                        mx = int(self.text[start:self.pos]) if self.pos > start else -1
                    else:
                        mx = mn
                    if self.peek() != "}":
                        self.error("expected }")
                    self.pos += 1
                else:
                    self.pos += 1
                    mn, mx = {"*": (0, -1), "+": (1, -1), "?": (0, 1)}[rep]
                items.extend(self._repeat(last, mn, mx))
        return tuple(items)

    def _repeat(self, item: Item, mn: int, mx: int) -> list[Item]:
        """Desugar item{mn,mx} (mx=-1 => unbounded) into items + aux rules."""
        out: list[Item] = [item] * mn
        if mx < 0:
            # rest: R ::= item R | ε
            rid = self.new_aux([])
            self.rules[rid] = [(item, RefItem(rid)), ()]
            out.append(RefItem(rid))
        elif mx > mn:
            # chain of optionals: O_k ::= item O_{k-1} | ε
            prev: int | None = None
            for _ in range(mx - mn):
                rid = self.new_aux([])
                alt: tuple[Item, ...] = (item,) + ((RefItem(prev),) if prev is not None else ())
                self.rules[rid] = [alt, ()]
                prev = rid
            out.append(RefItem(prev))
        return out

    def parse_alternates(self, rule_name: str, inner: bool = False) -> list[Alt]:
        alts = [self.parse_sequence(rule_name)]
        while True:
            self.skip_ws(newlines=inner)
            if self.peek() == "|":
                self.pos += 1
                self.skip_ws(newlines=True)
                alts.append(self.parse_sequence(rule_name))
            else:
                break
        return alts

    def parse(self) -> Grammar:
        self.skip_ws(newlines=True)
        while self.pos < len(self.text):
            name = self.parse_name()
            self.skip_ws()
            if self.text[self.pos:self.pos + 3] != "::=":
                self.error("expected ::=")
            self.pos += 3
            self.skip_ws(newlines=False)
            rid = self.rule_id(name)
            alts = self.parse_alternates(name)
            self.add_rule(rid, alts)
            self.skip_ws(newlines=True)
        if "root" not in self.names:
            raise ValueError("GBNF grammar must define a 'root' rule")
        for i, r in enumerate(self.rules):
            if r is None:
                name = next(n for n, j in self.names.items() if j == i)
                raise ValueError(f"GBNF rule '{name}' referenced but never defined")
        return Grammar(rules=self.rules, root=self.names["root"], names=dict(self.names))


def parse(text: str) -> Grammar:
    return _Parser(text).parse()


# ---------------------------------------------------------------------------
# pushdown automaton
# ---------------------------------------------------------------------------

Cursor = tuple[int, int, int]  # (rule, alt, idx)
Stack = tuple[Cursor, ...]


class GrammarState:
    """Set of pushdown stacks + partial-UTF8 byte state (for byte-fallback
    tokens that end mid-codepoint)."""

    def __init__(self, grammar: Grammar, stacks: frozenset[Stack] | None = None,
                 partial: tuple[int, int, int] = (0, 0, 0)):
        self.g = grammar
        if stacks is None:
            init: set[Stack] = set()
            for ai in range(len(grammar.rules[grammar.root])):
                self._normalize(((grammar.root, ai, 0),), init)
            stacks = frozenset(init)
        self.stacks = stacks
        self.partial = partial  # (value, bytes_remaining, min_codepoint)

    # -- stack mechanics ---------------------------------------------------
    def _item(self, cur: Cursor) -> Item | None:
        rule, alt, idx = cur
        seq = self.g.rules[rule][alt]
        return seq[idx] if idx < len(seq) else None

    def _normalize(self, stack: Stack, out: set[Stack], depth: int = 0):
        """Expand rule refs / pop finished frames until top item is a terminal
        (or the stack is empty)."""
        if depth > 256:
            raise RecursionError("grammar expansion too deep (left recursion?)")
        while True:
            if not stack:
                out.add(stack)
                return
            top = stack[-1]
            item = self._item(top)
            if item is None:
                # frame finished -> pop (the parent cursor was already advanced
                # past the ref when this frame was pushed)
                stack = stack[:-1]
                continue
            if isinstance(item, RefItem):
                base = stack[:-1] + ((top[0], top[1], top[2] + 1),)
                for ai in range(len(self.g.rules[item.rule])):
                    self._normalize(base + ((item.rule, ai, 0),), out, depth + 1)
                return
            out.add(stack)  # terminal on top
            return

    def advance_codepoint(self, cp: int) -> "GrammarState | None":
        new: set[Stack] = set()
        for stack in self.stacks:
            if not stack:
                continue
            item = self._item(stack[-1])
            if isinstance(item, CharItem) and item.matches(cp):
                top = stack[-1]
                self._normalize(stack[:-1] + ((top[0], top[1], top[2] + 1),), new)
        if not new:
            return None
        return GrammarState(self.g, frozenset(new), self.partial)

    # -- byte/token interface ---------------------------------------------
    def advance_bytes(self, data: bytes) -> "GrammarState | None":
        """Feed raw UTF-8 bytes, resuming/leaving partial codepoint state.
        Overlong encodings are rejected (min codepoint per sequence length)."""
        state: GrammarState | None = self
        value, remain, min_cp = self.partial
        for b in data:
            if state is None:
                return None
            if remain > 0:
                if b & 0xC0 != 0x80:
                    return None  # invalid continuation
                value = (value << 6) | (b & 0x3F)
                remain -= 1
                if remain == 0:
                    if value < min_cp or value > 0x10FFFF:
                        return None  # overlong / out of range
                    state = state.advance_codepoint(value)
                    value = 0
                    min_cp = 0
            elif b < 0x80:
                state = state.advance_codepoint(b)
            elif b >> 5 == 0b110:
                value, remain, min_cp = b & 0x1F, 1, 0x80
            elif b >> 4 == 0b1110:
                value, remain, min_cp = b & 0x0F, 2, 0x800
            elif b >> 3 == 0b11110:
                value, remain, min_cp = b & 0x07, 3, 0x10000
            else:
                return None
        if state is None:
            return None
        if remain > 0:
            # partial codepoint: some stack top must match a completion of the
            # prefix (reference llama_grammar_match_partial_char semantics,
            # tightened with the overlong minimum)
            low = value << (remain * 6)
            high = low | ((1 << (remain * 6)) - 1)
            low = max(low, min_cp)
            if high < low:
                return None
            ok = False
            for stack in state.stacks:
                if not stack:
                    continue
                item = state._item(stack[-1])
                if isinstance(item, CharItem) and item.matches_range(low, high):
                    ok = True
                    break
            if not ok:
                return None
        return GrammarState(self.g, state.stacks, (value, remain, min_cp))

    @property
    def allows_eos(self) -> bool:
        return any(not s for s in self.stacks)

    def accepts_token_bytes(self, data: bytes) -> bool:
        return self.advance_bytes(data) is not None


class TokenFilter:
    """Vocab-level grammar mask with a per-state memo.

    Counterpart of sample_grammar + grammar_accept_token
    (gpttype_adapter.cpp:1298,1437)."""

    def __init__(self, grammar_text: str, tokenizer):
        self.grammar = parse(grammar_text)
        self.tokenizer = tokenizer
        v = tokenizer.vocab
        self.n = v.n_tokens
        self._pieces: list[bytes] = [
            tokenizer.decode_token_bytes(i, skip_special=False) for i in range(self.n)
        ]
        self._eog = [v.is_eog(i) or v.is_control(i) for i in range(self.n)]
        self._eos_ids = {i for i in range(self.n) if v.is_eog(i)}
        self.state = GrammarState(self.grammar)

    def reset(self):
        self.state = GrammarState(self.grammar)

    def mask(self, candidate_ids: Iterable[int] | None = None):
        """Boolean mask over the vocab (True = allowed)."""
        import numpy as np

        ids = range(self.n) if candidate_ids is None else candidate_ids
        out = np.zeros(self.n, dtype=bool)
        allow_eos = self.state.allows_eos
        for i in ids:
            if i in self._eos_ids:
                out[i] = allow_eos
                continue
            piece = self._pieces[i]
            if not piece:
                continue
            if self.state.accepts_token_bytes(piece):
                out[i] = True
        return out

    def accept(self, token_id: int):
        if token_id in self._eos_ids:
            return
        nxt = self.state.advance_bytes(self._pieces[token_id])
        if nxt is None:
            raise ValueError(f"grammar cannot accept token {token_id}")
        self.state = nxt
