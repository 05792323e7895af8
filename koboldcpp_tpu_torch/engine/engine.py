"""Generation engine: the serving hot loop (single sequence).

Port of koboldcpp_tpu/engine/engine.py, standard llama-family path:
prefill in left-padded shape buckets -> sample -> stream -> stop checks,
with kobold's KV-reuse tricks:
  - context fast-forward (longest common prefix with the cached context)
  - context shift (drop a scrolled-out gap from the cache and re-rotate the
    keys that slide down)
  - anti-slop rewind (banned phrases)

Greedy requests without host-side logit modifiers decode FAST_DECODE_K
tokens per device chunk: argmax feeds the next step on the device and the
host pulls each chunk's tokens with one sync. Everything else samples on
the host through the `sampling` module. The KV cache is updated in place.
"""
from __future__ import annotations

import codecs
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..grammar.gbnf import TokenFilter
from ..kv.cache import init_cache
from ..models import llama as model_llama
from ..models.loader import Model
from ..ops.rope import rope_frequencies, rotate
from ..sampling import (SamplerParams, build_dry_sequences, make_state,
                        sample_logits)

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)
# Tokens per device chunk on the greedy fast path: one host sync per chunk.
# Overshoot past a stop condition is computed and discarded.
FAST_DECODE_K = 32
PIPELINE_DEPTH = 2  # chunks in flight: the pull of one overlaps the next


@dataclass
class GenParams:
    """Per-request generation controls."""

    max_length: int = 128
    sampler: SamplerParams = field(default_factory=SamplerParams)
    stop_sequences: list[str] = field(default_factory=list)
    grammar: str = ""
    grammar_retain_state: bool = False
    use_default_badwordsids: bool = False  # ban EOS
    banned_phrases: list[str] = field(default_factory=list)  # anti-slop
    dry_sequence_breakers: list[str] = field(default_factory=list)
    trim_stop: bool = True
    bypass_eos: bool = False
    images: list[str] = field(default_factory=list)  # LLaVA (not ported)


@dataclass
class Timings:
    prompt_tokens: int = 0
    gen_tokens: int = 0
    prompt_time: float = 0.0
    gen_time: float = 0.0

    @property
    def prompt_tps(self) -> float:
        return self.prompt_tokens / self.prompt_time if self.prompt_time > 0 else 0.0

    @property
    def gen_tps(self) -> float:
        return self.gen_tokens / self.gen_time if self.gen_time > 0 else 0.0


@dataclass
class GenerationResult:
    text: str = ""
    tokens: list[int] = field(default_factory=list)
    stop_reason: str = "length"  # length | eos | stop_sequence | abort
    timings: Timings = field(default_factory=Timings)


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


class Engine:
    """Single-sequence serving engine on one device (default cuda; raises
    without a GPU unless device="cpu"). The model's params must already
    live on that device."""

    def __init__(self, model: Model, max_context: int = 2048, device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model params live on {model.device}, the "
                             f"engine runs on {self.device}")
        cfg = model.cfg
        if cfg.is_recurrent or cfg.is_embedding or cfg.is_encoder_decoder \
                or cfg.arch in ("deepseek2", "minicpm3"):
            raise NotImplementedError(
                f"architecture {cfg.arch!r} is not ported yet")
        model_llama.check_supported(model.params, cfg, self.device)
        self.model = model
        self.cfg = cfg
        self.tokenizer = model.tokenizer
        self.max_context = max_context
        self.use_flash_prefill = False  # K4 comes with the next slice
        self.cache = init_cache(cfg.n_layers, 1, max_context, cfg.n_kv_heads,
                                cfg.head_dim, device=self.device)
        self.context_tokens: list[int] = []  # tokens currently in the cache
        self.abort_event = threading.Event()
        self.lock = threading.Lock()  # one generation at a time
        self._grammar_cache: tuple[str, TokenFilter] | None = None
        self.last_timings = Timings()
        self.total_gens = 0
        self.stream_tokens: list[str] = []  # streaming state (polling API)
        self.generation_finished = True

    # -- low-level steps ---------------------------------------------------
    def _forward(self, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            logits, _ = model_llama.forward(self.model.params, self.cfg, tok,
                                            pos, self.cache, last_only=True)
        return logits

    def _eval_chunk(self, tokens: list[int], start_pos: int) -> torch.Tensor:
        """Evaluate tokens at positions [start_pos, ...), left-padded to a
        bucket (padding rows get position -1 and write nothing); returns the
        last token's logits (1-D f32 tensor on the engine's device). A single
        token pads to 16 rows too, as in the JAX engine: a row's logits do
        not depend on the rows beside it, so a fast-forwarded request
        re-evaluates its last prompt token bit-identically."""
        n = len(tokens)
        pad = _bucket(n) - n
        tok = torch.tensor([[0] * pad + list(tokens)], dtype=torch.int64,
                           device=self.device)
        pos = torch.tensor([[-1] * pad + list(range(start_pos, start_pos + n))],
                           dtype=torch.int64, device=self.device)
        return self._forward(tok, pos)[0, -1]

    def eval_tokens(self, tokens: list[int], start_pos: int) -> torch.Tensor:
        """Chunked prefill (n_batch equivalent); returns logits of the last
        token."""
        logits = None
        pos = start_pos
        for i in range(0, len(tokens), PREFILL_BUCKETS[-1]):
            chunk = tokens[i:i + PREFILL_BUCKETS[-1]]
            logits = self._eval_chunk(chunk, pos)
            pos += len(chunk)
        return logits

    def _greedy_chunk(self, logits: torch.Tensor, start_pos: int,
                      ban_mask: torch.Tensor):
        """FAST_DECODE_K greedy tokens: argmax feeds the next step on the
        device; nothing here waits for the device. Returns (tokens (K,)
        tensor, logits after the last token)."""
        toks = torch.empty(FAST_DECODE_K, dtype=torch.int64,
                           device=self.device)
        for i in range(FAST_DECODE_K):
            nxt = torch.argmax(logits + ban_mask)
            toks[i] = nxt
            pos = torch.full((1, 1), start_pos + i, dtype=torch.int64,
                             device=self.device)
            logits = self._forward(nxt.view(1, 1), pos)[0, -1]
        return toks, logits

    # -- context reuse -----------------------------------------------------
    def _fast_forward(self, prompt: list[int]) -> int:
        """Longest common prefix with the cached context. Returns n_past.
        Always re-evaluates >= 1 token."""
        n = 0
        limit = min(len(self.context_tokens), len(prompt) - 1)
        while n < limit and self.context_tokens[n] == prompt[n]:
            n += 1
        return n

    def _context_shift(self, prompt: list[int]) -> list[int] | None:
        """When the history scrolled (chat trimmed at the top), drop the gap
        from the cache and re-rotate the shifted keys instead of
        re-evaluating everything. Returns None when not applicable."""
        ctx = self.context_tokens
        if not ctx or len(prompt) < 2:
            return None
        p0 = 0
        lim = min(len(ctx), len(prompt))
        while p0 < lim and ctx[p0] == prompt[p0]:
            p0 += 1
        if p0 == 0 or p0 >= len(ctx):
            return None
        tail_ctx = ctx[p0:]
        tail_prompt = prompt[p0:]
        best_len, ci, pi = _longest_common_run(tail_ctx, tail_prompt)
        threshold = max(96, len(tail_prompt) // 4)
        if best_len < threshold or ci == 0:
            return None
        self._kv_remove_shift(p0, p0 + ci)
        self.context_tokens = ctx[:p0] + ctx[p0 + ci:]
        return prompt

    def _kv_remove_shift(self, start: int, end: int):
        """Delete cache slots [start, end) and slide later slots down,
        re-rotating K by the position delta, in place."""
        freqs = rope_frequencies(self.cfg, self.device)
        heads = self.cache.heads
        with torch.inference_mode():
            for kl, vl in zip(self.cache.k, self.cache.v):
                B, S, KD = kl.shape
                k, v = _shift_rows(kl.view(B, S, heads, KD // heads),
                                   vl.view(B, S, heads, KD // heads),
                                   start, end, freqs, self.cfg.rope_type,
                                   self.cfg.rope_dim)
                kl.copy_(k.reshape(B, S, KD))
                vl.copy_(v.reshape(B, S, KD))

    def _fast_greedy_ok(self, params: GenParams, grammar) -> bool:
        """Device-side greedy chunks match the host loop only when no
        logit-modifying host sampler is active; token bans ride an
        on-device additive mask."""
        sp = params.sampler
        return (grammar is None and not params.banned_phrases
                and sp.temperature == 0.0 and sp.rep_pen == 1.0
                and sp.presence_penalty == 0.0 and sp.dry_multiplier == 0.0
                and not sp.logit_biases and sp.xtc_probability == 0.0
                and sp.mirostat == 0)

    # -- grammar -----------------------------------------------------------
    def _get_grammar(self, params: GenParams) -> TokenFilter | None:
        if not params.grammar:
            return None
        if (params.grammar_retain_state and self._grammar_cache
                and self._grammar_cache[0] == params.grammar):
            return self._grammar_cache[1]
        tf = TokenFilter(params.grammar, self.tokenizer)
        self._grammar_cache = (params.grammar, tf)
        return tf

    # -- main entry --------------------------------------------------------
    def abort(self):
        self.abort_event.set()

    def generate(self, prompt: str | list[int], params: GenParams,
                 on_token: Callable[[int, str], None] | None = None
                 ) -> GenerationResult:
        with self.lock:
            return self._generate_locked(prompt, params, on_token)

    def _generate_locked(self, prompt, params, on_token) -> GenerationResult:
        if params.images:
            raise NotImplementedError("LLaVA image input is not ported yet")
        self.abort_event.clear()
        self.generation_finished = False
        self.stream_tokens = []
        tk = self.tokenizer
        result = GenerationResult()
        t0 = time.perf_counter()

        prompt_tokens = tk.encode(prompt) if isinstance(prompt, str) \
            else list(prompt)
        if not prompt_tokens:
            prompt_tokens = [tk.vocab.bos_id if tk.vocab.bos_id >= 0 else 0]
        # clamp to the context window, keeping the tail
        budget = max(8, self.max_context - params.max_length)
        if len(prompt_tokens) > budget:
            keep_first = 1 if tk.vocab.add_bos else 0
            overflow = len(prompt_tokens) - budget
            prompt_tokens = (prompt_tokens[:keep_first]
                             + prompt_tokens[keep_first + overflow:])

        self._context_shift(prompt_tokens)
        n_past = self._fast_forward(prompt_tokens)
        self.context_tokens = self.context_tokens[:n_past]
        todo = prompt_tokens[n_past:]

        grammar = self._get_grammar(params)
        if grammar is not None and not params.grammar_retain_state:
            grammar.reset()

        state = make_state(params.sampler.seed)
        if params.sampler.dry_multiplier > 0:
            breakers = params.dry_sequence_breakers or ["\n", ":", '"', "*"]
            state.dry_sequences = build_dry_sequences(tk, breakers)

        sampler = params.sampler
        eos_ids = [i for i in (tk.vocab.eos_id, tk.vocab.eot_id, tk.vocab.eom_id)
                   if i is not None and i >= 0]
        banned = list(sampler.banned_tokens)
        if params.use_default_badwordsids:
            banned.extend(eos_ids)
        sampler_banned = tuple(banned)

        # prefill (ends in a device sync, so prompt_time is device time)
        logits = self.eval_tokens(todo, n_past)
        if logits.is_cuda:
            torch.cuda.synchronize(self.device)
        self.context_tokens.extend(todo)
        t1 = time.perf_counter()

        out_tokens: list[int] = []
        out_text = ""
        # incremental UTF-8: holds back partial sequences, emits U+FFFD for
        # invalid bytes immediately
        utf8 = codecs.getincrementaldecoder("utf-8")(errors="replace")
        stop_reason = "length"
        sp = SamplerParams(**{**sampler.__dict__, "banned_tokens": sampler_banned})
        max_len = min(params.max_length, self.max_context - len(self.context_tokens))
        # anti-slop bans are per position: rewinding to a spot bans the
        # offending token only when resampling that spot
        antislop_bans: dict[int, set[int]] = {}
        # with phrase bans, streaming lags by the longest phrase so rewound
        # text is never streamed
        stream_delay = 0
        if params.banned_phrases:
            stream_delay = 3 + max(
                (len(tk.encode(p)) for p in params.banned_phrases), default=0)
        stream_q: list[tuple[int, int, str]] = []  # (token_index, tok, piece)

        if self._fast_greedy_ok(params, grammar):
            # ---- device-side greedy chunks, PIPELINE_DEPTH in flight ----
            bias = np.zeros(self.cfg.vocab_size, np.float32)
            for b in sampler_banned:
                if 0 <= b < self.cfg.vocab_size:
                    bias[b] = np.float32(-1e30)
            ban_mask = torch.from_numpy(bias).to(self.device)
            logits_dev = logits.float()
            pending: deque = deque()
            dispatch_pos = len(self.context_tokens)
            dispatched = 0
            done = False
            while len(out_tokens) < max_len and not done:
                if self.abort_event.is_set():
                    stop_reason = "abort"
                    break
                while len(pending) < PIPELINE_DEPTH and dispatched < max_len:
                    toks, logits_dev = self._greedy_chunk(
                        logits_dev, dispatch_pos, ban_mask)
                    pending.append(toks)
                    dispatch_pos += FAST_DECODE_K
                    dispatched += FAST_DECODE_K
                for tok in pending.popleft().tolist():  # the one host sync
                    if self.abort_event.is_set():
                        stop_reason = "abort"
                        done = True
                        break
                    if len(out_tokens) >= max_len:
                        done = True
                        break
                    out_tokens.append(tok)
                    piece = utf8.decode(
                        tk.decode_token_bytes(tok, skip_special=False))
                    if piece:
                        out_text += piece
                        self.stream_tokens.append(piece)
                        if on_token:
                            on_token(tok, piece)
                    if not params.bypass_eos and tok in eos_ids:
                        stop_reason = "eos"
                        done = True
                        break
                    if params.stop_sequences:
                        hit = _find_stop(out_text, params.stop_sequences)
                        if hit is not None:
                            if params.trim_stop:
                                out_text = out_text[:hit]
                            stop_reason = "stop_sequence"
                            done = True
                            break
                    self.context_tokens.append(tok)
            # chunks past a stop wrote cache slots beyond len(context_tokens):
            # slot == position masking hides them and later tokens overwrite
            pending.clear()
            max_len = 0  # skip the host loop below

        if max_len > 0:
            logits = logits.float().cpu().numpy()
        for _ in range(max_len):
            if self.abort_event.is_set():
                stop_reason = "abort"
                break
            gmask = grammar.mask() if grammar is not None else None
            pos_bans = antislop_bans.get(len(self.context_tokens))
            sp_step = sp if not pos_bans else SamplerParams(
                **{**sp.__dict__,
                   "banned_tokens": sp.banned_tokens + tuple(pos_bans)})
            tok = sample_logits(logits, self.context_tokens, self.max_context,
                                sp_step, state, grammar_mask=gmask)
            if grammar is not None:
                try:
                    grammar.accept(tok)
                except ValueError:
                    pass
            out_tokens.append(tok)

            piece = utf8.decode(tk.decode_token_bytes(tok, skip_special=False))
            if piece:
                out_text += piece
                if stream_delay:
                    stream_q.append((len(out_tokens), tok, piece))
                else:
                    self.stream_tokens.append(piece)
                    if on_token:
                        on_token(tok, piece)

            if not params.bypass_eos and tok in eos_ids:
                stop_reason = "eos"
                break
            if params.stop_sequences:
                hit = _find_stop(out_text, params.stop_sequences)
                if hit is not None:
                    if params.trim_stop:
                        out_text = out_text[:hit]
                    stop_reason = "stop_sequence"
                    break

            # anti-slop: a banned phrase appeared -> rewind and ban its token
            if params.banned_phrases:
                rew = antislop_check(tk, out_text, params.banned_phrases,
                                     out_tokens)
                if rew is not None:
                    n_rewind, ban_tok = rew
                    out_tokens = out_tokens[:-n_rewind]
                    utf8 = codecs.getincrementaldecoder("utf-8")(errors="replace")
                    out_text = utf8.decode(b"".join(
                        tk.decode_token_bytes(t, skip_special=False)
                        for t in out_tokens))
                    # the just-sampled token is not in context yet, so the
                    # cache rewinds one fewer slot than the output does
                    self.context_tokens = self.context_tokens[
                        :len(self.context_tokens) - (n_rewind - 1)]
                    antislop_bans.setdefault(
                        len(self.context_tokens), set()).add(ban_tok)
                    stream_q = [e for e in stream_q if e[0] <= len(out_tokens)]
                    logits = self._replay_logits()
                    continue

            # emit pieces that are now beyond rewind reach
            while stream_q and stream_q[0][0] <= len(out_tokens) - stream_delay:
                _, qt, qp = stream_q.pop(0)
                self.stream_tokens.append(qp)
                if on_token:
                    on_token(qt, qp)

            logits = self._eval_chunk([tok], len(self.context_tokens)
                                      ).float().cpu().numpy()
            self.context_tokens.append(tok)

        for _, qt, qp in stream_q:  # flush held-back pieces
            self.stream_tokens.append(qp)
            if on_token:
                on_token(qt, qp)
        out_text += utf8.decode(b"", final=True)

        t2 = time.perf_counter()
        self.last_timings = Timings(
            prompt_tokens=len(todo), gen_tokens=len(out_tokens),
            prompt_time=t1 - t0, gen_time=t2 - t1)
        self.total_gens += 1
        self.generation_finished = True

        result.text = out_text
        result.tokens = out_tokens
        result.stop_reason = stop_reason
        result.timings = self.last_timings
        return result

    def _replay_logits(self) -> np.ndarray:
        """Recompute logits at the current context tail (after a rewind)."""
        last = self.context_tokens[-1]
        return self._eval_chunk([last], len(self.context_tokens) - 1
                                ).float().cpu().numpy()

    # -- utility API -------------------------------------------------------
    def token_count(self, text: str) -> list[int]:
        return self.tokenizer.encode(text)

    def reset_context(self):
        self.context_tokens = []


def antislop_check(tk, text: str, phrases: list[str],
                   out_tokens: list[int]) -> tuple[int, int] | None:
    """Walk generated tokens from the end, accumulating text, until the
    banned phrase is covered; rewind that many tokens and ban the first."""
    low = text.lower()
    for ph in phrases:
        pl = ph.lower()
        if pl not in low:
            continue
        tail = b""
        for n in range(len(out_tokens) - 1, -1, -1):
            tail = tk.decode_token_bytes(out_tokens[n],
                                         skip_special=False) + tail
            if pl in tail.decode("utf-8", errors="ignore").lower():
                return len(out_tokens) - n, out_tokens[n]
    return None


def _find_stop(text: str, stops: list[str]) -> int | None:
    from ..utils.native import find_first_stop

    return find_first_stop(text, stops)


def _longest_common_run(a: list[int], b: list[int]) -> tuple[int, int, int]:
    """Longest run of consecutive equal tokens; returns (length, start_in_a,
    start_in_b)."""
    from ..utils.native import longest_common_run

    return longest_common_run(a, b)


def _shift_rows(kl: torch.Tensor, vl: torch.Tensor, start: int, end: int,
                freqs: torch.Tensor, rope_type: str, rot_dim: int):
    """Context-shift math on one layer's (..., S, H, D) k/v pair: slide slots
    [end, ...) down to start and RoPE-re-rotate the moved K rows by -delta.
    Returns new tensors (the caller copies them into the cache)."""
    delta = end - start
    S = kl.shape[-3]
    idx = torch.arange(S, device=kl.device)
    src = torch.clamp(torch.where(idx >= start, idx + delta, idx), max=S - 1)
    k = torch.index_select(kl, kl.dim() - 3, src)
    v = torch.index_select(vl, vl.dim() - 3, src)
    angle = -delta * freqs  # (rot/2,)
    k_rot = rotate(k.float(), torch.cos(angle), torch.sin(angle), rope_type,
                   rot_dim or kl.shape[-1])
    moved = (idx >= start)[:, None, None]
    return torch.where(moved, k_rot.to(kl.dtype), k), v
