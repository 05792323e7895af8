"""Continuous-batching engine (`--multiuser N`).

Port of koboldcpp_tpu/engine/batch_engine.py for the llama-family path: a
slot scheduler that admits requests as they arrive, prefills each into its
own KV slot, and advances ALL active sequences with one batched decode step
per tick.

  - prefill runs in <=128-token chunks as SINGLE-ROW (1, b) forwards on the
    admitted slot's cache rows (a view of them: the cache is updated in
    place), or, when several slots are prefilling, as one (n_slots, b)
    admission wave; decode ticks interleave between chunks;
  - per-slot context fast-forward and context shift (PurgeMissingTokens,
    gpttype_adapter.cpp:1504) with RoPE re-rotation of that slot's rows;
  - anti-slop rewind (gpttype_adapter.cpp:3292) with per-position bans and
    stream hold-back, per slot;
  - LLaVA (`clip_model=`): a request's images are spliced after BOS as
    IMG_SENTINEL rows of that slot (its context re-evaluated in full); an
    image slot stays out of the admission wave and prefills one row at a
    time with the embedding rows spliced in, on the slot cache and on the
    paged pool alike (the JAX paged engine drops them: ROADMAP §3);
  - greedy slots decode by a device argmax, common stochastic presets by the
    device sampler (engine/device_sampler.py); slots that need the host
    chain (grammar, DRY, XTC, mirostat, anti-slop, ...) pull their logits;
  - in the steady state of the slot cache, K = BURST_TICKS decode steps are
    queued on the card with no host sync, and their (K, B) tokens are pulled
    once; BURST_DEPTH bursts are in flight, so a pull overlaps newer bursts.

A decode step is one forward at (n_slots, 1): q4_k / q5_k projections go
to K7 (2 <= n_slots <= 8) or K3 (n_slots > 8), under KCPP_SBQ=1 to K14
(2 <= n_slots <= 16, in_f >= 2048, a K-quant file's weights), and under
KCPP_FFN_FUSED=1 a q4_k FFN of n_slots <= 8 tokens to K15a (one launch);
q6_k / q8_0 ones to K3, attention to K5 over the slot cache (B, S, H_kv*D) or
K8 over the paged pool (kv/paged.py, `paged=True`); with `quantkv=1` to K6
over the Q8 slot cache or K9 over the Q8 pool, with `quantkv=2` to the plain
path over the Q4 slot cache or K10 over the Q4 pool. Tokens a burst computes
past a slot's stop are discarded; their cache rows lie past len(context) and
stay invisible. The worker thread owns the cache and runs every forward
under `torch.inference_mode`, on the engine's device and that thread's
current CUDA stream.
"""
from __future__ import annotations

import codecs
import collections
import os
import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..grammar.gbnf import TokenFilter
from ..kv.cache import init_cache, rows as cache_rows
from ..kv.paged import PageAllocator, init_paged_cache
from ..models import llama as model_llama
from ..models.loader import Model
from ..ops.rope import rope_frequencies
from ..sampling import (SamplerParams, build_dry_sequences, make_state,
                        sample_logits)
from ..sampling.samplers import (KCPP_SAMPLER_TEMP, KCPP_SAMPLER_TOP_K,
                                 KCPP_SAMPLER_TOP_P)
from . import device_sampler
from .engine import (IMG_SENTINEL, GenParams, GenerationResult, Timings,
                     _find_stop, _kv_quant, _longest_common_run, _shift_rows,
                     antislop_check, splice_chunk, splice_images)

PREFILL_BUCKETS = (16, 32, 64, 128)
PREFILL_CHUNK = 128  # interleave granularity: decode ticks between chunks
# steady-state burst length: K decode steps queued on the card per pull,
# bounded so admits and aborts are picked up within K ticks
BURST_TICKS = int(os.environ.get("KCPP_BURST_TICKS", "16"))
# bursts in flight: the host pulls the OLDEST while the card computes the
# newer ones
BURST_DEPTH = int(os.environ.get("KCPP_BURST_DEPTH", "4"))


def _bucket(n: int) -> int:
    for b in PREFILL_BUCKETS:
        if n <= b:
            return b
    return PREFILL_BUCKETS[-1]


@dataclass
class _Request:
    prompt_tokens: list[int]
    params: GenParams
    on_token: Callable[[int, str], None] | None
    done: threading.Event = field(default_factory=threading.Event)
    result: GenerationResult = field(default_factory=GenerationResult)
    genkey: str = ""
    aborted: bool = False


@dataclass
class _Slot:
    idx: int
    request: _Request | None = None
    context: list[int] = field(default_factory=list)  # tokens in cache
    out_tokens: list[int] = field(default_factory=list)
    out_text: str = ""
    utf8: object = None  # incremental UTF-8 decoder (set on _start_request)
    sampler_state: object = None
    sampler_params: SamplerParams | None = None
    grammar: TokenFilter | None = None
    eos_ids: tuple[int, ...] = ()
    max_new: int = 0
    t_start: float = 0.0
    t_prefill_done: float = 0.0
    prompt_len: int = 0
    pending_prefill: list[int] = field(default_factory=list)
    # LLaVA: absolute position -> image embedding row (on the device)
    emb_by_pos: dict | None = None
    # final-chunk logits row left on the device by the prefill; pulled for
    # all ready slots in one transfer at the next decode tick
    pending_first: torch.Tensor | None = None
    pend_tick: int = 0  # _tick counter when pending_first was set (age cap)
    # decode state: (token, position, append_to_context) for the next step
    feed: tuple[int, int, bool] | None = None
    # anti-slop state
    antislop_bans: dict[int, set[int]] = field(default_factory=dict)
    stream_delay: int = 0
    stream_q: list = field(default_factory=list)  # (tok_index, tok, piece)
    # sampled-token budget: rewound tokens still count against max_length
    # (the reference never refunds remaining_tokens on rewind,
    # gpttype_adapter.cpp:3249,3292)
    sampled: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None

    @property
    def decoding(self) -> bool:
        return self.request is not None and self.feed is not None


class _Pull:
    """A token block copied to the host behind the work queued before it:
    `done()` polls, `result()` waits. On the card the copy goes into pinned
    memory on the current stream, so the worker never blocks to start it."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if t.is_cuda:
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def result(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


def batch_capable(cfg) -> bool:
    """The architectures the batched scheduler serves (the JAX launcher's
    `batch_capable`, cli.py:384-391, without its smartcontext and
    multi-host terms, which the port does not have)."""
    return not (cfg.is_recurrent or cfg.is_embedding or cfg.is_encoder_decoder
                or cfg.arch in ("deepseek2", "minicpm3"))


class BatchedEngine:
    """Drop-in Engine replacement with cross-request continuous batching on
    one device (default cuda; raises without a GPU unless device="cpu").
    The model's params must already live on that device. quantkv: 0 bf16
    KV, 1 Q8, 2 Q4 (slot cache, or pool when paged). pool_fraction: the
    paged pool's pages as a share of n_slots full contexts.
    use_contextshift: context shift on the slot cache (always off when
    paged or quantized). mesh: the parallel/sharding.py Mesh the model's
    params are sharded over (tensor / expert parallel: the forward runs
    on the rank's shard; data parallel: the rank holds the slots of its
    dp index, each forward runs its rows, and the logits of every slot
    are gathered over dp; a paged pool is whole on each dp index, its
    pages written only by their slot's). KCPP_BATCH_DEV_SAMPLE=0 samples
    every slot on the
    host."""

    # the device-side steps a tensor-parallel rank 0 mirrors to its
    # followers (parallel/launch.py `mirror`)
    MIRRORED_STEPS = ("_forward", "_kv_shift_slot", "_reset_cache")

    def __init__(self, model: Model, max_context: int = 2048, n_slots: int = 4,
                 paged: bool = False, page_size: int = 64, device=None,
                 quantkv: int = 0, pool_fraction: float = 1.0,
                 use_contextshift: bool = True, clip_model=None, mesh=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model params live on {model.device}, the "
                             f"engine runs on {self.device}")
        cfg = model.cfg
        if not batch_capable(cfg):
            raise NotImplementedError(
                f"continuous batching of architecture {cfg.arch!r} is not "
                "ported (the JAX launcher serves it single-sequence)")
        model_llama.check_supported(model.params, cfg, self.device)
        self.model = model
        self.clip = clip_model  # models.clip.ClipModel for LLaVA requests
        self.cfg = cfg
        self.tokenizer = model.tokenizer
        self.max_context = max_context
        self.n_slots = n_slots
        self.mesh = mesh
        # data parallel: this rank's slots [dp_lo, dp_lo + slots_local)
        self._dp = mesh.shape["dp"] if mesh is not None else 1
        if n_slots % self._dp:
            raise ValueError(f"a batch of {n_slots} slots does not divide "
                             f"over dp={self._dp}")
        self.slots_local = n_slots // self._dp
        self.dp_lo = (mesh.coords["dp"] * self.slots_local
                      if mesh is not None else 0)
        self.paged = paged
        self.quantkv = quantkv
        # context shift needs in-place row surgery on the slot cache; the
        # paged pool reuses a prefix only (fast-forward), and a quantized
        # cache has none, as upstream (koboldcpp.py:840) and in JAX
        self.use_contextshift = use_contextshift and not paged and not quantkv
        if paged:
            max_pages = -(-max_context // page_size)
            n_pages = max(1, int(n_slots * max_pages * pool_fraction))
            self.page_size = page_size
            self.allocator = PageAllocator(n_pages, page_size, max_pages)
        self.cache = self._new_cache()
        self.slots = [_Slot(idx=i) for i in range(n_slots)]
        self.queue: "queue.Queue[_Request]" = queue.Queue()
        self._admit_lock = threading.Lock()
        self.last_timings = Timings()
        self._shutdown = False
        self._wake = threading.Event()
        self._tick_no = 0
        self._pending_bursts: collections.deque = collections.deque()
        self._bias_dev = None  # (n_slots, V) device bias; None = rebuild
        self._zero_bias_dev = None  # persistent all-zero bias rows
        # per-slot device sampling state: rep-pen windows (rolled by the
        # decode step itself; rows rebuilt from slot.context when a slot's
        # context changes outside decode feeds) and knob vectors
        self._recent_W = max_context
        self._recent = torch.zeros((n_slots, max_context), dtype=torch.int64,
                                   device=self.device)
        self._count = torch.zeros(n_slots, dtype=torch.int64,
                                  device=self.device)
        self._recent_dirty: set[int] = set()
        self._dyn_rows = None  # per-slot knob vectors; None = rebuild
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int.from_bytes(os.urandom(4), "little"))
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def _new_cache(self):
        cfg = self.cfg
        if self.paged:
            return init_paged_cache(cfg.n_layers, self.allocator.n_pages,
                                    self.page_size, cfg.n_kv_heads,
                                    cfg.head_dim,
                                    quantized=_kv_quant(self.quantkv),
                                    device=self.device)
        return init_cache(cfg.n_layers, self.slots_local, self.max_context,
                          cfg.n_kv_heads, cfg.head_dim, device=self.device,
                          quantized=_kv_quant(self.quantkv))

    def _reset_cache(self):
        """A fresh cache (after a failed step; mirrored on every rank)."""
        self.cache = self._new_cache()

    # -- public API --------------------------------------------------------
    def generate(self, prompt, params: GenParams,
                 on_token: Callable[[int, str], None] | None = None,
                 genkey: str = "") -> GenerationResult:
        req = self.submit(prompt, params, on_token, genkey)
        req.done.wait()
        return req.result

    def submit(self, prompt, params: GenParams,
               on_token: Callable[[int, str], None] | None = None,
               genkey: str = "") -> _Request:
        tk = self.tokenizer
        toks = tk.encode(prompt) if isinstance(prompt, str) else list(prompt)
        if not toks:
            toks = [tk.vocab.bos_id if tk.vocab.bos_id >= 0 else 0]
        budget = max(8, self.max_context - params.max_length)
        if len(toks) > budget:
            keep = 1 if tk.vocab.add_bos else 0
            toks = toks[:keep] + toks[keep + len(toks) - budget:]
        req = _Request(prompt_tokens=toks, params=params, on_token=on_token,
                       genkey=genkey)
        self.queue.put(req)
        self._wake.set()
        return req

    def abort(self, genkey: str = ""):
        """Abort the request with this genkey, or every request when genkey
        is empty, whether it is queued or in a slot."""
        with self._admit_lock:  # no request is between the queue and a slot
            with self.queue.mutex:
                reqs = list(self.queue.queue)
            reqs += [s.request for s in self.slots if s.active]
        for r in reqs:
            if not genkey or r.genkey == genkey:
                r.aborted = True

    def token_count(self, text: str) -> list[int]:
        return self.tokenizer.encode(text)

    def reset_context(self):
        for s in self.slots:
            if not s.active:
                s.context = []

    def shutdown(self):
        self._shutdown = True
        self._wake.set()
        self._worker.join(timeout=60)

    # -- scheduler loop ----------------------------------------------------
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._shutdown:
                try:
                    self._tick()
                except Exception as e:  # noqa: BLE001
                    # a failed step must not strand waiters on req.done (the
                    # reference returns status 0 instead of crashing,
                    # gpttype_adapter.cpp:3131): fail the active requests,
                    # rebuild the cache and keep serving
                    traceback.print_exc()
                    self._fail_active(e)

    def _fail_active(self, e: Exception):
        self._pending_bursts.clear()
        for s in self.slots:
            if s.active:
                try:
                    self._finish(s, f"error: {e}")
                except Exception:  # noqa: BLE001
                    s.request.result = GenerationResult(stop_reason="error")
                    s.request.done.set()
                    s.request = None
            s.context = []
            s.feed = None
            s.pending_prefill = []
            s.pending_first = None
        try:
            if self.paged:
                self.allocator.free = list(
                    range(self.allocator.n_pages - 1, -1, -1))
                self.allocator.slot_pages = {}
            self._reset_cache()
            self._bias_dev = None
            self._dyn_rows = None
            self._recent_dirty = set(range(self.n_slots))
        except Exception:  # noqa: BLE001
            traceback.print_exc()

    def _tick(self):
        self._tick_no += 1
        self._admit()
        active = [s for s in self.slots if s.active]
        if not active:
            # pending bursts whose feeds all finished hold only overshoot
            # tokens: drop them (cache rows are invisible beyond context)
            self._pending_bursts.clear()
            self._wake.wait(timeout=0.05)
            self._wake.clear()
            return
        # one prefill chunk (one slot, or an admission wave of all of them),
        # then one decode step for every decoding slot: live slots advance
        # between a newcomer's chunks instead of stalling for its prompt
        # image slots stay out of the wave: one of them advances a chunk
        # beside it (batch_engine.py:379-387)
        prefilling = [s for s in active if s.pending_prefill]
        wave = [s for s in prefilling if not s.emb_by_pos]
        if len(wave) >= 2:
            self._prefill_wave(wave)
            rest = [s for s in prefilling if s.emb_by_pos]
            if rest:
                self._prefill_chunk(rest[0])
        elif prefilling:
            self._prefill_chunk(prefilling[0])
        if (any(s.decoding for s in self.slots)
                or any(s.active and s.pending_first is not None
                       for s in self.slots)
                or self._pending_bursts):
            self._decode_step()

    def _admit(self):
        for slot in self.slots:
            if slot.active:
                continue
            with self._admit_lock:
                try:
                    req = self.queue.get_nowait()
                except queue.Empty:
                    break
                slot.request = req
            self._start_request(slot, req)

    def _start_request(self, slot: _Slot, req: _Request):
        tk = self.tokenizer
        params = req.params
        slot.request = req
        slot.out_tokens = []
        slot.out_text = ""
        slot.utf8 = codecs.getincrementaldecoder("utf-8")(errors="replace")
        slot.t_start = time.perf_counter()
        slot.t_prefill_done = 0.0
        slot.feed = None
        slot.pending_first = None
        slot.sampled = 0
        slot.antislop_bans = {}
        slot.stream_q = []
        slot.stream_delay = 0
        slot.emb_by_pos = None
        if params.banned_phrases:
            slot.stream_delay = 3 + max(
                (len(tk.encode(p)) for p in params.banned_phrases), default=0)

        prompt = list(req.prompt_tokens)
        # LLaVA: the image-patch embeddings spliced after BOS; the slot
        # re-evaluates its whole prompt
        if params.images and self.clip is not None:
            prompt, slot.emb_by_pos = splice_images(
                self.clip, tk.vocab.add_bos, prompt, params.images)
            slot.context = []
        # per-slot context shift, then fast-forward
        if self.use_contextshift:
            self._context_shift(slot, prompt)
        n = 0
        limit = min(len(slot.context), len(prompt) - 1)
        while n < limit and slot.context[n] == prompt[n]:
            n += 1
        slot.context = slot.context[:n]
        todo = prompt[n:]
        slot.prompt_len = len(todo)
        if self.paged:
            self.allocator.trim(slot.idx, n)

        state = make_state(params.sampler.seed)
        if params.sampler.dry_multiplier > 0:
            breakers = params.dry_sequence_breakers or ["\n", ":", '"', "*"]
            state.dry_sequences = build_dry_sequences(tk, breakers)
        slot.sampler_state = state

        banned = list(params.sampler.banned_tokens)
        eos_ids = tuple(i for i in (tk.vocab.eos_id, tk.vocab.eot_id,
                                    tk.vocab.eom_id) if i is not None and i >= 0)
        if params.use_default_badwordsids:
            banned.extend(eos_ids)
        slot.sampler_params = SamplerParams(
            **{**params.sampler.__dict__, "banned_tokens": tuple(banned)})
        slot.eos_ids = eos_ids
        slot.grammar = TokenFilter(params.grammar, tk) if params.grammar else None
        slot.max_new = min(params.max_length,
                           self.max_context - len(prompt))
        slot.pending_prefill = todo
        self._bias_dev = None  # slot set changed: rebuild device bias rows
        self._dyn_rows = None
        self._recent_dirty.add(slot.idx)

    # -- context shift (per slot) -------------------------------------------
    def _context_shift(self, slot: _Slot, prompt: list[int]):
        """PurgeMissingTokens on one slot's cache rows (gpttype_adapter.cpp:
        1504): drop the scrolled-out gap, slide the reusable tail down, and
        RoPE-re-rotate the moved keys."""
        ctx = slot.context
        if not ctx or len(prompt) < 2:
            return
        p0 = 0
        lim = min(len(ctx), len(prompt))
        while p0 < lim and ctx[p0] == prompt[p0]:
            p0 += 1
        if p0 == 0 or p0 >= len(ctx):
            return
        tail_ctx = ctx[p0:]
        tail_prompt = prompt[p0:]
        best_len, ci, pi = _longest_common_run(tail_ctx, tail_prompt)
        threshold = max(96, len(tail_prompt) // 4)
        if best_len < threshold or ci == 0:
            return
        self._kv_shift_slot(slot.idx, p0, p0 + ci)
        slot.context = ctx[:p0] + ctx[p0 + ci:]
        self._recent_dirty.add(slot.idx)

    def _kv_shift_slot(self, idx: int, start: int, end: int):
        """Context-shift surgery on ONE slot's cache rows: slide and
        re-rotate (`_shift_rows`), in place; other slots are untouched
        (under data parallelism the slot's dp index does it)."""
        idx -= self.dp_lo
        if not 0 <= idx < self.slots_local:
            return
        freqs = rope_frequencies(self.cfg, self.device)
        heads = self.cache.heads
        for kl, vl in zip(self.cache.k, self.cache.v):
            S, KD = kl.shape[1:]
            k, v = _shift_rows(kl[idx].view(S, heads, KD // heads),
                               vl[idx].view(S, heads, KD // heads), start,
                               end, freqs, self.cfg.rope_type,
                               self.cfg.rope_dim, self.cfg.use_rope)
            kl[idx].copy_(k.reshape(S, KD))
            vl[idx].copy_(v.reshape(S, KD))

    # -- device helpers ------------------------------------------------------
    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor without waiting for queued work (a
        pinned staging copy on the card)."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _table(self, idx: list[int]) -> torch.Tensor:
        return self._to_dev(np.stack([self.allocator.table(i) for i in idx]))

    def _forward(self, tok: torch.Tensor, pos: torch.Tensor,
                 table: torch.Tensor | None = None, rows: int | None = None,
                 **splice) -> torch.Tensor:
        """Last-token logits (B, V) f32 of one batched forward. The output
        projection runs over the forward's B rows, as in the JAX
        `BatchedEngine`: one for a lone prefill chunk, n_slots for an
        admission wave or a decode step (so on a kind whose T=1 and T>1
        kernels round otherwise, a request's first token may depend on
        whether it prefilled alone, as there). splice: the forwards'
        input_embeds / embed_mask (an image chunk). rows: the one slot a
        single-row chunk runs on (the slot cache's rows of it as a
        one-sequence cache, written in place), or None for a forward over
        every slot. Under data parallelism each dp index runs its slots'
        rows (a single-row chunk on its slot's index, the others with
        positions -1, which write nothing) and the logits are gathered."""
        if self._dp > 1:
            return self._forward_dp(tok, pos, table, rows, splice)
        return self._forward_local(tok, pos, table, rows, splice)

    def _forward_local(self, tok, pos, table, rows, splice) -> torch.Tensor:
        cache = self.cache
        if rows is not None and not self.paged:
            cache = cache_rows(self.cache, rows)
        if self.paged:
            lg, _ = model_llama.forward_paged(
                self.model.params, self.cfg, tok, pos, cache, table,
                last_only=True, **splice)
        else:
            lg, _ = model_llama.forward(self.model.params, self.cfg, tok,
                                        pos, cache, last_only=True, **splice)
        return lg[:, -1]

    def _forward_dp(self, tok, pos, table, rows, splice) -> torch.Tensor:
        from ..parallel import comm

        lo, n = self.dp_lo, self.slots_local
        if rows is None:
            sl = slice(lo, lo + n)
            lg = self._forward_local(
                tok[sl], pos[sl], None if table is None else table[sl], None,
                {k: v[sl] for k, v in splice.items()})
            return comm.all_gather(lg, self.mesh.group("dp"), dim=0)
        own = lo <= rows < lo + n
        lg = self._forward_local(tok, pos if own else torch.full_like(pos, -1),
                                 table, rows - lo if own else 0, splice)
        lg = comm.all_gather(lg, self.mesh.group("dp"), dim=0)
        return lg[rows // n:rows // n + 1]

    # -- prefill -------------------------------------------------------------
    def _prefill_chunk(self, slot: _Slot):
        """Evaluate the next <=PREFILL_CHUNK prompt tokens of `slot` as a
        single-row forward, an image chunk's sentinel rows taking their
        embeddings (batch_engine.py:571-584; on the paged pool too). On the
        last chunk the logits row stays on the device for the next decode
        tick."""
        req = slot.request
        if req.aborted:
            slot.pending_prefill = []
            self._finish(slot, "abort")
            return
        chunk = slot.pending_prefill[:PREFILL_CHUNK]
        pos0 = len(slot.context)
        b = _bucket(len(chunk))
        pad = b - len(chunk)
        tok = np.zeros((1, b), dtype=np.int64)
        ppos = np.full((1, b), -1, dtype=np.int64)
        tok[0, pad:] = [t if t >= 0 else 0 for t in chunk]
        ppos[0, pad:] = np.arange(pos0, pos0 + len(chunk))
        splice = {}
        if slot.emb_by_pos and IMG_SENTINEL in chunk:
            emb, mask = splice_chunk(chunk, slot.emb_by_pos, pos0, b,
                                     self.device)
            splice = dict(input_embeds=emb, embed_mask=mask)
        if self.paged:
            self.allocator.ensure(slot.idx, pos0 + len(chunk))
            lg = self._forward(self._to_dev(tok), self._to_dev(ppos),
                               self._table([slot.idx]), rows=slot.idx,
                               **splice)
        else:
            # the slot's rows as a one-sequence cache: views, written in place
            lg = self._forward(self._to_dev(tok), self._to_dev(ppos),
                               rows=slot.idx, **splice)
        slot.context.extend(chunk)
        slot.pending_prefill = slot.pending_prefill[len(chunk):]
        self._recent_dirty.add(slot.idx)
        if not slot.pending_prefill:
            slot.t_prefill_done = time.perf_counter()
            slot.pending_first = lg[0]
            slot.pend_tick = self._tick_no

    def _prefill_wave(self, slots: list[_Slot]):
        """Advance EVERY prefilling slot one chunk in a single (n_slots, b)
        forward: admitting slots' chunks ride right-aligned in their rows,
        all other rows carry position -1 (no KV write; their output is
        discarded)."""
        live = []
        for s in slots:
            if s.request.aborted:
                s.pending_prefill = []
                self._finish(s, "abort")
                continue
            live.append(s)
        if not live:
            return
        chunks = {s.idx: s.pending_prefill[:PREFILL_CHUNK] for s in live}
        b = _bucket(max(len(c) for c in chunks.values()))
        B = self.n_slots
        tok = np.zeros((B, b), dtype=np.int64)
        ppos = np.full((B, b), -1, dtype=np.int64)
        for s in live:
            chunk = chunks[s.idx]
            pos0 = len(s.context)
            pad = b - len(chunk)
            tok[s.idx, pad:] = chunk
            ppos[s.idx, pad:] = np.arange(pos0, pos0 + len(chunk))
        table = None
        if self.paged:
            for s in live:
                self.allocator.ensure(s.idx, len(s.context)
                                      + len(chunks[s.idx]))
            table = self._table(list(range(B)))
        lg = self._forward(self._to_dev(tok), self._to_dev(ppos), table)
        for s in live:
            chunk = chunks[s.idx]
            s.context.extend(chunk)
            s.pending_prefill = s.pending_prefill[len(chunk):]
            self._recent_dirty.add(s.idx)
            if not s.pending_prefill:
                s.t_prefill_done = time.perf_counter()
                s.pending_first = lg[s.idx]
                s.pend_tick = self._tick_no

    # -- decode: one step and K-step bursts ----------------------------------
    def _greedy_step(self, tok, pos, table=None) -> torch.Tensor:
        """Device argmax over (logits + bias rows): (B,) ids, no host sync."""
        return torch.argmax(self._forward(tok, pos, table) + self._bias_dev,
                            dim=-1)

    def _sampled_step(self, tok, pos, roll, order_key, greedy, table=None):
        """Batched forward + device rep-pen window roll + per-slot device
        sampling. Returns ((B,) ids, (B, V) logits); host-chain slots read
        their logits row from the second."""
        lg = self._forward(tok, pos, table)
        # the fed token enters each slot's context before sampling (the
        # host chain samples over context incl. the fed token)
        rolled = torch.roll(self._recent, -1, dims=1)
        rolled[:, -1] = tok[:, 0]
        self._recent = torch.where(roll[:, None], rolled, self._recent)
        self._count = torch.where(
            roll, torch.clamp(self._count + 1, max=self._recent_W),
            self._count)
        nxt = device_sampler.sample_step_batched(
            lg, self._bias_dev, self._recent, self._count, self._gen,
            self._dyn_rows, order_key, greedy)
        return nxt, lg

    def _burst(self, tok, pos, pos_np, K: int, mode: str, order_key=(),
               first_roll=None, roll2=None, greedy=None) -> dict:
        """Queue K self-feeding decode steps (each step's tokens feed the
        next, positions advance on the device) and start the pull of their
        (K, B) tokens. Returns the un-emitted burst record."""
        if self._bias_dev is None:
            self._bias_dev = self._bias_device_rows()
        outs = []
        for k in range(K):
            if mode == "greedy":
                nxt = self._greedy_step(tok, pos)
            else:
                nxt, _ = self._sampled_step(
                    tok, pos, first_roll if k == 0 else roll2, order_key,
                    greedy)
            outs.append(nxt)
            tok = nxt[:, None]
            pos = torch.where(pos >= 0, pos + 1, pos)
        return {"K": K, "pull": _Pull(torch.stack(outs)),
                "last_tok": tok, "pos_dev": pos,
                "pos_np": np.where(pos_np >= 0, pos_np + K, pos_np)}

    def _emit_burst(self, pb: dict, all_toks: np.ndarray):
        """Host bookkeeping for a pulled (K, B) burst block: consume feeds,
        append the within-burst token chain, emit. Tokens for slots that
        finished (or whose slot went to a NEW request) earlier in the burst
        are overshoot: discarded, their cache rows are invisible beyond
        len(context)."""
        for s, r in pb["feeds"]:
            if s.request is not r:
                continue
            if s.feed is not None:
                t, p, append = s.feed
                s.feed = None
                if append:
                    s.context.append(t)
        for k in range(pb["K"]):
            for s, r in pb["feeds"]:
                if s.request is not r or not s.active:
                    continue
                if k > 0:
                    s.feed = None
                    s.context.append(int(all_toks[k - 1, s.idx]))
                if r.aborted:
                    self._finish(s, "abort")
                    continue
                if s.sampled >= s.max_new:
                    self._finish(s, "length")
                    continue
                s.sampled += 1
                self._emit_sampled(s, int(all_toks[k, s.idx]))

    def _chain_or_drain(self) -> bool:
        """Bursts are in flight (oldest first). While the steady state
        holds, keep the pipeline BURST_DEPTH deep: queue the next burst from
        the device-side token chain, then pull and emit only the OLDEST.
        When it breaks, drain everything and fall through to the normal
        tick. Returns True when the pipeline advanced (this tick's decode
        budget is spent)."""
        pbq = self._pending_bursts
        newest = pbq[-1]
        inflight = sum(pb["K"] for pb in pbq)
        # chaining survives queued admissions and interleaved prefills: the
        # card runs in stream order, prefill writes touch only rows outside
        # the burst feed set, and a newcomer joins by breaking the chain
        # when its first feed appears (feed-set equality below)
        can = (all(s.request is r and not r.aborted
                   for s, r in newest["feeds"])
               and not any(s.pending_first is not None
                           for s in self.slots if s.active)
               and {s.idx for s, _ in newest["feeds"]}
               == {s.idx for s in self.slots if s.decoding})
        K_next = 0
        if can:
            # steady state chains full BURST_TICKS links; while admissions
            # or prefills interleave the chain drops to single steps so
            # newcomers join within one tick of their first feed
            steady = (self.queue.empty()
                      and not any(s.pending_prefill
                                  for s in self.slots if s.active))
            K_next = BURST_TICKS if steady else 1
            if (int(newest["pos_np"].max()) + K_next >= self.max_context
                    or all(s.sampled + inflight >= s.max_new
                           for s, _ in newest["feeds"])):
                K_next = 0  # near the cap / everyone done: drain
        if K_next >= 1:
            pb = newest
            if pb["mode"] == "stoch" and self._dyn_rows is None:
                self._dyn_rows = self._make_dyn_rows()
            new = self._burst(pb["last_tok"], pb["pos_dev"], pb["pos_np"],
                              K_next, pb["mode"], pb.get("order_key", ()),
                              pb.get("roll2"), pb.get("roll2"),
                              pb.get("greedy_mask"))
            for key in ("mode", "feeds", "order_key", "roll2", "greedy_mask"):
                if key in pb:
                    new[key] = pb[key]
            pbq.append(new)
            if len(pbq) > BURST_DEPTH:
                old = pbq.popleft()
                self._emit_burst(old, old["pull"].result())
            return True
        while pbq:
            old = pbq.popleft()
            self._emit_burst(old, old["pull"].result())
        return False

    def _decode_step(self):
        pbq = self._pending_bursts
        # non-blocking emits: any burst whose tokens already landed
        while pbq and pbq[0]["pull"].done():
            pb0 = pbq.popleft()
            self._emit_burst(pb0, pb0["pull"].result())
        pend = [s for s in self.slots
                if s.active and s.pending_first is not None]
        if pend and (not any(s.pending_prefill for s in self.slots
                             if s.active)
                     or self._tick_no - min(s.pend_tick for s in pend) >= 2):
            # ONE transfer for every freshly prefilled slot's logits row;
            # while more prefills are pending (and the oldest row is < 2
            # ticks old) the pull waits so a wave of admissions shares it
            rows = torch.stack([s.pending_first for s in pend]).float()
            rows = rows.cpu().numpy()
            for i, s in enumerate(pend):
                s.pending_first = None
                self._sample_and_emit(s, rows[i])
        if pbq and self._chain_or_drain():
            return  # chained: this tick's decode budget is spent
        tok = np.zeros((self.n_slots, 1), dtype=np.int64)
        pos = np.full((self.n_slots, 1), -1, dtype=np.int64)
        feeds: list[_Slot] = []
        for s in self.slots:
            if s.decoding:
                t, p, _append = s.feed
                tok[s.idx, 0] = t
                pos[s.idx, 0] = p
                feeds.append(s)
                if self.paged:
                    self.allocator.ensure(s.idx, p + 1)
        if not feeds:
            return  # nothing to decode: no all-dead-rows forward
        table = self._table(list(range(self.n_slots))) if self.paged else None
        no_prefill = not any(s.pending_prefill for s in self.slots if s.active)
        if self._bias_dev is None:
            self._bias_dev = self._bias_device_rows()
        if all(self._slot_greedy_ok(s) for s in feeds):
            # device argmax: B ids cross to the host, no host sampler. In the
            # steady state of the slot cache, a K-step burst
            K = 1
            if (not self.paged and no_prefill and self.queue.empty()
                    and any(s.max_new - s.sampled > 1 for s in feeds)):
                K = BURST_TICKS
                if int(pos.max()) + K >= self.max_context:
                    K = 1
            if self.paged:
                toks = self._greedy_step(self._to_dev(tok), self._to_dev(pos),
                                         table).cpu().numpy()
                self._emit_step(feeds, toks)
                return
            # K == 1 (prefills interleaving / queue busy) still pipelines
            self._pending_bursts.append({
                "mode": "greedy", "feeds": [(s, s.request) for s in feeds],
                **self._burst(self._to_dev(tok), self._to_dev(pos), pos, K,
                              "greedy")})
            return

        # per-slot device sampling: slots whose preset the device chain
        # covers (greedy or common stochastic) sample on the device; only
        # host-chain slots pull their (V,) logits row
        order_key = self._stoch_order_key(feeds)
        dev_idx = {s.idx for s in feeds
                   if self._slot_greedy_ok(s)
                   or self._slot_stoch_ok(s, order_key)}
        host_slots = [s for s in feeds if s.idx not in dev_idx]
        if dev_idx:
            self._sync_recent()
            if self._dyn_rows is None:
                self._dyn_rows = self._make_dyn_rows()
            greedy = self._to_dev(np.array(
                [s.idx not in dev_idx or self._slot_greedy_ok(s)
                 for s in self.slots], bool))
            roll = self._to_dev(np.array(
                [s.decoding and s.feed[2] for s in self.slots], bool))
            if (not host_slots and not self.paged and no_prefill
                    and self.queue.empty()
                    and any(s.max_new - s.sampled > 1 for s in feeds)
                    and int(pos.max()) + BURST_TICKS < self.max_context):
                roll2 = self._to_dev(np.array(
                    [s.decoding for s in self.slots], bool))
                self._pending_bursts.append({
                    "mode": "stoch", "order_key": order_key, "roll2": roll2,
                    "greedy_mask": greedy,
                    "feeds": [(s, s.request) for s in feeds],
                    **self._burst(self._to_dev(tok), self._to_dev(pos), pos,
                                  BURST_TICKS, "stoch", order_key, roll,
                                  roll2, greedy)})
                return
            nxt, lg = self._sampled_step(self._to_dev(tok), self._to_dev(pos),
                                         roll, order_key, greedy, table)
            toks = nxt.cpu().numpy()
            host_rows = {}
            if host_slots:
                rows = lg[[s.idx for s in host_slots]].cpu().numpy()
                host_rows = {s.idx: rows[i] for i, s in enumerate(host_slots)}
            for s in feeds:
                if s.idx in dev_idx:
                    self._emit_step([s], toks)
                else:
                    self._consume_feed(s)
                    self._sample_and_emit(s, host_rows[s.idx])
            return

        # every slot on the host chain: the device rep-pen windows miss
        # these feeds
        lg = self._forward(self._to_dev(tok), self._to_dev(pos),
                           table).cpu().numpy()
        for s in feeds:
            self._recent_dirty.add(s.idx)
            self._consume_feed(s)
            self._sample_and_emit(s, lg[s.idx])

    @staticmethod
    def _consume_feed(s: _Slot):
        t, p, append = s.feed
        s.feed = None
        if append:
            s.context.append(t)

    def _emit_step(self, feeds: list[_Slot], toks: np.ndarray):
        """Bookkeeping for one synchronous device-sampled step."""
        for s in feeds:
            self._consume_feed(s)
            if s.request.aborted:
                self._finish(s, "abort")
                continue
            if s.sampled >= s.max_new:
                self._finish(s, "length")
                continue
            s.sampled += 1
            self._emit_sampled(s, int(toks[s.idx]))

    def _slot_greedy_ok(self, slot: _Slot) -> bool:
        """Token choice is a pure argmax over (logits + static bias row):
        no grammar, no anti-slop state, no order-dependent host samplers."""
        sp = slot.sampler_params
        return (slot.grammar is None
                and not slot.request.params.banned_phrases
                and not slot.antislop_bans
                and sp.temperature == 0.0 and sp.rep_pen == 1.0
                and sp.presence_penalty == 0.0 and sp.dry_multiplier == 0.0
                and sp.xtc_probability == 0.0 and sp.mirostat == 0)

    def _slot_stoch_ok(self, slot: _Slot, order_key: tuple) -> bool:
        """The device sampler covers this slot: common stochastic preset
        (temp/top-k/top-p/min-p/rep-pen/bias/ban), rep-pen leading the
        order, and the same effective stage order as this tick's chain.
        Off for every slot under KCPP_BATCH_DEV_SAMPLE=0."""
        if os.environ.get("KCPP_BATCH_DEV_SAMPLE", "1") != "1":
            return False
        sp = slot.sampler_params
        if not (slot.grammar is None
                and not slot.request.params.banned_phrases
                and not slot.antislop_bans
                and sp.temperature > 0.0 and sp.mirostat == 0
                and sp.dry_multiplier == 0.0 and sp.xtc_probability == 0.0
                and sp.top_a == 0.0 and sp.tfs >= 1.0 and sp.typical_p >= 1.0
                and sp.dynatemp_range == 0.0 and sp.smoothing_factor == 0.0):
            return False
        rep_active = sp.rep_pen != 1.0 or sp.presence_penalty != 0.0
        if not device_sampler.supported_order(sp.sampler_order, rep_active):
            return False
        return self._order_key(sp.sampler_order) == order_key

    @staticmethod
    def _order_key(order) -> tuple:
        return tuple(s for s in order if s in (
            KCPP_SAMPLER_TOP_K, KCPP_SAMPLER_TOP_P, KCPP_SAMPLER_TEMP))

    def _stoch_order_key(self, feeds) -> tuple:
        """Effective stage order for this tick's device chain: the first
        stochastic-capable feed's order (slots with another order take the
        host chain this tick); the default order if none."""
        for s in feeds:
            sp = s.sampler_params
            if sp.temperature > 0.0 and s.grammar is None:
                return self._order_key(sp.sampler_order)
        return self._order_key(SamplerParams().sampler_order)

    def _make_dyn_rows(self) -> dict:
        return device_sampler.make_dyn_rows(
            [s.sampler_params or SamplerParams() for s in self.slots],
            self.max_context, self.device)

    def _sync_recent(self):
        """Rebuild device rep-pen window rows for slots whose context changed
        outside decode feeds (start/shift/rewind/prefill/host ticks)."""
        if not self._recent_dirty:
            return
        W = self._recent_W
        for idx in sorted(self._recent_dirty):
            ctx = self.slots[idx].context
            row = np.zeros(W, np.int64)
            # an image row's sentinel -> the sampler's spare column V
            tail = [t if t >= 0 else self.cfg.vocab_size for t in ctx[-W:]]
            if tail:
                row[-len(tail):] = tail
            self._recent[idx] = self._to_dev(row)
            self._count[idx] = min(len(ctx), W)
        self._recent_dirty.clear()

    def _bias_device_rows(self) -> torch.Tensor:
        """(n_slots, V) device bias for the tick: logit biases and bans of
        the active slots. The common all-zero case reuses one buffer."""
        rows = np.zeros((self.n_slots, self.cfg.vocab_size), np.float32)
        for s in self.slots:
            if not s.active:
                continue
            sp = s.sampler_params
            for tid, bv in sp.logit_biases.items():
                if 0 <= tid < self.cfg.vocab_size:
                    rows[s.idx, tid] += np.float32(bv)
            for b in sp.banned_tokens:
                if 0 <= b < self.cfg.vocab_size:
                    rows[s.idx, b] = np.float32(-1e30)
        if not rows.any():
            if self._zero_bias_dev is None:
                self._zero_bias_dev = self._to_dev(rows)
            return self._zero_bias_dev
        return self._to_dev(rows)

    # -- emission ------------------------------------------------------------
    def _sample_and_emit(self, slot: _Slot, logits: np.ndarray):
        req = slot.request
        if req.aborted:
            self._finish(slot, "abort")
            return
        if slot.sampled >= slot.max_new:
            self._finish(slot, "length")
            return
        gmask = slot.grammar.mask() if slot.grammar is not None else None
        sp = slot.sampler_params
        pos_bans = slot.antislop_bans.get(len(slot.context))
        if pos_bans:
            sp = SamplerParams(**{
                **sp.__dict__,
                "banned_tokens": sp.banned_tokens + tuple(pos_bans)})
        tok = sample_logits(logits, slot.context, self.max_context,
                            sp, slot.sampler_state, grammar_mask=gmask)
        slot.sampled += 1
        if slot.grammar is not None:
            try:
                slot.grammar.accept(tok)
            except ValueError:
                pass
        self._emit_sampled(slot, tok)

    def _emit_sampled(self, slot: _Slot, tok: int):
        """Post-sampling bookkeeping shared by the host-sampler and device
        paths: emission, stop checks, anti-slop, next feed."""
        req = slot.request
        params = req.params
        slot.out_tokens.append(tok)
        piece = slot.utf8.decode(
            self.tokenizer.decode_token_bytes(tok, skip_special=False))
        if piece:
            slot.out_text += piece
            if slot.stream_delay:
                slot.stream_q.append((len(slot.out_tokens), tok, piece))
            elif req.on_token:
                req.on_token(tok, piece)

        if not params.bypass_eos and tok in slot.eos_ids:
            self._finish(slot, "eos")
            return
        if params.stop_sequences:
            hit = _find_stop(slot.out_text, params.stop_sequences)
            if hit is not None:
                if params.trim_stop:
                    slot.out_text = slot.out_text[:hit]
                self._finish(slot, "stop_sequence")
                return

        # anti-slop: a banned phrase appeared -> rewind this slot and ban the
        # offending token at its position (gpttype_adapter.cpp:3292-3343)
        if params.banned_phrases:
            rew = antislop_check(self.tokenizer, slot.out_text,
                                 params.banned_phrases, slot.out_tokens)
            if rew is not None:
                n_rewind, ban_tok = rew
                slot.out_tokens = slot.out_tokens[:-n_rewind]
                slot.utf8 = codecs.getincrementaldecoder("utf-8")(
                    errors="replace")
                slot.out_text = slot.utf8.decode(b"".join(
                    self.tokenizer.decode_token_bytes(t, skip_special=False)
                    for t in slot.out_tokens))
                # the just-sampled token is not in context yet, so the cache
                # rewinds one fewer slot than the output does
                slot.context = slot.context[
                    :len(slot.context) - (n_rewind - 1)]
                slot.antislop_bans.setdefault(
                    len(slot.context), set()).add(ban_tok)
                self._recent_dirty.add(slot.idx)
                slot.stream_q = [e for e in slot.stream_q
                                 if e[0] <= len(slot.out_tokens)]
                # replay: recompute logits at the rewound tail (re-evaluates
                # context[-1] at its own position; the cache row rewrite is
                # identical)
                slot.feed = (slot.context[-1], len(slot.context) - 1, False)
                return

        # emit pieces that are now beyond rewind reach
        while (slot.stream_q
               and slot.stream_q[0][0] <= len(slot.out_tokens)
               - slot.stream_delay):
            _, qt, qp = slot.stream_q.pop(0)
            if req.on_token:
                req.on_token(qt, qp)

        if slot.sampled >= slot.max_new:
            self._finish(slot, "length")
            return
        slot.feed = (tok, len(slot.context), True)

    def _finish(self, slot: _Slot, reason: str):
        req = slot.request
        for _, qt, qp in slot.stream_q:  # flush held-back pieces
            if req.on_token:
                req.on_token(qt, qp)
        slot.stream_q = []
        tail = slot.utf8.decode(b"", final=True) if slot.utf8 else ""
        if tail:  # flush trailing partial UTF-8 (lossy, like reference detok)
            slot.out_text += tail
        slot.feed = None
        slot.pending_prefill = []
        slot.pending_first = None
        now = time.perf_counter()
        t = Timings(
            prompt_tokens=slot.prompt_len,
            gen_tokens=len(slot.out_tokens),
            prompt_time=(slot.t_prefill_done or now) - slot.t_start,
            gen_time=now - (slot.t_prefill_done or now))
        req.result = GenerationResult(
            text=slot.out_text, tokens=list(slot.out_tokens),
            stop_reason=reason, timings=t)
        self.last_timings = t
        # slot.context already equals exactly the tokens present in the
        # cache (prompt + generated-and-fed), which the next request
        # fast-forwards on
        slot.request = None
        self._bias_dev = None
        self._dyn_rows = None
        req.done.set()
