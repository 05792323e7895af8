"""Generation engine: the serving hot loop (single sequence).

Port of koboldcpp_tpu/engine/engine.py, standard llama-family path:
prefill in left-padded shape buckets (on the card, a chunk of >= 128 rows
from position 0 is padded at its end and runs flash prefill, K4) -> sample
-> stream -> stop checks, with kobold's KV-reuse tricks:
  - context fast-forward (longest common prefix with the cached context)
  - context shift (drop a scrolled-out gap from the cache and re-rotate the
    keys that slide down; off under a quantized KV cache, as upstream)
  - or legacy smart context (`use_smartcontext`: halve a diverging prompt
    and reuse the kept half later; turns context shift off)
  - anti-slop rewind (banned phrases)
The KV cache is bf16, or Q8 / Q4 with `quantkv=1|2` (`--quantkv`);
`save_state` / `load_state` write and read the bf16 cache in the JAX
engine's npz layout.

DeepSeek-V2 / MiniCPM3 (MLA, models/deepseek2.py) take the JAX engine's
branch for them: the stacked MLA cache (`deepseek2.init_cache`, bf16
whatever `quantkv` says, as the JAX engine builds it in its cache dtype),
no context shift, smart context or flash prefill, fast-forward kept, and
every token of a reply through the host loop (the JAX engine's `_std_path`
is False there, so no device chunk). The host loop's decode step
evaluates its token as one row (T = 1) where the JAX engine pads it to a
16-row chunk: the function is the same (a pad row writes nothing and no
row reads another's output), and the pad rows would take their own
experts through every MoE layer. Prompt chunks stay padded, so a
fast-forwarded request re-evaluates its last prompt token in the rows it
had.

The other architectures take the JAX engine's branches too, each token
of a reply through the host loop and the decode step one row:
  - recurrent (mamba, rwkv6, rwkv4: kv/recurrent.py's f32 states in place
    of a KV cache): prompt chunks right-padded to a bucket (padding rows
    keep the state; the recurrences stop after the last valid row), no
    context shift or smart context, a cached state reused only when the
    prompt extends the whole cached context (the reference's rule for
    recurrent models; anything else resets it), a rewind re-evaluating
    the context from a reset state, and `save_state` / `load_state` with
    the JAX file's `recurrent` flag and `leaf{i}` arrays;
  - embedding models (bert, nomic-bert, jina-bert-v2, t5encoder): no
    generation; `embed` pools the encoder's states (mean, or CLS under
    pooling type 2);
  - encoder-decoder (t5): the prompt through the encoder on every
    request, a fresh decoder cache decoding from `decoder_start`, no
    fast-forward.

LLaVA (`clip_model=`, a models/clip.py ClipModel): a request's images (up
to four) are encoded on the device, their embedding rows concatenated and
spliced after BOS as IMG_SENTINEL tokens; the request re-evaluates its
whole prompt, and a prompt chunk that holds a sentinel goes left-padded
through `forward` with the rows spliced in and without flash prefill
(the JAX engine's `_eval_chunk_embeds`). Decoding after it is the usual
path. The other architectures' branches refuse images (ValueError).

Greedy requests without host-side logit modifiers, and stochastic requests
of the common preset (temperature, top-k, top-p, min-p, rep-pen, biases,
bans: `device_sampler`), decode FAST_DECODE_K tokens per device chunk:
argmax or the device sampler feeds the next step on the device and the
host pulls each chunk's tokens with one sync (KCPP_FAST_DECODE=0 turns both
off). Everything else samples on the host through the `sampling` module.
The KV cache is updated in place.
"""
from __future__ import annotations

import codecs
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from ..device import resolve_device
from ..grammar.gbnf import TokenFilter
from ..kv.cache import QuantKVCache, init_cache, stack_cache
from ..kv.recurrent import state_leaves
from ..models import deepseek2 as model_deepseek2
from ..models import llama as model_llama
from ..models.loader import Model, arch_module
from ..ops import flash_prefill
from ..ops.rope import rope_frequencies, rotate
from ..sampling import (SamplerParams, build_dry_sequences, make_state,
                        sample_logits)

PREFILL_BUCKETS = (16, 32, 64, 128, 256, 512)
# Tokens per device chunk on the greedy and stochastic fast paths: one host
# sync per chunk. Overshoot past a stop condition is computed and discarded.
FAST_DECODE_K = int(os.environ.get("KCPP_FAST_DECODE_K", "32"))
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
    images: list[str] = field(default_factory=list)  # LLaVA, base64


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


IMG_SENTINEL = -999  # context placeholder of an image-patch row


def splice_images(clip, add_bos: bool, prompt: list[int],
                  images: list[str]) -> tuple[list[int], dict]:
    """LLaVA's splice (the reference's sentinel segments,
    gpttype_adapter.cpp:3406-3475): up to four base64 images encoded by
    `clip` (models/clip.py ClipModel), their patch rows after BOS (where the
    vocabulary adds one) as IMG_SENTINEL tokens. Returns (the prompt, the
    embedding rows by absolute position, on the clip model's device)."""
    all_emb = torch.cat([clip.embed_base64(b) for b in images[:4]])
    bos = prompt[:1] if add_bos else []
    rows = {len(bos) + i: all_emb[i] for i in range(len(all_emb))}
    return bos + [IMG_SENTINEL] * len(all_emb) + prompt[len(bos):], rows


def splice_chunk(tokens: list[int], emb_by_pos: dict, start_pos: int,
                 width: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`forward`'s input_embeds (1, width, C) f32 and embed_mask (1, width)
    for a chunk of tokens at positions start_pos.., left-padded to width:
    the rows whose token is IMG_SENTINEL take their embedding rows."""
    pad = width - len(tokens)
    mask = torch.tensor([[False] * pad + [t == IMG_SENTINEL for t in tokens]],
                        device=device)
    rows = torch.stack([emb_by_pos[start_pos + j]
                        for j, t in enumerate(tokens) if t == IMG_SENTINEL])
    emb = torch.zeros((1, width, rows.shape[-1]), dtype=torch.float32,
                      device=device)
    emb[mask] = rows.float().to(device)
    return emb, mask


def _kv_quant(quantkv: int) -> int:
    """--quantkv level (0 bf16, 1 Q8, 2 Q4_0-equivalent nibbles: the
    reference's F16/Q8_0/Q4_0 ladder, gpttype_adapter.cpp:1958-1959) ->
    init_cache's `quantized` (0, 1, 4)."""
    return 4 if quantkv == 2 else quantkv


class Engine:
    """Single-sequence serving engine on one device (default cuda; raises
    without a GPU unless device="cpu"). The model's params must already
    live on that device. quantkv: 0 bf16 KV cache, 1 Q8, 2 Q4.
    use_smartcontext: legacy smart context (turns context shift off);
    use_contextshift: context shift (always off under a quantized cache).
    A deepseek2 / minicpm3 model takes the MLA branch (module docstring):
    its cache stays bf16 under any quantkv, with no context shift or smart
    context; the recurrent, embedding and encoder-decoder architectures
    take theirs, none with a KV cache of the llama kind (quantkv is not
    read). pp_mesh / sp_mesh (parallel/sharding.py Meshes of one axis,
    "pp" or "sp"): this rank's stage of a pipeline or its rows of a
    sequence-sharded context (`_parallel_branch`; a model off the
    llama-family path takes its own branch unsharded, as in JAX); a
    tensor-parallel shard needs nothing here (the model's forward reads
    params["tp"]), but its ranks make every call of `MIRRORED_STEPS`
    together (parallel/launch.py)."""

    IMG_SENTINEL = IMG_SENTINEL
    # the device-side steps a tensor-parallel rank 0 mirrors to its
    # followers (parallel/launch.py `mirror`): every call that runs the
    # sharded model or changes the rank's cache or state
    MIRRORED_STEPS = ("_forward", "_kv_remove_shift", "_encode_rows",
                      "_run_encoder", "_reset_recurrent_state")

    def __init__(self, model: Model, max_context: int = 2048, device=None,
                 quantkv: int = 0, use_smartcontext: bool = False,
                 use_contextshift: bool = True, clip_model=None,
                 pp_mesh=None, sp_mesh=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model params live on {model.device}, the "
                             f"engine runs on {self.device}")
        cfg = model.cfg
        # MLA (the JAX engine's branch, engine.py:145-154, 194-198) and the
        # recurrent, embedding and encoder-decoder ones (:120-143)
        self.mla = cfg.arch in ("deepseek2", "minicpm3")
        self.recurrent = cfg.is_recurrent
        self.embedding = cfg.is_embedding
        self.encdec = cfg.is_encoder_decoder
        self._mod = arch_module(cfg.arch) or model_llama
        # the llama-family path: device chunks, flash prefill, the KV cache
        self._std_path = self._mod is model_llama
        if not self._std_path:
            use_smartcontext = use_contextshift = False
        else:
            model_llama.check_supported(model.params, cfg, self.device)
        self.model = model
        self.clip = clip_model  # models.clip.ClipModel for LLaVA requests
        self.cfg = cfg
        self.tokenizer = model.tokenizer
        self.max_context = max_context
        self.quantkv = quantkv
        self.use_smartcontext = use_smartcontext
        self.smartcontext: list[int] = []  # the kept half of a trimmed prompt
        # a quantized cache has no context shift: upstream turns it off
        # (koboldcpp.py:840), as the JAX BatchedEngine does
        # (batch_engine.py:146-149); smart context replaces it (engine.py:111)
        self.use_contextshift = (use_contextshift and not use_smartcontext
                                 and not quantkv)
        # flash prefill (K4) on the card, as the JAX engine enables it off
        # the CPU (engine.py:311-313): K4's head shapes, no ALiBi
        self.use_flash_prefill = (self.device.type == "cuda"
                                  and self._std_path
                                  and flash_prefill.supported(cfg.head_dim)
                                  and not cfg.use_alibi)
        if self.mla:
            self.cache = model_deepseek2.init_cache(cfg, 1, max_context,
                                                    device=self.device)
        elif self.recurrent:
            self.cache = self._mod.init_state(cfg, 1, device=self.device)
        elif self.embedding or self.encdec:
            self.cache = None  # the decoder's is built per request
        else:
            self.cache = init_cache(cfg.n_layers, 1, max_context,
                                    cfg.n_kv_heads, cfg.head_dim,
                                    device=self.device,
                                    quantized=_kv_quant(quantkv))
        if not self._std_path:
            # the JAX engine takes its model branches before the pipeline
            # and sequence-parallel ones (engine.py:170-198)
            pp_mesh = sp_mesh = None
        self.pp_mesh, self.sp_mesh = pp_mesh, sp_mesh
        if pp_mesh is not None or sp_mesh is not None:
            self._parallel_branch(model, pp_mesh, sp_mesh)
        self.context_tokens: list[int] = []  # tokens currently in the cache
        self._stoch_chunks: dict[tuple, Callable] = {}
        self.abort_event = threading.Event()
        self.lock = threading.Lock()  # one generation at a time
        self._grammar_cache: tuple[str, TokenFilter] | None = None
        self.last_timings = Timings()
        self.total_gens = 0
        self.stream_tokens: list[str] = []  # streaming state (polling API)
        self.generation_finished = True

    def _parallel_branch(self, model: Model, pp_mesh, sp_mesh):
        """The JAX engine's pipeline and sequence-parallel branches
        (engine.py:199-275): the llama-family path over this rank's layer
        stage (pp_mesh: `--pipeline N`) or its rows of the context
        (sp_mesh: `--seqparallel N`), with no context shift, smart
        context, flash prefill or device chunks (the JAX engine's
        `_std_path` is False there); fast-forward still applies."""
        if self.quantkv:
            raise ValueError("pipeline and sequence parallelism serve the "
                             "llama-family path over a bf16 KV cache")
        self.use_flash_prefill = False
        self.use_contextshift = self.use_smartcontext = False
        if sp_mesh is not None:
            from ..parallel.sequence import check_sp_supported, shard_cache_sp

            check_sp_supported(self.cfg)
            self._n_sp = sp_mesh.shape["sp"]
            self.cache = shard_cache_sp(self.cache, sp_mesh)
            return
        from ..parallel.pipeline import shard_stacked_for_pp

        sparams = model_llama.stack_layers(model.params)
        if "layers_stacked" not in sparams:
            raise ValueError("pipeline serving needs homogeneous layers "
                             "(stack_layers could not stack this model)")
        model.params, self.cache = shard_stacked_for_pp(sparams, self.cache,
                                                        pp_mesh)

    # -- embeddings and the encoder --------------------------------------
    def embed(self, texts: list[str]) -> np.ndarray:
        """Pooled embeddings (n, C) f32 of each text under an embedding
        model (the JAX `embed`): the tokens (at most max_context) padded
        at the end to a bucket, the encoder's states (bert's
        `forward_embed`, t5encoder's `encode`), pooled by
        {arch}.pooling_type: CLS for 2, else the mean."""
        if not self.embedding:
            raise ValueError("loaded model is not an embedding model")
        from ..models.bert import pool

        mode = {2: "cls"}.get((self.cfg.extras or {}).get("pooling", 1),
                              "mean")
        out = []
        with self.lock, torch.inference_mode():
            for text in texts:
                ids = self.tokenizer.encode(text) or [0]
                tok, pos = self._end_padded(ids[:self.max_context])
                hidden = self._encode_rows(tok, pos)
                out.append(pool(hidden.float(), pos, mode)[0].cpu().numpy())
        return np.stack(out)

    def _encode_rows(self, tok: torch.Tensor,
                     pos: torch.Tensor) -> torch.Tensor:
        """An embedding model's hidden states of one padded text (bert's
        `forward_embed`, t5encoder's `encode`)."""
        fn = (self._mod.encode if self.cfg.arch == "t5encoder"
              else self._mod.forward_embed)
        with torch.inference_mode():
            return fn(self.model.params, self.cfg, tok, pos)

    def _end_padded(self, ids: list[int], start_pos: int = 0):
        """(tokens, positions) (1, bucket) on the device: ids at positions
        start_pos.., padded at the end with position -1 (no padding past
        the largest bucket, as in JAX)."""
        n = len(ids)
        pad = max(0, _bucket(n) - n)
        tok = torch.tensor([list(ids) + [0] * pad], dtype=torch.int64,
                           device=self.device)
        pos = torch.tensor([list(range(start_pos, start_pos + n))
                            + [-1] * pad], dtype=torch.int64,
                           device=self.device)
        return tok, pos

    def _run_encoder(self, prompt_tokens: list[int]):
        """The prompt through the encoder, and a fresh decoder cache with
        the projected cross K / V (t5.prepare_cross)."""
        tok, pos = self._end_padded(prompt_tokens)
        with torch.inference_mode():
            enc_out = self._mod.encode(self.model.params, self.cfg, tok, pos)
            cache = self._mod.init_cache(self.cfg, 1, self.max_context,
                                         tok.shape[1], device=self.device)
            self.cache = self._mod.prepare_cross(self.model.params, self.cfg,
                                                 enc_out, pos >= 0, cache)

    def _reset_recurrent_state(self):
        self.cache = self._mod.init_state(self.cfg, 1, device=self.device)

    # -- low-level steps ---------------------------------------------------
    def _forward(self, tok: torch.Tensor, pos: torch.Tensor,
                 **kw) -> torch.Tensor:
        with torch.inference_mode():
            if self.pp_mesh is not None:
                from ..parallel.pipeline import (microbatches_for,
                                                 pipeline_forward)

                M = microbatches_for(tok.shape[0], self.pp_mesh.shape["pp"])
                logits, _ = pipeline_forward(
                    self.model.params, self.cfg, tok, pos, self.cache,
                    self.pp_mesh, microbatches=M, last_only=True)
            elif self.sp_mesh is not None:
                from ..parallel.sequence import sp_forward

                logits, _ = sp_forward(self.model.params, self.cfg, tok, pos,
                                       self.cache, self.sp_mesh,
                                       last_index=kw.get("last_index"))
            else:
                logits, _ = self._mod.forward(self.model.params, self.cfg,
                                              tok, pos, self.cache, **kw)
        return logits

    def _sp_eval(self, tokens: list[int], start_pos: int) -> torch.Tensor:
        """Sequence-parallel evaluation (the JAX `_sp_eval`): a fresh
        prompt goes through the ring-attention prefill in ONE forward,
        end-padded to a multiple of 16 n rows; a single token, or a
        reused context's tail token by token, steps through the
        distributed decode (each row lands on its owner rank)."""
        dev = self.device
        if len(tokens) == 1:
            return self._forward(
                torch.tensor([[tokens[0]]], dtype=torch.int64, device=dev),
                torch.tensor([[start_pos]], dtype=torch.int64,
                             device=dev))[0, -1]
        if start_pos > 0:
            out = None
            for i, t in enumerate(tokens):
                out = self._sp_eval([t], start_pos + i)
            return out
        n = self._n_sp
        b = min(-(-len(tokens) // (16 * n)) * (16 * n), self.max_context)
        tok = torch.tensor([list(tokens) + [0] * (b - len(tokens))],
                           dtype=torch.int64, device=dev)
        pos = torch.arange(b, dtype=torch.int64, device=dev)[None]
        return self._forward(tok, pos, last_index=len(tokens) - 1)[0, -1]

    def _eval_chunk(self, tokens: list[int], start_pos: int) -> torch.Tensor:
        """Evaluate tokens at positions [start_pos, ...), left-padded to a
        bucket (padding rows get position -1 and write nothing); returns the
        last token's logits (1-D f32 tensor on the engine's device). A single
        token pads to 16 rows too, as in the JAX engine: a row's logits do
        not depend on the rows beside it, so a fast-forwarded request
        re-evaluates its last prompt token bit-identically. A chunk of >= 128
        rows from position 0 takes flash prefill when it is on: padded at
        its END so that row index == position, logits gathered at the last
        real row (engine.py:419-428). A recurrent chunk is padded at its end
        (engine.py:408-418: padding rows keep the state), its logits
        gathered at the last real row; an encoder-decoder chunk (the
        decoder's start token, or a rewind's last token) is its rows
        unpadded."""
        if self.sp_mesh is not None:
            return self._sp_eval(tokens, start_pos)
        n = len(tokens)
        b = _bucket(n)
        pad = b - n
        if self.recurrent:
            tok, pos = self._end_padded(tokens, start_pos)
            last = torch.tensor([n - 1], dtype=torch.int64, device=self.device)
            return self._forward(tok, pos, last_index=last)[0, -1]
        if self.encdec:
            return self._forward(
                torch.tensor([list(tokens)], dtype=torch.int64,
                             device=self.device),
                torch.arange(start_pos, start_pos + n,
                             device=self.device)[None],
                last_only=True)[0, -1]
        if self.use_flash_prefill and start_pos == 0 and b >= 128:
            tok = torch.tensor([list(tokens) + [0] * pad], dtype=torch.int64,
                               device=self.device)
            pos = torch.tensor([list(range(n)) + [-1] * pad],
                               dtype=torch.int64, device=self.device)
            last = torch.tensor([n - 1], dtype=torch.int64, device=self.device)
            return self._forward(tok, pos, last_index=last,
                                 flash_prefill=True)[0, -1]
        tok = torch.tensor([[0] * pad + list(tokens)], dtype=torch.int64,
                           device=self.device)
        pos = torch.tensor([[-1] * pad + list(range(start_pos, start_pos + n))],
                           dtype=torch.int64, device=self.device)
        return self._forward(tok, pos, last_only=True)[0, -1]

    def _step(self, tok: int, pos: int) -> torch.Tensor:
        """One decode token of the host loop at position pos: a 16-row
        padded chunk (`_eval_chunk`), or off the llama-family path one
        unpadded row (module docstring). Returns its logits (1-D f32 on the
        device)."""
        if self._std_path:
            return self._eval_chunk([tok], pos)
        return self._forward(
            torch.tensor([[tok]], dtype=torch.int64, device=self.device),
            torch.tensor([[pos]], dtype=torch.int64, device=self.device),
            last_only=True)[0, -1]

    def _eval_chunk_embeds(self, tokens: list[int], emb_by_pos: dict,
                           start_pos: int) -> torch.Tensor:
        """Evaluate a mixed chunk (engine.py:439-461): the rows whose token
        is IMG_SENTINEL take their embedding rows (`splice_chunk`); left-
        padded to a bucket, through `forward` without flash prefill.
        Returns the last row's logits."""
        n = len(tokens)
        pad = _bucket(n) - n
        dev = self.device
        tok = torch.tensor([[0] * pad + [t if t >= 0 else 0 for t in tokens]],
                           dtype=torch.int64, device=dev)
        pos = torch.tensor([[-1] * pad + list(range(start_pos, start_pos + n))],
                           dtype=torch.int64, device=dev)
        emb, mask = splice_chunk(tokens, emb_by_pos, start_pos, pad + n, dev)
        return self._forward(tok, pos, last_only=True, input_embeds=emb,
                             embed_mask=mask)[0, -1]

    def eval_tokens(self, tokens: list[int], start_pos: int,
                    emb_by_pos: dict[int, torch.Tensor] | None = None
                    ) -> torch.Tensor:
        """Chunked prefill (n_batch equivalent); returns logits of the last
        token. emb_by_pos maps the absolute positions of IMG_SENTINEL tokens
        to their image-patch embedding rows."""
        logits = None
        pos = start_pos
        for i in range(0, len(tokens), PREFILL_BUCKETS[-1]):
            chunk = tokens[i:i + PREFILL_BUCKETS[-1]]
            if emb_by_pos and IMG_SENTINEL in chunk:
                logits = self._eval_chunk_embeds(chunk, emb_by_pos, pos)
            else:
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
            logits = self._forward(nxt.view(1, 1), pos, last_only=True)[0, -1]
        return toks, logits

    # -- context reuse -----------------------------------------------------
    def _fast_forward(self, prompt: list[int]) -> int:
        """Longest common prefix with the cached context. Returns n_past.
        Always re-evaluates >= 1 token. A recurrent state continues only
        from its exact point: the whole cached context must be a strict
        prefix of the prompt, else the state resets and everything is
        evaluated (engine.py:497-503)."""
        if self.recurrent:
            ctx = self.context_tokens
            if ctx and len(ctx) <= len(prompt) - 1 and prompt[:len(ctx)] == ctx:
                return len(ctx)
            self._reset_recurrent_state()
            return 0
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

    def _smart_context(self, prompt: list[int]) -> list[int]:
        """Legacy smart context (ContextFastForward, model_adapter.cpp:
        424-558; the JAX `_smart_context`). When the cache is nearly full
        and the prompt diverges far from it, cut the prompt's un-reusable
        half and remember the kept tail (`smartcontext`); a later prompt
        that still holds that tail is trimmed to it, so only new text is
        evaluated. Positions are deliberately discontinuous, as upstream.
        Returns the (possibly trimmed) prompt for the fast-forward."""
        nctx = self.max_context
        ctx_thresh = int(nctx * 0.8)     # SCCtxLenThreshold
        inp_thresh = int(nctx * 0.6)     # SCInpLenThreshold
        past_thresh = int(nctx * 0.5)    # SCPastLenThreshold
        tok_thresh = 32 + int(nctx * 0.05)  # SCTokThreshold

        n_past = self._fast_forward(prompt)
        rem = prompt[n_past:]
        reused = False
        if self.smartcontext and len(rem) >= inp_thresh:
            # reuse: the remembered buffer must reappear (prefix-anchored)
            blen, ci, pi = _longest_common_run(self.smartcontext, rem)
            if blen > tok_thresh and ci == 0:
                rem = rem[pi:]
                reused = True
            else:
                self.smartcontext = []
        else:
            self.smartcontext = []
        if (not reused and not self.smartcontext
                and len(self.context_tokens) >= ctx_thresh
                and len(rem) >= inp_thresh
                and len(self.context_tokens) - n_past > past_thresh):
            # trigger: keep the tail half, remember it as the anchor
            shift = int(len(rem) * 0.5)  # SCTruncationRatio
            self.smartcontext = rem[shift:]
            rem = self.smartcontext
        # the reused prefix + the trimmed rest; the fast-forward then also
        # reuses what of rest was evaluated last time (model_adapter.cpp:508)
        return prompt[:n_past] + rem

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
                                   self.cfg.rope_dim, self.cfg.use_rope)
                kl.copy_(k.reshape(B, S, KD))
                vl.copy_(v.reshape(B, S, KD))

    def _fast_greedy_ok(self, params: GenParams, grammar) -> bool:
        """Device-side greedy chunks match the host loop only when no
        logit-modifying host sampler is active; token bans ride an
        on-device additive mask. Off under KCPP_FAST_DECODE=0 and off the
        llama-family path (the JAX engine's `_std_path`)."""
        if (os.environ.get("KCPP_FAST_DECODE", "1") != "1"
                or not self._std_path or self.pp_mesh is not None
                or self.sp_mesh is not None):
            return False
        sp = params.sampler
        return (grammar is None and not params.banned_phrases
                and sp.temperature == 0.0 and sp.rep_pen == 1.0
                and sp.presence_penalty == 0.0 and sp.dry_multiplier == 0.0
                and not sp.logit_biases and sp.xtc_probability == 0.0
                and sp.mirostat == 0)

    def _fast_stoch_ok(self, params: GenParams, grammar) -> bool:
        """Device-side stochastic chunks cover the common preset:
        temperature / top-k / top-p / min-p / rep-pen / biases / bans with
        rep-pen leading the order; the same distribution as the host chain
        (another draw). DRY, XTC, mirostat, dynatemp, smoothing, top-a,
        TFS, typical, grammar and anti-slop stay on the host loop. Off
        under KCPP_FAST_DECODE=0 and off the llama-family path."""
        from .device_sampler import supported_order

        if (os.environ.get("KCPP_FAST_DECODE", "1") != "1"
                or not self._std_path or self.pp_mesh is not None
                or self.sp_mesh is not None):
            return False
        sp = params.sampler
        if not (grammar is None and not params.banned_phrases
                and sp.temperature > 0.0 and sp.mirostat == 0
                and sp.dry_multiplier == 0.0 and sp.xtc_probability == 0.0
                and sp.top_a == 0.0 and sp.tfs >= 1.0 and sp.typical_p >= 1.0
                and sp.dynatemp_range == 0.0 and sp.smoothing_factor == 0.0):
            return False
        rep_active = sp.rep_pen != 1.0 or sp.presence_penalty != 0.0
        return supported_order(sp.sampler_order, rep_active)

    def _get_stoch_chunk(self, order) -> Callable:
        """The stochastic chunk, kept per effective stage order (only the
        relative order of top-k / top-p / temperature changes the chain)."""
        from ..sampling.samplers import (KCPP_SAMPLER_TEMP, KCPP_SAMPLER_TOP_K,
                                         KCPP_SAMPLER_TOP_P)
        from .device_sampler import make_stoch_chunk

        key = tuple(s for s in order if s in (
            KCPP_SAMPLER_TOP_K, KCPP_SAMPLER_TOP_P, KCPP_SAMPLER_TEMP))
        fn = self._stoch_chunks.get(key)
        if fn is None:
            def fwd(tok, pos):
                return self._forward(tok, pos, last_only=True)[0, -1]

            fn = make_stoch_chunk(fwd, FAST_DECODE_K, key)
            self._stoch_chunks[key] = fn
        return fn

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
        if self.embedding:
            raise ValueError(
                "embedding-only model (bert/t5encoder) cannot generate text; "
                "use the embeddings endpoints")
        if params.images and self.clip is not None and not self._std_path:
            # the JAX engine would run such a request through
            # models/llama.forward over this branch's own cache
            branch = ("MLA" if self.mla else "recurrent" if self.recurrent
                      else "encoder-decoder" if self.encdec
                      else self.cfg.arch)
            raise ValueError(f"image input needs a llama-family language "
                             f"model; the {branch} branch ({self.cfg.arch}) "
                             "takes none")
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

        # LLaVA: the image-patch embeddings spliced after BOS
        emb_by_pos: dict[int, torch.Tensor] | None = None
        if params.images and self.clip is not None:
            prompt_tokens, emb_by_pos = splice_images(
                self.clip, tk.vocab.add_bos, prompt_tokens, params.images)
            self.context_tokens = []  # image requests re-evaluate fully

        if self.encdec:
            # T5: the prompt through the encoder, the decoder fresh from
            # its start token on every request (engine.py:722-729)
            self._run_encoder(prompt_tokens)
            self.context_tokens = []
            n_past = 0
            todo = [self.cfg.extras.get("decoder_start", 0)]
        else:
            # context reuse: smart context (legacy) or context shift, then
            # the fast-forward (engine.py:730-736)
            if self.use_smartcontext:
                prompt_tokens = self._smart_context(prompt_tokens)
            elif self.use_contextshift:
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
        logits = self.eval_tokens(todo, n_past, emb_by_pos)
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

        fast_kind = None
        if self._fast_greedy_ok(params, grammar):
            fast_kind = "greedy"
        elif self._fast_stoch_ok(params, grammar):
            fast_kind = "stoch"
        if fast_kind is not None:
            # ---- device-side chunks, PIPELINE_DEPTH in flight ----
            bias = np.zeros(self.cfg.vocab_size, np.float32)
            for tid, bv in sampler.logit_biases.items():
                if 0 <= tid < self.cfg.vocab_size:
                    bias[tid] += np.float32(bv)
            for b in sampler_banned:
                if 0 <= b < self.cfg.vocab_size:
                    bias[b] = np.float32(-1e30)
            bias_mask = torch.from_numpy(bias).to(self.device)
            logits_dev = logits.float()
            if fast_kind == "stoch":
                from .device_sampler import make_dyn

                # the rep-pen window: the last max_context context tokens,
                # right-aligned, and how many of them are real; an image
                # row's sentinel goes to the sampler's spare column V, which
                # penalizes no token (the host sampler's window matches no
                # token with it either)
                W = self.max_context
                rec = np.zeros(W, np.int64)
                tail = [t if t >= 0 else self.cfg.vocab_size
                        for t in self.context_tokens[-W:]]
                if tail:
                    rec[-len(tail):] = tail
                recent = torch.from_numpy(rec).to(self.device)
                count = torch.tensor([min(len(self.context_tokens), W)],
                                     dtype=torch.int64, device=self.device)
                seed = sampler.seed if sampler.seed >= 0 else int(
                    np.random.default_rng().integers(2 ** 31))
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
                dyn = make_dyn(sampler, self.max_context, self.device)
                stoch_chunk = self._get_stoch_chunk(sampler.sampler_order)
            pending: deque = deque()
            dispatch_pos = len(self.context_tokens)
            dispatched = 0
            done = False
            while len(out_tokens) < max_len and not done:
                if self.abort_event.is_set():
                    stop_reason = "abort"
                    break
                while len(pending) < PIPELINE_DEPTH and dispatched < max_len:
                    if fast_kind == "greedy":
                        toks, logits_dev = self._greedy_chunk(
                            logits_dev, dispatch_pos, bias_mask)
                    else:
                        toks, logits_dev, recent, count = stoch_chunk(
                            logits_dev, dispatch_pos, bias_mask, recent,
                            count, gen, dyn)
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

            logits = self._step(tok, len(self.context_tokens)
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
        """Recompute logits at the current context tail (after a rewind).
        A recurrent state cannot rewind: it resets and the whole context is
        evaluated again (engine.py:1004-1006)."""
        if self.recurrent:
            self._reset_recurrent_state()
            return self.eval_tokens(self.context_tokens, 0
                                    ).float().cpu().numpy()
        last = self.context_tokens[-1]
        return self._step(last, len(self.context_tokens) - 1
                          ).float().cpu().numpy()

    # -- utility API -------------------------------------------------------
    def token_count(self, text: str) -> list[int]:
        return self.tokenizer.encode(text)

    def reset_context(self):
        """Forget the cached context (a recurrent state resets with it)."""
        self.context_tokens = []
        if self.recurrent:
            self._reset_recurrent_state()

    # -- state save / restore (llama_state_*, src/llama.cpp:20833; the JAX
    #    engine's npz layout, engine.py:1025-1066) -------------------------
    def _check_state_kind(self, what: str):
        """Refuse state calls on a model that keeps no state, or on a
        quantized KV cache."""
        if self.embedding or self.encdec:
            raise ValueError(f"{what}: an embedding or encoder-decoder model "
                             "keeps no state between requests")
        if (self.pp_mesh is not None or self.sp_mesh is not None
                or "tp" in self.model.params):
            raise ValueError(f"{what}: a sharded engine holds only this "
                             "rank's part of the cache")
        if isinstance(self.cache, QuantKVCache):
            raise ValueError(
                f"{what}: a quantized KV cache (--quantkv) cannot be saved or "
                "restored: the JAX engine's state file keeps only the cache's "
                "codes and drops its scales (stack_cache), and loads them back "
                "as bf16 values")

    def save_state(self, path: str):
        """The bf16 cache as k / v stacked (L, B, S, H, D; the MLA cache's
        K and V rows of their own widths), the context tokens (int64) and
        max_context, in one compressed npz. bf16 goes as 2-byte void
        ('<V2'), the bytes numpy writes for the JAX package's bfloat16, so
        no bf16 numpy dtype is needed to read it. A recurrent model's
        state goes as the JAX engine writes it: `recurrent` = 1 and its f32
        tensors as leaf0, leaf1, ... in kv/recurrent.py's field order."""
        self._check_state_kind("save_state")
        if self.recurrent:
            np.savez_compressed(
                path, recurrent=np.array(1),
                context_tokens=np.asarray(self.context_tokens, dtype=np.int64),
                max_context=self.max_context,
                **{f"leaf{i}": t.cpu().numpy()
                   for i, t in enumerate(state_leaves(self.cache))})
            return
        st = stack_cache(self.cache)

        def raw(t: torch.Tensor) -> np.ndarray:
            return t.contiguous().view(torch.int16).cpu().numpy().view("V2")

        np.savez_compressed(
            path, k=raw(st.k), v=raw(st.v),
            context_tokens=np.asarray(self.context_tokens, dtype=np.int64),
            max_context=self.max_context)

    def load_state(self, path: str):
        """Restore a state written by `save_state` or by the JAX engine
        (a bf16 cache as '<V2' bytes, or a float cache, cast to bf16 as
        the JAX `load_state` casts it to its cache dtype). A recurrent
        state file (the `recurrent` flag) fills the state's tensors leaf by
        leaf (a bf16 leaf, as the JAX Mamba's conv state under bf16
        weights, as '<V2' bytes, cast to f32)."""
        self._check_state_kind("load_state")
        data = np.load(path)
        if int(data["max_context"]) != self.max_context:
            raise ValueError("state was saved with a different context size")

        def tensor(a: np.ndarray) -> torch.Tensor:
            if a.dtype.kind == "V" and a.dtype.itemsize == 2:
                return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            return torch.from_numpy(np.asarray(a, np.float32))

        if self.recurrent != ("recurrent" in data):
            raise ValueError("state file is not a recurrent-model state"
                             if self.recurrent else
                             "state file holds a recurrent-model state")
        if self.recurrent:
            leaves = state_leaves(self.cache)
            arrays = [tensor(data[f"leaf{i}"]) for i in range(len(leaves))]
            for dst, a in zip(leaves, arrays):
                if tuple(a.shape) != tuple(dst.shape):
                    raise ValueError(f"state leaf of shape {tuple(a.shape)} "
                                     f"does not fit {tuple(dst.shape)}")
            with torch.inference_mode():
                for dst, a in zip(leaves, arrays):
                    dst.copy_(a)
            self.context_tokens = [int(t) for t in data["context_tokens"]]
            return

        k, v = tensor(data["k"]), tensor(data["v"])
        L = len(self.cache.k)
        if k.dim() != 5 or k.shape[0] != L or v.shape[:4] != k.shape[:4]:
            raise ValueError(f"state k / v of shape {tuple(k.shape)} do not "
                             f"fit this cache ({L} layers)")
        with torch.inference_mode():
            for i in range(L):
                dst_k, dst_v = self.cache.k[i], self.cache.v[i]
                dst_k.copy_(k[i].reshape(dst_k.shape))
                dst_v.copy_(v[i].reshape(dst_v.shape))
        self.context_tokens = [int(t) for t in data["context_tokens"]]


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
                freqs: torch.Tensor, rope_type: str, rot_dim: int,
                rotate_k: bool = True):
    """Context-shift math on one layer's (..., S, H, D) k/v pair: slide slots
    [end, ...) down to start and RoPE-re-rotate the moved K rows by -delta.
    A rope-less model's K (ALiBi, learned positions; rotate_k False) was
    never rotated, so its rows only move, as upstream's K-shift skips a
    model without rope; the JAX `_shift_rows` rotates them all the same.
    Returns new tensors (the caller copies them into the cache)."""
    delta = end - start
    S = kl.shape[-3]
    idx = torch.arange(S, device=kl.device)
    src = torch.clamp(torch.where(idx >= start, idx + delta, idx), max=S - 1)
    k = torch.index_select(kl, kl.dim() - 3, src)
    v = torch.index_select(vl, vl.dim() - 3, src)
    if not rotate_k:
        return k, v
    angle = -delta * freqs  # (rot/2,)
    k_rot = rotate(k.float(), torch.cos(angle), torch.sin(angle), rope_type,
                   rot_dim or kl.shape[-1])
    moved = (idx >= start)[:, None, None]
    return torch.where(moved, k_rot.to(kl.dtype), k), v
