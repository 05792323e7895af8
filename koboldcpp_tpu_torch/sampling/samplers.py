"""The kobold sampler stack, numpy host implementation.

Semantics mirror the reference's own sampler chain (NOT llama.cpp's):
gpttype_adapter.cpp SampleLogits :1338-1434 and the individual
sample_* functions (:483-1300). Chain order: logit bias -> grammar -> DRY ->
top-k 5000 prefilter -> (mirostat bypass | user-ordered samplers) -> XTC ->
multinomial draw. Candidates are (ids, logits) arrays; "removing" tokens
shrinks the arrays exactly like the reference's size-truncation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


class Candidates:
    """Mutable candidate set: token ids + logits (+ cached softmax probs)."""

    __slots__ = ("ids", "logits", "probs", "sorted")

    def __init__(self, logits: np.ndarray):
        self.ids = np.arange(len(logits), dtype=np.int64)
        self.logits = logits.astype(np.float32).copy()
        self.probs: np.ndarray | None = None
        self.sorted = False

    def softmax(self):
        """Sort by logit desc + compute probs (reference sample_softmax)."""
        if not self.sorted:
            order = np.argsort(-self.logits, kind="stable")
            self.ids = self.ids[order]
            self.logits = self.logits[order]
            self.sorted = True
        x = self.logits - self.logits[0]
        e = np.exp(x)
        self.probs = e / e.sum()

    def truncate(self, n: int):
        n = max(1, min(n, len(self.ids)))
        self.ids = self.ids[:n]
        self.logits = self.logits[:n]
        if self.probs is not None:
            self.probs = self.probs[:n]

    def __len__(self):
        return len(self.ids)


@dataclass
class SamplerParams:
    """Generation-time sampler knobs (generation_inputs fields, expose.h:76-175)."""

    temperature: float = 0.7
    top_k: int = 100
    top_a: float = 0.0
    top_p: float = 0.92
    min_p: float = 0.0
    typical_p: float = 1.0
    tfs: float = 1.0
    rep_pen: float = 1.1
    rep_pen_range: int = 320
    rep_pen_slope: float = 1.0
    presence_penalty: float = 0.0
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    dry_multiplier: float = 0.0
    dry_base: float = 1.75
    dry_allowed_length: int = 2
    dry_penalty_last_n: int = 0
    xtc_threshold: float = 0.2
    xtc_probability: float = 0.0
    dynatemp_range: float = 0.0
    dynatemp_exponent: float = 1.0
    smoothing_factor: float = 0.0
    sampler_order: tuple[int, ...] = (6, 0, 1, 3, 4, 2, 5)
    logit_biases: dict[int, float] = field(default_factory=dict)
    banned_tokens: tuple[int, ...] = ()
    seed: int = -1


# sampler-order ids (expose.h:12-22)
KCPP_SAMPLER_TOP_K = 0
KCPP_SAMPLER_TOP_A = 1
KCPP_SAMPLER_TOP_P = 2
KCPP_SAMPLER_TFS = 3
KCPP_SAMPLER_TYP = 4
KCPP_SAMPLER_TEMP = 5
KCPP_SAMPLER_REP_PEN = 6


@dataclass
class SamplerState:
    """Cross-step sampler state for one generation."""

    rng: np.random.Generator
    mirostat_mu: float | None = None
    dry_sequences: dict[int, list[list[int]]] = field(default_factory=dict)


def make_state(seed: int = -1) -> SamplerState:
    return SamplerState(rng=np.random.default_rng(None if seed < 0 else seed))


# ---------------------------------------------------------------------------
# individual samplers (reference file:line in each docstring)
# ---------------------------------------------------------------------------

def sample_top_k(c: Candidates, k: int):
    """gpttype_adapter.cpp:508 (bucket sort == plain sort here)."""
    if k <= 0:
        k = len(c)
    if not c.sorted:
        order = np.argsort(-c.logits, kind="stable")
        c.ids = c.ids[order]
        c.logits = c.logits[order]
        if c.probs is not None:
            c.probs = c.probs[order]
        c.sorted = True
    c.truncate(k)


def sample_top_a(c: Candidates, a: float, min_keep: int = 1):
    """gpttype_adapter.cpp:675: drop p < a * pmax^2."""
    if a <= 0.0 or len(c) <= 1:
        return
    c.softmax()
    threshold = a * c.probs[0] * c.probs[0]
    below = np.nonzero(c.probs < threshold)[0]
    for i in below:
        if i >= min_keep:
            c.truncate(int(i))
            break


def sample_top_p(c: Candidates, p: float, min_keep: int = 1):
    """gpttype_adapter.cpp:1009."""
    if p >= 1.0:
        return
    c.softmax()
    cum = np.cumsum(c.probs)
    hit = np.nonzero(cum >= p)[0]
    for i in hit:
        if i + 1 >= min_keep:
            c.truncate(int(i) + 1)
            break


def sample_min_p(c: Candidates, p: float, min_keep: int = 1):
    """gpttype_adapter.cpp:1035: keep logit >= max_logit + log(p)."""
    if p <= 0.0 or len(c) == 0:
        return
    max_logit = c.logits.max()
    min_logit = max_logit + math.log(p)
    keep = c.logits >= min_logit
    if not c.sorted:
        if keep.sum() >= min_keep:
            c.ids = c.ids[keep]
            c.logits = c.logits[keep]
            c.probs = None
            return
        sample_top_k(c, len(c))  # sort path
    # sorted path: scan from index 1
    i = 1
    while i < len(c):
        if c.logits[i] < min_logit and i >= min_keep:
            break
        i += 1
    c.truncate(i)


def sample_tail_free(c: Candidates, z: float, min_keep: int = 1):
    """gpttype_adapter.cpp:1090: second-derivative tail cut."""
    if z >= 1.0 or len(c) <= 2:
        return
    c.softmax()
    d1 = c.probs[:-1] - c.probs[1:]
    d2 = np.abs(d1[:-1] - d1[1:])
    s = d2.sum()
    d2 = d2 / s if s > 1e-6 else np.full_like(d2, 1.0 / len(d2))
    cum = np.cumsum(d2)
    last = len(c)
    for i in range(len(d2)):
        if cum[i] > z and i >= min_keep:
            last = i
            break
    c.truncate(last)


def sample_typical(c: Candidates, p: float, min_keep: int = 1):
    """gpttype_adapter.cpp:1144: entropy-shifted score ordering."""
    if p >= 1.0:
        return
    c.softmax()
    pr = c.probs
    ent = -np.sum(np.where(pr > 0, pr * np.log(np.where(pr > 0, pr, 1.0)), 0.0))
    with np.errstate(divide="ignore"):
        shifted = np.abs(-np.log(pr) - ent)
    order = np.argsort(shifted, kind="stable")
    cum = 0.0
    last = len(order)
    for i, idx in enumerate(order):
        cum += pr[idx]
        if cum > p and i >= min_keep - 1:
            last = i + 1
            break
    sel = order[:last]
    c.ids = c.ids[sel]
    c.logits = c.logits[sel]
    c.probs = None
    c.sorted = False


def _apply_smoothing(c: Candidates, smoothing_factor: float):
    if smoothing_factor > 0 and len(c) > 1:
        c.softmax()
        h = c.logits[0]
        shifted = c.logits - h
        c.logits = -smoothing_factor * shifted * shifted + h
        c.softmax()


def sample_temperature(c: Candidates, temp: float, smoothing_factor: float):
    """gpttype_adapter.cpp:1265: temp<=0 => greedy via tiny temp + top-1."""
    greedy = temp <= 0
    if greedy:
        temp = 0.00390625
        smoothing_factor = 0.0
    c.logits = c.logits / temp
    _apply_smoothing(c, smoothing_factor)
    if greedy:
        sample_top_k(c, 1)


def sample_entropy(c: Candidates, min_temp: float, max_temp: float,
                   exponent: float, smoothing_factor: float):
    """gpttype_adapter.cpp:1205 (dynatemp)."""
    if len(c) <= 1:
        return
    max_entropy = -math.log(1.0 / len(c))
    c.softmax()
    pr = c.probs
    entropy = -np.sum(np.where(pr > 0, pr * np.log(np.where(pr > 0, pr, 1.0)), 0.0))
    dyn_temp = min_temp + (max_temp - min_temp) * (entropy / max_entropy) ** exponent
    c.logits = c.logits / dyn_temp
    # reference recomputes probs without resorting
    x = c.logits - c.logits[0]
    e = np.exp(x.astype(np.float64))
    c.probs = (e / e.sum()).astype(np.float32)
    _apply_smoothing(c, smoothing_factor)


def sample_rep_pen(c: Candidates, ctx_tokens: list[int], n_ctx: int,
                   rep_pen_range: int, rep_pen: float, rep_pen_slope: float,
                   presence_penalty: float):
    """gpttype_adapter.cpp:950: near/far split with slope-reduced far penalty."""
    last_n = min(len(ctx_tokens), rep_pen_range, n_ctx)
    if last_n == 0 or (rep_pen == 1.0 and presence_penalty == 0.0):
        return
    window = ctx_tokens[len(ctx_tokens) - last_n:]
    near, far = set(), set()
    for i, t in enumerate(window):
        (near if i * 2 >= last_n else far).add(t)
    rep_pen_reduced = rep_pen
    if rep_pen_reduced > 1.0:
        rep_pen_reduced = 1.0 + (rep_pen - 1.0) * rep_pen_slope
    for i in range(len(c)):
        tid = int(c.ids[i])
        in_near = tid in near
        if not in_near and tid not in far:
            continue
        penalty = rep_pen if in_near else rep_pen_reduced
        if c.logits[i] <= 0:
            c.logits[i] *= penalty
        else:
            c.logits[i] /= penalty
        c.logits[i] -= presence_penalty
    c.sorted = False
    c.probs = None


def sample_xtc(c: Candidates, threshold: float, probability: float,
               rng: np.random.Generator):
    """gpttype_adapter.cpp:703: exclude-top-choices."""
    if threshold > 0.5 or probability <= 0.0 or len(c) <= 1:
        return
    if rng.random() >= probability:
        return
    c.softmax()
    last = len(c)
    for i in range(len(c)):
        if c.probs[i] < threshold:
            last = i
            break
    if last > 1:
        c.logits[:last - 1] -= 999.0
        c.sorted = False


def sample_token(c: Candidates, rng: np.random.Generator) -> int:
    """gpttype_adapter.cpp:585: softmax + multinomial draw."""
    c.softmax()
    idx = int(rng.choice(len(c), p=c.probs / c.probs.sum()))
    return int(c.ids[idx])


def sample_mirostat_v1(c: Candidates, rng: np.random.Generator, n_vocab: int,
                       tau: float, eta: float, m: int, mu: float) -> tuple[int, float]:
    """gpttype_adapter.cpp:614."""
    c.softmax()
    n = float(n_vocab)
    s_hat, sum_ti_bi, sum_ti_sq = 0.0, 0.0, 0.0
    for i in range(min(m - 1, len(c) - 1)):
        t_i = math.log((i + 2) / (i + 1))
        b_i = math.log(c.probs[i] / c.probs[i + 1]) if c.probs[i + 1] > 0 else 0.0
        sum_ti_bi += t_i * b_i
        sum_ti_sq += t_i * t_i
    s_hat = sum_ti_bi / sum_ti_sq if sum_ti_sq > 0 else 1.0
    eps_hat = s_hat - 1
    if eps_hat == 0:
        k = len(c)
    else:
        k = ((eps_hat * 2 ** mu) / (1 - n ** -eps_hat)) ** (1 / s_hat)
    sample_top_k(c, int(k))
    tok = sample_token(c, rng)
    idx = int(np.nonzero(c.ids == tok)[0][0])
    surprise = -math.log2(max(c.probs[idx], 1e-30))
    return tok, mu - eta * (surprise - tau)


def sample_mirostat_v2(c: Candidates, rng: np.random.Generator,
                       tau: float, eta: float, mu: float) -> tuple[int, float]:
    """gpttype_adapter.cpp:645."""
    c.softmax()
    surprises = -np.log2(np.maximum(c.probs, 1e-30))
    over = np.nonzero(surprises > mu)[0]
    size = int(over[0]) if len(over) else len(c)
    c.truncate(max(size, 1))
    c.probs = None
    c.sorted = True  # still sorted; re-softmax normalizes
    c.softmax()
    tok = sample_token(c, rng)
    idx = int(np.nonzero(c.ids == tok)[0][0])
    surprise = -math.log2(max(c.probs[idx], 1e-30))
    return tok, mu - eta * (surprise - tau)


# ---------------------------------------------------------------------------
# DRY
# ---------------------------------------------------------------------------

def build_dry_sequences(tokenizer, breakers: list[str],
                        max_tail_len: int = 20) -> dict[int, list[list[int]]]:
    """Restart-sequence multimap: head token id -> tail token lists.
    Mirrors GetOverlappingTokenSequences (gpttype_adapter.cpp:348)."""
    out: dict[int, list[list[int]]] = {}
    if not breakers:
        return out
    v = tokenizer.vocab
    pieces = [tokenizer.token_str(i) for i in range(v.n_tokens)]
    for s in breakers:
        if not s:
            continue
        for tid, word in enumerate(pieces):
            if not word:
                continue
            if s in word:
                lst = out.setdefault(tid, [])
                if [] not in lst:
                    lst.append([])
                continue
            pos = word.find(s[0])
            while pos != -1:
                i = 1
                match = True
                while i < len(s) and i + pos < len(word):
                    if word[pos + i] != s[i]:
                        match = False
                        break
                    i += 1
                if match:
                    tail = tokenizer.encode(s[i:], add_bos=False, add_eos=False,
                                            parse_special=False)[:max_tail_len]
                    lst = out.setdefault(tid, [])
                    if tail not in lst:
                        lst.append(tail)
                pos = word.find(s[0], pos + 1)
    return out


def sample_dry(c: Candidates, ctx_tokens: list[int], n_ctx: int,
               penalty_range: int, multiplier: float, base: float,
               allowed_length: int,
               restart_sequences: dict[int, list[list[int]]]):
    """DRY repetition penalty (gpttype_adapter.cpp:744): reverse Z-algorithm
    repeat scan + exponential penalty. Must run before any reordering
    (penalties index candidates by token id)."""
    if multiplier <= 0.0 or base <= 0.0:
        return
    if penalty_range <= 0 or penalty_range > n_ctx:
        penalty_range = n_ctx
    last_n = min(len(ctx_tokens), penalty_range, n_ctx)
    if last_n <= allowed_length:
        return
    toks = ctx_tokens[len(ctx_tokens) - last_n:]

    # Step 1: restart sequences limit the repeat window
    rep_limit = last_n
    for i in range(last_n):
        ix = last_n - 1 - i
        seqs = restart_sequences.get(toks[ix])
        if seqs is None:
            continue
        longest = -1
        for tail in seqs:
            sl = len(tail)
            if sl > longest and sl <= i and toks[ix + 1: ix + 1 + sl] == tail:
                longest = sl
        if longest >= 0:
            rep_limit = i - longest
            break
    if rep_limit <= allowed_length:
        return

    # Step 2: reverse Z-algorithm over the window (native C++ when available)
    from ..utils.native import dry_repeat_scan

    repeat = dry_repeat_scan(toks, rep_limit)

    # Step 3: max repeat ending in each continuation token
    max_rep: dict[int, int] = {}
    for i in range(last_n - 1):
        rl = repeat[i]
        if rl >= allowed_length:
            t = toks[i + 1]
            if max_rep.get(t, -1) < rl:
                max_rep[t] = rl

    # Step 4: apply penalties (candidates still in vocab order)
    if not max_rep:
        return
    FLOAT_MAX_LOG = 88.7228391
    max_exp = int(FLOAT_MAX_LOG / math.log(base)) if base > 1.000001 else 0
    for t, rl in max_rep.items():
        e = rl - allowed_length
        if max_exp > 0 and e > max_exp:
            e = max_exp
        c.logits[t] -= multiplier * (base ** e)
    c.sorted = False
    c.probs = None


# ---------------------------------------------------------------------------
# the full chain
# ---------------------------------------------------------------------------

def sample_logits(logits: np.ndarray, ctx_tokens: list[int], n_ctx: int,
                  params: SamplerParams, state: SamplerState,
                  grammar_mask: np.ndarray | None = None) -> int:
    """Full reference chain (SampleLogits, gpttype_adapter.cpp:1338). Returns
    the sampled token id."""
    c = Candidates(np.asarray(logits, dtype=np.float32))

    for tid, bias in params.logit_biases.items():
        if 0 <= tid < len(c.logits):
            c.logits[tid] += bias
    for tid in params.banned_tokens:
        if 0 <= tid < len(c.logits):
            c.logits[tid] = -np.inf

    if grammar_mask is not None:
        c.logits = np.where(grammar_mask, c.logits, -np.inf)

    sample_dry(c, ctx_tokens, n_ctx, params.dry_penalty_last_n,
               params.dry_multiplier, params.dry_base,
               params.dry_allowed_length, state.dry_sequences)

    sample_top_k(c, 5000)  # prefilter (reference :1365)

    if params.mirostat in (1, 2):
        if state.mirostat_mu is None:
            state.mirostat_mu = 2.0 * params.mirostat_tau
        sample_rep_pen(c, ctx_tokens, n_ctx, params.rep_pen_range, params.rep_pen,
                       params.rep_pen_slope, params.presence_penalty)
        sample_temperature(c, params.temperature, params.smoothing_factor)
        if params.mirostat == 1:
            tok, state.mirostat_mu = sample_mirostat_v1(
                c, state.rng, len(logits), params.mirostat_tau,
                params.mirostat_eta, 100, state.mirostat_mu)
        else:
            tok, state.mirostat_mu = sample_mirostat_v2(
                c, state.rng, params.mirostat_tau, params.mirostat_eta,
                state.mirostat_mu)
        return tok

    for s in params.sampler_order:
        if s == KCPP_SAMPLER_TOP_K:
            sample_top_k(c, params.top_k)
        elif s == KCPP_SAMPLER_TOP_A:
            sample_top_a(c, params.top_a, 1)
        elif s == KCPP_SAMPLER_TOP_P:
            sample_top_p(c, params.top_p, 1)
            sample_min_p(c, params.min_p, 1)
        elif s == KCPP_SAMPLER_TFS:
            sample_tail_free(c, params.tfs, 1)
        elif s == KCPP_SAMPLER_TYP:
            sample_typical(c, params.typical_p, 1)
        elif s == KCPP_SAMPLER_TEMP:
            if params.dynatemp_range > 0:
                dmin = max(0.0, params.temperature - params.dynatemp_range)
                dmax = max(0.0, params.temperature + params.dynatemp_range)
                sample_entropy(c, dmin, dmax, max(0.0, params.dynatemp_exponent),
                               params.smoothing_factor)
            else:
                sample_temperature(c, params.temperature, params.smoothing_factor)
        elif s == KCPP_SAMPLER_REP_PEN:
            sample_rep_pen(c, ctx_tokens, n_ctx, params.rep_pen_range,
                           params.rep_pen, params.rep_pen_slope,
                           params.presence_penalty)

    sample_xtc(c, params.xtc_threshold, params.xtc_probability, state.rng)
    return sample_token(c, state.rng)
