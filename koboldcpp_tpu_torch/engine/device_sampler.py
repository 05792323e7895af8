"""Device-side stochastic sampling: the single-stream engine's K-token
decode chunk and the batched engine's decode step.

Port of koboldcpp_tpu/engine/device_sampler.py. The reference samples on the
host every token (SampleLogits, gpttype_adapter.cpp:1338); this module runs
the common sampler preset on the device, so a single-stream chunk of
FAST_DECODE_K tokens (`make_stoch_chunk`) or a batched decode step (or a
burst of them, per slot) needs no host round trip.

After the rep-pen/bias/ban stage, which modifies logit VALUES, every
remaining supported stage (top-k 5000 prefilter, top-k, top-p, min-p,
temperature) keeps a PREFIX of the candidates sorted by descending logit.
So one sort per step suffices; the chain reduces to a prefix length n and an
inverse temperature per row, and the draw is Gumbel-max over the masked
prefix.

Parity contract: the same candidate SET and probabilities as the host chain
and as the JAX module (`candidate_distribution`). The random draw uses a
`torch.Generator` on the engine's device, so per-seed sequences differ from
the JAX PRNG's (both are faithful samples of the same distribution).

Supported: temperature > 0, top_k, top_p, min_p, rep-pen (range/slope/
presence) in leading order position, logit biases, token bans, top-k 5000
prefilter. Everything else (DRY, XTC, mirostat, dynatemp, smoothing, top-a,
TFS, typical, grammar, anti-slop) stays on the host chain.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sampling.samplers import (KCPP_SAMPLER_REP_PEN, KCPP_SAMPLER_TEMP,
                                 KCPP_SAMPLER_TOP_K, KCPP_SAMPLER_TOP_P)

NEG = -1e30


def supported_order(order, rep_pen_active: bool) -> bool:
    """The single-sort scheme needs value-modifying stages (rep-pen) BEFORE
    the sort — i.e. rep-pen must come before top_k/top_p/temp in the user
    order (true for the kobold default [6,0,1,3,4,2,5])."""
    filt = [s for s in order if s in (KCPP_SAMPLER_TOP_K, KCPP_SAMPLER_TOP_P,
                                      KCPP_SAMPLER_TEMP, KCPP_SAMPLER_REP_PEN)]
    if not rep_pen_active:
        return True
    return bool(filt) and filt[0] == KCPP_SAMPLER_REP_PEN


def make_dyn_rows(sps, max_context: int, device="cpu") -> dict:
    """Per-slot knob vectors: one (B,) tensor per knob. Greedy slots
    (temperature == 0) get sanitized values (temp 1) — their pick is
    overridden by the greedy mask, the sanitized row just keeps the chain
    NaN-free."""
    def col(f, dtype):
        return torch.from_numpy(np.array([f(sp) for sp in sps],
                                         dtype=dtype)).to(device)

    return dict(
        temperature=col(lambda sp: sp.temperature if sp.temperature > 0
                        else 1.0, np.float32),
        top_k=col(lambda sp: sp.top_k, np.int64),
        top_p=col(lambda sp: sp.top_p, np.float32),
        min_p=col(lambda sp: sp.min_p, np.float32),
        rep_pen=col(lambda sp: sp.rep_pen, np.float32),
        rep_pen_slope=col(lambda sp: sp.rep_pen_slope, np.float32),
        presence=col(lambda sp: sp.presence_penalty, np.float32),
        # the host chain caps the window at min(range, n_ctx)
        # (sample_rep_pen, gpttype_adapter.cpp:950)
        rep_limit=col(lambda sp: min(max(sp.rep_pen_range, 0), max_context),
                      np.int64),
    )


def make_dyn(sp, max_context: int, device="cpu") -> dict:
    """The knob vectors of one SamplerParams (a batch of one row)."""
    return make_dyn_rows([sp], max_context, device)


def apply_rep_pen(logits, recent, count, dyn):
    """Vectorized sample_rep_pen (gpttype_adapter.cpp:950) over B rows:
    the last min(count, rep_limit) entries of each rolling `recent` (B, W)
    window form the penalty window; the older half takes the slope-reduced
    penalty. Identity when rep_pen == 1 and presence == 0."""
    B, V = logits.shape
    W = recent.shape[1]
    dev = logits.device
    last_n = torch.clamp(torch.minimum(count, dyn["rep_limit"]), max=W)[:, None]
    age = (W - 1 - torch.arange(W, device=dev))[None, :]  # 0 == newest slot
    in_win = age < last_n
    near = in_win & (2 * (last_n - 1 - age) >= last_n)
    far = in_win & ~near
    rep_pen = dyn["rep_pen"]
    reduced = torch.where(rep_pen > 1.0,
                          1.0 + (rep_pen - 1.0) * dyn["rep_pen_slope"], rep_pen)
    recent = recent.long()
    drop = torch.full_like(recent, V)  # one spare column takes masked entries
    pen = torch.ones((B, V + 1), dtype=torch.float32, device=dev)
    pen.scatter_(1, torch.where(far, recent, drop),
                 reduced[:, None].expand(B, W).contiguous())
    pen.scatter_(1, torch.where(near, recent, drop),
                 rep_pen[:, None].expand(B, W).contiguous())
    present = torch.zeros((B, V + 1), dtype=torch.float32, device=dev)
    present.scatter_(1, torch.where(in_win, recent, drop), 1.0)
    pen, present = pen[:, :V], present[:, :V]
    out = torch.where(pen != 1.0,
                      torch.where(logits <= 0, logits * pen, logits / pen),
                      logits)
    return out - dyn["presence"][:, None] * present


def _chain(logits, bias, recent, count, dyn, order):
    """Run the supported sampler chain over B rows; returns (scaled, masked
    logits over sorted candidates (B, V), sorted ids (B, V)). Softmax of the
    first gives the exact distribution the host chain would draw from."""
    B, V = logits.shape
    dev = logits.device
    l = logits.float() + bias
    # top-k 5000 prefilter happens BEFORE the order chain (reference :1365)
    if V > 5000:
        thresh = torch.topk(l, 5000, dim=1).values[:, -1:]
        l = torch.where(l >= thresh, l, torch.full_like(l, NEG))
    l = apply_rep_pen(l, recent, count, dyn)

    # one (stable: ties keep the lower id first, as lax.top_k) sort; every
    # later stage keeps a prefix
    sorted_l, sorted_ids = torch.sort(l, dim=1, descending=True, stable=True)
    n = torch.full((B,), V, dtype=torch.int64, device=dev)
    inv_temp = torch.ones(B, dtype=torch.float32, device=dev)
    pos = torch.arange(V, device=dev)[None, :]
    for s in order:
        if s == KCPP_SAMPLER_TOP_K:
            # k <= 0 keeps everything (sample_top_k, host :111)
            k_eff = torch.where(dyn["top_k"] > 0,
                                torch.clamp(dyn["top_k"], max=V), V)
            n = torch.minimum(n, k_eff)
        elif s == KCPP_SAMPLER_TOP_P:
            scaled = sorted_l * inv_temp[:, None]
            live = pos < n[:, None]
            m = torch.where(live, scaled, torch.full_like(scaled, NEG))
            cum = torch.cumsum(torch.softmax(m, dim=1), dim=1)
            # host keeps indices [0, first(cum >= p)]  (:1009)
            keep = 1 + ((cum < dyn["top_p"][:, None]) & live).sum(dim=1)
            n = torch.where(dyn["top_p"] < 1.0, torch.minimum(n, keep), n)
            # min-p rides the same stage (host :505): keep logit >=
            # max_logit + log(min_p) on CURRENT (possibly temp-scaled) values
            cutoff = sorted_l[:, 0] * inv_temp + torch.log(dyn["min_p"])
            ge = (scaled >= cutoff[:, None]) & (pos < n[:, None])
            n_minp = torch.clamp(ge.sum(dim=1), min=1)
            n = torch.where(dyn["min_p"] > 0.0, torch.minimum(n, n_minp), n)
        elif s == KCPP_SAMPLER_TEMP:
            inv_temp = 1.0 / dyn["temperature"]
    final = torch.where(pos < n[:, None], sorted_l * inv_temp[:, None],
                        torch.full_like(sorted_l, NEG))
    return final, sorted_ids


def _draw(final, sorted_ids, generator):
    """Gumbel-max over each row's masked prefix with noise from
    `generator`: (B,) int64 token ids."""
    u = torch.rand(final.shape, generator=generator, device=final.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    return torch.gather(sorted_ids, 1,
                        torch.argmax(final + gumbel, dim=1, keepdim=True))[:, 0]


def sample_step_batched(logits, bias, recent, count, generator, dyn, order,
                        greedy):
    """Per-slot device sampling: the chain over B rows with per-slot knob
    vectors, then the draw. `greedy` rows take argmax(logits + bias), the
    host semantics of temperature == 0. Returns (B,) int64 token ids."""
    pick = _draw(*_chain(logits, bias, recent, count, dyn, order), generator)
    gpick = torch.argmax(logits.float() + bias, dim=1)
    return torch.where(greedy, gpick, pick)


def candidate_distribution(logits, bias_mask, recent, count, dyn, order):
    """Full-vocab probability vector the device sampler draws from for one
    row — the parity hook against the host chain and the JAX module.
    logits/bias_mask (V,), recent (W,), count int, dyn from make_dyn."""
    logits = torch.as_tensor(logits)
    final, sorted_ids = _chain(
        logits[None], torch.as_tensor(bias_mask)[None],
        torch.as_tensor(recent)[None],
        torch.as_tensor(count, dtype=torch.int64).reshape(1), dyn,
        tuple(order))
    p = torch.softmax(final, dim=1)[0]
    return torch.zeros_like(p).scatter_(0, sorted_ids[0], p)


def sample_step(logits, bias_mask, recent, count, generator, dyn, order):
    """One full sampler-chain step for one row on the device: the chain,
    then Gumbel-max over the masked prefix with noise from `generator`.
    logits / bias_mask (V,), recent (W,), count a one-element int64 tensor,
    dyn from make_dyn. Returns a one-element int64 tensor; nothing here
    waits for the device."""
    return _draw(*_chain(logits[None], bias_mask[None], recent[None],
                         count.reshape(1), dyn, order), generator)


def make_stoch_chunk(forward_fn, k_tokens: int, order):
    """The K-token decode+sample chunk (the JAX `make_stoch_chunk`).
    forward_fn(tokens (1, 1), positions (1, 1)) -> last-token logits (V,)
    runs the T=1 llama-family step over the engine's cache, which it
    updates in place. Returns fn(logits0, start_pos, bias_mask, recent,
    count, generator, dyn) -> (toks (K,), logits, recent, count): each step
    samples, writes toks[i], rolls `recent` and bumps `count` (at most W),
    and runs the forward on the sampled token. Nothing in it waits for the
    host: the tokens stay on the device until the caller pulls them."""
    order = tuple(order)

    def chunk(logits0, start_pos: int, bias_mask, recent, count, generator,
              dyn):
        dev = logits0.device
        W = recent.shape[0]
        toks = torch.empty(k_tokens, dtype=torch.int64, device=dev)
        logits = logits0
        for i in range(k_tokens):
            tok = sample_step(logits, bias_mask, recent, count, generator,
                              dyn, order)
            toks[i:i + 1] = tok
            recent = torch.cat([recent[1:], tok.to(recent.dtype)])
            count = torch.clamp(count + 1, max=W)
            pos = torch.full((1, 1), start_pos + i, dtype=torch.int64,
                             device=dev)
            logits = forward_fn(tok.view(1, 1), pos)
        return toks, logits, recent, count

    return chunk
