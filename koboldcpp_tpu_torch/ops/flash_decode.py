"""Batched flash decode with the in-place K/V row write, over the slot
cache (K5 bf16 or f32, K6 Q8), over a row window of the scan decode path's
pooled cache (K17c), and over a paged pool through a (B, MP) page table
(K8 bf16, K9 Q8, K10 Q4); and the read-only single-sequence decode K16.

`decode_attention_batched`, `decode_attention_rows`,
`decode_attention_batched_q8`, `decode_attention_paged`,
`decode_attention_paged_q8`, `decode_attention_paged_q4` and
`decode_attention` are the ports of the JAX package's functions of the same
names (ops/flash_decode.py, bodies `_bkernel`, `_bkernel` with pos_off=1,
`_bqkernel`, `_pkernel`, `_pq8kernel`, `_pq4kernel`, `_kernel`). For a
CUDA tensor each launches csrc/flash_decode.cu; for a CPU tensor it runs
the plain PyTorch version beside it. Every one but K16 writes this step's
K/V row into the cache IN PLACE at each sequence's position (quantized
first for a quantized cache, rounded to bf16 for an f32 one; nothing is
written where pos < 0 or pos >= S, S = MP * P when paged), and returns the
same cache tensors. The quantized plain versions round as their JAX
kernels do: K6 dequantizes the history to bf16 before the dot, K9/K10
apply the scales on the score side. Over an f32 cache q and p are rounded
to bf16 and the scores and p . V read the f32 rows, as the JAX kernel's
bf16-by-f32 dots do.

The kernel takes any head_dim (an even one for K10's nibble planes;
padded to a multiple of 16 in its tiles; past 512 a head group's output
columns go in chunks of 128 to blocks of their own, and Q's, K's and V's
rows stream through shared memory in pieces of 128 columns, so that only
two pieces live there whatever the head_dim) and any number of query
heads per kv head (`check_kernel_shape`). Its grid is cut
by `decode_plan` from (B, Hkv, S) alone, so no launch reads a position on
the host; its partials and merge tickets live in a scratch kept across
calls of one shape (`_scratch`). Its head_dims past 256 live in a second
library, csrc/flash_decode_wide.cu, built beside the first (`_source`).
"""
from __future__ import annotations

import torch

from ..kv.cache import _dequant, _q8
from ..kv.paged import _q4_planes, _quantize_q4
from . import _build

TILE_ROWS = 64  # history rows per tile of csrc/flash_decode.cu (16 a warp)
MAX_SPLITS = 256  # splits of one sequence that the kernel's merge holds
TARGET_BLOCKS = 264  # two blocks for each of the H100's 132 SMs
HEAD_GROUP = 16  # query heads per block (one m16 tile)
COL_CHUNK = 128  # output columns a block takes past head_dim 512 (DCH)


def _source(D: int) -> str:
    """The library that holds the kernel instances for head_dim D: the
    instances past 256 are built apart (csrc/flash_decode_wide.cu)."""
    return "flash_decode_wide" if D > 256 else "flash_decode"


def col_chunks(D: int) -> tuple[int, int]:
    """(chunks, columns a chunk) of a head's D output columns: one block
    takes all D up to 512, COL_CHUNK-column chunks past it (the last may
    be narrower), each a unit of csrc/flash_decode.cu's grid."""
    dc = D if D <= 512 else COL_CHUNK
    return -(-D // dc), dc


def decode_plan(B: int, n_kv_heads: int, S: int) -> tuple[int, int]:
    """(rows_per_split, nsplit) of csrc/flash_decode.cu's grid (B * Hkv *
    head groups, nsplit): a function of the batch, the kv heads and the
    cache length S alone, never of the positions, so a launch needs no
    host read and the slot, paged (S = MP * P) and pooled caches cut a
    history at the same rows. The split is the smallest multiple of
    TILE_ROWS that gives at most TARGET_BLOCKS blocks for the B * Hkv
    (sequence, kv head) pairs and at most MAX_SPLITS splits."""
    want = max(-(-S * B * n_kv_heads // TARGET_BLOCKS), -(-S // MAX_SPLITS), 1)
    rps = -(-want // TILE_ROWS) * TILE_ROWS
    return rps, max(1, -(-S // rps))


def _softcap(s: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(s / cap) if cap > 0 else s


def _attend_plain(q, k_new, v_new, k, v, n_hist, n_heads: int,
                  n_kv_heads: int, scale: float, softcap: float):
    """Softmax over the history rows < n_hist of k/v (B, S, Hkv*D) plus the
    self term from k_new/v_new (none when k_new is None); scores bf16 q . k
    in f32, p cast to bf16 before p . V. Returns out (B, H, D) f32."""
    B, S, KD = k.shape
    Hkv = n_kv_heads
    D = KD // Hkv
    G = n_heads // Hkv
    qf = q.to(torch.bfloat16).float().reshape(B, Hkv, G, D)
    kf = k.float().reshape(B, S, Hkv, D)
    vf = v.float().reshape(B, S, Hkv, D)
    scores = _softcap(torch.einsum("bhgd,bshd->bhgs", qf, kf) * scale, softcap)
    hist = torch.arange(S, device=k.device)[None, :] < n_hist[:, None]
    scores = torch.where(hist[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    m = scores.amax(dim=-1)
    if k_new is not None:
        kn = k_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
        s_self = _softcap(torch.einsum("bhgd,bhd->bhg", qf, kn) * scale,
                          softcap)
        m = torch.maximum(m, s_self)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgs,bshd->bhgd", p.to(torch.bfloat16).float(), vf)
    if k_new is not None:
        vn = v_new.to(torch.bfloat16).float().reshape(B, Hkv, D)
        p_self = torch.exp(s_self - m)
        l = l + p_self
        acc = acc + p_self[..., None] * vn[:, :, None, :]
    return (acc / l[..., None]).reshape(B, n_heads, D)


def decode_attention_batched_plain(q, k_new, v_new, k_layer, v_layer,
                                   positions, n_heads: int, n_kv_heads: int,
                                   scale: float,
                                   softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K5: softmax over the history rows < pos (every row
    when pos < 0, all S when pos >= S) plus the self term. Returns out
    (B, H, D) f32 and writes the cache rows."""
    S = k_layer.shape[1]
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.where(pos < 0, S, torch.clamp(pos, max=S))
    out = _attend_plain(q, k_new, v_new, k_layer, v_layer, n_hist, n_heads,
                        n_kv_heads, scale, softcap)
    _write_rows(k_layer, v_layer, k_new, v_new, pos)
    return out


def _write_rows(k_layer, v_layer, k_new, v_new, pos) -> None:
    """In-place row write at pos per sequence, dropping pos outside [0, S)
    without a host sync (each sequence writes one distinct row). The row is
    rounded to bf16 first (an f32 cache holds the bf16 values, as the JAX
    kernel writes its bf16 k_new / v_new operands)."""
    B, S, KD = k_layer.shape
    valid = (pos >= 0) & (pos < S)
    idx = torch.where(valid, pos, torch.zeros_like(pos))
    b = torch.arange(B, device=pos.device)
    for cache, new in ((k_layer, k_new), (v_layer, v_new)):
        new = new.reshape(B, KD).to(torch.bfloat16).to(cache.dtype)
        cache[b, idx] = torch.where(valid[:, None], new, cache[b, idx])


def decode_attention_batched(q, k_new, v_new, k_layer, v_layer, positions,
                             n_heads: int, n_kv_heads: int, scale: float,
                             softcap: float = 0.0):
    """q: (B, H, D) post-rope; k_new/v_new: (B, Hkv, D) this step's post-rope
    K/V (not yet in the cache); k_layer/v_layer: (B, S, Hkv*D) bf16 or f32
    fused cache buffers; positions: (B,) int. Returns (out (B, H, D) f32,
    k_layer, v_layer) with the caches updated in place."""
    if not q.is_cuda:
        out = decode_attention_batched_plain(q, k_new, v_new, k_layer,
                                             v_layer, positions, n_heads,
                                             n_kv_heads, scale, softcap)
        return out, k_layer, v_layer
    out = _launch_rows("K5", q, k_new, v_new, k_layer, v_layer, positions,
                       None, n_heads, n_kv_heads, scale, softcap)
    return out, k_layer, v_layer


# csrc/flash_decode.cu's kinds of K5 / K17c, by the cache's dtype
_ROWS_KIND = {torch.bfloat16: 0, torch.float32: 4}
# argtypes of its entry points (pointers, ints, scale and softcap, stream)
_TAIL = [_build.F, _build.F, _build.P]
_K5_ARGS = [_build.I] + [_build.P] * 11 + [_build.I] * 7 + _TAIL
_K16_ARGS = [_build.P] * 8 + [_build.I] * 6 + _TAIL
_K6_ARGS = [_build.P] * 12 + [_build.I] * 7 + _TAIL
_K8_ARGS = [_build.I] + [_build.P] * 13 + [_build.I] * 9 + _TAIL


def _launch_rows(kid, q, k_new, v_new, k_cache, v_cache, positions, li,
                 n_heads, n_kv_heads, scale, softcap):
    """Launch K5 (li None: k_cache/v_cache are (B, S, KD)) or K17c (li a
    one-element int32 tensor on the card: rows [li B, li B + B) of (N, S,
    KD) pools) over bf16 or f32 caches; returns out (B, H, D) f32."""
    B = q.shape[0]
    N, S, KD = k_cache.shape
    D = KD // n_kv_heads
    check_kernel_shape(n_heads, n_kv_heads, D, kid)
    dt = k_cache.dtype
    if dt not in _ROWS_KIND:
        raise ValueError(f"{kid} takes bf16 or f32 caches, not {dt}")
    others = (k_new, v_new, positions) + (() if li is None else (li,))
    _checked(kid, q, (k_cache, v_cache), (dt, dt), others)
    if li is None and N != B:
        raise ValueError(f"{kid} takes caches of B = {B} sequences")
    if li is not None and (N % B or li.dtype != torch.int32
                           or li.numel() != 1):
        raise ValueError(f"{kid} takes pools of whole layers of B = {B} "
                         "rows and a one-element int32 layer index")
    lib, fn = _build.entry(_source(D), "k5_flash_decode", _K5_ARGS)
    rps, nsplit, out, scratch = _scratch(B, n_heads, n_kv_heads, D, S,
                                         q.device)
    qb, kn, vn = _bf16(q), _bf16(k_new), _bf16(v_new)
    pos = _i32(positions)
    _build.check(lib, fn(
        _ROWS_KIND[dt], qb.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(), _ptr(li),
        out.data_ptr(), *scratch, B, S, n_heads, n_kv_heads, D, nsplit, rps,
        float(scale), float(softcap), _build.stream_ptr()), kid)
    _build.launches[kid] += 1
    return out


def decode_attention_rows_plain(q, k_new, v_new, k_pool, v_pool, positions,
                                li, n_heads: int, n_kv_heads: int,
                                scale: float,
                                softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K17c: K5's plain version on the views
    k_pool[li B:(li + 1) B] (li an int or a one-element tensor). Returns
    out (B, H, D) f32 and writes the window's rows."""
    B = q.shape[0]
    base = int(li) * B
    return decode_attention_batched_plain(
        q, k_new, v_new, k_pool[base:base + B], v_pool[base:base + B],
        positions, n_heads, n_kv_heads, scale, softcap)


def decode_attention_rows(q, k_new, v_new, k_pool, v_pool, positions, li,
                          n_heads: int, n_kv_heads: int, scale: float,
                          softcap: float = 0.0):
    """K5 over a row window of a pooled cache (the JAX `decode_attention_
    rows`). k_pool/v_pool: (L*B, S, Hkv*D) bf16 or f32 buffers holding
    every layer's cache, row l*B + b for layer l and sequence b; li: the
    layer as a one-element int32 tensor on the pool's device, which the
    kernel reads (the JAX function takes the row base li*B as a traced
    scalar). Sequence b reads and writes row li*B + b only; a dead row (pos
    < 0) attends every row of its cache and writes nothing. Returns (out
    (B, H, D) f32, k_pool, v_pool), the pools updated in place."""
    if not q.is_cuda:
        out = decode_attention_rows_plain(q, k_new, v_new, k_pool, v_pool,
                                          positions, li, n_heads, n_kv_heads,
                                          scale, softcap)
        return out, k_pool, v_pool
    out = _launch_rows("K17c", q, k_new, v_new, k_pool, v_pool, positions,
                       li, n_heads, n_kv_heads, scale, softcap)
    return out, k_pool, v_pool


def decode_attention_plain(q, k_layer, v_layer, pos, n_heads: int,
                           scale: float, softcap: float = 0.0
                           ) -> torch.Tensor:
    """Plain version of K16: softmax over the rows <= pos of one sequence's
    cache (all S when pos >= S, every row when pos < 0), no self term, no
    write. q (H, D) is rounded to bf16. Returns out (H, D) f32."""
    S, Hkv, D = k_layer.shape
    p = int(pos)
    n_hist = torch.tensor([S if p < 0 else min(p + 1, S)],
                          device=k_layer.device)
    return _attend_plain(q[None], None, None, k_layer.reshape(1, S, -1),
                         v_layer.reshape(1, S, -1), n_hist, n_heads, Hkv,
                         scale, softcap)[0]


def decode_attention(q, k_layer, v_layer, pos, n_heads: int, scale: float,
                     softcap: float = 0.0) -> torch.Tensor:
    """K16, the JAX `decode_attention`: q (H, D) post-rope (f32 or bf16,
    rounded to bf16); k_layer/v_layer: (S, Hkv, D) bf16 cache views already
    holding this step's row at pos; pos: the position as a one-element
    int32 tensor (read by the kernel). Returns (H, D) f32 over the rows <=
    pos (all S when pos >= S). B=1 decode; nothing is written. For pos < 0
    the JAX kernel masks every row and returns the plain mean of V; the
    port attends every row then, as K5 does; no caller passes one."""
    if not q.is_cuda:
        return decode_attention_plain(q, k_layer, v_layer, pos, n_heads,
                                      scale, softcap)
    S, Hkv, D = k_layer.shape
    check_kernel_shape(n_heads, Hkv, D, "K16")
    _checked("K16", q, (k_layer, v_layer), (torch.bfloat16,) * 2, (pos,))
    if pos.dtype != torch.int32 or pos.numel() != 1:
        raise ValueError("K16 takes pos as a one-element int32 tensor")
    lib, fn = _build.entry(_source(D), "k16_flash_decode", _K16_ARGS)
    rps, nsplit, out, scratch = _scratch(1, n_heads, Hkv, D, S, q.device)
    qb = _bf16(q)
    _build.check(lib, fn(
        qb.data_ptr(), k_layer.data_ptr(), v_layer.data_ptr(), pos.data_ptr(),
        out.data_ptr(), *scratch, S, n_heads, Hkv, D, nsplit, rps,
        float(scale), float(softcap), _build.stream_ptr()), "K16")
    _build.launches["K16"] += 1
    return out[0]


def _page_rows(page_table: torch.Tensor, page_size: int,
               n_pages: int) -> torch.Tensor:
    """(B, MP) page table -> (B, MP*P) pool row of each history row (table
    entries clamped to the pool, as the TPU kernel's index map does)."""
    tab = torch.clamp(page_table.to(torch.int64), 0, n_pages - 1)
    offs = torch.arange(page_size, device=tab.device)
    return (tab[:, :, None] * page_size + offs).reshape(tab.shape[0], -1)


def decode_attention_paged_plain(q, k_new, v_new, k_pool, v_pool, page_table,
                                 positions, n_heads: int, n_kv_heads: int,
                                 page_size: int, scale: float,
                                 softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K8: K5's function over the rows the page table maps
    (row r of sequence b at pool row tab[b, r // P] * P + r % P), S = MP*P.
    A dead slot (pos < 0) takes the overshoot path: every page is read,
    nothing is written. Returns out (B, H, D) f32 and writes the pool rows."""
    MP = page_table.shape[1]
    S = MP * page_size
    rows = _page_rows(page_table, page_size, k_pool.shape[0] // page_size)
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.clamp(torch.where(pos >= 0, pos, S), max=S)
    out = _attend_plain(q, k_new, v_new, k_pool[rows], v_pool[rows], n_hist,
                        n_heads, n_kv_heads, scale, softcap)
    valid = (pos >= 0) & (pos < S)
    b_idx = torch.nonzero(valid).flatten()
    r = rows[b_idx, pos[b_idx]]
    KD = k_pool.shape[1]
    k_pool[r] = k_new.reshape(-1, KD)[b_idx].to(k_pool.dtype)
    v_pool[r] = v_new.reshape(-1, KD)[b_idx].to(v_pool.dtype)
    return out


def _checked(kid: str, q, caches, dtypes, others) -> None:
    """Raise unless every cache tensor is contiguous and of its dtype and
    every operand lies on q's device."""
    for t, dt in zip(caches, dtypes):
        if t.dtype is not dt or not t.is_contiguous():
            raise ValueError(f"{kid} takes contiguous caches of dtypes "
                             f"{sorted({str(d) for d in dtypes})}")
    dev = q.get_device()
    for t in (*caches, *others):
        if t.get_device() != dev:
            raise ValueError(f"{kid} takes every operand on {q.device}")


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous bf16 tensor (itself when it is one already)."""
    if t.dtype is torch.bfloat16 and t.is_contiguous():
        return t
    return t.to(torch.bfloat16).contiguous()


def _i32(t: torch.Tensor) -> torch.Tensor:
    if t.dtype is torch.int32 and t.is_contiguous():
        return t
    return t.to(torch.int32).contiguous()


# the kernel's scratch by (device, units, nsplit, D): kept across calls, so
# a decode step allocates only its output
_SCRATCH: dict = {}


def _scratch(B: int, n_heads: int, n_kv_heads: int, D: int, S: int, dev):
    """(rows_per_split, nsplit, out (B, H, D) f32, the kernel's scratch
    pointers): the splits' (acc, max/sum) partials and the merge tickets
    (zero between calls; every call leaves them so) of the B * Hkv * head
    groups * column chunks units. Calls on one stream may share them."""
    rps, nsplit = decode_plan(B, n_kv_heads, S)
    nc, dc = col_chunks(D)
    units = B * n_kv_heads * -(-(n_heads // n_kv_heads) // HEAD_GROUP) * nc
    key = (dev, units, nsplit, dc)
    scratch = _SCRATCH.get(key)
    if scratch is None:
        f32 = dict(dtype=torch.float32, device=dev)
        tensors = (torch.empty((units, nsplit, HEAD_GROUP, dc), **f32),
                   torch.empty((units, nsplit, HEAD_GROUP, 2), **f32),
                   torch.zeros(units, dtype=torch.int32, device=dev))
        scratch = _SCRATCH[key] = (tensors,
                                   tuple(t.data_ptr() for t in tensors))
    out = torch.empty((B, n_heads, D), dtype=torch.float32, device=dev)
    return rps, nsplit, out, scratch[1]


def _ptr(t):
    return None if t is None else t.data_ptr()


# kinds of csrc/flash_decode.cu's paged entry point
_PAGED_KIND = {"K8": 0, "K9": 2, "K10": 3}


def _launch_paged(kid, q, k_new, v_new, k_pool, v_pool, ks_pool, vs_pool,
                  page_table, positions, n_heads, n_kv_heads, page_size,
                  scale, softcap, D):
    """Launch K8 (bf16 pools), K9 (int8) or K10 (uint8 nibbles) and return
    out (B, H, D) f32; the pools are updated in place."""
    B, MP = page_table.shape
    NPP = k_pool.shape[0]
    check_kernel_shape(n_heads, n_kv_heads, D, kid)
    if NPP % page_size:
        raise ValueError(f"{kid} takes pools of whole pages")
    lib, fn = _build.entry(_source(D), "k8_flash_decode_paged",
                           _K8_ARGS)
    rps, nsplit, out, scratch = _scratch(B, n_heads, n_kv_heads, D,
                                         MP * page_size, q.device)
    qb, kn, vn = _bf16(q), _bf16(k_new), _bf16(v_new)
    tab, pos = _i32(page_table), _i32(positions)
    _build.check(lib, fn(
        _PAGED_KIND[kid], qb.data_ptr(), kn.data_ptr(), vn.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), _ptr(ks_pool), _ptr(vs_pool),
        tab.data_ptr(), pos.data_ptr(), out.data_ptr(), *scratch, B, MP,
        page_size, NPP // page_size, n_heads, n_kv_heads, D, nsplit, rps,
        float(scale), float(softcap), _build.stream_ptr()), kid)
    _build.launches[kid] += 1
    return out


def decode_attention_paged(q, k_new, v_new, k_pool, v_pool, page_table,
                           positions, n_heads: int, n_kv_heads: int,
                           page_size: int, scale: float, softcap: float = 0.0):
    """q: (B, H, D) post-rope; k_new/v_new: (B, Hkv, D); k_pool/v_pool:
    (NP*P, Hkv*D) bf16 fused page pools; page_table: (B, MP) int; positions:
    (B,) int. Returns (out (B, H, D) f32, k_pool, v_pool) with the pools
    updated in place."""
    if not q.is_cuda:
        out = decode_attention_paged_plain(q, k_new, v_new, k_pool, v_pool,
                                           page_table, positions, n_heads,
                                           n_kv_heads, page_size, scale,
                                           softcap)
        return out, k_pool, v_pool
    _checked("K8", q, (k_pool, v_pool), (torch.bfloat16,) * 2,
             (k_new, v_new, page_table, positions))
    out = _launch_paged("K8", q, k_new, v_new, k_pool, v_pool, None, None,
                        page_table, positions, n_heads, n_kv_heads, page_size,
                        scale, softcap, k_pool.shape[1] // n_kv_heads)
    return out, k_pool, v_pool


# ---------------------------------------------------------------------------
# quantized caches (--quantkv): K6 over the Q8 slot cache, K9 / K10 over the
# Q8 / Q4 paged pools
# ---------------------------------------------------------------------------

def _quantize_row(x: torch.Tensor, bits: int):
    """This step's (B, Hkv, D) row as the cache stores it: codes (B, Hkv,
    D or D/2), bf16 scales (B, Hkv), and the bf16 values they dequantize to
    (the self term's operand), as the JAX kernels' wrappers compute them."""
    x = x.to(torch.bfloat16)
    if bits == 4:
        packed, s = _quantize_q4(x)
        return packed, s, _dequant(_q4_planes(packed), s)
    q, s = _q8(x)
    return q, s, _dequant(q, s)


def _write_quant_rows(vals, scales, codes, sc, rows, b_idx) -> None:
    """Codes (B, Hkv, w) and scales (B, Hkv) of the sequences b_idx into the
    flat (N, Hkv*w) / (N, Hkv) cache rows `rows`, in place."""
    B = codes.shape[0]
    vals[rows] = codes.reshape(B, -1)[b_idx]
    scales[rows] = sc[b_idx]


def decode_attention_batched_q8_plain(q, k_new, v_new, k_layer, v_layer,
                                      ks_layer, vs_layer, positions,
                                      n_heads: int, n_kv_heads: int,
                                      scale: float,
                                      softcap: float = 0.0) -> torch.Tensor:
    """Plain version of K6: K5's function over the Q8 slot cache, each
    history element dequantized to bf16(int8 * scale) before the dot, the
    self term from this step's row quantized as `_q8` does and dequantized.
    Returns out (B, H, D) f32 and writes the codes and scales at pos."""
    B, S, KD = k_layer.shape
    Hkv = n_kv_heads
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.where(pos < 0, S, torch.clamp(pos, max=S))
    kq, ksn, kdq = _quantize_row(k_new, 8)
    vq, vsn, vdq = _quantize_row(v_new, 8)
    kd = _dequant(k_layer.view(B, S, Hkv, -1), ks_layer).reshape(B, S, KD)
    vd = _dequant(v_layer.view(B, S, Hkv, -1), vs_layer).reshape(B, S, KD)
    out = _attend_plain(q, kdq, vdq, kd, vd, n_hist, n_heads, Hkv, scale,
                        softcap)
    b_idx = torch.nonzero((pos >= 0) & (pos < S)).flatten()
    flat = b_idx * S + pos[b_idx]
    _write_quant_rows(k_layer.view(B * S, KD), ks_layer.view(B * S, Hkv), kq,
                      ksn, flat, b_idx)
    _write_quant_rows(v_layer.view(B * S, KD), vs_layer.view(B * S, Hkv), vq,
                      vsn, flat, b_idx)
    return out


def decode_attention_batched_q8(q, k_new, v_new, k_layer, v_layer, ks_layer,
                                vs_layer, positions, n_heads: int,
                                n_kv_heads: int, scale: float,
                                softcap: float = 0.0):
    """q: (B, H, D) post-rope; k_new/v_new: (B, Hkv, D) unquantized;
    k_layer/v_layer: (B, S, Hkv*D) int8; ks_layer/vs_layer: (B, S, Hkv) bf16
    scales; positions: (B,) int. Returns (out (B, H, D) f32, k_layer,
    v_layer, ks_layer, vs_layer), all four updated in place."""
    res = (k_layer, v_layer, ks_layer, vs_layer)
    if not q.is_cuda:
        out = decode_attention_batched_q8_plain(
            q, k_new, v_new, k_layer, v_layer, ks_layer, vs_layer, positions,
            n_heads, n_kv_heads, scale, softcap)
        return (out, *res)
    return (_launch_q8(q, k_new, v_new, res, positions, n_heads, n_kv_heads,
                       scale, softcap), *res)


def _launch_q8(q, k_new, v_new, res, positions, n_heads, n_kv_heads, scale,
               softcap):
    """Launch K6 over res = (k, v, k scales, v scales) of the Q8 slot cache
    (updated in place); returns out (B, H, D) f32."""
    B, S, KD = res[0].shape
    D = KD // n_kv_heads
    check_kernel_shape(n_heads, n_kv_heads, D, "K6")
    _checked("K6", q, res, (torch.int8,) * 2 + (torch.bfloat16,) * 2,
             (k_new, v_new, positions))
    lib, fn = _build.entry(_source(D), "k6_flash_decode_q8", _K6_ARGS)
    rps, nsplit, out, scratch = _scratch(B, n_heads, n_kv_heads, D, S,
                                         q.device)
    qb, kn, vn = _bf16(q), _bf16(k_new), _bf16(v_new)
    pos = _i32(positions)
    _build.check(lib, fn(
        qb.data_ptr(), kn.data_ptr(), vn.data_ptr(), *(t.data_ptr()
                                                       for t in res),
        pos.data_ptr(), out.data_ptr(), *scratch, B, S, n_heads, n_kv_heads,
        D, nsplit, rps, float(scale), float(softcap), _build.stream_ptr()),
        "K6")
    _build.launches["K6"] += 1
    return out


def decode_attention_paged_quant_plain(q, k_new, v_new, k_pool, v_pool,
                                       ks_pool, vs_pool, page_table, positions,
                                       n_heads: int, n_kv_heads: int,
                                       page_size: int, scale: float,
                                       softcap: float = 0.0,
                                       bits: int = 8) -> torch.Tensor:
    """Plain version of K9 (bits 8, int8 pools) and K10 (bits 4, plane-split
    nibble pools): K8's function with the scales on the score side, as the
    JAX kernels apply them: score = (bf16 q . k_int) * k_scale * scale,
    weight = bf16(p * v_scale) before weight . v_int; the self term from
    this step's row quantized and dequantized. A dead slot (pos < 0) reads
    every page and writes nothing. Returns out (B, H, D) f32 and writes the
    codes and scales at pos."""
    B, MP = page_table.shape
    Hkv = n_kv_heads
    G = n_heads // Hkv
    S = MP * page_size
    rows = _page_rows(page_table, page_size, k_pool.shape[0] // page_size)
    pos = positions.to(torch.int64).reshape(-1)
    n_hist = torch.clamp(torch.where(pos >= 0, pos, S), max=S)
    kq, ksn, kdq = _quantize_row(k_new, bits)
    vq, vsn, vdq = _quantize_row(v_new, bits)

    def ints(pool):  # (B, S, Hkv, D) f32 integer values
        x = pool[rows].view(B, S, Hkv, -1)
        return (_q4_planes(x) if bits == 4 else x).float()

    D = kdq.shape[-1]
    qf = q.to(torch.bfloat16).float().reshape(B, Hkv, G, D)
    ks = ks_pool[rows].float().permute(0, 2, 1)[:, :, None, :]  # (B,Hkv,1,S)
    vs = vs_pool[rows].float().permute(0, 2, 1)[:, :, None, :]
    scores = torch.einsum("bhgd,bshd->bhgs", qf, ints(k_pool)) * ks * scale
    scores = _softcap(scores, softcap)
    hist = torch.arange(S, device=q.device)[None, :] < n_hist[:, None]
    scores = torch.where(hist[:, None, None, :], scores,
                         torch.full_like(scores, -1e30))
    s_self = _softcap(torch.einsum("bhgd,bhd->bhg", qf, kdq.float()) * scale,
                      softcap)
    m = torch.maximum(scores.amax(dim=-1), s_self)
    p = torch.exp(scores - m[..., None])
    p_self = torch.exp(s_self - m)
    l = p.sum(dim=-1) + p_self
    w = (p * vs).to(torch.bfloat16).float()
    acc = torch.einsum("bhgs,bshd->bhgd", w, ints(v_pool))
    acc = acc + p_self[..., None] * vdq.float()[:, :, None, :]
    out = (acc / l[..., None]).reshape(B, n_heads, D)
    b_idx = torch.nonzero((pos >= 0) & (pos < S)).flatten()
    r = rows[b_idx, pos[b_idx]]
    _write_quant_rows(k_pool, ks_pool, kq, ksn, r, b_idx)
    _write_quant_rows(v_pool, vs_pool, vq, vsn, r, b_idx)
    return out


def _paged_quant(kid: str, bits: int, q, k_new, v_new, k_pool, v_pool,
                 ks_pool, vs_pool, page_table, positions, n_heads, n_kv_heads,
                 page_size, scale, softcap):
    res = (k_pool, v_pool, ks_pool, vs_pool)
    if not q.is_cuda:
        out = decode_attention_paged_quant_plain(
            q, k_new, v_new, *res, page_table, positions, n_heads, n_kv_heads,
            page_size, scale, softcap, bits)
        return (out, *res)
    vdt = torch.uint8 if bits == 4 else torch.int8
    _checked(kid, q, res, (vdt,) * 2 + (torch.bfloat16,) * 2,
             (k_new, v_new, page_table, positions))
    D = k_pool.shape[1] * (2 if bits == 4 else 1) // n_kv_heads
    out = _launch_paged(kid, q, k_new, v_new, *res, page_table, positions,
                        n_heads, n_kv_heads, page_size, scale, softcap, D)
    return (out, *res)


def decode_attention_paged_q8(q, k_new, v_new, k_pool, v_pool, ks_pool,
                              vs_pool, page_table, positions, n_heads: int,
                              n_kv_heads: int, page_size: int, scale: float,
                              softcap: float = 0.0):
    """q: (B, H, D); k_new/v_new: (B, Hkv, D) unquantized; k_pool/v_pool:
    (NP*P, Hkv*D) int8 row pools; ks_pool/vs_pool: (NP*P, Hkv) bf16 scales;
    page_table: (B, MP) int; positions: (B,). Returns (out (B, H, D) f32,
    k_pool, v_pool, ks_pool, vs_pool), all four updated in place."""
    return _paged_quant("K9", 8, q, k_new, v_new, k_pool, v_pool, ks_pool,
                        vs_pool, page_table, positions, n_heads, n_kv_heads,
                        page_size, scale, softcap)


def decode_attention_paged_q4(q, k_new, v_new, k_pool, v_pool, ks_pool,
                              vs_pool, page_table, positions, n_heads: int,
                              n_kv_heads: int, page_size: int, scale: float,
                              softcap: float = 0.0):
    """As decode_attention_paged_q8 over (NP*P, Hkv*D/2) uint8 plane-split
    nibble pools (kv/paged.py `_quantize_q4`)."""
    return _paged_quant("K10", 4, q, k_new, v_new, k_pool, v_pool, ks_pool,
                        vs_pool, page_table, positions, n_heads, n_kv_heads,
                        page_size, scale, softcap)


def supported(B: int, T: int, Hkv: int, D: int) -> bool:
    """K16 applies to single-token single-sequence decode with a
    lane-aligned fused KV width (the JAX `supported`)."""
    return B == 1 and T == 1 and (Hkv * D) % 128 == 0


def supported_batched(T: int, Hkv: int, D: int) -> bool:
    return T == 1 and (Hkv * D) % 128 == 0


def check_kernel_shape(n_heads: int, n_kv_heads: int, head_dim: int,
                       kernel: str = "K5") -> None:
    """Raise NotImplementedError for the head shapes csrc/flash_decode.cu
    (K5, K6, K8, K9, K10, K16, K17c) is not built for: it takes any
    head_dim (K10 an even one: its rows are two nibble planes, and the JAX
    Q4 pool refuses an odd one too) and any number of query heads per kv
    head (n_heads a multiple of n_kv_heads)."""
    if (head_dim < 1
            or (kernel == "K10" and head_dim % 2)
            or n_kv_heads <= 0 or n_heads % n_kv_heads):
        raise NotImplementedError(
            f"{kernel} (flash decode) is not built for head_dim {head_dim} "
            f"with {n_heads} query heads over {n_kv_heads} kv heads "
            "(head_dim even for K10, whose rows are two nibble planes; "
            "n_heads a multiple of n_kv_heads)")
