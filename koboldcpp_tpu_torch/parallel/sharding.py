"""Mesh and Megatron-style weight shards over torch.distributed.

Port of koboldcpp_tpu/parallel/sharding.py. The JAX package places the
params on a device mesh with NamedShardings and XLA inserts the
collectives; here each rank of a `Mesh` holds only its slice of the
params, and the model's forward calls the collectives itself through
params["tp"] (`TensorShard`: `reduce`, `gather_vocab`, the norms over
sharded activations) and this module's `matmul`, `reduce` and
`head_logits`:

  dp: data parallel: the batch (the slots of the batched engine) over
      dp; a batch dp does not divide is refused, as JAX's device_put
      refuses it.
  tp: tensor parallel. The models/llama.py decoders and the BERT
      encoders: each rank takes a range of query heads (whole kv groups,
      or an even split of the query heads and the kv heads they read
      where tp > n_kv_heads; `HeadShard`, per layer for openelm) and a
      range of the FFN's columns. wq / wk / wv / wqkv, w_gate / w_up /
      w_gateup and the head are column parallel (out rows), wo and w_down
      row parallel (in columns, then an all_reduce over tp); the fused
      wqkv and w_gateup are split part by part and fused again per rank.
      A norm over sharded activations (bitnet's sub-norms, a flat QK
      norm, jina's QK layer norm) sums its statistics over tp; per-head
      tables (chameleon's QK norm, ALiBi's slopes) take the rank's heads.
      deepseek2 / minicpm3 shard by heads (wq or wq_b, wkv_b, wo, the MLA
      cache), RWKV6 its time mix by heads and RWKV-4 by channels (with
      their recurrent state), the dense and shared-expert FFNs and RWKV's
      channel mix Megatron-style; Mamba and T5 shard their head only, as
      JAX does. The head's vocab-sharded logits are all-gathered, so
      every rank holds the same logits.
  ep: expert parallel: the MoE expert stacks over the ep axis when the
      mesh has one, else over tp (dense-EP); each rank runs its experts'
      share and the combine sums over that axis.

Packed QTensors split in whole 256-column quant blocks, unevenly where the
blocks do not divide (a 7B's w_down, 43 blocks, takes 11/11/11/10 at
tp=4), and the head in whole 256-row blocks (TinyLlama's 32000 rows take
16128 / 15872 at tp=2), so that a shard meets every rule of the kernel
dispatch (ops/quant_matmul.py `matmul_packed`) that the whole weight
meets. A weight whose shard would not is kept whole on every rank: a
column-parallel one computes its whole output and keeps its range
(`Sliced`), a row-parallel one gathers its input and only the tp
group's first rank adds the product (`Gathered`), so the all_reduce that
follows sums it once; `matmul` runs such a `KeptWhole` weight's own
product. The JAX package's TPU sidecars (`_t` / `_pt` fields, iq2p's
in-dim replication) are layouts of the TPU; the port shards on values.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import linear
from ..ops.linear import QTensor
from . import comm

# MoE expert stacks (E, F, C): the expert axis over ep (or tp)
_EXPERT_SHARDED = {"ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"}
QBLOCK = 256  # columns of a K-quant superblock; rows of a head block


class Mesh:
    """A grid of ranks over named axes (("dp", "tp"), ("dp", "tp", "ep"),
    or one axis: "pp", "sp"), one process group per axis through this
    rank, and the rank-to-device map. Ranks lie in numpy's reshape order
    (the last axis fastest), as the JAX mesh lays its devices out. Every
    rank of the default group must build the same mesh: the groups are
    made collectively."""

    def __init__(self, axes: dict[str, int], devices=None,
                 backend: str | None = None):
        import itertools

        import torch.distributed as dist

        self.axis_names = tuple(axes)
        self.shape = dict(axes)
        sizes = [axes[a] for a in self.axis_names]
        n = 1
        for k in sizes:
            n *= k
        world = dist.get_world_size()
        if n != world:
            raise ValueError(f"a mesh of {' x '.join(map(str, sizes))} "
                             f"ranks needs {n} processes (have {world})")
        self.rank = dist.get_rank()
        self.backend = backend or dist.get_backend()
        self.devices = [torch.device(*d) if isinstance(d, tuple)
                        else torch.device(d) for d in (
            devices or [("cuda", r) if self.backend == "nccl" else "cpu"
                        for r in range(n)])]
        self.device = self.devices[self.rank]
        grid = list(itertools.product(*(range(k) for k in sizes)))
        self.coords = dict(zip(self.axis_names, grid[self.rank]))
        self.world = comm.world_group()
        self.groups: dict[str, comm.Group] = {}
        for i, axis in enumerate(self.axis_names):
            lines: dict[tuple, list[int]] = {}
            for r, c in enumerate(grid):  # ranks sharing the other coords
                lines.setdefault(c[:i] + c[i + 1:], []).append(r)
            for ranks in lines.values():
                g = comm.new_group(ranks, self.backend)
                if g.index >= 0:
                    self.groups[axis] = g

    @property
    def size(self) -> int:
        return len(self.devices)

    def group(self, axis: str) -> comm.Group:
        return self.groups[axis]


def make_mesh(n_devices: int | None = None, dp: int | None = None,
              tp: int | None = None, devices=None, ep: int | None = None,
              backend: str | None = None) -> Mesh:
    """The JAX `make_mesh` over the default process group's ranks: with
    `ep`, a (dp, tp, ep) mesh (tp defaults to n // ep); else (dp, tp),
    favouring tp (up to 8, halved until it divides n). devices: each
    rank's device (default cuda:<rank> under NCCL, the CPU under gloo);
    backend: the groups' backend (default the default group's)."""
    import torch.distributed as dist

    n = n_devices or dist.get_world_size()
    if ep:
        if dp is None or tp is None:
            tp = tp or max(1, n // ep)
            dp = n // (tp * ep)
        return Mesh({"dp": dp, "tp": tp, "ep": ep}, devices, backend)
    if dp is None or tp is None:
        tp = tp or min(n, 8)
        while n % tp:
            tp //= 2
        dp = n // tp
    return Mesh({"dp": dp, "tp": tp}, devices, backend)


def split(n: int, parts: int, index: int) -> tuple[int, int]:
    """Part `index` of n units cut into `parts` ranges as evenly as they
    go, the first n % parts one unit longer."""
    base, extra = divmod(n, parts)
    start = index * base + min(index, extra)
    return start, start + base + (index < extra)


# ---------------------------------------------------------------------------
# shards of one weight
# ---------------------------------------------------------------------------

def _packed(qt: QTensor) -> bool:
    return qt.kind != "dense"


def _rows(qt: QTensor, ranges) -> QTensor:
    """The out rows of `ranges` ([(start, stop)...], concatenated) of
    every field: each field keeps its out rows on dim 0."""
    data = {n: torch.cat([a[r0:r1] for r0, r1 in ranges]).contiguous()
            if len(ranges) > 1 else a[ranges[0][0]:ranges[0][1]].contiguous()
            for n, a in qt.data.items()}
    out = sum(r1 - r0 for r0, r1 in ranges)
    return QTensor(kind=qt.kind, shape=(out, qt.shape[1]), data=data)


def _cols(qt: QTensor, c0: int, c1: int) -> QTensor:
    """In columns [c0, c1) of every field: a field's last dim holds the in
    columns at a fixed ratio, superblock by superblock (ops/linear.py's
    layouts), so [c0, c1) in whole superblocks is a contiguous slice."""
    in_f = qt.shape[1]
    data = {}
    for n, a in qt.data.items():
        w = a.shape[-1]
        data[n] = a[..., c0 * w // in_f:c1 * w // in_f].contiguous()
    return QTensor(kind=qt.kind, shape=(qt.shape[0], c1 - c0), data=data,
                   whole_in_f=qt.whole_in_f or in_f)


def _meets_rule(shape) -> bool:
    """The packed kernels' dispatch rule (`matmul_packed`)."""
    return not (shape[0] % QBLOCK or shape[1] % QBLOCK)


class KeptWhole:
    """A weight that a shard keeps whole on every rank: models/llama.py
    runs its `matmul` in place of ops/linear.py's."""


class Sliced(KeptWhole):
    """A column-parallel weight kept whole: every rank computes the whole
    output and keeps its range of it."""

    def __init__(self, qt: QTensor, ranges):
        self.qt, self.ranges = qt, ranges
        self.shape = (sum(r1 - r0 for r0, r1 in ranges), qt.shape[1])

    def matmul(self, x, out_dtype=None):
        y = linear.matmul(x, self.qt, out_dtype)
        return torch.cat([y[..., r0:r1] for r0, r1 in self.ranges], dim=-1)


class Gathered(KeptWhole):
    """A row-parallel weight kept whole: the rank's input columns are
    gathered over tp and the tp group's first rank computes the whole
    product; the others give zeros, so the all_reduce after it sums the
    product once, exactly."""

    def __init__(self, qt: QTensor, group: comm.Group, sizes):
        self.qt, self.group, self.sizes = qt, group, sizes
        self.shape = (qt.shape[0], sizes[group.index])

    def matmul(self, x, out_dtype=None):
        xf = comm.all_gather(x, self.group, -1, self.sizes)
        if self.group.index == 0:
            return linear.matmul(xf, self.qt, out_dtype)
        return x.new_zeros(*x.shape[:-1], self.qt.shape[0],
                           dtype=out_dtype or x.dtype)


def _col_parallel(qt: QTensor, ranges):
    """Out rows `ranges` of qt, or the whole weight `Sliced` where that
    shard would break the dispatch rule the whole weight meets."""
    sub = _rows(qt, ranges)
    if _packed(qt) and _meets_rule(qt.shape) and not _meets_rule(sub.shape):
        return Sliced(qt, ranges)
    return sub


def _row_parallel(qt: QTensor, c0: int, c1: int, group: comm.Group, sizes):
    """In columns [c0, c1) of qt, or the whole weight `Gathered` where the
    range is not in whole quant blocks or the shard would break the
    dispatch rule the whole weight meets."""
    if _packed(qt) and (c0 % QBLOCK or c1 % QBLOCK or (
            _meets_rule(qt.shape)
            and not _meets_rule((qt.shape[0], c1 - c0)))):
        return Gathered(qt, group, sizes)
    return _cols(qt, c0, c1)


def _vec(v: torch.Tensor, ranges) -> torch.Tensor:
    """Entries `ranges` of a vector (or rows of a table), concatenated."""
    return torch.cat([v[a:b] for a, b in ranges]).contiguous()


def _merged(ranges) -> list[tuple[int, int]]:
    """Adjacent ranges joined."""
    out: list[tuple[int, int]] = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def matmul(x: torch.Tensor, w, out_dtype=None) -> torch.Tensor:
    """x @ w.T through ops/linear.py, or the product of a weight that a
    tensor-parallel shard keeps whole (`KeptWhole`)."""
    if isinstance(w, KeptWhole):
        return w.matmul(x, out_dtype)
    return linear.matmul(x, w, out_dtype)


# ---------------------------------------------------------------------------
# the forward's collectives
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class HeadShard:
    """One layer's attention heads on a tp rank: query heads [q0, q1) of
    the layer's n_q and the kv heads they read, in the rank's order, of
    its n_kv. Where the rank's query heads fall into whole groups of
    equal size, each kv head appears once; otherwise the rank holds one kv
    head per query head (kv heads repeat), so that its heads keep a
    uniform grouping. copies: per kv head of the rank, how many copies
    of it all tp ranks hold together (a norm over the flat K counts each
    kv head once)."""
    q: tuple[int, int]
    kv: tuple[int, ...]
    n_q: int
    n_kv: int
    copies: tuple[int, ...]


def _kv_heads(nq: int, nkv: int, tp: int, t: int):
    """(query range, kv heads) of rank t: whole kv groups where tp <=
    n_kv (unevenly where tp does not divide), else an even split of the
    query heads and the kv heads they read."""
    g = nq // nkv
    if tp <= nkv:
        k0, k1 = split(nkv, tp, t)
        return (k0 * g, k1 * g), tuple(range(k0, k1))
    q0, q1 = split(nq, tp, t)
    kv = [h // g for h in range(q0, q1)]
    runs = {kv.count(k) for k in kv}
    return (q0, q1), tuple(dict.fromkeys(kv) if len(runs) == 1 else kv)


def head_shard(nq: int, nkv: int, tp: int, t: int) -> HeadShard:
    """Rank t's `HeadShard` of a layer with nq >= tp query and nkv kv
    heads (`check_shardable`)."""
    plans = [_kv_heads(nq, nkv, tp, i) for i in range(tp)]
    (q0, q1), kv = plans[t]
    n = [sum(p[1].count(k) for p in plans) for k in range(nkv)]
    return HeadShard((q0, q1), kv, nq, nkv, tuple(n[k] for k in kv))


@dataclass
class TensorShard:
    """What a model's forward needs of the shard it runs on
    (params["tp"]): the tp group (the row-parallel all_reduce, the
    norms over sharded activations and the head's all_gather), the global
    head counts (the flash-decode kernel is chosen on the global shape,
    as JAX chooses it), each tp rank's vocab rows, the rank's expert range
    with the group its combine sums over, per layer its `HeadShard` and
    FFN width (the widths of the norms over them), and an RWKV rank's
    time-mix channels."""
    group: comm.Group
    n_heads: int
    n_kv_heads: int
    vocab_sizes: list[int]
    experts: tuple[int, int] | None = None
    n_experts: int = 0
    expert_group: comm.Group | None = None
    heads: list = dataclasses.field(default_factory=list)
    ffn: list = dataclasses.field(default_factory=list)
    channels: tuple[int, int] | None = None

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel sum over tp (of a fresh tensor, in place)."""
        return comm.all_reduce(x.contiguous(), self.group)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(logits, self.group, -1, self.vocab_sizes)

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x.contiguous(), self.expert_group)

    def rms_norm(self, x: torch.Tensor, weight: torch.Tensor, eps: float,
                 n: int, copies=None) -> torch.Tensor:
        """ops/norms.py's rms_norm over a dim of n columns of which x holds
        this rank's part: the sum of squares is summed over tp before it
        divides. copies: per head of x (its last dim in heads of equal
        width), how many ranks hold that head; its squares count once."""
        xf = x.float()
        sq = xf * xf
        if copies is not None and any(c != 1 for c in copies):
            w = torch.tensor([1.0 / c for c in copies], device=x.device)
            sq = (sq.unflatten(-1, (len(copies), -1))
                  * w[:, None]).flatten(-2)
        ss = self.reduce(sq.sum(dim=-1, keepdim=True))
        out = xf * torch.rsqrt(ss / n + eps)
        return (out * weight.float()).to(x.dtype)

    def layer_norm(self, x: torch.Tensor, weight: torch.Tensor,
                   bias: torch.Tensor | None, eps: float,
                   n: int) -> torch.Tensor:
        """ops/norms.py's layer_norm over a dim of n columns of which x
        holds this rank's part: the mean and the variance summed over
        tp."""
        xf = x.float()
        mean = self.reduce(xf.sum(dim=-1, keepdim=True)) / n
        var = self.reduce(((xf - mean) ** 2).sum(dim=-1, keepdim=True)) / n
        out = (xf - mean) * (var + eps) ** -0.5 * weight.float()
        if bias is not None:
            out = out + bias.float()
        return out.to(x.dtype)


def reduce(params: dict, x: torch.Tensor) -> torch.Tensor:
    """The sum over tp of a row-parallel product, or x unsharded."""
    tp = params.get("tp")
    return x if tp is None else tp.reduce(x)


def head_logits(params: dict, x: torch.Tensor,
                key: str = "output") -> torch.Tensor:
    """The f32 logits of the head params[key]: under tensor parallelism
    the rank's vocab rows, gathered so that every rank holds them all."""
    logits = matmul(x, params[key], out_dtype=torch.float32)
    tp = params.get("tp")
    return logits if tp is None else tp.gather_vocab(logits)


def check_shardable(cfg, tp: int) -> None:
    """The one shape the shards refuse: a layer with fewer query heads
    than tp ranks (a rank would hold no head). Every other shape shards,
    unevenly where tp does not divide it, or stays whole."""
    if tp == 1 or _family(cfg) in ("mamba", "t5", "rwkv4"):
        return
    counts = (cfg.extras or {}).get("head_counts") or [cfg.n_heads]
    for li, nq in enumerate(counts):
        if nq < tp:
            raise NotImplementedError(
                f"tp={tp} is more ranks than layer {li}'s {nq} query heads")


def _family(cfg) -> str:
    """The module a model runs: "llama" for the models/llama.py decoders,
    else its models/ module's name."""
    from ..models.loader import arch_module

    m = arch_module(cfg.arch)
    return "llama" if m is None else m.__name__.rsplit(".", 1)[-1]


def _packed_any(layer: dict, keys) -> bool:
    return any(isinstance(layer.get(k), QTensor) and _packed(layer[k])
               for k in keys)


class _Cols:
    """A rank's share of n columns sharded over tp, in whole 256-column
    blocks for packed weights where every rank gets one, else an even
    split: its range `r` and every rank's width."""

    def __init__(self, n: int, tp: int, t: int, blocks: bool):
        if blocks and n % QBLOCK == 0 and n // QBLOCK >= tp:
            cuts = [(a * QBLOCK, b * QBLOCK) for a, b in
                    (split(n // QBLOCK, tp, i) for i in range(tp))]
        else:
            cuts = [split(n, tp, i) for i in range(tp)]
        self.r = cuts[t]
        self.sizes = [b - a for a, b in cuts]


def _place_decoder(layer: dict, li: int, cfg, tp: int, t: int, tg,
                   bo_partial: bool):
    """A models/llama.py or models/bert.py layer's shard: heads and FFN
    columns Megatron-style (fused wqkv / w_gateup part by part), QK-norm
    and sub-norm tables cut with their activations. bo_partial: the
    output bias is added before the all_reduce (bert), so it goes to rank
    0 alone; else after it (llama), on every rank."""
    ex = cfg.extras or {}
    hc, kvc = ex.get("head_counts"), ex.get("kv_head_counts")
    nq = hc[li] if hc else cfg.n_heads
    nkv = kvc[li] if kvc else cfg.n_kv_heads
    hs = head_shard(nq, nkv, tp, t)
    D = cfg.head_dim
    q_r = [(hs.q[0] * D, hs.q[1] * D)]
    kv_r = _merged([(k * D, (k + 1) * D) for k in hs.kv])

    def off(rs, o):
        return [(a + o, b + o) for a, b in rs]
    qkv_r = q_r + off(kv_r, nq * D) + off(kv_r, (nq + nkv) * D)
    wo_sizes = [(p[1] - p[0]) * D for p in
                (_kv_heads(nq, nkv, tp, i)[0] for i in range(tp))]
    gu = layer.get("w_gateup", layer.get("w_up"))
    F = 0 if gu is None else (gu.shape[0] // 2 if "w_gateup" in layer
                              else gu.shape[0])
    fc = _Cols(F, tp, t, _packed_any(layer, ("w_down", "w_gateup", "w_up")))
    (f0, f1) = fc.r
    per_head = ex.get("qk_norm_per_head")
    head_rms = ex.get("qk_head_rms")
    out = {}
    for k, v in layer.items():
        if k in _EXPERT_SHARDED:
            out[k] = v  # placed by shard_params
        elif k == "wqkv":
            out[k] = _col_parallel(v, _merged(qkv_r))
        elif k == "bqkv":
            out[k] = _vec(v, qkv_r)
        elif k in ("wq", "bq"):
            out[k] = (_col_parallel(v, q_r) if isinstance(v, QTensor)
                      else _vec(v, q_r))
        elif k in ("wk", "wv", "bk", "bv"):
            out[k] = (_col_parallel(v, kv_r) if isinstance(v, QTensor)
                      else _vec(v, kv_r))
        elif k in ("attn_q_norm", "attn_q_norm_bias"):
            out[k] = (v if head_rms else v[hs.q[0]:hs.q[1]] if per_head
                      else _vec(v, q_r))
        elif k in ("attn_k_norm", "attn_k_norm_bias"):
            out[k] = (v if head_rms else v[list(hs.kv)] if per_head
                      else _vec(v, kv_r))
        elif k == "attn_sub_norm":
            out[k] = _vec(v, q_r)
        elif k == "w_gateup":
            out[k] = _col_parallel(v, [(f0, f1), (F + f0, F + f1)])
        elif k in ("w_gate", "w_up"):
            out[k] = _col_parallel(v, [(f0, f1)])
        elif k in ("b_gate", "b_up", "ffn_sub_norm"):
            out[k] = v[f0:f1]
        elif k == "wo":
            out[k] = _row_parallel(v, q_r[0][0], q_r[0][1], tg, wo_sizes)
        elif k == "w_down":
            out[k] = _row_parallel(v, f0, f1, tg, fc.sizes)
        elif k == "b_down" or (k == "bo" and bo_partial):
            if t == 0:  # added once: the all_reduce sums the rest
                out[k] = v
        else:
            out[k] = v
    return out, hs, F


def _place_deepseek2(layer: dict, cfg, tp: int, t: int, tg):
    """A models/deepseek2.py layer's shard: wq / wq_b and wkv_b by heads,
    wo row-parallel over them (each rank's MLA cache holds its heads);
    the lead dense FFN and the shared experts Megatron-style; wq_a,
    wkv_a_mqa and the norms whole."""
    H = cfg.n_heads
    dk, dv = cfg.head_dim, cfg.extras["v_head_dim"]
    dn = dk - cfg.rope_dim
    heads = [split(H, tp, i) for i in range(tp)]
    h0, h1 = heads[t]
    out = {}
    ffn = {}
    for keys in (("w_gate", "w_up", "w_down"),
                 ("ffn_gate_shexp", "ffn_up_shexp", "ffn_down_shexp")):
        if keys[0] in layer:
            ffn[keys] = _Cols(layer[keys[0]].shape[0], tp, t,
                              _packed_any(layer, keys))
    for k, v in layer.items():
        if k in ("wq", "wq_b"):
            out[k] = _col_parallel(v, [(h0 * dk, h1 * dk)])
        elif k == "wkv_b":
            out[k] = _col_parallel(v, [(h0 * (dn + dv), h1 * (dn + dv))])
        elif k == "wo":
            out[k] = _row_parallel(v, h0 * dv, h1 * dv, tg,
                                   [(b - a) * dv for a, b in heads])
        else:
            keys = next((ks for ks in ffn if k in ks), None)
            if keys is None:
                out[k] = v
            elif k == keys[2]:
                c = ffn[keys]
                out[k] = _row_parallel(v, c.r[0], c.r[1], tg, c.sizes)
            else:
                out[k] = _col_parallel(v, [ffn[keys].r])
    return out


def _place_rwkv(layer: dict, cfg, tp: int, t: int, tg, v6: bool):
    """An RWKV layer's shard: the time mix by heads (RWKV6: its group norm
    is per head) or channels (RWKV-4: its recurrence is per channel) with
    the rank's part of the recurrent state, wo row-parallel over them; the
    channel mix Megatron-style (ck by rows, cv by columns, the sum over
    tp before the receptance gate); the token-shift lerps, the w1 / w2 /
    decay_w1 bottleneck and cr whole."""
    C = cfg.hidden_size
    if v6:
        hc = _Cols(cfg.n_heads, tp, t, False)
        D = cfg.head_dim
        cr, csz = (hc.r[0] * D, hc.r[1] * D), [s * D for s in hc.sizes]
    else:
        cc = _Cols(C, tp, t, _packed_any(layer, ("wo",)))
        cr, csz = cc.r, cc.sizes
    fc = _Cols(layer["ck"].shape[0], tp, t, _packed_any(layer, ("cv",)))
    rows_c = ("wr", "wk", "wv", "wg", "decay_w2")
    vec_c = ("decay", "ln_x", "ln_x_b") + (() if v6 else ("first",))
    out = {}
    for k, v in layer.items():
        if k in rows_c:
            out[k] = _col_parallel(v, [cr])
        elif k in vec_c:
            out[k] = v[cr[0]:cr[1]]
        elif k == "first":  # RWKV6: (H, D)
            out[k] = v[hc.r[0]:hc.r[1]]
        elif k == "wo":
            out[k] = _row_parallel(v, cr[0], cr[1], tg, csz)
        elif k == "ck":
            out[k] = _col_parallel(v, [fc.r])
        elif k == "cv":
            out[k] = _row_parallel(v, fc.r[0], fc.r[1], tg, fc.sizes)
        else:
            out[k] = v
    return out, cr


def shard_params(params: dict, mesh: Mesh, cfg) -> dict:
    """This rank's shard of a model's params (its module's layout): the
    JAX `shard_params` as explicit per-rank slices, with each module
    calling the collectives its shard needs. The JAX rules: the
    projections it row-shards (wq / wk / wv / wqkv, w_gate / w_up /
    w_gateup, the head) shard their out rows, wo / w_down their in
    columns, the expert stacks the expert axis over ep (or tp), and
    everything else stays whole, T5's encoder and decoder blocks
    included. Past those names a module's weights shard where the same
    function results (bert's, deepseek2's and rwkv's, as their
    `_place_*` say). Returns a new params dict holding `tp` (a
    TensorShard) where tp > 1 or the experts shard; the rank computes
    with `local_config(cfg, params["tp"])`."""
    tp, t = mesh.shape["tp"], mesh.coords["tp"]
    ax = "ep" if "ep" in mesh.shape else "tp"
    n_exp, e_range = cfg.n_experts, None
    if n_exp and (mesh.shape[ax] > 1) and n_exp % mesh.shape[ax] == 0:
        e_range = split(n_exp, mesh.shape[ax], mesh.coords[ax])
    if tp == 1 and e_range is None:
        return dict(params)
    check_shardable(cfg, tp)
    tg = mesh.group("tp")
    fam = _family(cfg)
    heads, ffn, chans = [], [], []

    def place_layer(li: int, layer: dict) -> dict:
        if tp == 1:
            out = dict(layer)
        elif fam in ("llama", "bert"):
            out, hs, F = _place_decoder(layer, li, cfg, tp, t, tg,
                                        bo_partial=fam == "bert")
            heads.append(hs)
            ffn.append(F)
        elif fam == "deepseek2":
            out = _place_deepseek2(layer, cfg, tp, t, tg)
        elif fam in ("rwkv6", "rwkv4"):
            out, cr = _place_rwkv(layer, cfg, tp, t, tg, fam == "rwkv6")
            chans.append(cr)
        else:  # mamba, t5: JAX shards only their head
            out = dict(layer)
        for k in _EXPERT_SHARDED & set(layer):
            v = layer[k]
            out[k] = v if e_range is None else QTensor(
                kind=v.kind, shape=v.shape,
                data={"w": v.data["w"][e_range[0]:e_range[1]].contiguous()})
        return out

    out = {k: v for k, v in params.items() if k != "layers"}
    if "layers" in params:
        out["layers"] = [place_layer(li, layer)
                         for li, layer in enumerate(params["layers"])]
    vocab = cfg.vocab_size
    head = params.get("output")
    vocab_sizes = [vocab]
    if tp > 1 and isinstance(head, QTensor) and head.shape[0] == vocab:
        blocks = _packed(head) and vocab % QBLOCK == 0
        ranges = [(split(vocab // QBLOCK, tp, i) if blocks
                   else split(vocab, tp, i)) for i in range(tp)]
        if blocks:
            ranges = [(a * QBLOCK, b * QBLOCK) for a, b in ranges]
        vocab_sizes = [b - a for a, b in ranges]
        if head is params.get("tok_embd"):
            out["tok_embd"] = head  # a tied head: the embedding stays whole
        out["output"] = _col_parallel(head, [ranges[t]])
    out["tp"] = TensorShard(
        tg, cfg.n_heads, cfg.n_kv_heads, vocab_sizes,
        experts=e_range, n_experts=n_exp,
        expert_group=mesh.group(ax) if e_range is not None else None,
        heads=heads, ffn=ffn, channels=chans[0] if chans else None)
    return out


def local_config(cfg, shard: TensorShard | None):
    """The config a rank computes with under `shard` (params["tp"]): its
    query and kv heads (openelm: per layer), ALiBi's slopes from the
    rank's first head on (`alibi_heads`), RWKV6's heads and RWKV-4's WKV
    channels (`wkv_channels`)."""
    if shard is None or shard.group.size == 1:
        return cfg
    fam = _family(cfg)
    ex = dict(cfg.extras or {})
    if fam in ("llama", "bert") and shard.heads:
        nq = [h.q[1] - h.q[0] for h in shard.heads]
        nkv = [len(h.kv) for h in shard.heads]
        if ex.get("head_counts"):
            ex["head_counts"], ex["kv_head_counts"] = nq, nkv
        if cfg.use_alibi:
            ex["alibi_heads"] = (shard.heads[0].n_q, shard.heads[0].q[0])
        return dataclasses.replace(cfg, n_heads=max(nq), n_kv_heads=max(nkv),
                                   extras=ex)
    if fam == "deepseek2":
        h0, h1 = split(cfg.n_heads, shard.group.size, shard.group.index)
        return dataclasses.replace(cfg, n_heads=h1 - h0)
    if fam == "rwkv6":
        c0, c1 = shard.channels
        return dataclasses.replace(cfg, n_heads=(c1 - c0) // cfg.head_dim)
    if fam == "rwkv4":
        c0, c1 = shard.channels
        ex["wkv_channels"] = c1 - c0
        return dataclasses.replace(cfg, extras=ex)
    return cfg


def shard_model(model, mesh: Mesh):
    """A models/loader.py Model's shard for this rank: sharded params, the
    rank's local config, on the rank's device."""
    from ..models.loader import Model

    params = shard_params(model.params, mesh, model.cfg)
    return Model(local_config(model.cfg, params.get("tp")), params,
                 model.tokenizer, model.device)


def cache_rows_of(mesh: Mesh, n_slots: int) -> tuple[int, int]:
    """The slots (batch rows) of this rank's dp index: dp must divide the
    batch, as JAX's device_put of a dp-sharded batch requires."""
    dp = mesh.shape["dp"]
    if n_slots % dp:
        raise ValueError(f"a batch of {n_slots} does not divide over "
                         f"dp={dp}")
    per = n_slots // dp
    d = mesh.coords["dp"]
    return d * per, (d + 1) * per


def shard_params_stacked(params: dict, mesh: Mesh, cfg) -> dict:
    """TP shard of a stack_layers() pytree (the JAX
    `shard_params_stacked`): the layers shard as `shard_params` shards
    them and stack again. NotImplementedError where a weight's shard
    would be kept whole (`Sliced` / `Gathered` do not stack)."""
    from ..models.llama import _take_layer, stack_layers

    st = params["layers_stacked"]
    flat = {k: v for k, v in params.items() if k != "layers_stacked"}
    flat["layers"] = [_take_layer(st, i)
                      for i in range(st["attn_norm"].shape[0])]
    out = shard_params(flat, mesh, cfg)
    if any(isinstance(v, KeptWhole) for v in out["layers"][0].values()):
        raise NotImplementedError(
            "a stacked model whose shards do not all meet the kernel "
            "dispatch rule (kept whole on every rank) does not stack")
    return stack_layers(out)


def shard_cache(cache, mesh: Mesh, cfg):
    """This rank's part of a per-layer fused (B, S, Hkv*D) KVCache (the
    JAX `shard_cache`): its dp rows and its kv heads."""
    from ..kv.cache import KVCache

    r0, r1 = cache_rows_of(mesh, cache.k[0].shape[0])
    kv = head_shard(cfg.n_heads, cfg.n_kv_heads, mesh.shape["tp"],
                    mesh.coords["tp"]).kv
    D = cfg.head_dim
    cols = _merged([(k * D, (k + 1) * D) for k in kv])

    def part(x):
        return torch.cat([x[r0:r1, :, a:b] for a, b in cols], dim=-1)
    return KVCache(k=[part(x) for x in cache.k], v=[part(x) for x in cache.v],
                   heads=len(kv))


def token_sharding(mesh: Mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's dp rows of a (B, T) batch (the JAX `token_sharding`'s
    P("dp", None))."""
    r0, r1 = cache_rows_of(mesh, tokens.shape[0])
    return tokens[r0:r1]


