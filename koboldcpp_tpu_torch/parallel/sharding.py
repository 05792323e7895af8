"""Mesh and Megatron-style weight shards over torch.distributed.

Port of koboldcpp_tpu/parallel/sharding.py. The JAX package places the
params on a device mesh with NamedShardings and XLA inserts the
collectives; here each rank of a `Mesh` holds only its slice of the
params, and models/llama.py's forward calls the collectives itself
(`TensorShard`):

  dp: data parallel: the batch (the slots of the batched engine) over
      dp; a batch dp does not divide is refused, as JAX's device_put
      refuses it.
  tp: tensor parallel: each rank takes a range of query heads (and the kv
      heads they read: where tp > n_kv_heads a kv head is replicated on
      the ranks of its group) and a range of the FFN's columns. wq / wk /
      wv / wqkv, w_gate / w_up / w_gateup and the head are column
      parallel (out rows), wo and w_down row parallel (in columns, then an
      all_reduce over tp); the fused wqkv and w_gateup are split part by
      part (q / k / v by heads, gate / up by halves) and fused again per
      rank. The head's vocab-sharded logits are all-gathered, so every
      rank holds the same logits.
  ep: expert parallel: the MoE expert stacks over the ep axis when the
      mesh has one, else over tp (dense-EP); each rank runs its experts'
      share and ops/moe.py's combine sums over that axis.

Packed QTensors split in whole 256-column quant blocks, unevenly where the
blocks do not divide (a 7B's w_down, 43 blocks, takes 11/11/11/10 at
tp=4), and the head in whole 256-row blocks (TinyLlama's 32000 rows take
16128 / 15872 at tp=2), so that a shard meets every rule of the kernel
dispatch (ops/quant_matmul.py `matmul_packed`) that the whole weight
meets. A weight whose shard would not is kept whole on every rank: a
column-parallel one computes its whole output and keeps its range
(`Sliced`), a row-parallel one gathers its input and only the tp
group's first rank adds the product (`Gathered`), so the all_reduce that
follows sums it once; models/llama.py runs such a `KeptWhole` weight's
own product. The JAX package's TPU sidecars (`_t` / `_pt`
fields, iq2p's in-dim replication) are layouts of the TPU; the port
shards on values.
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
    return QTensor(kind=qt.kind, shape=(qt.shape[0], c1 - c0), data=data)


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


def _col_parallel(qt: QTensor, ranges, whole_ok: bool):
    """Out rows `ranges` of qt, or the whole weight `Sliced` where that
    shard would break the dispatch rule the whole weight meets."""
    sub = _rows(qt, ranges)
    if _packed(qt) and whole_ok and not _meets_rule(sub.shape):
        return Sliced(qt, ranges)
    return sub


def _row_parallel(qt: QTensor, c0: int, c1: int, group: comm.Group, sizes,
                  whole_ok: bool):
    """In columns [c0, c1) of qt, or the whole weight `Gathered` where the
    range is not in whole quant blocks or the shard would break the
    dispatch rule the whole weight meets."""
    if _packed(qt) and (c0 % QBLOCK or c1 % QBLOCK
                        or (whole_ok and not _meets_rule((qt.shape[0],
                                                          c1 - c0)))):
        return Gathered(qt, group, sizes)
    return _cols(qt, c0, c1)


# ---------------------------------------------------------------------------
# the forward's collectives
# ---------------------------------------------------------------------------

@dataclass
class TensorShard:
    """What models/llama.py's forward needs of the shard it runs on
    (params["tp"]): the tp group (its row-parallel all_reduce and the
    head's all_gather), the global head counts (the flash-decode kernel
    is chosen on the global shape, as JAX chooses it), each tp rank's
    vocab rows, and the rank's expert range with the group its combine
    sums over."""
    group: comm.Group
    n_heads: int
    n_kv_heads: int
    vocab_sizes: list[int]
    experts: tuple[int, int] | None = None
    n_experts: int = 0
    expert_group: comm.Group | None = None

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        """The row-parallel sum over tp (of a fresh tensor, in place)."""
        return comm.all_reduce(x.contiguous(), self.group)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        return comm.all_gather(logits, self.group, -1, self.vocab_sizes)

    def reduce_experts(self, x: torch.Tensor) -> torch.Tensor:
        return comm.all_reduce(x.contiguous(), self.expert_group)


_REFUSED = (("bitnet", "bitnet's sub-norms over the sharded activations"),
            ("head_counts", "openelm's per-layer head counts"),
            ("qk_norm_per_head", "chameleon's (H, D) per-head QK norm"))


def check_shardable(cfg, params: dict, tp: int, experts: bool = False
                    ) -> None:
    """NotImplementedError where the port's shards would compute another
    function than the JAX package's global one: a model that
    models/llama.py does not run (its module calls no collective), a norm
    over the sharded activations (bitnet's sub-norms, a flat QK norm),
    per-layer or per-head tables (openelm's heads, chameleon's QK norm,
    ALiBi's slopes), or heads tp does not divide. experts: the expert
    stacks shard (over ep, or over tp)."""
    from ..models.loader import arch_module

    if tp == 1 and not experts:
        return
    module = arch_module(cfg.arch)
    if module is not None:
        raise NotImplementedError(
            f"tensor and expert parallelism serve the models/llama.py "
            f"decoders; {cfg.arch} runs {module.__name__.rsplit('.', 1)[-1]}"
            f".py, which shards nothing")
    if tp == 1:
        return
    ex = cfg.extras or {}
    why = next((w for k, w in _REFUSED if ex.get(k)), None)
    layer0 = (params.get("layers") or [{}])[0]
    if why is None and cfg.use_alibi:
        why = "ALiBi's per-head slopes"
    elif (why is None and "attn_q_norm" in layer0
          and not ex.get("qk_head_rms")):
        why = "a QK norm over the flat projection"
    elif why is None and (cfg.n_heads % tp or (
            cfg.n_kv_heads % tp if tp <= cfg.n_kv_heads
            else tp % cfg.n_kv_heads)):
        why = (f"{cfg.n_heads} query / {cfg.n_kv_heads} kv heads over "
               f"tp={tp}")
    if why:
        raise NotImplementedError(f"tensor parallelism does not take {why}")


def local_config(cfg, tp: int, t: int):
    """The config rank t of tp computes with: its query and kv heads."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    return dataclasses.replace(cfg, n_heads=H // tp,
                               n_kv_heads=Hkv // tp if tp <= Hkv else 1)


def _head_ranges(cfg, tp: int, t: int):
    """(q heads, kv heads) of tp rank t: a contiguous q range, and the kv
    heads it reads (one kv head per rank where tp > n_kv_heads)."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    h0, h1 = t * H // tp, (t + 1) * H // tp
    if tp <= Hkv:
        return (h0, h1), (t * Hkv // tp, (t + 1) * Hkv // tp)
    k0 = h0 // (H // Hkv)
    return (h0, h1), (k0, k0 + 1)


def _ffn_range(F: int, tp: int, t: int, blocks: bool) -> tuple[int, int]:
    """Rank t's FFN columns: in whole 256-column blocks for packed
    weights (the w_down in-dim), else an even split."""
    if blocks and F % QBLOCK == 0:
        b0, b1 = split(F // QBLOCK, tp, t)
        return b0 * QBLOCK, b1 * QBLOCK
    return split(F, tp, t)


def shard_params(params: dict, mesh: Mesh, cfg) -> dict:
    """This rank's shard of a model's params (models/loader.py layout):
    the JAX `shard_params` as explicit per-rank slices. Returns a new
    params dict holding `tp` (a TensorShard) where tp > 1 or the experts
    shard; the rank computes with `local_config(cfg, tp, t)`."""
    tp, t = mesh.shape["tp"], mesh.coords["tp"]
    ax = "ep" if "ep" in mesh.shape else "tp"
    n_exp, e_range = cfg.n_experts, None
    if n_exp and (mesh.shape[ax] > 1) and n_exp % mesh.shape[ax] == 0:
        e_range = split(n_exp, mesh.shape[ax], mesh.coords[ax])
    check_shardable(cfg, params, tp, e_range is not None)
    tg = mesh.group("tp")
    D = cfg.head_dim
    (h0, h1), (k0, k1) = _head_ranges(cfg, tp, t)
    qdim, kvdim = cfg.n_heads * D, cfg.n_kv_heads * D
    q_r = (h0 * D, h1 * D)
    k_r = (qdim + k0 * D, qdim + k1 * D)
    v_r = (qdim + kvdim + k0 * D, qdim + kvdim + k1 * D)
    wo_sizes = [(_head_ranges(cfg, tp, i)[0][1]
                 - _head_ranges(cfg, tp, i)[0][0]) * D for i in range(tp)]

    def place_layer(layer: dict) -> dict:
        out = {}
        gu = layer.get("w_gateup", layer.get("w_up"))
        F = (gu.shape[0] // 2 if "w_gateup" in layer else gu.shape[0]) \
            if gu is not None else 0
        blocks = any(isinstance(layer.get(k), QTensor) and _packed(layer[k])
                     for k in ("w_down", "w_gateup", "w_up"))
        f0, f1 = _ffn_range(F, tp, t, blocks)
        f_sizes = [b - a for a, b in (_ffn_range(F, tp, i, blocks)
                                      for i in range(tp))]
        for k, v in layer.items():
            if tp == 1 and k not in _EXPERT_SHARDED:
                out[k] = v
            elif k in _EXPERT_SHARDED:
                out[k] = v if e_range is None else QTensor(
                    kind=v.kind, shape=v.shape,
                    data={"w": v.data["w"][e_range[0]:e_range[1]]
                          .contiguous()})
            elif k == "wqkv":
                out[k] = _col_parallel(v, [q_r, k_r, v_r], True)
            elif k == "bqkv":
                out[k] = torch.cat([v[a:b] for a, b in (q_r, k_r, v_r)])
            elif k in ("wq", "bq"):
                out[k] = (_col_parallel(v, [q_r], True)
                          if isinstance(v, QTensor) else v[q_r[0]:q_r[1]])
            elif k in ("wk", "wv", "bk", "bv"):
                r = (k0 * D, k1 * D)
                out[k] = (_col_parallel(v, [r], True)
                          if isinstance(v, QTensor) else v[r[0]:r[1]])
            elif k == "w_gateup":
                out[k] = _col_parallel(v, [(f0, f1), (F + f0, F + f1)], True)
            elif k in ("w_gate", "w_up"):
                out[k] = _col_parallel(v, [(f0, f1)], True)
            elif k in ("b_gate", "b_up"):
                out[k] = v[f0:f1]
            elif k == "wo":
                out[k] = _row_parallel(v, q_r[0], q_r[1], tg, wo_sizes, True)
            elif k == "w_down":
                out[k] = _row_parallel(v, f0, f1, tg, f_sizes, True)
            elif k in ("bo", "b_down"):
                if t == 0:  # added once: the all_reduce sums the rest
                    out[k] = v
            else:
                out[k] = v
        return out

    out = {k: v for k, v in params.items() if k != "layers"}
    out["layers"] = [place_layer(layer) for layer in params["layers"]]
    vocab = cfg.vocab_size
    head = params.get("output")
    vocab_sizes = [vocab]
    if tp > 1 and isinstance(head, QTensor):
        blocks = _packed(head) and vocab % QBLOCK == 0
        ranges = [(split(vocab // QBLOCK, tp, i) if blocks
                   else split(vocab, tp, i)) for i in range(tp)]
        if blocks:
            ranges = [(a * QBLOCK, b * QBLOCK) for a, b in ranges]
        vocab_sizes = [b - a for a, b in ranges]
        sub = _rows(head, [ranges[t]])
        if head is params.get("tok_embd"):
            out["tok_embd"] = head  # a tied head: the embedding stays whole
        out["output"] = (Sliced(head, [ranges[t]]) if _packed(head)
                         and _meets_rule(head.shape)
                         and not _meets_rule(sub.shape) else sub)
    if tp > 1 or e_range is not None:
        out["tp"] = TensorShard(
            tg, cfg.n_heads, cfg.n_kv_heads, vocab_sizes,
            experts=e_range, n_experts=n_exp,
            expert_group=mesh.group(ax) if e_range is not None else None)
    return out


def shard_model(model, mesh: Mesh):
    """A models/loader.py Model's shard for this rank: sharded params, the
    rank's local config, on the rank's device."""
    from ..models.loader import Model

    cfg = model.cfg
    params = shard_params(model.params, mesh, cfg)
    lcfg = local_config(cfg, mesh.shape["tp"], mesh.coords["tp"])
    return Model(lcfg, params, model.tokenizer, model.device)


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
    _, (k0, k1) = _head_ranges(cfg, mesh.shape["tp"], mesh.coords["tp"])
    D = cfg.head_dim

    def part(x):
        return x[r0:r1, :, k0 * D:k1 * D].contiguous()
    return KVCache(k=[part(x) for x in cache.k], v=[part(x) for x in cache.v],
                   heads=k1 - k0)


def token_sharding(mesh: Mesh, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's dp rows of a (B, T) batch (the JAX `token_sharding`'s
    P("dp", None))."""
    r0, r1 = cache_rows_of(mesh, tokens.shape[0])
    return tokens[r0:r1]


