"""Collectives over explicit torch.distributed process groups.

The port's counterpart of the collectives that XLA inserts for the JAX
package's sharded programs (psum, pmax, all_gather, ppermute) and of
`multihost_utils.broadcast_one_to_all`: `all_reduce` (sum or max),
`all_gather` along a dim (shards of unequal length padded to the longest
and cut back), `ppermute` (paired sends and receives in one
`batch_isend_irecv`, so a ring cannot deadlock), `broadcast` and
`broadcast_bytes` (a length frame, then the payload).

The backend is always the caller's choice, never a fallback: NCCL where
every rank has a GPU of its own (the launcher's case), gloo on the CPU
(the tests) and, where the caller asks for it, gloo over CUDA tensors
(two ranks sharing one card, which NCCL refuses). gloo reduces and
broadcasts CUDA tensors itself but has no all_gather, send or receive
for them: under a gloo group those three copy a CUDA tensor through host
memory (`Group.staged`), and only there.
"""
from __future__ import annotations

import datetime
import socket
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

# gloo's collectives that take a CUDA tensor as it is; the others are
# staged through host memory
GLOO_CUDA_OPS = ("all_reduce", "broadcast")


@dataclass
class Group:
    """One process group: its global ranks in group order, this process's
    index in it (-1 when it is not a member) and its backend."""
    ranks: tuple[int, ...]
    backend: str
    pg: object = field(default=None, repr=False)
    index: int = -1

    @property
    def size(self) -> int:
        return len(self.ranks)

    def staged(self, x: torch.Tensor, op: str) -> bool:
        """Whether `op` copies x through host memory: a CUDA tensor under
        gloo for the ops gloo does not take on the device."""
        return (self.backend == "gloo" and x.is_cuda
                and op not in GLOO_CUDA_OPS)


def free_port() -> int:
    """A free TCP port on localhost (for a rendezvous address)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def init(backend: str, init_method: str, world_size: int, rank: int,
         timeout_s: float = 600.0) -> None:
    """Join the default process group (`tcp://host:port` rendezvous)."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', not {backend!r}")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))


def world_group() -> Group:
    """The default group as a Group."""
    n = dist.get_world_size()
    return Group(tuple(range(n)), dist.get_backend(), dist.group.WORLD,
                 dist.get_rank())


def new_group(ranks, backend: str | None = None) -> Group:
    """A process group over `ranks`. Every process of the default group
    must make the same calls in the same order."""
    ranks = tuple(int(r) for r in ranks)
    backend = backend or dist.get_backend()
    pg = dist.new_group(list(ranks), backend=backend)
    me = dist.get_rank()
    return Group(ranks, backend, pg, ranks.index(me) if me in ranks else -1)


def all_reduce(x: torch.Tensor, group: Group, op: str = "sum") -> torch.Tensor:
    """The sum (or max) of x over the group, on every member; x is
    reduced in place and returned. A group of one returns x."""
    if group.size == 1:
        return x
    rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(x, op=rop, group=group.pg)
    return x


def all_gather(x: torch.Tensor, group: Group, dim: int = -1,
               sizes=None) -> torch.Tensor:
    """Every member's x concatenated along `dim` in group order. sizes:
    each member's length along dim where they differ (the shorter pad to
    the longest for the exchange, then are cut back)."""
    if group.size == 1:
        return x
    dim = dim % x.dim()
    n = max(sizes) if sizes else x.shape[dim]
    if x.shape[dim] < n:
        pad = list(x.shape)
        pad[dim] = n - x.shape[dim]
        x = torch.cat([x, x.new_zeros(pad)], dim=dim)
    src = x.contiguous()
    staged = group.staged(src, "all_gather")
    if staged:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(group.size)]
    dist.all_gather(parts, src, group=group.pg)
    if sizes:
        parts = [p.narrow(dim, 0, s) for p, s in zip(parts, sizes)]
    out = torch.cat(parts, dim=dim)
    return out.to(x.device) if staged else out


def ppermute(x: torch.Tensor, group: Group, perm) -> torch.Tensor:
    """The JAX `lax.ppermute` over group indices: perm is a list of
    (source, destination) pairs; this member receives from the source
    that names it (zeros where none does) and sends to the destination
    it names. The sends and receives of one call go out together in one
    `batch_isend_irecv`."""
    me = group.index
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    buf = x.contiguous()
    staged = group.staged(buf, "ppermute")
    if staged:
        buf = buf.cpu()
    out = torch.zeros_like(buf)
    ops = [dist.P2POp(dist.isend, buf, group.ranks[d], group=group.pg)
           for d in dst]
    ops += [dist.P2POp(dist.irecv, out, group.ranks[s], group=group.pg)
            for s in src]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(x.device) if staged else out


def broadcast(x: torch.Tensor, group: Group, src: int = 0) -> torch.Tensor:
    """Member `src`'s x (a group index) on every member, in place."""
    if group.size == 1:
        return x
    dist.broadcast(x, group.ranks[src], group=group.pg)
    return x


def broadcast_bytes(data: bytes, group: Group, src: int = 0,
                    device=None) -> bytes:
    """Member `src`'s bytes on every member (the others pass anything): a
    length frame, then the payload as one uint8 tensor on `device` (a
    CUDA device under NCCL, the CPU under gloo)."""
    if group.size == 1:
        return data
    dev = torch.device(device or ("cuda" if group.backend == "nccl"
                                  else "cpu"))
    me = group.index == src
    n = torch.tensor([len(data) if me else 0], dtype=torch.int64, device=dev)
    broadcast(n, group, src)
    total = int(n.item())
    if me:
        buf = torch.frombuffer(bytearray(data), dtype=torch.uint8).to(dev) \
            if total else torch.empty(0, dtype=torch.uint8, device=dev)
    else:
        buf = torch.empty(total, dtype=torch.uint8, device=dev)
    if total:
        broadcast(buf, group, src)
    return data if me else bytes(buf.cpu().numpy().tobytes())
