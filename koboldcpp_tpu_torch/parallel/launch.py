"""The launcher's rank processes and the step mirror.

The JAX package is a single controller: one process drives every device
of a mesh. The port runs one process per rank instead. Under `--mesh`,
`--pipeline` or `--seqparallel` the launcher (rank 0) starts the other
ranks itself (`spawn_ranks`: `python -m koboldcpp_tpu_torch.parallel.
launch --rank r --world n --init tcp://127.0.0.1:port -- <argv>`), each
on its own device, and they meet at a local TCP rendezvous. Every rank
loads the model and builds the same engine on its shard; rank 0 serves
HTTP and drives every sharded step: `mirror` makes each of its engine's
device-side methods (the forward, the cache surgery) broadcast its
arguments first, and the followers `follow`, making the same call on
their own shard, so the collectives inside meet. A step is mirrored, not
a whole engine call, so the batched engine's scheduler thread runs on
rank 0 alone and `--multiuser` works.

Arguments go as a pickled header (the call's name, its plain arguments
and each tensor's shape and dtype) by `comm.broadcast_bytes`, then each
tensor by `comm.broadcast` on the engine's device.
"""
from __future__ import annotations

import argparse
import pickle
import subprocess
import sys

import torch

from . import comm

_STOP = "__stop__"


class _T:
    """A tensor's place in a mirrored call's header."""

    def __init__(self, t: torch.Tensor):
        self.shape, self.dtype = tuple(t.shape), t.dtype


def _encode(args, kwargs):
    tensors = []

    def enc(v):
        if isinstance(v, torch.Tensor):
            tensors.append(v)
            return _T(v)
        return v
    return ([enc(a) for a in args], {k: enc(v) for k, v in kwargs.items()},
            tensors)


def _send(group: comm.Group, device, name: str, args=(), kwargs=None):
    a, kw, tensors = _encode(args, kwargs or {})
    comm.broadcast_bytes(pickle.dumps((name, a, kw)), group, 0, device)
    for t in tensors:
        comm.broadcast(t.contiguous(), group, 0)


def _recv(group: comm.Group, header_device, device):
    """The next mirrored call: its name and arguments, the tensors on this
    rank's `device`."""
    name, a, kw = pickle.loads(comm.broadcast_bytes(b"", group, 0,
                                                    header_device))

    def dec(v):
        if isinstance(v, _T):
            return comm.broadcast(torch.empty(v.shape, dtype=v.dtype,
                                              device=device), group, 0)
        return v
    return name, [dec(x) for x in a], {k: dec(v) for k, v in kw.items()}


def _header_device(group: comm.Group, device):
    """Where the header bytes travel: the engine's CUDA device under NCCL,
    the host under gloo."""
    return device if group.backend == "nccl" else torch.device("cpu")


def mirror(engine, group: comm.Group, names) -> None:
    """On rank 0: each method of `names` on `engine` broadcasts its
    arguments to the followers before it runs."""
    dev = _header_device(group, engine.device)
    for name in names:
        fn = getattr(engine, name)

        def wrapped(*args, _fn=fn, _name=name, **kwargs):
            _send(group, dev, _name, args, kwargs)
            return _fn(*args, **kwargs)
        setattr(engine, name, wrapped)
    engine._mirror_group = group


def follow(engine, group: comm.Group) -> None:
    """On a follower: make every call rank 0's mirrored engine makes, on
    this rank's engine, until rank 0 stops (`stop`)."""
    dev = _header_device(group, engine.device)
    with torch.inference_mode():
        while True:
            name, args, kwargs = _recv(group, dev, engine.device)
            if name == _STOP:
                return
            getattr(engine, name)(*args, **kwargs)


def stop(engine) -> None:
    """On rank 0: release the followers (their `follow` returns)."""
    group = getattr(engine, "_mirror_group", None)
    if group is not None:
        _send(group, _header_device(group, engine.device), _STOP)
        engine._mirror_group = None


def spawn_ranks(argv: list[str], world: int, init_method: str
                ) -> list[subprocess.Popen]:
    """Start ranks 1..world-1 of the launcher's command line `argv`."""
    return [subprocess.Popen(
        [sys.executable, "-m", "koboldcpp_tpu_torch.parallel.launch",
         "--rank", str(r), "--world", str(world), "--init", init_method,
         "--", *argv])
        for r in range(1, world)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="koboldcpp_tpu_torch.parallel.launch",
        description="one follower rank of the launcher's parallel serving")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--init", required=True, help="tcp://host:port")
    p.add_argument("argv", nargs=argparse.REMAINDER)
    a = p.parse_args(argv)
    rest = a.argv[1:] if a.argv[:1] == ["--"] else a.argv
    from .. import cli

    return cli.main(rest, rank=(a.rank, a.world, a.init))


if __name__ == "__main__":
    sys.exit(main())
