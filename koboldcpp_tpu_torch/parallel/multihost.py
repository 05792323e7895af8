"""Multi-host serving: every process joins one torch.distributed group.

Port of koboldcpp_tpu/parallel/multihost.py. Every process runs the same
command with `--coordinator host0:port --numprocesses N --processid i`;
`initialize` joins the default process group at tcp://host0:port. The
weights shard over the global mesh and the forward's collectives cross
the hosts. The HTTP API runs on host 0, and the followers replay every
engine call that host 0 makes (the JAX package's protocol): host 0
broadcasts a pickled op before each call (`broadcast_request`: a length
frame, then payload frames), each follower makes the same call, and
since the computation is deterministic and the sampled tokens are the
same on every host, every host's control flow stays in lockstep.
"""
from __future__ import annotations

import pickle
import random
from dataclasses import dataclass

import numpy as np
import torch

from . import comm
from .sharding import make_mesh

# broadcast frame size for serialized ops; larger requests go as several
# frames (a count frame first, then the payload frames)
_FRAME = 64 * 1024


@dataclass
class HostTopology:
    n_hosts: int
    host_id: int
    n_devices_global: int
    is_server: bool  # host 0 runs the HTTP API

    @property
    def is_follower(self) -> bool:
        return not self.is_server


def initialize(coordinator: str | None = None, n_hosts: int = 1,
               host_id: int = 0, backend: str = "nccl",
               device=None) -> HostTopology:
    """Join (or, single-host, skip) the default process group; each
    process drives one device (`device`, made current under NCCL)."""
    import torch.distributed as dist

    if coordinator and n_hosts > 1:
        if device is not None and torch.device(device).type == "cuda":
            torch.cuda.set_device(torch.device(device))
        comm.init(backend, f"tcp://{coordinator}", n_hosts, host_id)
    n = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    return HostTopology(n_hosts=n, host_id=me, n_devices_global=n,
                        is_server=me == 0)


def global_mesh(topo: HostTopology, dp: int | None = None,
                tp: int | None = None, devices=None):
    """Mesh over every host's device: by default tp within a host (one
    device a process here, so tp = 1) and dp across hosts, as the JAX
    `global_mesh` keeps tp on the fast fabric."""
    if dp is None and tp is None:
        tp = 1
        dp = topo.n_devices_global // tp
    return make_mesh(dp=dp, tp=tp, devices=devices)


def _device(group: comm.Group):
    return torch.device("cuda", torch.cuda.current_device()) \
        if group.backend == "nccl" else torch.device("cpu")


def broadcast_request(obj_bytes: bytes, group: comm.Group | None = None
                      ) -> bytes:
    """Host 0's serialized request on every host (the others pass
    anything): a length frame, then ceil(len / 64 KiB) payload frames."""
    group = group or comm.world_group()
    dev = _device(group)
    n = torch.tensor([len(obj_bytes)], dtype=torch.int64, device=dev)
    total = int(comm.broadcast(n, group, 0).item())
    nframes = max(1, -(-total // _FRAME))
    padded = obj_bytes.ljust(nframes * _FRAME, b"\0")
    out = bytearray()
    for i in range(nframes):
        arr = torch.from_numpy(np.frombuffer(
            padded[i * _FRAME:(i + 1) * _FRAME], dtype=np.uint8).copy())
        out += comm.broadcast(arr.to(dev), group, 0).cpu().numpy().tobytes()
    return bytes(out[:total])


# -- serving lockstep -------------------------------------------------------

def _engine_call(engine, op: str, payload: dict):
    if op == "generate":
        from ..engine.engine import GenParams
        from ..sampling import SamplerParams

        params = GenParams(**{**payload["params"],
                              "sampler": SamplerParams(**payload["sampler"])})
        return engine.generate(payload["prompt"], params)
    if op == "reset":
        engine.reset_context()
        return None
    raise ValueError(f"unknown multihost op {op!r}")


def announce_shutdown(group: comm.Group | None = None):
    broadcast_request(pickle.dumps(("shutdown", {})), group)


def follower_loop(engine, group: comm.Group | None = None):
    """Follower hosts: replay every op host 0 broadcasts until shutdown."""
    while True:
        op, payload = pickle.loads(broadcast_request(b"", group))
        if op == "shutdown":
            return
        _engine_call(engine, op, payload)


class LockstepEngine:
    """Engine wrapper for host 0 under multi-host: broadcasts each generate
    to the followers before running it, so all hosts advance together.

    Lockstep needs determinism: host 0 draws a concrete sampler seed and
    broadcasts it (a per-host seed would split the token streams and the
    collectives), and a mid-generation abort is off (an abort on host 0
    alone would leave the followers in collectives host 0 never joins)."""

    def __init__(self, engine, topo: HostTopology,
                 group: comm.Group | None = None):
        self._engine = engine
        self._topo = topo
        self._group = group

    def generate(self, prompt, params, on_token=None, genkey: str = ""):
        sampler = dict(params.sampler.__dict__)
        if sampler.get("seed", -1) is not None and sampler.get("seed", -1) < 0:
            sampler["seed"] = random.randrange(2 ** 31)
        pp = {k: v for k, v in params.__dict__.items() if k != "sampler"}
        payload = {
            "prompt": list(prompt) if not isinstance(prompt, str) else prompt,
            "params": pp, "sampler": sampler}
        broadcast_request(pickle.dumps(("generate", payload)), self._group)
        result = _engine_call(self._engine, "generate", payload)
        if on_token is not None:  # streamed after the fact (host 0 only)
            for piece in self._engine.stream_tokens:
                on_token(0, piece)
        return result

    def abort(self, genkey: str = ""):
        pass  # see the class docstring

    def reset_context(self):
        broadcast_request(pickle.dumps(("reset", {})), self._group)
        self._engine.reset_context()

    def __getattr__(self, name):
        return getattr(self._engine, name)
