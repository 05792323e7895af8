"""Parallel serving over torch.distributed (port of the JAX package's
parallel/): the mesh and tensor / data / expert shards (`sharding`), the
collectives (`comm`), pipeline stages (`pipeline`), ring attention and
sequence-parallel serving (`ring_attention`, `sequence`), multi-host
lockstep (`multihost`) and the launcher's rank processes (`launch`)."""
from .sharding import (Mesh, make_mesh, shard_cache, shard_model,
                       shard_params, shard_params_stacked, token_sharding)

__all__ = ["Mesh", "make_mesh", "shard_cache", "shard_model", "shard_params",
           "shard_params_stacked", "token_sharding"]
