"""One rank of tests/test_torch_parallel_archs.py's 4-rank gloo group.

    python tests/torch_parallel_archs_child.py <dir> <rank> <world> <port>

Reads <dir>/inputs.pt (the fixture paths, the synthetic models' port
params and configs, the tokens), runs every case of CASES in order on this
rank, and writes <dir>/out_<rank>.pt: {case: this rank's results as numpy
arrays}. Imports torch and koboldcpp_tpu_torch only."""
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from koboldcpp_tpu_torch.engine import Engine, GenParams  # noqa: E402
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine  # noqa: E402
from koboldcpp_tpu_torch.kv.cache import init_cache  # noqa: E402
from koboldcpp_tpu_torch.models import llama  # noqa: E402
from koboldcpp_tpu_torch.models.loader import (  # noqa: E402
    Model, arch_module, load_model)
from koboldcpp_tpu_torch.ops import linear  # noqa: E402
from koboldcpp_tpu_torch.parallel import (  # noqa: E402
    comm, launch, make_mesh, shard_model)
from koboldcpp_tpu_torch.sampling import SamplerParams  # noqa: E402

torch.set_num_threads(1)
GREEDY = GenParams(max_length=6, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


def _np(t):
    return t.detach().float().cpu().numpy()


def logits(m: Model, toks: list[int]) -> torch.Tensor:
    """The model's forward over toks at positions 0.. (B = 1): logits, or
    an embedding model's hidden states, or T5's decoder logits over its
    first 4 tokens after the encoder took them all."""
    mod = arch_module(m.cfg.arch)
    cfg = m.cfg
    tok = torch.tensor([toks])
    pos = torch.arange(len(toks))[None]
    if mod is None:
        c = init_cache(cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim,
                       dtype=torch.float32)
        return llama.forward(m.params, cfg, tok, pos, c)[0][0]
    if cfg.is_embedding:
        return mod.forward_embed(m.params, cfg, tok, pos)[0]
    if cfg.is_encoder_decoder:
        enc = mod.encode(m.params, cfg, tok, pos)
        c = mod.prepare_cross(m.params, cfg, enc, pos >= 0,
                              mod.init_cache(cfg, 1, 16, tok.shape[1]))
        return mod.forward(m.params, cfg, tok[:, :4], pos[:, :4], c)[0][0]
    if cfg.arch in ("deepseek2", "minicpm3"):
        c = mod.init_cache(cfg, 1, 32, dtype=torch.float32)
        return mod.forward(m.params, cfg, tok, pos, c)[0][0]
    return mod.forward(m.params, cfg, tok, pos, mod.init_state(cfg, 1))[0][0]


def _dequant_shapes(fn):
    """fn()'s result and the (out, in) shapes it dequantized (the packed
    weights no kernel took)."""
    seen = []
    orig = linear.dequant

    def rec(qt, *a, **kw):
        seen.append(tuple(qt.shape))
        return orig(qt, *a, **kw)
    linear.dequant = rec
    try:
        return fn(), seen
    finally:
        linear.dequant = orig


def case_fixtures(inp):
    """Each fixture at dp=2 x tp=2, loaded dense f32 and packed (f32
    activations): the logits (hidden states for nomic-bert), and the
    shapes the packed tp forward dequantized."""
    mesh = make_mesh(dp=2, tp=2)
    out = {}
    for name, path in inp["fixtures"].items():
        r = {}
        for packed in (False, True):
            m = shard_model(load_model(path, packed=packed,
                                       dtype=torch.float32, device="cpu"),
                            mesh)
            lg, seen = _dequant_shapes(lambda: logits(m, inp["tokens"]))
            r["packed" if packed else "dense"] = _np(lg)
            if packed:
                r["dequant"] = seen
        out[name] = r
    return out


def case_synthetic(inp):
    """The synthetic llama models: a flat QK norm at dp=2 x tp=2, q / k /
    v / o biases over 6 query and 3 kv heads at dp=2 x tp=2 (kv heads 2 /
    1), and 10 query over 2 kv heads at tp=4 (a rank whose query heads
    straddle two kv groups holds a kv head per query head): logits and
    the rank's kv heads."""
    out = {}
    for name, tp in (("flat_qk", 2), ("uneven", 2), ("straddle", 4)):
        cfg, params = inp[name]
        mesh = make_mesh(dp=4 // tp, tp=tp)
        m = shard_model(Model(cfg, params, None), mesh)
        heads = m.params["tp"].heads
        out[name] = {"logits": _np(logits(m, inp["tokens"])),
                     "kv": [list(h.kv) for h in heads],
                     "copies": [list(h.copies) for h in heads]}
    return out


def _drive(engine, group, fn):
    """Rank 0 of `group` mirrors its engine's steps and runs fn(engine);
    the others follow. Returns rank 0's result (None elsewhere)."""
    if group.index != 0:
        launch.follow(engine, group)
        return None
    launch.mirror(engine, group, engine.MIRRORED_STEPS)
    try:
        return fn(engine)
    finally:
        launch.stop(engine)


def case_engines(inp):
    """Engine over tp=2 shards (two pairs) of the dense f32 rwkv6,
    deepseek2 and t5 fixtures: the greedy tokens of two prompts, the
    second starting with the first (a fast-forward; rwkv6 resets its
    state, the context not being a prefix); nomic-bert's embeddings of
    two texts; BatchedEngine (2 slots, one a dp index) over the dp=2 x
    tp=2 shards of the openelm fixture, its per-layer heads, driven over
    the whole world."""
    mesh = make_mesh(dp=2, tp=2)
    out = {}
    for name in ("rwkv6", "deepseek2", "t5"):
        m = shard_model(load_model(inp["fixtures"][name], packed=False,
                                   dtype=torch.float32, device="cpu"), mesh)
        out[name] = _drive(Engine(m, max_context=64, device="cpu"),
                           mesh.group("tp"), lambda e: [
                               e.generate(p, GREEDY).tokens
                               for p in inp["engine_prompts"]])
    m = shard_model(load_model(inp["fixtures"]["nomic-bert"], packed=False,
                               dtype=torch.float32, device="cpu"), mesh)
    out["embed"] = _drive(Engine(m, max_context=64, device="cpu"),
                          mesh.group("tp"),
                          lambda e: e.embed(inp["texts"]))
    m = shard_model(load_model(inp["fixtures"]["openelm"], packed=False,
                               dtype=torch.float32, device="cpu"), mesh)
    eng = BatchedEngine(m, max_context=64, n_slots=2, device="cpu",
                        mesh=mesh)
    try:
        out["batched"] = _drive(eng, mesh.world, lambda e: [
            e.generate(p, GREEDY).tokens for p in inp["engine_prompts"]])
    finally:
        eng.shutdown()
    return out


CASES = (("fixtures", case_fixtures), ("synthetic", case_synthetic),
         ("engines", case_engines))


def main():
    d, rank, world, port = sys.argv[1], *map(int, sys.argv[2:5])
    comm.init("gloo", f"tcp://127.0.0.1:{port}", world, rank)
    inp = torch.load(os.path.join(d, "inputs.pt"), weights_only=False)
    out, times = {}, {}
    for name, fn in CASES:
        t0 = time.perf_counter()
        with torch.inference_mode():
            out[name] = fn(inp)
        times[name] = time.perf_counter() - t0
    out["seconds"] = times
    torch.save(out, os.path.join(d, f"out_{rank}.pt"))


if __name__ == "__main__":
    main()
