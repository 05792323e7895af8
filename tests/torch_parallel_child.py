"""One rank of tests/test_torch_parallel.py's 4-rank gloo group.

    python tests/torch_parallel_child.py <dir> <rank> <world> <port>

Reads <dir>/inputs.pt (the parent's port params, configs and seeded
inputs), runs every case of CASES in order on this rank, and writes
<dir>/out_<rank>.pt: {case: this rank's results as numpy arrays}. Imports
torch and koboldcpp_tpu_torch only."""
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
from koboldcpp_tpu_torch.models.loader import Model  # noqa: E402
from koboldcpp_tpu_torch.parallel import (  # noqa: E402
    comm, launch, make_mesh, multihost, shard_cache, shard_model,
    shard_params_stacked, token_sharding)
from koboldcpp_tpu_torch.parallel.pipeline import (  # noqa: E402
    pipeline_forward, shard_stacked_for_pp)
from koboldcpp_tpu_torch.parallel.ring_attention import ring_attention  # noqa: E402
from koboldcpp_tpu_torch.parallel.sequence import (  # noqa: E402
    shard_cache_sp, sp_forward)
from koboldcpp_tpu_torch.parallel.sharding import Mesh  # noqa: E402
from koboldcpp_tpu_torch.sampling import SamplerParams  # noqa: E402
from koboldcpp_tpu_torch.tokenizers import Tokenizer  # noqa: E402
from koboldcpp_tpu_torch.tokenizers.vocab import vocab_from_metadata  # noqa: E402

torch.set_num_threads(1)
GREEDY = GenParams(max_length=8, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


def _np(t):
    return t.detach().float().cpu().numpy()


def _model(inp, key):
    cfg, params = inp[key]
    return Model(cfg, params, Tokenizer(vocab_from_metadata(inp["vocab"])))


def case_tp(inp):
    """dp=2 x tp=2 forward of the dense model on this rank's dp row
    (token_sharding) over its part of a whole cache (shard_cache): the
    logits and its heads of every layer's cache rows; then the same
    through forward_stacked over shard_params_stacked's shard."""
    cfg, params = inp["tp_model"]
    mesh = make_mesh(dp=2, tp=2)
    sm = shard_model(Model(cfg, params, None), mesh)
    tok = token_sharding(mesh, inp["tp_tokens"])
    pos = token_sharding(mesh, inp["tp_positions"])

    def cache():
        return shard_cache(init_cache(cfg.n_layers, 2, 32, cfg.n_kv_heads,
                                      cfg.head_dim, dtype=torch.float32),
                           mesh, cfg)
    c = cache()
    lg, _ = llama.forward(sm.params, sm.cfg, tok, pos, c)
    st = shard_params_stacked(llama.stack_layers(params), mesh, cfg)
    lg_st, _ = llama.forward_stacked(st, sm.cfg, tok, pos, cache())
    return {"logits": _np(lg), "k": np.stack([_np(k) for k in c.k]),
            "stacked": _np(lg_st)}


def case_q4k(inp):
    """dp=2 x tp=2 forward of the q4_k model at hidden 256 (its FFN's 3
    blocks split 2 / 1): logits of this rank's dp row and the shard
    shapes."""
    cfg, params = inp["q4k_model"]
    mesh = make_mesh(dp=2, tp=2)
    sm = shard_model(Model(cfg, params, None), mesh)
    r0 = mesh.coords["dp"]
    tok, pos = inp["q4k_tokens"][r0:r0 + 1], inp["q4k_positions"][r0:r0 + 1]
    cache = init_cache(cfg.n_layers, 1, 32, sm.cfg.n_kv_heads, cfg.head_dim)
    lg, _ = llama.forward(sm.params, sm.cfg, tok, pos, cache)
    layer = sm.params["layers"][0]
    return {"logits": _np(lg), "shapes": {k: tuple(v.shape) for k, v in
                                          layer.items()
                                          if hasattr(v, "kind")},
            "kinds": {k: v.kind for k, v in layer.items()
                      if hasattr(v, "kind")}}


def case_ep(inp):
    """The MoE model, dense-EP with experts over tp=4 and sorted-EP over
    ep=4 (tp=1): logits."""
    out = {}
    for form, mesh_kw in (("dense", {"dp": 1, "tp": 4}),
                          ("sorted", {"dp": 1, "tp": 1, "ep": 4})):
        cfg, params = inp[f"ep_{form}_model"]
        mesh = make_mesh(**mesh_kw)
        sm = shard_model(Model(cfg, params, None), mesh)
        cache = init_cache(cfg.n_layers, 1, 8, sm.cfg.n_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
        lg, _ = llama.forward(sm.params, sm.cfg, inp["ep_tokens"],
                              inp["ep_positions"], cache)
        out[form] = _np(lg)
        out[f"{form}_experts"] = sm.params["layers"][0][
            "ffn_gate_exps"].data["w"].shape[0]
    return out


def case_pp(inp):
    """pipeline_forward at pp 2 and 4, 2 and 4 microbatches: logits and
    the stage's cache; then pp=4, mb=4 decode steps from its own
    argmax."""
    st_params = inp["pp_params"]
    cfg = inp["pp_cfg"]
    out = {}
    meshes = {4: Mesh({"pp": 4}), 2: Mesh({"rep": 2, "pp": 2})}
    for pp, mb in ((2, 2), (2, 4), (4, 2), (4, 4)):
        tok = inp[f"pp_tokens_{mb}"]
        pos = torch.broadcast_to(torch.arange(tok.shape[1]), tok.shape)
        cache = init_cache(cfg.n_layers, mb, 32, cfg.n_kv_heads,
                           cfg.head_dim, dtype=torch.float32)
        p, c = shard_stacked_for_pp(st_params, cache, meshes[pp])
        lg, c = pipeline_forward(p, cfg, tok, pos, c, meshes[pp],
                                 microbatches=mb)
        out[(pp, mb)] = {"logits": _np(lg),
                         "k": np.stack([_np(k) for k in c.k])}
    tok = inp["pp_tokens_4"]
    T = tok.shape[1]
    pos = torch.broadcast_to(torch.arange(T), tok.shape)
    cache = init_cache(cfg.n_layers, 4, 32, cfg.n_kv_heads, cfg.head_dim,
                       dtype=torch.float32)
    p, c = shard_stacked_for_pp(st_params, cache, meshes[4])
    lg, c = pipeline_forward(p, cfg, tok, pos, c, meshes[4], microbatches=4)
    steps = []
    for step in range(2):
        nxt = lg[:, -1:].argmax(-1)
        lg, c = pipeline_forward(p, cfg, nxt, torch.full((4, 1), T + step),
                                 c, meshes[4], microbatches=4)
        steps.append({"tokens": nxt.numpy(), "logits": _np(lg)})
    out["decode"] = steps
    return out


def case_ring(inp):
    """ring_attention over sp=4 at hkv 4, 2, 1: this rank's block."""
    mesh = Mesh({"sp": 4})
    g = mesh.group("sp")
    out = {}
    for hkv in (4, 2, 1):
        q, k, v = inp[f"ring_{hkv}"]
        Tl = q.shape[1] // 4
        sl = slice(g.index * Tl, (g.index + 1) * Tl)
        out[hkv] = _np(ring_attention(q[:, sl], k[:, sl], v[:, sl], mesh,
                                      scale=q.shape[-1] ** -0.5))
    return out


def case_sp(inp):
    """sp_forward over sp=4: a 32-row prefill (last logits, this rank's
    cache rows), then 6 greedy decode steps after it from its own
    argmax."""
    cfg, params = inp["sp_model"]
    mesh = Mesh({"sp": 4})
    cache = shard_cache_sp(init_cache(cfg.n_layers, 1, 64, cfg.n_kv_heads,
                                      cfg.head_dim), mesh)
    tok = inp["sp_tokens"]
    T = tok.shape[1]
    lg, cache = sp_forward(params, cfg, tok, torch.arange(T)[None], cache,
                           mesh)
    out = {"prefill": _np(lg), "k": np.stack([_np(k) for k in cache.k]),
           "decode": []}
    for i in range(6):
        t = lg[0, -1].argmax()
        lg, cache = sp_forward(params, cfg, t.view(1, 1),
                               torch.tensor([[T + i]]), cache, mesh)
        out["decode"].append((int(t), _np(lg)))
    return out


def _drive(engine, group, steps, prompts, batched=False):
    """Rank 0 of `group` mirrors its engine's steps and generates; the
    others follow. Returns rank 0's token lists (None elsewhere)."""
    if group.index != 0:
        launch.follow(engine, group)
        if batched:
            engine.shutdown()
        return None
    launch.mirror(engine, group, steps)
    try:
        if batched:
            import threading

            res = [None] * len(prompts)

            def one(i):
                res[i] = engine.generate(prompts[i], GREEDY).tokens
            ts = [threading.Thread(target=one, args=(i,))
                  for i in range(len(prompts))]
            for t in ts:
                t.start()
            for t in ts:
                t.join()
            return res
        toks = []
        for p in prompts:
            toks.append(engine.generate(p, GREEDY).tokens)
        return toks
    finally:
        if batched:
            engine.shutdown()
        launch.stop(engine)


ENGINE_STEPS = ("_forward", "_kv_remove_shift")
BATCH_STEPS = ("_forward", "_kv_shift_slot", "_reset_cache")


def case_engines(inp):
    """Greedy tokens of Engine under tp (two tp=2 pairs), pp (two pp=2
    pairs) and sp (sp=4), and of BatchedEngine under dp=2 x tp=2 and
    ep=4, each driven by its group's rank 0 through the step mirror; a
    KV-reuse continuation rides each single-stream run."""
    out = {}
    prompts = inp["engine_prompts"]
    mesh = make_mesh(dp=2, tp=2)
    m = shard_model(_model(inp, "engine_model"), mesh)
    eng = Engine(m, max_context=64, device="cpu")
    out["tp"] = _drive(eng, mesh.group("tp"), ENGINE_STEPS, prompts)
    ppm = Mesh({"rep": 2, "pp": 2})
    eng = Engine(_model(inp, "engine_model"), max_context=64, device="cpu",
                 pp_mesh=ppm)
    out["pp"] = _drive(eng, ppm.group("pp"), ENGINE_STEPS, prompts)
    spm = Mesh({"sp": 4})
    eng = Engine(_model(inp, "engine_model"), max_context=64, device="cpu",
                 sp_mesh=spm)
    out["sp"] = _drive(eng, spm.group("sp"), ENGINE_STEPS, prompts)
    m = shard_model(_model(inp, "engine_model"), mesh)
    eng = BatchedEngine(m, max_context=64, n_slots=4, device="cpu",
                        mesh=mesh)
    out["batched_dp_tp"] = _drive(eng, mesh.world, BATCH_STEPS,
                                  inp["batch_prompts"], batched=True)
    epm = make_mesh(dp=1, tp=1, ep=4)
    m = shard_model(_model(inp, "ep_engine_model"), epm)
    eng = BatchedEngine(m, max_context=64, n_slots=4, device="cpu",
                        mesh=epm)
    out["batched_ep"] = _drive(eng, epm.world, BATCH_STEPS,
                               inp["batch_prompts"], batched=True)
    return out


def case_multihost(inp):
    """broadcast_request of a multi-frame payload, then LockstepEngine on
    rank 0 with two generates (and a reset between) that the followers
    replay through follower_loop, over a dp=2 x tp=2 sharded model."""
    world = comm.world_group()
    payload = inp["mh_payload"]
    got = multihost.broadcast_request(payload if world.index == 0 else b"")
    mesh = make_mesh(dp=2, tp=2)
    m = shard_model(_model(inp, "engine_model"), mesh)
    eng = Engine(m, max_context=64, device="cpu")
    topo = multihost.HostTopology(4, world.index, 4, world.index == 0)
    toks = None
    if topo.is_follower:
        multihost.follower_loop(eng)
    else:
        le = multihost.LockstepEngine(eng, topo)
        toks = [le.generate(inp["engine_prompts"][0], GREEDY).tokens]
        le.reset_context()
        toks.append(le.generate(inp["engine_prompts"][0], GREEDY).tokens)
        multihost.announce_shutdown()
    return {"payload_ok": got == payload, "tokens": toks,
            "context": list(eng.context_tokens)}


CASES = (("tp", case_tp), ("q4k", case_q4k), ("ep", case_ep),
         ("pp", case_pp), ("ring", case_ring), ("sp", case_sp),
         ("engines", case_engines), ("multihost", case_multihost))


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
