"""The port's parallel forms (koboldcpp_tpu_torch/parallel/) held against
the JAX package's sharded functions on the conftest's 8-device CPU mesh.

One module fixture starts ONE 4-rank gloo group (tests/torch_parallel_
child.py; the children import torch and koboldcpp_tpu_torch only), which
runs every case on the inputs this module writes (the JAX synthetic
params converted by models/convert.py, seeded numpy tokens), while the
tests here compute the JAX references. Tolerances: the JAX tests' own
(2e-2 for bf16 activations, 2e-3 / 2e-4 for f32 ones, in
assert_allclose's atol + rtol |ref| form) are the ceiling; each test's
docstring gives the max |diff| measured on this tree.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from koboldcpp_tpu.kv.cache import init_cache as jinit_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.config import ModelConfig
from koboldcpp_tpu.models.synthetic import synthetic_params
from koboldcpp_tpu.ops.linear import dense as jdense
from koboldcpp_tpu.parallel import make_mesh, shard_cache, shard_params
from koboldcpp_tpu.parallel.pipeline import (pipeline_forward,
                                             shard_stacked_for_pp)
from koboldcpp_tpu.parallel.ring_attention import ring_attention
from koboldcpp_tpu.parallel.sequence import shard_cache_sp, sp_forward
from koboldcpp_tpu_torch.cli import apply_rope_config
from koboldcpp_tpu_torch.engine import Engine as TEngine, GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.models.config import ModelConfig as TConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import Model as TModel
from koboldcpp_tpu_torch.models.loader import load_model as t_load_model
from koboldcpp_tpu_torch.ops import linear as tlinear
from koboldcpp_tpu_torch.parallel import comm
from koboldcpp_tpu_torch.parallel.sharding import KeptWhole, _cols
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.tokenizers import Tokenizer
from koboldcpp_tpu_torch.tokenizers.vocab import vocab_from_metadata

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_parallel_child.py")
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf", "tiny-q4_k_m.gguf")
BERT_FIX = os.path.join(ROOT, "tests", "fixtures", "portgguf",
                        "tiny-nomic-bert-q4_k_m.gguf")
WORLD = 4
VOCAB_MD = {"tokenizer.ggml.model": "gpt2",
            "tokenizer.ggml.tokens": [f"tok{i}" for i in range(256)],
            "tokenizer.ggml.token_type": np.full(256, 1, np.int32),
            "tokenizer.ggml.bos_token_id": np.uint32(1),
            "tokenizer.ggml.eos_token_id": np.uint32(2),
            "tokenizer.ggml.add_bos_token": False}

TP_CFG = ModelConfig(arch="llama", vocab_size=512, hidden_size=128,
                     n_layers=2, n_heads=8, n_kv_heads=4, head_dim=32,
                     intermediate_size=256, rope_dim=32)
# q4_k at hidden 256: the FFN's 3 quant blocks split 2 / 1 over tp=2,
# every shard in whole blocks
Q4K_CFG = ModelConfig(arch="llama", vocab_size=512, hidden_size=256,
                      n_layers=1, n_heads=8, n_kv_heads=4, head_dim=64,
                      intermediate_size=768, rope_dim=64)
MOE_CFG = ModelConfig(arch="llama", vocab_size=256, hidden_size=64,
                      n_layers=1, n_heads=4, n_kv_heads=2, head_dim=16,
                      intermediate_size=96, rope_dim=16, n_experts=4,
                      n_experts_used=2)
PP_CFG = ModelConfig(arch="llama", vocab_size=512, hidden_size=64,
                     n_layers=8, n_heads=4, n_kv_heads=2, head_dim=16,
                     intermediate_size=128, rope_dim=16)
SP_CFG = ModelConfig(arch="llama", vocab_size=256, hidden_size=128,
                     n_layers=3, n_heads=4, n_kv_heads=2, head_dim=32,
                     intermediate_size=256, rope_dim=32)
ENGINE_CFG = ModelConfig(arch="llama", vocab_size=256, hidden_size=128,
                         n_layers=4, n_heads=4, n_kv_heads=2, head_dim=32,
                         intermediate_size=256, rope_dim=32)
GREEDY = GenParams(max_length=8, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


def _tcfg(cfg) -> TConfig:
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _np_tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _f32(p):
    """Every floating leaf of a JAX params tree as f32 (an f32 model, as
    the JAX tests of these forms load theirs)."""
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, p)


def _moe_params(cfg, rng):
    """test_parallel.py's dense MoE layer: router and (E, F, C) stacks in
    place of the FFN."""
    params = _f32(synthetic_params(cfg, kind="dense", seed=9))
    layer = params["layers"][0]
    for k in ("w_gate", "w_up", "w_down", "w_gateup"):
        layer.pop(k, None)
    C, F, E = cfg.hidden_size, cfg.intermediate_size, cfg.n_experts
    f32 = jnp.float32
    layer["ffn_gate_inp"] = jdense(
        rng.standard_normal((E, C)).astype(np.float32) * 0.1, dtype=f32)
    for k, shape in (("ffn_gate_exps", (E, F, C)), ("ffn_up_exps", (E, F, C)),
                     ("ffn_down_exps", (E, C, F))):
        layer[k] = jdense(rng.standard_normal(shape).astype(np.float32) * 0.1,
                          dtype=f32)
    return params


class _Run:
    """The children's run, started at construction; `outs` waits for it."""

    def __init__(self, d: str, inputs: dict):
        self.d, self.inputs = d, inputs
        torch.save(inputs, os.path.join(d, "inputs.pt"))
        port = comm.free_port()
        env = {k: v for k, v in os.environ.items()
               if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
        env["PYTHONPATH"] = ROOT
        env["OMP_NUM_THREADS"] = "1"  # one core each, beside the JAX refs
        self.procs = [subprocess.Popen(
            [sys.executable, CHILD, d, str(r), str(WORLD), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for r in range(WORLD)]

        def cli(model, *flags):
            return subprocess.Popen(
                [sys.executable, "-m", "koboldcpp_tpu_torch", model,
                 "--device", "cpu", "--prompt", "Once upon a time",
                 "--promptlimit", "4", "--contextsize", "256", *flags],
                cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                env=env)
        # the launcher's own ranks: `--mesh 1,2` on the CPU, one-shot; the
        # same serving a BERT model's embeddings; two hosts of one process
        # each
        self.cli = cli(FIX, "--mesh", "1,2")
        self.bert_port = comm.free_port()
        self.cli_bert = subprocess.Popen(
            [sys.executable, "-m", "koboldcpp_tpu_torch", BERT_FIX,
             "--device", "cpu", "--mesh", "1,2", "--contextsize", "256",
             "--host", "127.0.0.1", "--port", str(self.bert_port)],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            env=env)
        host_port = str(comm.free_port())
        self.cli_hosts = [cli(FIX, "--coordinator", f"127.0.0.1:{host_port}",
                              "--numprocesses", "2", "--processid", str(i))
                          for i in range(2)]
        self._outs = None

    @property
    def outs(self) -> list[dict]:
        if self._outs is None:
            logs = []
            try:
                for p in self.procs:
                    logs.append(p.communicate(timeout=300)[0].decode(
                        errors="replace"))
            finally:
                for p in self.procs:
                    p.kill()
            for r, p in enumerate(self.procs):
                assert p.returncode == 0, f"rank {r}:\n{logs[r][-4000:]}"
            self._outs = [torch.load(os.path.join(self.d, f"out_{r}.pt"),
                                     weights_only=False)
                          for r in range(WORLD)]
        return self._outs


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    rng = np.random.default_rng(0)
    inp = {"vocab": VOCAB_MD}
    jp = {}
    jp["tp"] = synthetic_params(TP_CFG, kind="dense", seed=3)
    inp["tp_model"] = (_tcfg(TP_CFG), params_from_jax(_np_tree(jp["tp"])))
    inp["tp_tokens"] = torch.from_numpy(rng.integers(0, 512, (2, 8)))
    inp["tp_positions"] = torch.broadcast_to(torch.arange(8), (2, 8))
    jp["q4k"] = synthetic_params(Q4K_CFG, kind="q4_k", seed=4)
    inp["q4k_model"] = (_tcfg(Q4K_CFG), params_from_jax(_np_tree(jp["q4k"])))
    inp["q4k_tokens"] = torch.from_numpy(rng.integers(0, 512, (2, 8)))
    inp["q4k_positions"] = torch.broadcast_to(torch.arange(8), (2, 8))
    jp["moe"] = _moe_params(MOE_CFG, np.random.default_rng(5))
    moe_t = params_from_jax(_np_tree(jp["moe"]))
    dense_cfg = dataclasses.replace(MOE_CFG, moe_dense_ep=True)
    sorted_cfg = dataclasses.replace(MOE_CFG, moe_sorted_ep=True,
                                     moe_capacity_factor=100.0)
    inp["ep_dense_model"] = (_tcfg(dense_cfg), moe_t)
    inp["ep_sorted_model"] = (_tcfg(sorted_cfg), moe_t)
    inp["ep_tokens"] = torch.from_numpy(rng.integers(0, 256, (1, 4)))
    inp["ep_positions"] = torch.arange(4)[None]
    jp["pp"] = jllama.stack_layers(_f32(synthetic_params(PP_CFG, kind="dense",
                                                         seed=21)))
    inp["pp_cfg"] = _tcfg(PP_CFG)
    inp["pp_params"] = params_from_jax(_np_tree(jp["pp"]))
    for mb in (2, 4):
        inp[f"pp_tokens_{mb}"] = torch.from_numpy(rng.integers(3, 500,
                                                               (mb, 6)))
    for hkv in (4, 2, 1):
        inp[f"ring_{hkv}"] = tuple(torch.from_numpy(
            rng.standard_normal(s).astype(np.float32))
            for s in ((2, 64, 4, 16), (2, 64, hkv, 16), (2, 64, hkv, 16)))
    jp["sp"] = synthetic_params(SP_CFG, kind="dense", seed=17)
    inp["sp_model"] = (_tcfg(SP_CFG), params_from_jax(_np_tree(jp["sp"])))
    inp["sp_tokens"] = torch.from_numpy(rng.integers(0, 256, (1, 32)))
    inp["engine_model"] = (_tcfg(ENGINE_CFG), params_from_jax(_np_tree(
        synthetic_params(ENGINE_CFG, kind="dense", seed=21))))
    inp["ep_engine_model"] = (_tcfg(sorted_cfg), moe_t)
    inp["engine_prompts"] = [[1, 5, 9], [1, 5, 9, 11, 40, 3]]
    inp["batch_prompts"] = [[1, 5, 9], [7, 42, 3, 100], [12], [200, 8, 9]]
    inp["mh_payload"] = bytes(rng.integers(0, 256, 150_000, dtype=np.uint8))
    r = _Run(str(tmp_path_factory.mktemp("par")), inp)
    r.jax_params = jp
    # the JAX references while the children run, in threads (XLA compiles
    # them with the GIL released; each mesh context is thread-local)
    with ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(fn, r) for name, fn in _REFS.items()}
        r.refs = {name: f.result() for name, f in futs.items()}
    yield r
    for p in (*r.procs, r.cli, r.cli_bert, *r.cli_hosts):
        p.kill()


def _dp_rows(outs, key, sub):
    """Each dp index's row of `sub` from its tp-rank-0 child (ranks 0, 2
    of the dp=2 x tp=2 mesh), stacked."""
    return np.concatenate([outs[r][key][sub] for r in (0, 2)])


# ---------------------------------------------------------------------------
# the JAX references (computed by the fixture while the children run)
# ---------------------------------------------------------------------------

def _ref_tp(run):
    """The JAX forward sharded over dp=2 x tp=4: logits and cache."""
    B, T = 2, 8
    tokens = jnp.asarray(run.inputs["tp_tokens"].numpy(), jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(T), (B, T)).astype(jnp.int32)
    mesh = make_mesh(8, dp=2, tp=4)
    sc = shard_cache(jinit_cache(2, B, 32, 4, 32, dtype=jnp.float32), mesh)
    with mesh:
        ref, cache = jax.jit(lambda p_, t, q, c: jllama.forward(
            p_, TP_CFG, t, q, c))(shard_params(run.jax_params["tp"], mesh),
                                  tokens, positions, sc)
    return np.asarray(ref), np.asarray(cache.k)


def _ref_q4k(run):
    """The JAX forward of the q4_k model sharded over dp=2 x tp=2."""
    B, T = 2, 8
    tokens = jnp.asarray(run.inputs["q4k_tokens"].numpy(), jnp.int32)
    positions = jnp.broadcast_to(jnp.arange(T), (B, T)).astype(jnp.int32)
    mesh = make_mesh(4, dp=2, tp=2)
    sc = shard_cache(jinit_cache(1, B, 32, 4, 64), mesh)
    with mesh:
        ref, _ = jax.jit(lambda p_, t, q, c: jllama.forward(
            p_, Q4K_CFG, t, q, c))(shard_params(run.jax_params["q4k"], mesh),
                                   tokens, positions, sc)
    return np.asarray(ref.astype(jnp.float32))


def _ref_ep(run):
    """The JAX dense-EP over dp=2 x tp=4 and routed sorted-EP over dp=1 x
    tp=2 x ep=4."""
    out = {}
    tokens = jnp.asarray(run.inputs["ep_tokens"].numpy(), jnp.int32)
    pos = jnp.arange(4)[None].astype(jnp.int32)
    for form in ("dense", "sorted"):
        cfg = (dataclasses.replace(MOE_CFG, moe_dense_ep=True)
               if form == "dense"
               else dataclasses.replace(MOE_CFG, moe_sorted_ep=True,
                                        moe_capacity_factor=100.0))
        mesh = (make_mesh(8, dp=2, tp=4) if form == "dense"
                else make_mesh(dp=1, tp=2, ep=4))
        cache = jinit_cache(1, 1, 8, 2, 16, dtype=jnp.float32)
        with mesh:
            ref, _ = jax.jit(lambda p_, t, q, c, cfg=cfg: jllama.forward(
                p_, cfg, t, q, c))(shard_params(run.jax_params["moe"], mesh),
                                   tokens, pos, cache)
        out[form] = np.asarray(ref)
    return out


def _ref_pp(run):
    """The JAX pipeline_forward at each (pp, mb): logits and the stacked
    cache; then two greedy decode steps through pp=4, mb=4."""
    out = {}
    p = run.jax_params["pp"]
    for pp, mb in ((2, 2), (2, 4), (4, 2), (4, 4)):
        mesh = JMesh(np.array(jax.devices()[:pp]), ("pp",))
        fwd = jax.jit(lambda p_, t, q, c, mesh=mesh, mb=mb: pipeline_forward(
            p_, PP_CFG, t, q, c, mesh, microbatches=mb))
        tok = jnp.asarray(run.inputs[f"pp_tokens_{mb}"].numpy(), jnp.int32)
        T = tok.shape[1]
        pos = jnp.broadcast_to(jnp.arange(T), tok.shape).astype(jnp.int32)
        pc, cc = shard_stacked_for_pp(p, jinit_cache(8, mb, 32, 2, 16,
                                                     dtype=jnp.float32), mesh)
        lg, cc = fwd(pc, tok, pos, cc)
        out[pp, mb] = (np.asarray(lg),
                       np.asarray(cc.k).reshape(8, mb, 32, 32))
        if (pp, mb) == (4, 4):
            steps = []
            for step in range(2):
                nxt = jnp.argmax(lg[:, -1:], axis=-1).astype(jnp.int32)
                lg, cc = fwd(pc, nxt, jnp.full((4, 1), T + step, jnp.int32),
                             cc)
                steps.append((np.asarray(nxt), np.asarray(lg)))
            out["decode"] = steps
    return out


def _ref_ring(run):
    """The JAX ring_attention on a 4-way sequence mesh, at each hkv."""
    mesh = JMesh(np.array(jax.devices()[:4]), ("sp",))
    fn = jax.jit(lambda a, b, c: ring_attention(a, b, c, mesh,
                                                scale=16 ** -0.5))
    return {hkv: np.asarray(fn(*(jnp.asarray(t.numpy())
                                 for t in run.inputs[f"ring_{hkv}"])))
            for hkv in (4, 2, 1)}


def _ref_sp(run):
    """The JAX sp_forward on a 4-way mesh: the prefill's logits and cache,
    then six greedy decode steps."""
    mesh = JMesh(np.array(jax.devices()[:4]), ("sp",))
    fwd = jax.jit(lambda p_, t, q, c: sp_forward(p_, SP_CFG, t, q, c, mesh))
    p = run.jax_params["sp"]
    tok = jnp.asarray(run.inputs["sp_tokens"].numpy(), jnp.int32)
    c = shard_cache_sp(jinit_cache(3, 1, 64, 2, 32), mesh)
    lg, c = fwd(p, tok, jnp.arange(32)[None].astype(jnp.int32), c)
    out = {"prefill": np.asarray(lg),
           "k": np.asarray(c.k.astype(jnp.float32)), "decode": []}
    for i in range(6):
        t = int(np.asarray(lg[0, -1]).argmax())
        lg, c = fwd(p, jnp.full((1, 1), t, jnp.int32),
                    jnp.full((1, 1), 32 + i, jnp.int32), c)
        out["decode"].append((t, np.asarray(lg)))
    return out


_REFS = {"tp": _ref_tp, "q4k": _ref_q4k, "ep": _ref_ep, "pp": _ref_pp, "ring": _ref_ring,
         "sp": _ref_sp}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def test_tp_dp_logits_and_cache_rows(run):
    """dp=2 x tp=2 against the JAX forward sharded over dp=2 x tp=4 (the
    test_parallel.py setup, bf16 weights): logits within 2e-2 + 2e-2 |ref|
    (the JAX test's; measured max |diff| 5.4e-3), also through
    forward_stacked over shard_params_stacked (the same), and the cache
    rows, each rank's kv heads, within the same (measured 3.9e-3, one
    bf16 step)."""
    ref, rk = run.refs["tp"]  # rk: (L, B, S, Hkv * D)
    outs = run.outs
    for key in ("logits", "stacked"):
        np.testing.assert_allclose(_dp_rows(outs, "tp", key), ref,
                                   rtol=2e-2, atol=2e-2)
    # rank (d, t) holds kv heads [2t, 2t + 2) of row d
    for r in range(4):
        d, t = divmod(r, 2)
        np.testing.assert_allclose(outs[r]["tp"]["k"][:, 0],
                                   rk[:, d, :, t * 64:(t + 1) * 64],
                                   rtol=2e-2, atol=2e-2)


def test_q4k_shards_uneven_blocks(run):
    """q4_k at hidden 256, dp=2 x tp=2: every shard a packed q4_k in whole
    256-column blocks (w_down's 3 blocks split 2 / 1, each meeting the
    kernel dispatch rule), logits against the JAX forward of the same
    params sharded over dp=2 x tp=2 within 2e-2 + 2e-2 |ref|
    (test_parallel.py's; measured max |diff| 3.1e-2 at logits up to 4.8,
    one bf16 step there)."""
    outs = run.outs
    for r in range(4):
        o = outs[r]["q4k"]
        assert set(o["kinds"].values()) == {"q4_k"}, o["kinds"]
        want_f = 512 if r % 2 == 0 else 256
        assert o["shapes"]["w_down"] == (256, want_f)
        assert o["shapes"]["w_gateup"] == (2 * want_f, 256)
        assert o["shapes"]["wqkv"] == (512, 256)
        assert o["shapes"]["wo"] == (256, 256)
    got = _dp_rows(outs, "q4k", "logits")
    np.testing.assert_allclose(got, run.refs["q4k"], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("form", ["dense", "sorted"])
def test_expert_parallel_matches_jax(run, form):
    """Dense-EP with the experts over tp=4 (its kv heads, 2, replicated
    over the 4 ranks) against the JAX dense-EP sharded over dp=2 x tp=4
    (2e-3, test_parallel.py's); sorted-EP over ep=4 against the JAX
    routed EP over dp=1 x tp=2 x ep=4 (2e-4, test_moe.py's). f32 weights;
    measured max |diff| 3.2e-7 and 4.3e-7. One expert a rank, every rank
    the same logits."""
    tol = 2e-3 if form == "dense" else 2e-4
    for r in range(4):
        assert run.outs[r]["ep"][f"{form}_experts"] == 1
        np.testing.assert_allclose(run.outs[r]["ep"][form],
                                   run.refs["ep"][form], rtol=tol, atol=tol)


@pytest.mark.parametrize("pp,mb", [(2, 2), (2, 4), (4, 2), (4, 4)])
def test_pipeline_matches_jax(run, pp, mb):
    """pipeline_forward at pp stages and mb microbatches against the JAX
    pipeline_forward (f32, 2e-4 as test_pipeline.py; measured max |diff|
    2.7e-7): the logits on every rank, and each stage's cache layers for
    the whole batch."""
    ref, rk = run.refs["pp"][pp, mb]
    per = 8 // pp
    for r in range(4):
        o = run.outs[r]["pp"][(pp, mb)]
        np.testing.assert_allclose(o["logits"], ref, rtol=2e-4, atol=2e-4)
        s = r % pp
        np.testing.assert_allclose(o["k"], rk[s * per:(s + 1) * per],
                                   rtol=2e-4, atol=2e-4)


def test_pipeline_decode_steps(run):
    """Two T=1 steps through pp=4, mb=4 after the prefill, the cache
    threaded across calls: the same greedy tokens as the JAX pipeline's
    and logits within 2e-4 (measured max |diff| 2.1e-7)."""
    for got, (nxt, lg) in zip(run.outs[0]["pp"]["decode"],
                              run.refs["pp"]["decode"]):
        np.testing.assert_array_equal(got["tokens"], nxt)
        np.testing.assert_allclose(got["logits"], lg, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_ring_attention_matches_jax(run, hkv):
    """ring_attention over sp=4 (B=2, T=64, H=4, D=16, f32) against the
    JAX ring_attention on the same 4-way sequence mesh: 2e-5 (the JAX
    test's; measured max |diff| 7.2e-7), the blocks in rank order."""
    got = np.concatenate([run.outs[r]["ring"][hkv] for r in range(4)], 1)
    np.testing.assert_allclose(got, run.refs["ring"][hkv], rtol=2e-5,
                               atol=2e-5)


def test_sp_prefill_and_decode_match_jax(run):
    """sp_forward over sp=4 against the JAX sp_forward on a 4-way mesh
    (bf16 weights and cache): the 32-row prefill's last logits and the
    cache rows each rank owns within 2e-2, then six greedy decode steps
    after it with the same tokens and logits within 3e-2 (test_sequence_
    parallel.py's; measured max |diff| 2.4e-3 on the prefill, 3.9e-3 on
    the cache rows, at most 3.6e-3 in the decode)."""
    ref = run.refs["sp"]
    outs = run.outs
    for r in range(4):
        np.testing.assert_allclose(outs[r]["sp"]["prefill"], ref["prefill"],
                                   rtol=2e-2, atol=2e-2)
        np.testing.assert_allclose(outs[r]["sp"]["k"],
                                   ref["k"][:, :, 16 * r:16 * (r + 1)],
                                   rtol=2e-2, atol=2e-2)
    for i, ((t, got), (want_t, want)) in enumerate(zip(
            outs[0]["sp"]["decode"], ref["decode"])):
        assert t == want_t, f"step {i}"
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2)


def _tmodel(key, inputs):
    cfg, params = inputs[key]
    return TModel(cfg, params, Tokenizer(vocab_from_metadata(VOCAB_MD)))


@pytest.mark.parametrize("form", ["tp", "pp", "sp"])
def test_engine_greedy_tokens_equal_unsharded(run, form):
    """Engine under tp (two tp=2 pairs), pp (two pp=2 pairs) and sp (sp=4),
    driven through the step mirror: the greedy tokens of a prompt and of
    a KV-reusing continuation equal the unsharded port engine's."""
    eng = TEngine(_tmodel("engine_model", run.inputs), max_context=64,
                  device="cpu")
    want = [eng.generate(p, GREEDY).tokens
            for p in run.inputs["engine_prompts"]]
    assert run.outs[0]["engines"][form] == want
    if form != "sp":  # the second pair's rank 0
        assert run.outs[2]["engines"][form] == want


@pytest.mark.parametrize("form", ["batched_dp_tp", "batched_ep"])
def test_batched_engine_greedy_tokens_equal_unsharded(run, form):
    """BatchedEngine under dp=2 x tp=2 (each dp index two of the four
    slots) and under sorted-EP over ep=4, four requests together: the
    greedy tokens equal the unsharded port BatchedEngine's."""
    key = "engine_model" if form == "batched_dp_tp" else "ep_engine_model"
    eng = BatchedEngine(_tmodel(key, run.inputs), max_context=64, n_slots=4,
                        device="cpu")
    try:
        want = [eng.generate(p, GREEDY).tokens
                for p in run.inputs["batch_prompts"]]
    finally:
        eng.shutdown()
    assert run.outs[0]["engines"][form] == want


def test_multihost_broadcast_and_lockstep(run):
    """broadcast_request of a 150 kB payload (three 64 KiB frames) reaches
    every rank whole; LockstepEngine's two generates, replayed by the
    followers' follower_loop over a dp=2 x tp=2 sharded model, give the
    unsharded engine's tokens and leave every rank the same context."""
    eng = TEngine(_tmodel("engine_model", run.inputs), max_context=64,
                  device="cpu")
    want = eng.generate(run.inputs["engine_prompts"][0], GREEDY).tokens
    outs = run.outs
    assert all(o["multihost"]["payload_ok"] for o in outs)
    assert outs[0]["multihost"]["tokens"] == [want, want]
    assert len({tuple(o["multihost"]["context"]) for o in outs}) == 1


def test_children_stay_within_budget(run):
    """The 4-rank run's cases, each timed by its child: the whole run in
    well under a minute of CPU."""
    secs = run.outs[0]["seconds"]
    assert sum(secs.values()) < 60, secs


def test_mesh_launch_on_the_cpu(run):
    """`python -m koboldcpp_tpu_torch <fixture> --device cpu --mesh 1,2`
    starts its second rank itself (gloo on the CPU), which follows rank
    0's steps through a one-shot prompt, and both exit."""
    out = run.cli.communicate(timeout=240)[0].decode(errors="replace")
    assert run.cli.returncode == 0, out[-3000:]
    assert "Device mesh: dp=1 tp=2 (2 devices)" in out
    assert "Rank 1: following rank 0's steps" in out


class _Bf16Partials(KeptWhole):
    """A row-parallel weight as tp=2 computes it: the products of its two
    column halves (`_cols`, each taking the whole weight's activation
    variant), each leaving the kernel in bf16, summed in the activations'
    dtype as the ranks' all_reduce sums them."""

    def __init__(self, qt):
        h = qt.shape[1] // 2
        self.halves = [(0, h, _cols(qt, 0, h)),
                       (h, qt.shape[1], _cols(qt, h, qt.shape[1]))]
        self.shape = qt.shape

    def matmul(self, x, out_dtype=None):
        y0, y1 = (tlinear.matmul(x[..., a:b].contiguous(), w, out_dtype)
                  for a, b, w in self.halves)
        return y0 + y1


def test_mesh_refuses_a_model_llama_does_not_run(run):
    """`--mesh 1,2 --device cpu` over the nomic-bert fixture (Q4_K_M,
    bf16): both ranks load their shard (models/bert.py's heads and FFN
    columns), rank 0 serves /v1/embeddings while rank 1 follows its
    steps; SIGINT stops both ranks. The embeddings equal, bit for bit,
    the unsharded port engine's with each w_down summed from its two
    column halves' bf16 products (`_Bf16Partials`: what the ranks
    compute), and the unsharded engine's own within the fixtures' 2e-2 +
    2e-2 |want| (measured max |diff| 1.0e-2 at bf16 activations). Both
    references take the launcher's NTK-aware RoPE base for context 256."""
    texts = ["Once upon a time", "abc"]
    url = f"http://127.0.0.1:{run.bert_port}"
    deadline = time.time() + 240
    while True:
        try:
            urllib.request.urlopen(url + "/api/extra/version", timeout=5)
            break
        except OSError:
            assert run.cli_bert.poll() is None and time.time() < deadline, \
                run.cli_bert.communicate()[0].decode(errors="replace")[-3000:]
            time.sleep(0.5)
    req = urllib.request.Request(
        url + "/v1/embeddings", data=json.dumps({"input": texts}).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        got = np.array([d["embedding"] for d in json.load(r)["data"]])
    run.cli_bert.send_signal(signal.SIGINT)
    out = run.cli_bert.communicate(timeout=120)[0].decode(errors="replace")
    assert "Device mesh: dp=1 tp=2 (2 devices)" in out, out[-3000:]
    assert "Rank 1: following rank 0's steps" in out, out[-3000:]
    m = t_load_model(BERT_FIX, device="cpu")
    apply_rope_config(m.cfg, None, 256)  # the launcher's NTK-aware base
    want = TEngine(m, max_context=256, device="cpu").embed(texts)
    for layer in m.params["layers"]:
        layer["w_down"] = _Bf16Partials(layer["w_down"])
    split = TEngine(m, max_context=256, device="cpu").embed(texts)
    np.testing.assert_array_equal(got, split)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_multihost_launch_on_the_cpu(run):
    """Two hosts of one process each (`--coordinator`, `--numprocesses 2`,
    `--processid 0 / 1`) over the global dp=2 mesh: host 0 serves a
    one-shot prompt through LockstepEngine, host 1 replays it in
    follower_loop, and both exit."""
    outs = [p.communicate(timeout=240)[0].decode(errors="replace")
            for p in run.cli_hosts]
    for p, out in zip(run.cli_hosts, outs):
        assert p.returncode == 0, out[-3000:]
        assert "Device mesh: dp=2 tp=1 (2 devices)" in out
    assert "Follower host 1: entering lockstep loop" in outs[1]
