"""Tensor and expert parallelism over every model module of the port
(parallel/sharding.py with models/bert.py, t5.py, deepseek2.py, mamba.py,
rwkv6.py, rwkv4.py and the models/llama.py branches: bitnet's sub-norms,
openelm's per-layer heads, chameleon's per-head QK norm, ALiBi, a flat QK
norm, heads tp does not divide) held against the JAX forward of the same
model with its params sharded by the JAX `shard_params` on the
conftest's CPU mesh.

One module fixture starts ONE 4-rank gloo group (tests/torch_parallel_
archs_child.py; the children import torch and koboldcpp_tpu_torch only)
while the tests here compute the JAX references in threads, and the
launcher's `--pipeline 2` / `--seqparallel 2` over the rwkv6 fixture
beside it. The fixtures are tests/fixtures/portgguf's (Q4_K_M; RWKV-4 a
q8_0 .bin) on the 8 tokens of late.json. Tolerances, in assert_allclose's
atol + rtol |ref| form: loaded dense in f32, 1e-4 (the f32 port-vs-JAX
tests' own, test_torch_recurrent.py / test_torch_encoders.py /
test_torch_deepseek2.py); loaded packed, the fixtures' own 2e-2 (a
row-parallel shard takes its whole weight's activation variant, so its
group dots are the whole weight's). Each test's docstring gives the max
|diff| measured on this tree.
"""
import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.kv.cache import init_cache as jinit_cache
from koboldcpp_tpu.models import bert as jbert
from koboldcpp_tpu.models import deepseek2 as jds
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models import mamba as jmamba
from koboldcpp_tpu.models import rwkv4 as jrwkv4
from koboldcpp_tpu.models import rwkv6 as jrwkv6
from koboldcpp_tpu.models import t5 as jt5
from koboldcpp_tpu.models.config import ModelConfig
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.models.synthetic import synthetic_params
from koboldcpp_tpu.parallel import make_mesh, shard_params
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.models.config import ModelConfig as TConfig
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.parallel import comm
from koboldcpp_tpu_torch.sampling import SamplerParams

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = os.path.join(ROOT, "tests", "torch_parallel_archs_child.py")
PORT_FIX = os.path.join(ROOT, "tests", "fixtures", "portgguf")
WORLD = 4
FIXTURES = {a: os.path.join(PORT_FIX, f) for a, f in (
    ("nomic-bert", "tiny-nomic-bert-q4_k_m.gguf"),
    ("t5", "tiny-t5-q4_k_m.gguf"),
    ("deepseek2", "tiny-deepseek2-q4_k_m.gguf"),
    ("minicpm3", "tiny-minicpm3-q4_k_m.gguf"),
    ("mamba", "tiny-mamba-q4_k_m.gguf"),
    ("rwkv6", "tiny-rwkv6-q4_k_m.gguf"),
    ("rwkv4", "tiny-rwkv4-q8_0.bin"),
    ("bitnet", "tiny-bitnet-q4_k_m.gguf"),
    ("openelm", "tiny-openelm-q4_k_m.gguf"),
    ("chameleon_swin", "tiny-chameleon_swin-q4_k_m.gguf"),
    ("mpt", "tiny-mpt-q4_k_m.gguf"),
    ("jais", "tiny-jais-q4_k_m.gguf"))}
TOKENS = json.load(open(os.path.join(PORT_FIX, "late.json")))["tokens"][:8]
ENGINE_PROMPTS = [[46, 387, 327], [46, 387, 327, 220, 217]]
TEXTS = ["Once upon a time", "abc"]
GREEDY = GenParams(max_length=6, bypass_eos=True,
                   sampler=SamplerParams(temperature=0.0, rep_pen=1.0))
F32_TOL = dict(rtol=1e-4, atol=1e-4)
PACKED_TOL = dict(rtol=2e-2, atol=2e-2)
NEAR_TIE = 2.0 ** -6
# the synthetic llama models: (config, tp)
SYNTH = {
    "flat_qk": (ModelConfig(arch="llama", vocab_size=512, hidden_size=64,
                            n_layers=2, n_heads=4, n_kv_heads=2,
                            head_dim=16, intermediate_size=128,
                            rope_dim=16), 2),
    "uneven": (ModelConfig(arch="llama", vocab_size=512, hidden_size=96,
                           n_layers=2, n_heads=6, n_kv_heads=3, head_dim=16,
                           intermediate_size=160, rope_dim=16), 2),
    "straddle": (ModelConfig(arch="llama", vocab_size=512, hidden_size=160,
                             n_layers=2, n_heads=10, n_kv_heads=2,
                             head_dim=16, intermediate_size=128,
                             rope_dim=16), 4),
}


def _tcfg(cfg) -> TConfig:
    return TConfig(**{f.name: getattr(cfg, f.name)
                      for f in dataclasses.fields(TConfig)})


def _synthetic(name):
    """The JAX params of a synthetic model, f32: a flat QK RMS norm
    (attn_q_norm over the H * D projection) on "flat_qk", q / k / v / o
    biases on "uneven"."""
    cfg = SYNTH[name][0]
    rng = np.random.default_rng(31)
    p = jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32)
        if jnp.issubdtype(a.dtype, jnp.floating) else a,
        synthetic_params(cfg, kind="dense", seed=7))
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for layer in p["layers"]:
        if name in ("flat_qk", "straddle"):
            layer["attn_q_norm"] = jnp.asarray(
                1 + 0.2 * rng.standard_normal(H * D), jnp.float32)
            layer["attn_k_norm"] = jnp.asarray(
                1 + 0.2 * rng.standard_normal(Hkv * D), jnp.float32)
        elif name == "uneven":
            for k, n in (("bq", H * D), ("bk", Hkv * D), ("bv", Hkv * D),
                         ("bo", cfg.hidden_size)):
                layer[k] = jnp.asarray(0.1 * rng.standard_normal(n),
                                       jnp.float32)
    return p


class _Run:
    """The children's run and the launcher's runs, started at
    construction; `outs` waits for the children."""

    def __init__(self, d: str, inputs: dict):
        self.d = d
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
        # the rwkv6 fixture plain, under --pipeline 2 and --seqparallel 2
        self.cli = {flags: subprocess.Popen(
            [sys.executable, "-m", "koboldcpp_tpu_torch", FIXTURES["rwkv6"],
             "--device", "cpu", "--prompt", "Once upon a time",
             "--promptlimit", "6", "--contextsize", "128", *flags],
            cwd=d, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
            for flags in ((), ("--pipeline", "2"), ("--seqparallel", "2"))}
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


def _jax_logits(m, params, mesh):
    """The JAX forward of model m (its cfg) over TOKENS with `params`
    under `mesh` (the child's `logits`)."""
    cfg = m.cfg
    tok = jnp.asarray([TOKENS], jnp.int32)
    pos = jnp.arange(len(TOKENS), dtype=jnp.int32)[None]
    mods = {"mamba": jmamba, "rwkv6": jrwkv6, "rwkv4": jrwkv4}
    if cfg.is_embedding:
        def fn(p):
            return jbert.forward_embed(p, cfg, tok, pos)
    elif cfg.is_encoder_decoder:
        def fn(p):
            e = jt5.encode(p, cfg, tok, pos)
            c = jt5.prepare_cross(p, cfg, e, pos >= 0,
                                  jt5.init_cache(cfg, 1, 16, tok.shape[1]))
            return jt5.forward(p, cfg, tok[:, :4], pos[:, :4], c)[0]
    elif cfg.arch in ("deepseek2", "minicpm3"):
        def fn(p):
            return jds.forward(p, cfg, tok, pos, jds.init_cache(
                cfg, 1, 32, dtype=jnp.float32))[0]
    elif cfg.arch in mods:
        def fn(p):
            mod = mods[cfg.arch]
            return mod.forward(p, cfg, tok, pos, mod.init_state(cfg, 1))[0]
    else:
        def fn(p):
            return jllama.forward(p, cfg, tok, pos, jinit_cache(
                cfg.n_layers, 1, 32, cfg.n_kv_heads, cfg.head_dim,
                dtype=jnp.float32))[0]
    with mesh:
        return np.asarray(jax.jit(fn)(shard_params(params, mesh)))[0]


def _ref_fixture(name):
    out = {}
    for packed in (False, True):
        m = j_load_model(FIXTURES[name], packed=packed, dtype=jnp.float32)
        out["packed" if packed else "dense"] = _jax_logits(
            m, m.params, make_mesh(2, dp=1, tp=2))
    return out


class _Synth:
    def __init__(self, cfg):
        self.cfg = cfg


def _ref_synthetic(name, params):
    cfg, tp = SYNTH[name]
    return _jax_logits(_Synth(cfg), params, make_mesh(tp, dp=1, tp=tp))


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    jp = {name: _synthetic(name) for name in SYNTH}
    inp = {"fixtures": FIXTURES, "tokens": TOKENS,
           "engine_prompts": ENGINE_PROMPTS, "texts": TEXTS}
    for name, p in jp.items():
        inp[name] = (_tcfg(SYNTH[name][0]), params_from_jax(
            jax.tree_util.tree_map(np.asarray, p)))
    r = _Run(str(tmp_path_factory.mktemp("par_archs")), inp)
    # the JAX references while the children run, in threads (XLA compiles
    # them with the GIL released; each mesh context is thread-local)
    with ThreadPoolExecutor(3) as pool:
        futs = {name: pool.submit(_ref_fixture, name) for name in FIXTURES}
        sfuts = {name: pool.submit(_ref_synthetic, name, jp[name])
                 for name in SYNTH}
        r.refs = {name: f.result() for name, f in futs.items()}
        r.srefs = {name: f.result() for name, f in sfuts.items()}
    yield r
    for p in (*r.procs, *r.cli.values()):
        p.kill()


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_fixture_dense_matches_jax_sharded(run, arch):
    """Each fixture loaded dense in f32 at dp=2 x tp=2 (both dp rows):
    the logits (nomic-bert: the hidden states; t5: the decoder's over 4
    tokens after the encoder took 8) within 1e-4 of the JAX forward with
    params sharded over tp=2. Measured max |diff| 2.9e-6 (mamba)."""
    want = run.refs[arch]["dense"]
    for r in (0, 2):
        np.testing.assert_allclose(run.outs[r]["fixtures"][arch]["dense"],
                                   want, **F32_TOL)


def _rule(shape) -> bool:
    return shape[0] % 256 == 0 and shape[1] % 256 == 0


@pytest.mark.parametrize("arch", list(FIXTURES))
def test_fixture_packed_matches_jax_sharded(run, arch):
    """Each fixture loaded packed (its Q4_K_M / q8_0 weights through the
    kernels' plain versions, f32 activations) at dp=2 x tp=2: the logits
    within 2e-2 + 2e-2 |ref| of the JAX sharded forward (measured worst
    0.57 of it, chameleon_swin, max |diff| 1.4e-2), the argmax equal up to near-ties (the port's own two logits
    within 2^-6), and no dequantized weight whose shape meets the
    kernels' 256 rule (a shard that meets it takes its kernel)."""
    want = run.refs[arch]["packed"]
    for r in (0, 2):
        o = run.outs[r]["fixtures"][arch]
        got = o["packed"]
        np.testing.assert_allclose(got, want, **PACKED_TOL)
        assert not [s for s in o["dequant"] if _rule(s)], o["dequant"]
        if arch != "nomic-bert":
            g, w = got.argmax(-1), want.argmax(-1)
            rows = np.nonzero(g != w)[0]
            gap = got[rows, g[rows]] - got[rows, w[rows]]
            assert (gap <= NEAR_TIE).all(), (rows, gap)


@pytest.mark.parametrize("T", [1, 8])
def test_row_shard_takes_its_whole_weights_activation_variant(
        T, monkeypatch):
    """The two row-parallel shards (in columns 0-255, 256-511) of a 256 x
    512 q4_k weight take the int8-activation body that the whole weight
    takes (in_f 512: K1 at T = 1, K7 at T = 8), not the bf16 one that
    their own in_f 256 would pick. Their quantized groups are the whole
    weight's, so the sum of the two bf16 products is within half a bf16
    step of each partial and of the whole product of the whole one's."""
    from koboldcpp_tpu_torch.models.synthetic import rand_q4k
    from koboldcpp_tpu_torch.ops import quant_matmul as qm
    from koboldcpp_tpu_torch.parallel.sharding import _cols

    seen = []
    orig = qm.q4k_matvec_t_plain  # K1's plain version calls it too
    monkeypatch.setattr(qm, "q4k_matvec_t_plain", lambda x, qt, i8: (
        seen.append(i8), orig(x, qt, i8))[1])
    rng = np.random.default_rng(5)
    qt = rand_q4k(rng, 256, 512)
    x = torch.from_numpy(rng.standard_normal((T, 512)).astype(
        np.float32)).bfloat16()
    whole = qm.matmul_packed(x, qt).float()
    parts = [qm.matmul_packed(x[:, c0:c0 + 256].contiguous(),
                              _cols(qt, c0, c0 + 256)).float()
             for c0 in (0, 256)]
    assert seen == [True] * 3
    bound = 2.0 ** -8 * (parts[0].abs() + parts[1].abs() + whole.abs())
    assert ((parts[0] + parts[1] - whole).abs() <= bound + 1e-6).all()


def test_synthetic_branches_match_jax_sharded(run):
    """The synthetic f32 models against the JAX forward sharded the same
    way, within 1e-4 (measured max |diff| 5.1e-7): a flat QK RMS norm at
    tp=2 (its sum of squares over both ranks' heads, each kv head once),
    6 query / 3 kv heads with q / k / v / o biases at tp=2 (kv heads 2 /
    1, bo added once after the all_reduce on every rank) and 10 query / 2
    kv heads at tp=4, where rank 1's query heads 3-5 straddle kv heads 0
    and 1 and it holds one kv head per query head."""
    outs = run.outs
    for name, (_, tp) in SYNTH.items():
        for r in range(WORLD):
            np.testing.assert_allclose(outs[r]["synthetic"][name]["logits"],
                                       run.srefs[name], **F32_TOL)
    kv = [outs[r]["synthetic"]["uneven"]["kv"][0] for r in (0, 1)]
    assert kv == [[0, 1], [2]]
    kv = [outs[r]["synthetic"]["straddle"]["kv"][0] for r in range(4)]
    assert kv == [[0], [0, 0, 1], [1], [1]]
    copies = [outs[r]["synthetic"]["straddle"]["copies"][0]
              for r in range(4)]
    assert copies == [[3], [3, 3, 3], [3], [3]]


def _port_dense(arch):
    return load_model(FIXTURES[arch], packed=False, dtype=torch.float32,
                      device="cpu")


@pytest.mark.parametrize("arch", ["rwkv6", "deepseek2", "t5"])
def test_engine_greedy_tokens_equal_unsharded(run, arch):
    """Engine over a tp=2 shard (two pairs), its steps mirrored to the
    follower (`Engine.MIRRORED_STEPS`: the forward, the recurrent reset,
    the encoder): the greedy tokens of two prompts equal the unsharded
    port engine's (dense f32 fixtures)."""
    eng = Engine(_port_dense(arch), max_context=64, device="cpu")
    want = [eng.generate(p, GREEDY).tokens for p in ENGINE_PROMPTS]
    for r in (0, 2):
        assert run.outs[r]["engines"][arch] == want


def test_batched_engine_greedy_tokens_equal_unsharded(run):
    """BatchedEngine (2 slots) over the dp=2 x tp=2 shards of the dense f32
    openelm fixture (each layer's own heads on each rank), its steps
    mirrored over the world: the greedy tokens of two requests equal the
    unsharded port BatchedEngine's."""
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine

    eng = BatchedEngine(_port_dense("openelm"), max_context=64, n_slots=2,
                        device="cpu")
    try:
        want = [eng.generate(p, GREEDY).tokens for p in ENGINE_PROMPTS]
    finally:
        eng.shutdown()
    assert run.outs[0]["engines"]["batched"] == want


def test_embeddings_equal_unsharded(run):
    """nomic-bert's Engine.embed over a tp=2 shard (`_encode_rows`
    mirrored): every rank pools the same vector, within 1e-5 of the
    unsharded port's (measured 6.0e-7)."""
    want = Engine(_port_dense("nomic-bert"), max_context=64,
                  device="cpu").embed(TEXTS)
    for r in (0, 2):
        np.testing.assert_allclose(run.outs[r]["engines"]["embed"], want,
                                   rtol=1e-5, atol=1e-5)


def test_pipeline_and_seqparallel_serve_arch_models_unsharded(run):
    """`--pipeline 2` and `--seqparallel 2` over the rwkv6 fixture: the
    model's own branch serves the prompt unsharded, as in the JAX engine
    (the launcher's note, no follower rank), as the plain run does."""
    outs = {f: p.communicate(timeout=240)[0].decode(errors="replace")
            for f, p in run.cli.items()}
    for flags, out in outs.items():
        assert run.cli[flags].returncode == 0, out[-3000:]
        assert "following rank 0" not in out
    for flags in (("--pipeline", "2"), ("--seqparallel", "2")):
        assert (f"Note: {flags[0]} 2 serves the llama-family decoders; "
                "rwkv6 runs its own branch unsharded") in outs[flags]
        assert "parallelism:" not in outs[flags]


def test_children_stay_within_budget(run):
    """The 4-rank run's cases, each timed by its child: the whole run in
    well under a minute of CPU."""
    secs = run.outs[0]["seconds"]
    assert sum(secs.values()) < 60, secs
