"""DeepSeek-V2 / MiniCPM3 (MLA) in the port held against the JAX package, on
the CPU in f32.

The tiny models are tests/test_deepseek2.py's (transformers DeepseekV2,
hidden 64, 3 layers, 4 heads of 16 + 8 roped dims, v_head_dim 12,
kv_lora_rank 24, a dense lead layer then 4 experts with top-2 scaled by 1.5
and one shared expert; q-LoRA rank 32 or the "lite" plain wq), written by
tools/convert_hf.py: the port's `deepseek2.forward` against the JAX one in
one shot and token by token, minicpm3 (the same graph under its scales
and NEOX rope), `_moe` (with a top-k tie), DeepSeek's YaRN factors, the
loader's expert stacks against the JAX loader's, `params_from_jax`, the
Engine's greedy tokens and fast-forward against the JAX Engine's, a state
the JAX engine wrote, `--multiuser` on such a file, the served tiny Q4_K_M
fixtures (tests/fixtures/portgguf/late.json) against their committed JAX
logits, and a fault of the reference: the JAX forward writes a padded
chunk's pad rows into the cache's last slot.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from koboldcpp_tpu.engine.engine import Engine as JEngine
from koboldcpp_tpu.engine.engine import GenParams as JGenParams
from koboldcpp_tpu.models import deepseek2 as jds
from koboldcpp_tpu.models.config import config_from_metadata as j_config
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.ops import linear as jlinear
from koboldcpp_tpu.ops import rope as jrope
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine import batch_engine as be
from koboldcpp_tpu_torch.models import deepseek2 as tds
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.config import config_from_metadata
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import Model, load_model
from koboldcpp_tpu_torch.models.synthetic import DEEPSEEK_V2_LITE_MD
from koboldcpp_tpu_torch.ops import linear
from koboldcpp_tpu_torch.ops import rope as trope
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_hf import convert_deepseek2_state_dict  # noqa: E402

from .test_deepseek2 import make_model  # noqa: E402
from .test_model_forward import tiny_tokenizer_md  # noqa: E402

pytest_plugins = ("aiohttp.pytest_plugin",)

TOKENS = [1, 5, 9, 42, 7, 300]
TOL = dict(rtol=1e-4, atol=1e-4)
PORT_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """q_lora_rank (32, or None for "lite") -> the tiny model's GGUF, and
    "minicpm3" -> the q-LoRA file's tensors under the minicpm3
    architecture (as tests/test_deepseek2.py writes it)."""
    from koboldcpp_tpu.gguf import GGMLType, GGUFReader, GGUFWriter

    d = tmp_path_factory.mktemp("ds2")
    out = {}
    for rank in (32, None):
        model, cfg = make_model(rank)
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        out[rank] = str(d / f"ds2-{rank}.gguf")
        convert_deepseek2_state_dict(state, cfg, out[rank],
                                     tokenizer_md=tiny_tokenizer_md(512))
    out["minicpm3"] = str(d / "mc3.gguf")
    with GGUFReader(out[32]) as r:
        w = GGUFWriter(out["minicpm3"], architecture="minicpm3")
        for k, v in r.metadata.items():
            if k.startswith("deepseek2."):
                w.add("minicpm3." + k.split(".", 1)[1], v)
            elif k != "general.architecture":
                w.add(k, v)
        for name in r.tensors:
            w.add_tensor(name, r.tensor_data(name), GGMLType.F32)
        w.write()
    return out


def _jax(path, tokens=TOKENS, S=32):
    m = j_load_model(path, packed=False, dtype=jnp.float32)
    cache = jds.init_cache(m.cfg, 1, S, dtype=jnp.float32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    logits, cache = jds.forward(m.params, m.cfg,
                                jnp.asarray([tokens], jnp.int32), pos, cache)
    return m, np.asarray(logits)[0], cache


def _port_model(path):
    return load_model(path, packed=False, dtype=torch.float32, device="cpu")


def _port(m, tokens=TOKENS, S=32, positions=None):
    cache = tds.init_cache(m.cfg, 1, S, dtype=torch.float32)
    pos = (torch.arange(len(tokens))[None] if positions is None
           else torch.tensor([positions]))
    with torch.inference_mode():
        logits, cache = tds.forward(m.params, m.cfg, torch.tensor([tokens]),
                                    pos, cache)
    return logits[0].numpy(), cache


@pytest.mark.parametrize("rank", [32, None], ids=["qlora", "lite"])
@pytest.mark.parametrize("mode", ["one_shot", "token_by_token"])
def test_forward_matches_jax(files, rank, mode):
    """The same file and tokens: the port's forward equals the JAX forward
    within 1e-4, over the 6 tokens at once or one token a call (each step
    against the JAX one-shot row), and its cache equals the JAX one."""
    jm, want, jcache = _jax(files[rank])
    tm = _port_model(files[rank])
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    assert ("wq_a" in tm.params["layers"][0]) == (rank is not None)
    assert "w_gate" in tm.params["layers"][0]  # the dense lead layer
    assert "ffn_gate_inp" in tm.params["layers"][1]
    if mode == "one_shot":
        got, cache = _port(tm)
    else:
        cache = tds.init_cache(tm.cfg, 1, 32, dtype=torch.float32)
        rows = []
        with torch.inference_mode():
            for t, tok in enumerate(TOKENS):
                lg, _ = tds.forward(tm.params, tm.cfg, torch.tensor([[tok]]),
                                    torch.tensor([[t]]), cache)
                rows.append(lg[0, 0])
        got = torch.stack(rows).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), **TOL)
    np.testing.assert_allclose(cache.v.numpy(), np.asarray(jcache.v), **TOL)


def test_minicpm3_matches_jax(files):
    """minicpm3 (the embedding scale 12, residual 1.4 / sqrt(L), logits
    256 / hidden, NEOX rope) against the JAX minicpm3 within 1e-4, and
    last_index / last_only pick the JAX rows."""
    jm, want, _ = _jax(files["minicpm3"])
    tm = _port_model(files["minicpm3"])
    assert tm.cfg.arch == "minicpm3" and tm.cfg.embedding_scale == 12.0
    assert tm.cfg.rope_type == "neox" and tm.cfg.logit_scale == 4.0
    got, _ = _port(tm)
    np.testing.assert_allclose(got, want, **TOL)
    cache = tds.init_cache(tm.cfg, 1, 32, dtype=torch.float32)
    with torch.inference_mode():
        lg, _ = tds.forward(tm.params, tm.cfg, torch.tensor([TOKENS]),
                            torch.arange(6)[None], cache,
                            last_index=torch.tensor([3]))
        ll, _ = tds.forward(tm.params, tm.cfg, torch.tensor([TOKENS]),
                            torch.arange(6)[None],
                            tds.init_cache(tm.cfg, 1, 32,
                                           dtype=torch.float32),
                            last_only=True)
    np.testing.assert_allclose(lg[0, 0].numpy(), want[3], **TOL)
    np.testing.assert_allclose(ll[0, 0].numpy(), want[5], **TOL)


def test_moe_matches_jax_and_ties_go_low(files):
    """`_moe` on the same rows and weights as the JAX `_moe` within 1e-5; a
    router whose experts 1 and 2 tie for the last of the k = 2 places
    (rows 0 > 1 = 2 > 3 for every token) gives expert 1, the lower index,
    in both packages."""
    jm = j_load_model(files[32], packed=False, dtype=jnp.float32)
    tm = _port_model(files[32])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    for tie in (False, True):
        jl, tl = dict(jm.params["layers"][1]), dict(tm.params["layers"][1])
        if tie:
            u = np.abs(rng.standard_normal(64)).astype(np.float32) * 0.1
            w = np.stack([3 * u, u, u, -u])
            jl["ffn_gate_inp"] = jlinear.dense(w, dtype=jnp.float32)
            tl["ffn_gate_inp"] = linear.dense(w, dtype=torch.float32)
            xa = np.abs(x)
        else:
            xa = x
        want = np.asarray(jds._moe(jnp.asarray(xa), jl, jm.cfg))
        with torch.inference_mode():
            got = tds._moe(torch.from_numpy(xa), tl, tm.cfg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        if tie:
            router = torch.from_numpy(xa.reshape(-1, 64) @ w.T)
            _, idx = tllama._top_k(torch.softmax(router, -1), 2)
            assert (idx == torch.tensor([0, 1])).all()


def test_yarn_factors_at_v2_lite():
    """DeepSeek-V2-Lite's rope keys (YaRN factor 40 over 4096,
    yarn_log_multiplier 0.0707, rope dim 64): the port's
    rope_frequencies equal the JAX ones within 1 ulp-scale, `_scales`
    equal exactly, and mscale / kq_scale take the reference's values."""
    tcfg = config_from_metadata(DEEPSEEK_V2_LITE_MD)
    jcfg = j_config(DEEPSEEK_V2_LITE_MD)
    assert tcfg.rope_scaling_type == "yarn" and tcfg.rope_scaling_factor == 40
    assert tcfg.rope_dim == 64 and tcfg.head_dim == 192
    np.testing.assert_allclose(trope.rope_frequencies(tcfg).numpy(),
                               np.asarray(jrope.rope_frequencies(jcfg)),
                               rtol=1e-6, atol=0)
    kq, rf = tds._scales(tcfg)
    assert (kq, rf) == jds._scales(jcfg)
    mscale = 1 + tcfg.extras["yarn_log_mul"] * np.log(40)
    assert kq == pytest.approx(mscale * mscale / np.sqrt(192), rel=1e-12)
    assert rf == pytest.approx(1 / (1 + 0.1 * np.log(40)), rel=1e-12)


def test_expert_stacks_and_params_from_jax(files):
    """The Q4_K_M fixture's 3-D expert stacks load dense and bit-equal to
    the JAX loader's (packed=False), in bf16 and f32; params_from_jax
    carries the q-LoRA, MLA and expert keys, and its tree gives the JAX
    logits through the port's forward."""
    path = os.path.join(PORT_FIX, "tiny-deepseek2-q4_k_m.gguf")
    for dt, jdt in ((torch.bfloat16, jnp.bfloat16),
                    (torch.float32, jnp.float32)):
        tm = load_model(path, dtype=dt, device="cpu")
        jm = j_load_model(path, packed=False, dtype=jdt)
        layer, jlayer = tm.params["layers"][1], jm.params["layers"][1]
        for key in ("ffn_gate_exps", "ffn_up_exps", "ffn_down_exps"):
            got = layer[key].data["w"]
            assert got.dim() == 3 and got.dtype == dt
            want = np.asarray(jlayer[key].data["w"].astype(jnp.float32))
            np.testing.assert_array_equal(got.float().numpy(), want)
    jm, want, _ = _jax(files[32])
    tm = _port_model(files[32])
    import jax

    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    assert set(conv["layers"][0]) == set(tm.params["layers"][0])
    assert set(conv["layers"][1]) == set(tm.params["layers"][1])
    assert {"wq_a", "q_a_norm", "wq_b", "wkv_a_mqa", "kv_a_norm",
            "wkv_b"} <= set(conv["layers"][0])
    assert conv["layers"][1]["ffn_up_exps"].data["w"].shape == (4, 48, 64)
    got, _ = _port(Model(tm.cfg, conv, tm.tokenizer, "cpu"))
    np.testing.assert_allclose(got, want, **TOL)


def _greedy(n):
    return GenParams(max_length=n, use_default_badwordsids=True,
                     sampler=SamplerParams(temperature=0.0))


def _jgreedy(n):
    return JGenParams(max_length=n, use_default_badwordsids=True,
                      sampler=JSamplerParams(temperature=0.0))


def _port_engine(path, S=64):
    tm = _port_model(path)
    eng = Engine(tm, max_context=S, device="cpu", quantkv=1)
    assert eng.mla and not eng.use_contextshift and not eng.use_flash_prefill
    assert eng.cache.k.dtype == torch.bfloat16  # --quantkv leaves it bf16
    assert tuple(eng.cache.k.shape) == (3, 1, S, 4, 24)
    assert tuple(eng.cache.v.shape) == (3, 1, S, 4, 12)
    eng.cache = tds.init_cache(tm.cfg, 1, S, dtype=torch.float32)
    return eng


def test_engine_matches_jax_engine(files):
    """The port's Engine (the MLA branch: no device chunk, each token one
    row) against the JAX Engine over an f32 cache: the same 6 greedy
    tokens, and a fast-forwarded request that evaluates one new prompt
    token, as tests/test_deepseek2.py's engine test."""
    je = JEngine(j_load_model(files[32], packed=False, dtype=jnp.float32),
                 max_context=64, cache_dtype=jnp.float32)
    want = je.generate([1, 5, 9, 42], _jgreedy(6)).tokens
    want2 = je.generate(list(je.context_tokens) + [7], _jgreedy(6)).tokens
    eng = _port_engine(files[32])
    assert not eng._fast_greedy_ok(_greedy(6), None)
    r1 = eng.generate([1, 5, 9, 42], _greedy(6))
    assert r1.tokens == want
    r2 = eng.generate(list(eng.context_tokens) + [7], _greedy(6))
    assert eng.last_timings.prompt_tokens == 1
    assert r2.tokens == want2


def test_port_loads_a_jax_written_state(files, tmp_path):
    """A state the JAX engine saved over its f32 MLA cache ((L, B, S, H, dk)
    K and (L, B, S, H, dv) V) loads into the port's bf16 cache (cast, as
    the JAX load casts to its cache dtype), and the next request
    fast-forwards over it; the port's own save writes the same layout."""
    je = JEngine(j_load_model(files[32], packed=False, dtype=jnp.float32),
                 max_context=64, cache_dtype=jnp.float32)
    r = je.generate([1, 5, 9, 42], _jgreedy(4))
    path = str(tmp_path / "jax_state.npz")
    je.save_state(path)
    data = np.load(path)
    assert data["k"].shape == (3, 1, 64, 4, 24)
    assert data["v"].shape == (3, 1, 64, 4, 12)
    e = Engine(_port_model(files[32]), max_context=64, device="cpu")
    e.load_state(path)
    assert e.context_tokens == [1, 5, 9, 42] + r.tokens
    assert torch.equal(e.cache.k, torch.from_numpy(data["k"]).to(
        torch.bfloat16))
    assert torch.equal(e.cache.v, torch.from_numpy(data["v"]).to(
        torch.bfloat16))
    e.generate(e.context_tokens + [7], _greedy(2))
    assert e.last_timings.prompt_tokens == 1
    mine = str(tmp_path / "port_state.npz")
    e.save_state(mine)
    back = np.load(mine)
    assert back["k"].shape == data["k"].shape
    assert back["v"].shape == data["v"].shape


def test_pad_rows_fault_of_the_reference(files):
    """A fault of the reference: the JAX forward scatters with
    mode="drop", which on this JAX wraps a padded chunk's position -1 to
    the last slot, so every left-padded chunk writes its pad rows' K / V
    into slot S - 1; the port drops them (as kv/cache.py `write` does).
    Before a chunk reaches S - 1 that slot is masked for every row, so no
    logit moves; when a padded chunk's real row is at S - 1, two writes
    land on one index and the order is undefined: on this CPU the real
    row, written last, wins, and the logits agree (within 1e-6)."""
    jm = j_load_model(files[32], packed=False, dtype=jnp.float32)
    tm = _port_model(files[32])
    S = 8
    for n_real, start in ((4, 0), (6, 2)):  # ends at 3; ends at S - 1 = 7
        toks = [0] * (16 - n_real) + TOKENS[:n_real]
        pos = [-1] * (16 - n_real) + list(range(start, start + n_real))
        jc = jds.init_cache(jm.cfg, 1, S, dtype=jnp.float32)
        want, jc = jds.forward(jm.params, jm.cfg, jnp.asarray([toks]),
                               jnp.asarray([pos]), jc)
        got, tc = _port(tm, toks, S, pos)
        np.testing.assert_allclose(got[16 - n_real:],
                                   np.asarray(want)[0, 16 - n_real:],
                                   rtol=1e-6, atol=1e-6)
        jk = np.asarray(jc.k)[:, 0, S - 1]
        if start == 0:
            assert np.abs(jk).max() > 0.05  # a pad row's K in the JAX cache
            assert tc.k[:, 0, S - 1].abs().max() == 0  # nothing in the port
        else:
            np.testing.assert_allclose(tc.k[:, 0, S - 1].numpy(), jk,
                                       rtol=1e-6, atol=1e-6)


def test_multiuser_serves_through_the_single_engine(capsys, monkeypatch):
    """`--multiuser 4` on a deepseek2 file: batch_capable refuses the
    architecture, the launcher prints the JAX note and serves through the
    single Engine (no BatchedEngine is built)."""
    from koboldcpp_tpu_torch import cli

    path = os.path.join(PORT_FIX, "tiny-deepseek2-q4_k_m.gguf")
    cfg = config_from_metadata({"general.architecture": "deepseek2"})
    assert not be.batch_capable(cfg)
    built = []
    monkeypatch.setattr(be.BatchedEngine, "__init__",
                        lambda self, *a, **k: built.append(k))
    assert cli.main([path, "--device", "cpu", "--contextsize", "128",
                     "--multiuser", "4", "--prompt", "Once upon",
                     "--promptlimit", "3"]) == 0
    out = capsys.readouterr().out
    assert not built
    assert "continuous batching is unavailable" in out and "deepseek2" in out


async def test_served_over_http(aiohttp_client):
    """The tiny DeepSeek-V2 Q4_K_M fixture behind the server on the CPU:
    two /api/v1/generate replies at temperature 0 are equal and not
    empty."""
    tm = load_model(os.path.join(PORT_FIX, "tiny-deepseek2-q4_k_m.gguf"),
                    device="cpu")
    client = await aiohttp_client(make_app(
        Engine(tm, max_context=128, device="cpu"),
        ServerSettings(model_name="tiny-deepseek2")))
    body = {"prompt": "Once upon", "max_length": 6, "temperature": 0,
            "rep_pen": 1.0}
    texts = []
    for _ in range(2):
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] == texts[1] and texts[0]


@pytest.mark.parametrize("arch", ["deepseek2", "minicpm3"])
def test_fixture_matches_jax_logits(arch):
    """The deepseek2 / minicpm3 Q4_K_M fixtures (tests/make_torch_fixtures.py
    --late) loaded packed in f32: the port's forward over the manifest's
    tokens against the committed JAX logits, |err| <= 2e-2 + 2e-2 |want|
    (test_torch_archs.py's fixture tolerance), and the same argmax."""
    man = json.load(open(os.path.join(PORT_FIX, "late.json")))
    tm = load_model(os.path.join(PORT_FIX, man["files"][arch]),
                    dtype=torch.float32, device="cpu")
    assert tm.cfg.arch == arch
    got, _ = _port(tm, man["tokens"], 64)
    want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
    worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())
    assert worst <= 1.0, worst
    assert (got.argmax(-1) == want.argmax(-1)).all()
