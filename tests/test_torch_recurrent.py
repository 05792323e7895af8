"""The recurrent models in the port (Mamba, RWKV6, RWKV4) held against the
JAX package, on the CPU in f32.

The tiny models are the JAX tests' own: tests/test_mamba.py's transformers
Mamba (hidden 64, d_inner 128, d_state 8, dt_rank 4, 2 layers) and
tests/test_rwkv6.py's RWKV6 state dict (hidden 32, 2 heads of 16, 3
layers, rescale every 2), both written by tools/convert_hf.py, and
tests/test_rwkv4.py's transformers RWKV-4 (hidden 64, 2 layers) written as
a legacy .bin by tools/convert_rwkv.py with its vocab sidecar. No
download. Each case: the port's forward against the JAX one (logits and
every state leaf within 1e-4), prefill in chunks equal to one shot,
right-padding that moves neither the valid rows nor the state, the
Engine's greedy tokens against the JAX Engine's with the full-prefix
reset rule, a state file written by each package read by the other,
FalconMamba's dt / B / C norm through `params_from_jax`, a rewind, the
legacy loader, the served tiny fixtures (tests/fixtures/portgguf/
text.json) against their committed JAX logits, and a fault of the
reference: the JAX Mamba under bf16 weights writes a state file it cannot
read back.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from koboldcpp_tpu.engine.engine import Engine as JEngine
from koboldcpp_tpu.engine.engine import GenParams as JGenParams
from koboldcpp_tpu.models import mamba as jmamba
from koboldcpp_tpu.models import rwkv4 as jrwkv4
from koboldcpp_tpu.models import rwkv6 as jrwkv6
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.kv.recurrent import state_leaves
from koboldcpp_tpu_torch.models import mamba, rwkv4, rwkv6
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.models.loader import Model, load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_hf import (convert_mamba_state_dict,  # noqa: E402
                        convert_rwkv6_state_dict)
from convert_rwkv import convert_state_dict  # noqa: E402

from .test_model_forward import tiny_tokenizer_md  # noqa: E402
from .test_rwkv4 import _write_pile_vocab  # noqa: E402
from .test_rwkv6 import CFG as RWKV6_CFG  # noqa: E402
from .test_rwkv6 import V as RWKV6_VOCAB  # noqa: E402
from .test_rwkv6 import make_state as rwkv6_state  # noqa: E402

pytest_plugins = ("aiohttp.pytest_plugin",)

ARCHS = ("mamba", "rwkv6", "rwkv4")
JMOD = {"mamba": jmamba, "rwkv6": jrwkv6, "rwkv4": jrwkv4}
TMOD = {"mamba": mamba, "rwkv6": rwkv6, "rwkv4": rwkv4}
TOKENS = [3, 17, 40, 8, 77, 2, 55, 12]
TOL = dict(rtol=1e-4, atol=1e-4)
PORT_FIX = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from transformers import (MambaConfig, MambaForCausalLM, RwkvConfig,
                              RwkvForCausalLM)

    d = tmp_path_factory.mktemp("recurrent")
    torch.manual_seed(11)
    cfg = MambaConfig(vocab_size=512, hidden_size=64, state_size=8,
                      num_hidden_layers=2, conv_kernel=4,
                      intermediate_size=128, time_step_rank=4,
                      use_cache=False)
    m = MambaForCausalLM(cfg).eval().float()
    out = {"mamba": str(d / "mamba.gguf"), "rwkv6": str(d / "rwkv6.gguf"),
           "rwkv4": str(d / "rwkv4.bin")}
    convert_mamba_state_dict({k: v.numpy() for k, v in m.state_dict().items()},
                             cfg, out["mamba"],
                             tokenizer_md=tiny_tokenizer_md(512))
    convert_rwkv6_state_dict(rwkv6_state(7), RWKV6_CFG, out["rwkv6"],
                             tokenizer_md=tiny_tokenizer_md(RWKV6_VOCAB))
    torch.manual_seed(23)
    rc = RwkvConfig(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                    attention_hidden_size=64, intermediate_size=128,
                    context_length=256, use_cache=False)
    convert_state_dict(RwkvForCausalLM(rc).eval().float().state_dict(),
                       out["rwkv4"], dtype="f32")
    _write_pile_vocab(str(d / "rwkv_vocab.embd"), 512)
    return out


@pytest.fixture(scope="module")
def models(files):
    """arch -> (JAX model, port model), both f32 unpacked."""
    return {a: (j_load_model(p, packed=False, dtype=jnp.float32),
                load_model(p, packed=False, dtype=torch.float32,
                           device="cpu")) for a, p in files.items()}


def _jax_run(arch, jm, tokens, positions, state=None, **kw):
    mod = JMOD[arch]
    state = mod.init_state(jm.cfg, 1) if state is None else state
    logits, state = mod.forward(jm.params, jm.cfg,
                                jnp.asarray([tokens], jnp.int32),
                                jnp.asarray([positions], jnp.int32), state,
                                **kw)
    return np.asarray(logits)[0], state


def _port_run(arch, tm, tokens, positions, state=None, **kw):
    mod = TMOD[arch]
    state = mod.init_state(tm.cfg, 1) if state is None else state
    with torch.inference_mode():
        logits, state = mod.forward(tm.params, tm.cfg, torch.tensor([tokens]),
                                    torch.tensor([positions]), state, **kw)
    return logits[0].numpy(), state


def _leaves_close(tstate, jstate, **tol):
    jl = [np.asarray(getattr(jstate, f.name))
          for f in dataclasses.fields(tstate)]
    for got, want in zip(state_leaves(tstate), jl):
        np.testing.assert_allclose(got.numpy(), want.astype(np.float32),
                                   **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_jax(models, arch):
    """The same file and tokens: logits within 1e-4 of the JAX forward and
    every state leaf (in the JAX dataclass's field order) too; the config
    equal to the JAX one."""
    jm, tm = models[arch]
    assert dataclasses.asdict(tm.cfg) == dataclasses.asdict(jm.cfg)
    pos = list(range(len(TOKENS)))
    want, jstate = _jax_run(arch, jm, TOKENS, pos)
    got, tstate = _port_run(arch, tm, TOKENS, pos)
    np.testing.assert_allclose(got, want, **TOL)
    assert [f.name for f in dataclasses.fields(tstate)] == \
        [f.name for f in dataclasses.fields(jstate)]
    _leaves_close(tstate, jstate, **TOL)
    if arch == "rwkv4":
        pp = TMOD[arch].init_state(tm.cfg, 1).pp
        assert (pp == torch.tensor(-1e30, dtype=torch.float32)).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_equals_one_shot(models, arch):
    """A prefill of 5 then one token a call (the engine's decode step) over
    the carried state equals one shot (the JAX tests' 2e-4), and its last
    state equals the JAX one-shot state."""
    jm, tm = models[arch]
    want, jstate = _jax_run(arch, jm, TOKENS, list(range(len(TOKENS))))
    got, state = _port_run(arch, tm, TOKENS[:5], list(range(5)))
    rows = [got]
    for t in range(5, len(TOKENS)):
        lg, state = _port_run(arch, tm, [TOKENS[t]], [t], state)
        rows.append(lg)
    np.testing.assert_allclose(np.concatenate(rows), want, rtol=2e-4,
                               atol=2e-4)
    _leaves_close(state, jstate, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_padding_rows_keep_the_state(models, arch):
    """Right padding (position -1) moves neither the valid rows' logits nor
    the state; every row, the padding's too, equals the JAX forward's on
    the same padded chunk, and last_index picks the last valid row. A
    padding row in the middle of the chunk (gated inside the loop) also
    equals JAX."""
    jm, tm = models[arch]
    T = len(TOKENS)
    clean, clean_state = _port_run(arch, tm, TOKENS, list(range(T)))
    toks = TOKENS + [0] * 3
    pos = list(range(T)) + [-1] * 3
    padded, state = _port_run(arch, tm, toks, pos)
    np.testing.assert_allclose(padded[:T], clean, rtol=1e-5, atol=1e-5)
    for a, b in zip(state_leaves(state), state_leaves(clean_state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)
    want, jstate = _jax_run(arch, jm, toks, pos)
    np.testing.assert_allclose(padded, want, **TOL)
    last, _ = _port_run(arch, tm, toks, pos,
                        last_index=torch.tensor([T - 1]))
    np.testing.assert_allclose(last[0], clean[-1], rtol=1e-5, atol=1e-5)
    mid = [0, 1, 2, -1, 3, 4]
    want, jstate = _jax_run(arch, jm, TOKENS[:6], mid)
    got, state = _port_run(arch, tm, TOKENS[:6], mid)
    np.testing.assert_allclose(got, want, **TOL)
    _leaves_close(state, jstate, **TOL)


def test_falcon_mamba_norms_through_params_from_jax(models):
    """FalconMamba's `ssm_dt_b_c_rms` (dt, B and C RMS-normed before the dt
    projection) with the cfg replaced in both packages, the port running
    `params_from_jax` of the JAX tree: logits and state within 1e-4, and
    different from the plain Mamba's."""
    jm, tm = models["mamba"]
    jcfg = dataclasses.replace(jm.cfg, ssm_dt_b_c_rms=True)
    tcfg = dataclasses.replace(tm.cfg, ssm_dt_b_c_rms=True)
    conv = params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params))
    assert set(conv["layers"][0]) == set(tm.params["layers"][0])
    pos = list(range(len(TOKENS)))
    want, jstate = _jax_run("mamba", Model(jcfg, jm.params, None), TOKENS, pos)
    got, tstate = _port_run("mamba", Model(tcfg, conv, None), TOKENS, pos)
    np.testing.assert_allclose(got, want, **TOL)
    _leaves_close(tstate, jstate, **TOL)
    plain, _ = _port_run("mamba", tm, TOKENS, pos)
    assert np.abs(plain - got).max() > 1e-2


def _greedy(n):
    return GenParams(max_length=n, use_default_badwordsids=True,
                     sampler=SamplerParams(temperature=0.0))


def _jgreedy(n):
    return JGenParams(max_length=n, use_default_badwordsids=True,
                      sampler=JSamplerParams(temperature=0.0))


@pytest.fixture(scope="module")
def jax_engines(models):
    return {a: JEngine(jm, max_context=64) for a, (jm, _) in models.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_matches_jax_engine(models, jax_engines, arch):
    """The port's Engine (the recurrent branch: host loop, one-row decode
    steps) against the JAX Engine on the same file: the same greedy tokens
    for a prompt, for a prompt extending the whole cached context (one
    prompt token evaluated: the state continues) and for a prompt that
    does not (the state resets: every prompt token evaluated)."""
    je = jax_engines[arch]
    eng = Engine(models[arch][1], max_context=64, device="cpu")
    assert eng.recurrent and not eng.use_contextshift
    assert not eng._fast_greedy_ok(_greedy(6), None)
    prompt = [1, 5, 9, 42]
    assert eng.generate(prompt, _greedy(6)).tokens == \
        je.generate(prompt, _jgreedy(6)).tokens
    ext = list(eng.context_tokens) + [7]
    assert ext == list(je.context_tokens) + [7]
    got = eng.generate(ext, _greedy(6)).tokens
    assert eng.last_timings.prompt_tokens == 1
    assert got == je.generate(ext, _jgreedy(6)).tokens
    other = [2, 8, 3, 59, 4]
    got = eng.generate(other, _greedy(6)).tokens
    assert eng.last_timings.prompt_tokens == len(other)
    assert got == je.generate(other, _jgreedy(6)).tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_state_files_interchange(models, jax_engines, arch, tmp_path):
    """A state the JAX engine saved (`recurrent` = 1, leaf0.. in its
    dataclass's order) loads into the port's Engine leaf for leaf, and the
    next request continues from it as the JAX engine continues; the port's
    own file loads into the JAX engine, which then gives the port's
    tokens."""
    je = jax_engines[arch]
    je.generate([4, 9, 60, 7], _jgreedy(4))
    jpath = str(tmp_path / "jax.npz")
    je.save_state(jpath)
    eng = Engine(models[arch][1], max_context=64, device="cpu")
    eng.load_state(jpath)
    data = np.load(jpath)
    assert eng.context_tokens == list(je.context_tokens)
    for i, leaf in enumerate(state_leaves(eng.cache)):
        np.testing.assert_array_equal(leaf.numpy(), data[f"leaf{i}"])
    ext = list(eng.context_tokens) + [11]
    got = eng.generate(ext, _greedy(4)).tokens
    assert eng.last_timings.prompt_tokens == 1
    assert got == je.generate(ext, _jgreedy(4)).tokens

    ppath = str(tmp_path / "port.npz")
    eng.save_state(ppath)
    back = np.load(ppath)
    assert int(back["recurrent"]) == 1
    assert sorted(back.files) == sorted(data.files)
    je2 = JEngine(models[arch][0], max_context=64)
    je2.load_state(ppath)
    ext = list(eng.context_tokens) + [13]
    want = je2.generate(ext, _jgreedy(4)).tokens
    assert je2.last_timings.prompt_tokens == 1
    assert eng.generate(ext, _greedy(4)).tokens == want
    with pytest.raises(ValueError, match="recurrent"):
        Engine(load_model(os.path.join(PORT_FIX, "tiny-q2_k.gguf"),
                          device="cpu"), max_context=64,
               device="cpu").load_state(ppath)


def test_jax_bf16_mamba_state_fault_of_the_reference(tmp_path):
    """A fault of the reference: under bf16 weights the JAX Mamba carries
    its conv state in the activations' dtype (mamba.py:69-71 returns the
    bf16 conv inputs, which replace the f32 leaf), so its state file holds
    leaf0 as bf16 ('<V2' bytes) and the JAX engine cannot load its own
    file (TypeError, as with its bf16 KV state). The port keeps every leaf
    f32 (the bf16 values are exact in f32), reads that file, and continues
    from it by one prompt token."""
    path = os.path.join(PORT_FIX, _manifest()["files"]["mamba"])
    jm = j_load_model(path, dtype=jnp.bfloat16)
    je = JEngine(jm, max_context=64)
    je.generate([1, 5, 9, 42], _jgreedy(4))
    assert je.cache.conv.dtype == jnp.bfloat16
    spath = str(tmp_path / "jax_bf16.npz")
    je.save_state(spath)
    data = np.load(spath)
    assert data["leaf0"].dtype == np.dtype("V2")
    with pytest.raises(TypeError):
        JEngine(jm, max_context=64).load_state(spath)
    eng = Engine(load_model(path, device="cpu"), max_context=64,
                 device="cpu")
    eng.load_state(spath)
    assert eng.cache.conv.dtype == torch.float32
    want = torch.from_numpy(data["leaf0"].view(np.int16)).view(
        torch.bfloat16).float()
    assert torch.equal(eng.cache.conv, want)
    eng.generate(list(eng.context_tokens) + [7], _greedy(2))
    assert eng.last_timings.prompt_tokens == 1


def test_rewind_resets_and_replays(models):
    """A rewind (anti-slop) of a recurrent model resets the state and
    evaluates the context again: the replayed logits equal those of a
    fresh engine's prefill of the same context."""
    tm = models["rwkv4"][1]
    eng = Engine(tm, max_context=64, device="cpu")
    eng.generate([1, 5, 9, 42], _greedy(3))
    ctx = list(eng.context_tokens)
    got = eng._replay_logits()
    fresh = Engine(tm, max_context=64, device="cpu")
    want = fresh.eval_tokens(ctx, 0).float().numpy()
    np.testing.assert_array_equal(got, want)
    for a, b in zip(state_leaves(eng.cache), state_leaves(fresh.cache)):
        assert torch.equal(a, b)


def test_legacy_rwkv_loads_with_its_vocab(files):
    """The legacy RWKV-4 .bin loads through LegacyRwkvReader with the
    vocab sidecar beside it (the greedy legacy tokenizer), as in JAX."""
    tm = load_model(files["rwkv4"], device="cpu")
    assert tm.cfg.arch == "rwkv4" and tm.cfg.is_recurrent
    assert tm.tokenizer.encode("the the", add_bos=False) == [1, 2]
    assert tm.params["layers"][0]["wk"].kind == "dense"


def _manifest():
    return json.load(open(os.path.join(PORT_FIX, "text.json")))


@pytest.mark.parametrize("arch", ARCHS)
def test_fixture_matches_jax_logits(arch):
    """The tiny fixtures (tests/make_torch_fixtures.py --text: Mamba and
    RWKV6 at Q4_K_M, RWKV-4 as a q8_0 legacy .bin) loaded packed in f32:
    the port's forward over the manifest's tokens against the committed
    JAX logits, |err| <= 2e-2 + 2e-2 |want| (test_torch_archs.py's
    fixture tolerance), and the same argmax."""
    man = _manifest()
    tm = load_model(os.path.join(PORT_FIX, man["files"][arch]),
                    dtype=torch.float32, device="cpu")
    assert tm.cfg.arch == arch
    kinds = {v.kind for ly in tm.params["layers"] for v in ly.values()
             if hasattr(v, "kind")}
    assert kinds & {"q4_k", "q8_0"}
    toks = man["tokens"]
    got, _ = _port_run(arch, tm, toks, list(range(len(toks))))
    want = np.load(os.path.join(PORT_FIX, f"logits-jax-{arch}.npy"))
    worst = float((np.abs(got - want) / (2e-2 + 2e-2 * np.abs(want))).max())
    assert worst <= 1.0, worst
    assert (got.argmax(-1) == want.argmax(-1)).all()


async def test_served_over_http(aiohttp_client):
    """The tiny Mamba Q4_K_M fixture behind the server on the CPU: two
    /api/v1/generate replies at temperature 0 are equal and not empty, and
    /v1/embeddings refuses a model that makes none (400)."""
    tm = load_model(os.path.join(PORT_FIX, _manifest()["files"]["mamba"]),
                    device="cpu")
    client = await aiohttp_client(make_app(
        Engine(tm, max_context=128, device="cpu"),
        ServerSettings(model_name="tiny-mamba")))
    body = {"prompt": "Once upon", "max_length": 6, "temperature": 0,
            "rep_pen": 1.0}
    texts = []
    for _ in range(2):
        r = await client.post("/api/v1/generate", json=body)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] == texts[1] and texts[0]
    r = await client.post("/v1/embeddings", json={"input": "abc"})
    assert r.status == 400
