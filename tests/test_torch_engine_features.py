"""The port's single-stream engine features held against the JAX engine
on the committed Q4_K_M fixture (CPU, plain kernel versions, bf16 caches
on both sides): legacy smart context over the scripted session of
tests/test_engine.py::test_smart_context, save_state / load_state (a port
round trip, a state file the JAX engine wrote, the quantized cache), and
the launcher's RoPE decision against the JAX `main`'s."""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu import cli as jcli
from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu_torch import cli
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams

from .test_torch_batch_engine import NEAR_TIE

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(ROOT, "tests", "fixtures", "refgguf", "tiny-q4_k_m.gguf")


@pytest.fixture(scope="module")
def model():
    return load_model(FIX, device="cpu")


@pytest.fixture(scope="module")
def jmodel():
    return j_load_model(FIX)


def assert_same_tokens(model, ctx, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits there (on the port, after the token list `ctx`)
    within NEAR_TIE of each other."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)
    with torch.inference_mode():
        lg = Engine(model, max_context=256, device="cpu").eval_tokens(
            list(ctx) + got[:i], 0)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


def greedy(n=4):
    return GenParams(max_length=n, bypass_eos=True,
                     sampler=SamplerParams(temperature=0.0, rep_pen=1.0))


def jgreedy(n=4):
    return JGenParams(max_length=n, bypass_eos=True,
                      sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))


def _record_smart(eng, log):
    real = eng._smart_context

    def wrapped(prompt):
        out = real(prompt)
        log.append((list(out), list(eng.smartcontext)))
        return out
    eng._smart_context = wrapped


def test_smart_context_session_matches_jax():
    """The scripted session: a full context, a diverging long prompt that
    triggers the halving, then a continuation that reuses the kept half.
    Each turn: the same composed prompt and buffer, the same evaluated
    prompt tokens, context tokens and greedy tokens. Dense f32 weights on
    both sides (the JAX test's f32 model), bf16 caches."""
    e = Engine(load_model(FIX, device="cpu", packed=False,
                          dtype=torch.float32),
               max_context=128, device="cpu", use_smartcontext=True)
    je = JEngine(j_load_model(FIX, packed=False, dtype=jnp.float32),
                 max_context=128, cache_dtype=jnp.bfloat16,
                 use_smartcontext=True)
    assert not e.use_contextshift and not je.use_contextshift
    log, jlog = [], []
    _record_smart(e, log)
    _record_smart(je, jlog)
    base = [1, 5] + [(7 * i) % 500 + 2 for i in range(110)]
    b = [1, 5] + [(11 * i) % 500 + 2 for i in range(110)]
    turns = [base, b]
    for turn in range(3):
        prompt = turns[turn]
        r = e.generate(prompt, greedy())
        jr = je.generate(prompt, jgreedy())
        assert log[-1] == jlog[-1], turn
        assert r.timings.prompt_tokens == jr.timings.prompt_tokens, turn
        assert r.tokens == jr.tokens, turn
        assert e.context_tokens == je.context_tokens, turn
        if turn == 1:
            turns.append(b + r.tokens + [(13 * i) % 500 + 2
                                         for i in range(6)])
    # the JAX test's own claims, on the port
    assert not log[0][1] and log[1][1] and log[2][1]
    assert len(log[2][0]) < len(turns[2])


def test_smart_context_turns_shift_off_and_quantkv_keeps_it_off(model):
    assert not Engine(model, max_context=64, device="cpu",
                      use_smartcontext=True).use_contextshift
    assert not Engine(model, max_context=64, device="cpu",
                      use_contextshift=False).use_contextshift
    assert not Engine(model, max_context=64, device="cpu",
                      quantkv=1).use_contextshift
    assert Engine(model, max_context=64, device="cpu").use_contextshift


PROMPT = [1, 5, 9, 20, 33, 140]


def test_state_round_trip_gives_the_jax_continuation(model, jmodel,
                                                     tmp_path):
    je = JEngine(jmodel, max_context=128, cache_dtype=jnp.bfloat16)
    jr1 = je.generate(PROMPT, jgreedy())
    want = je.generate(PROMPT + jr1.tokens, jgreedy(6)).tokens

    e = Engine(model, max_context=128, device="cpu")
    r1 = e.generate(PROMPT, greedy())
    assert r1.tokens == jr1.tokens
    path = str(tmp_path / "state.npz")
    e.save_state(path)
    saved = list(e.context_tokens)
    data = np.load(path)
    assert sorted(data.files) == ["context_tokens", "k", "max_context", "v"]
    L, KD = model.cfg.n_layers, model.cfg.n_kv_heads * model.cfg.head_dim
    assert data["k"].shape == (L, 1, 128, model.cfg.n_kv_heads,
                               model.cfg.head_dim)
    assert data["k"].dtype.str == "|V2" and data["context_tokens"].dtype == \
        np.int64 and int(data["max_context"]) == 128
    k_before = [t.clone() for t in e.cache.k]
    e.reset_context()
    e.generate([1, 7, 7, 7], greedy(2))  # clobber the live state
    e.load_state(path)
    assert e.context_tokens == saved
    for a, b in zip(e.cache.k, k_before):
        assert torch.equal(a, b) and a.shape == (1, 128, KD)
    r2 = e.generate(PROMPT + r1.tokens, greedy(6))
    assert r2.timings.prompt_tokens <= 1  # the restored cache fast-forwards
    assert_same_tokens(model, PROMPT + r1.tokens, r2.tokens, want)


def test_port_loads_a_jax_written_state(model, jmodel, tmp_path):
    """A bf16 state the JAX engine saved ('<V2' bytes) restores into the
    port's cache bit for bit and continues as the JAX engine does; the JAX
    engine itself cannot read its own bf16 file back (a fault of the
    reference: jnp.asarray has no cast from the void dtype)."""
    je = JEngine(jmodel, max_context=128, cache_dtype=jnp.bfloat16)
    jr1 = je.generate(PROMPT, jgreedy())
    path = str(tmp_path / "jax_state.npz")
    je.save_state(path)
    want = je.generate(PROMPT + jr1.tokens, jgreedy(6)).tokens
    with pytest.raises(ValueError, match="No cast function"):
        je.load_state(path)

    e = Engine(model, max_context=128, device="cpu")
    e.load_state(path)
    assert e.context_tokens == PROMPT + jr1.tokens
    k = np.load(path)["k"].view(np.uint16)
    for i, t in enumerate(e.cache.k):
        np.testing.assert_array_equal(
            t.view(torch.int16).numpy().view(np.uint16),
            k[i].reshape(t.shape))
    r = e.generate(PROMPT + jr1.tokens, greedy(6))
    assert r.timings.prompt_tokens <= 1
    assert_same_tokens(model, PROMPT + jr1.tokens, r.tokens, want)


def test_port_loads_a_jax_f32_state(model, jmodel, tmp_path):
    """A float cache's state (the JAX tests' f32 engine) is cast to the
    port's bf16 cache, as the JAX load casts it to its cache dtype."""
    je = JEngine(jmodel, max_context=64, cache_dtype=jnp.float32)
    je.generate(PROMPT, jgreedy())
    path = str(tmp_path / "f32_state.npz")
    je.save_state(path)
    e = Engine(model, max_context=64, device="cpu")
    e.load_state(path)
    k = np.load(path)["k"]
    assert k.dtype == np.float32
    for i, t in enumerate(e.cache.k):
        assert torch.equal(t, torch.from_numpy(k[i]).reshape(t.shape).to(
            torch.bfloat16))


def test_state_of_another_context_size_is_refused(model, tmp_path):
    e = Engine(model, max_context=64, device="cpu")
    e.generate(PROMPT, greedy(2))
    path = str(tmp_path / "s.npz")
    e.save_state(path)
    with pytest.raises(ValueError, match="different context size"):
        Engine(model, max_context=128, device="cpu").load_state(path)


def test_quantized_cache_state_is_refused(model, jmodel, tmp_path):
    """The JAX engine's save_state over a --quantkv cache writes the int8
    codes alone (stack_cache drops the scales) and its load_state brings
    them back as a bf16 cache of code values: pinned here as a fault of
    the reference. The port refuses both with a ValueError naming it."""
    je = JEngine(jmodel, max_context=64, cache_dtype=jnp.bfloat16, quantkv=1)
    je.generate(PROMPT, jgreedy(2))
    path = str(tmp_path / "q8.npz")
    je.save_state(path)
    data = np.load(path)
    assert sorted(data.files) == ["context_tokens", "k", "max_context", "v"]
    assert data["k"].dtype == np.int8  # codes, no scales
    je.load_state(path)
    assert type(je.cache).__name__ == "KVCache"  # no longer quantized
    assert float(jnp.abs(je.cache.k[0].astype(jnp.float32)).max()) > 1.0

    e = Engine(model, max_context=64, device="cpu", quantkv=1)
    e.generate(PROMPT, greedy(2))
    with pytest.raises(ValueError, match="scales"):
        e.save_state(str(tmp_path / "port_q8.npz"))
    with pytest.raises(ValueError, match="scales"):
        e.load_state(path)


# ---------------------------------------------------------------------------
# the launcher's RoPE decision (cli.py:336-357 of the JAX package)
# ---------------------------------------------------------------------------

class _Stop(Exception):
    pass


def _jax_main_cfg(argv, monkeypatch, name=None):
    """Drive the JAX `main` up to its engine, which a stand-in replaces;
    returns the config it would serve."""
    import koboldcpp_tpu.engine as jeng_pkg
    import koboldcpp_tpu.models.loader as jloader
    import koboldcpp_tpu.utils.compile_cache as jcc

    seen = {}

    class Stub:
        def __init__(self, model, **kw):
            seen["cfg"] = model.cfg
            raise _Stop

    real = jloader.load_model

    def load(path, **kw):
        m = real(path, **kw)
        if name is not None:
            m.cfg.name = name
        return m

    monkeypatch.setattr(jeng_pkg, "Engine", Stub)
    monkeypatch.setattr(jloader, "load_model", load)
    monkeypatch.setattr(jcc, "enable_compile_cache", lambda: None)
    with pytest.raises(_Stop):
        jcli.main(argv)
    return seen["cfg"]


def _port_main_cfg(argv, monkeypatch, name=None):
    import koboldcpp_tpu_torch.engine as teng_pkg
    import koboldcpp_tpu_torch.models.loader as tloader

    seen = {}

    class Stub:
        def __init__(self, model, **kw):
            seen["cfg"] = model.cfg
            raise _Stop

    real = tloader.load_model

    def load(path, **kw):
        m = real(path, **kw)
        if name is not None:
            m.cfg.name = name
        return m

    monkeypatch.setattr(teng_pkg, "Engine", Stub)
    monkeypatch.setattr(tloader, "load_model", load)
    with pytest.raises(_Stop):
        cli.main(argv + ["--device", "cpu"])
    return seen["cfg"]


ROPE = ("rope_theta", "rope_scaling_type", "rope_scaling_factor")
ROPE_CASES = {
    "auto_ntk_4096": (["--contextsize", "4096"], None),
    "auto_ntk_16384": (["--contextsize", "16384"], None),
    "auto_ntk_solar": (["--contextsize", "4096"], "SOLAR-10.7B-Instruct"),
    "within_trained": (["--contextsize", "1024"], None),
    "override_linear": (["--ropeconfig", "0.5", "20000"], None),
    "override_base_only": (["--ropeconfig", "1.0", "50000",
                            "--contextsize", "8192"], None),
}


@pytest.mark.parametrize("case", sorted(ROPE_CASES))
def test_launcher_rope_matches_jax_main(case, monkeypatch):
    """The RoPE the port's launcher serves equals the JAX launcher's for the
    same file and flags; where the JAX launcher changes it, the parent
    port's launcher (which left the loaded config as it was) served other
    rope frequencies."""
    argv, name = ROPE_CASES[case]
    want = _jax_main_cfg([FIX] + argv, monkeypatch, name)
    got = _port_main_cfg([FIX] + argv, monkeypatch, name)
    assert {k: getattr(got, k) for k in ROPE} == \
        {k: getattr(want, k) for k in ROPE}
    loaded = load_model(FIX, device="cpu").cfg
    changed = any(getattr(want, k) != getattr(loaded, k) for k in ROPE)
    assert changed == (case != "within_trained")


def test_apply_rope_config_on_a_loaded_config(model):
    cfg = dataclasses.replace(model.cfg)
    assert cli.apply_rope_config(cfg, None, cfg.max_position_embeddings) \
        is None
    line = cli.apply_rope_config(cfg, None, 4 * cfg.max_position_embeddings)
    assert line.startswith("Auto RoPE") and cfg.rope_theta > \
        model.cfg.rope_theta
    cfg = dataclasses.replace(model.cfg, rope_scaling_type="yarn")
    assert cli.apply_rope_config(cfg, None, 8192) is None  # ships its own
    assert cfg.rope_theta == model.cfg.rope_theta


def _smart_turns(engine_cls, prompts_fn) -> list[int]:
    """The prompt tokens each turn evaluates under `engine_cls`'s smart
    context rule at context 2048, on token lists alone: a stand-in engine
    whose generate appends 4 generated tokens after the composed prompt."""
    import types

    e = types.SimpleNamespace(max_context=2048, smartcontext=[],
                              context_tokens=[], encdec=False,
                              recurrent=False)
    e._fast_forward = lambda p: engine_cls._fast_forward(e, p)
    rng = np.random.default_rng(0)
    seen, reply = [], []
    for turn in range(3):
        prompt = prompts_fn(turn, reply)
        composed = engine_cls._smart_context(e, prompt)
        n_past = e._fast_forward(composed)
        seen.append(len(composed) - n_past)
        reply = rng.integers(3, 32000, size=4).tolist()
        e.context_tokens = composed + reply
    return seen


def test_smart_context_chip_script():
    """chip_smoke.py's smart-context session (SMART_TURNS there): a
    1700-token prompt, a diverging one (the halving keeps 849 tokens), then
    that prompt with its reply and 300 new tokens (the kept half reused).
    The JAX rule evaluates 1700, 849 and 300 prompt tokens, and so does
    the port's."""
    rng = np.random.default_rng(3)
    a = [1] + rng.integers(3, 32000, size=1699).tolist()
    b = a[:2] + rng.integers(3, 32000, size=1698).tolist()
    new = rng.integers(3, 32000, size=300).tolist()

    def prompts(turn, reply):
        return (a, b, b + reply + new)[turn]

    assert _smart_turns(JEngine, prompts) == [1700, 849, 300]
    assert _smart_turns(Engine, prompts) == [1700, 849, 300]
