"""The port's loader features and batched-engine switches held against the
JAX package on the CPU: the LoRA merge at load (tests/test_lora.py's cases
and the adapter's validation errors), the legacy GGML / GGJT containers of
tests/test_legacy_formats.py and the pre-GGUF gpt-j / gpt-neox / mpt /
gpt-2 files of tests/test_legacy_otherarch.py (the same files through both
`forward`s), KCPP_IQ_NATIVE=0, and the batched engine's pool_fraction,
use_contextshift, KCPP_BATCH_DEV_SAMPLE and burst variables."""
import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.engine import batch_engine as jbatch
from koboldcpp_tpu.gguf import legacy as jlegacy
from koboldcpp_tpu.gguf import sniff as jsniff
from koboldcpp_tpu.gguf.sniff import FileFormat, check_file_format
from koboldcpp_tpu.kv.cache import init_cache as j_init_cache
from koboldcpp_tpu.models import llama as jllama
from koboldcpp_tpu.models.loader import LoraAdapter as JLoraAdapter
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu_torch.engine import GenParams
from koboldcpp_tpu_torch.engine import batch_engine as tbatch
from koboldcpp_tpu_torch.engine import device_sampler as tds
from koboldcpp_tpu_torch.gguf import legacy as tlegacy
from koboldcpp_tpu_torch.gguf import sniff as tsniff
from koboldcpp_tpu_torch.gguf.writer import GGUFWriter
from koboldcpp_tpu_torch.kv.cache import init_cache
from koboldcpp_tpu_torch.models import llama as tllama
from koboldcpp_tpu_torch.models.loader import LoraAdapter, load_model
from koboldcpp_tpu_torch.sampling import SamplerParams

from . import test_legacy_otherarch as jot
from .test_legacy_formats import (q4_0_v1, q4_0_v2, tiny_llama,  # noqa: F401
                                  write_legacy)

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
from convert_hf import convert_llama_state_dict  # noqa: E402

from .test_model_forward import tiny_tokenizer_md  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tests", "fixtures", "refgguf")
PORT = os.path.join(ROOT, "tests", "fixtures", "portgguf")
TOKENS = [1, 5, 9, 42, 7, 300]
F32_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 on both sides
Q_TOL = dict(rtol=1e-2, atol=1e-2)    # bf16 matmul outputs on both sides


def _jax_logits(path, packed=False, **kw):
    dt = jnp.float32 if not packed else jnp.bfloat16
    m = j_load_model(path, packed=packed, dtype=dt, **kw)
    cache = j_init_cache(m.cfg.n_layers, 1, 32, m.cfg.n_kv_heads,
                         m.cfg.head_dim, dtype=jnp.float32)
    logits, _ = jllama.forward(
        m.params, m.cfg, jnp.asarray([TOKENS], jnp.int32),
        jnp.arange(len(TOKENS), dtype=jnp.int32)[None], cache)
    return m, np.asarray(logits, np.float32)[0]


def _port_logits(path, packed=False, **kw):
    dt = torch.float32 if not packed else torch.bfloat16
    m = load_model(path, packed=packed, dtype=dt, device="cpu", **kw)
    cache = init_cache(m.cfg.n_layers, 1, 32, m.cfg.n_kv_heads,
                       m.cfg.head_dim, dtype=torch.float32)
    with torch.inference_mode():
        logits, _ = tllama.forward(m.params, m.cfg, torch.tensor([TOKENS]),
                                   torch.arange(len(TOKENS))[None], cache)
    return m, logits[0].float().numpy()


# ---------------------------------------------------------------------------
# LoRA
# ---------------------------------------------------------------------------

ALPHA, RANK, MULT = 8.0, 4, 0.7


def _write_adapter(path, pairs, alpha=ALPHA, gtype="adapter", atype="lora",
                   extra=None):
    w = GGUFWriter(path, architecture="llama")
    w.add("general.type", gtype)
    w.add("adapter.type", atype)
    w.add("adapter.lora.alpha", np.float32(alpha))
    for base, (a, b) in pairs.items():
        if a is not None:
            w.add_tensor(base + ".lora_a", a)
        if b is not None:
            w.add_tensor(base + ".lora_b", b)
    for name, arr in (extra or {}).items():
        w.add_tensor(name, arr)
    w.write()
    return path


@pytest.fixture(scope="module")
def lora_files(tmp_path_factory):
    """tests/test_lora.py::test_lora_merge_matches_manual's base model and
    adapter pairs (ffn_gate: the fused gate/up group; ffn_down and output:
    plain), plus attn_q and attn_v (the fused q/k/v group)."""
    from transformers import LlamaConfig, LlamaForCausalLM

    d = tmp_path_factory.mktemp("lora")
    torch.manual_seed(11)
    cfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64,
                      tie_word_embeddings=False)
    model = LlamaForCausalLM(cfg).eval().float()
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    base = str(d / "base.gguf")
    convert_llama_state_dict(state, cfg, base,
                             tokenizer_md=tiny_tokenizer_md(512))
    rng = np.random.default_rng(3)
    pairs = {}
    for gname, out_dim, in_dim in (("blk.0.ffn_gate.weight", 128, 64),
                                   ("blk.1.ffn_down.weight", 64, 128),
                                   ("output.weight", 512, 64),
                                   ("blk.1.attn_q.weight", 64, 64),
                                   ("blk.0.attn_v.weight", 32, 64)):
        a = rng.standard_normal((RANK, in_dim)).astype(np.float32) * 0.05
        b = rng.standard_normal((out_dim, RANK)).astype(np.float32) * 0.05
        pairs[gname] = (a, b)
    adapter = _write_adapter(str(d / "adapter.gguf"), pairs)
    # rank 8 on attn_q / attn_v of every layer of the Q4_K_M fixture
    fix_pairs = {}
    for i in range(2):
        for name, out_dim in (("attn_q", 256), ("attn_v", 128)):
            a = rng.standard_normal((8, 256)).astype(np.float32) * 0.02
            b = rng.standard_normal((out_dim, 8)).astype(np.float32) * 0.02
            fix_pairs[f"blk.{i}.{name}.weight"] = (a, b)
    fix_adapter = _write_adapter(str(d / "fix_adapter.gguf"), fix_pairs,
                                 alpha=16.0)
    return base, adapter, fix_adapter


def test_lora_merge_matches_jax(lora_files):
    """Dense f32 on both sides: the merged logits equal the JAX merged
    model's within 1e-4, and differ from the base's (the merge applied)."""
    base, adapter, _ = lora_files
    _, want = _jax_logits(base, loras=[(adapter, MULT)])
    m, got = _port_logits(base, loras=[(adapter, MULT)])
    np.testing.assert_allclose(got, want, **F32_TOL)
    _, plain = _port_logits(base)
    assert np.abs(plain - got).max() > 1e-3
    for layer in m.params["layers"]:
        assert layer["wqkv"].kind == "dense"


def test_lora_on_a_quantized_file_matches_jax(lora_files):
    """The Q4_K_M fixture with a rank-8 adapter on attn_q / attn_v of every
    layer, packed: the adapted weights become dense bf16 merged weights (a
    same-type q/k/v group one row-concatenation of them), bit-equal to
    JAX's, every other weight stays packed for its kernel; logits within
    1e-2 of the JAX merged model's."""
    _, _, fix_adapter = lora_files
    path = os.path.join(REF, "tiny-q4_k_m.gguf")
    jm, want = _jax_logits(path, packed=True, loras=[(fix_adapter, 1.0)])
    m, got = _port_logits(path, packed=True, loras=[(fix_adapter, 1.0)])
    np.testing.assert_allclose(got, want, **Q_TOL)
    for layer, jlayer in zip(m.params["layers"], jm.params["layers"]):
        assert layer.keys() == jlayer.keys()
        adapted = ("wqkv",) if "wqkv" in layer else ("wq", "wv")
        for key in adapted:
            assert layer[key].kind == "dense" == jlayer[key].kind
            np.testing.assert_array_equal(
                layer[key].data["w"].float().numpy(),
                np.asarray(jlayer[key].data["w"], np.float32))
        for key in ("wo", "w_down") + (("wk",) if "wk" in layer else ()):
            assert layer[key].kind == jlayer[key].kind != "dense"


def _bad_adapters(d):
    a = np.zeros((2, 4), np.float32)
    b = np.zeros((4, 2), np.float32)
    return {
        "general_type": _write_adapter(str(d / "t.gguf"), {}, gtype="model"),
        "adapter_type": _write_adapter(str(d / "a.gguf"), {}, atype="ia3"),
        "suffix": _write_adapter(str(d / "s.gguf"), {},
                                 extra={"blk.0.attn_q.weight.lora_c": a}),
        "missing_b": _write_adapter(str(d / "m.gguf"),
                                    {"blk.0.attn_q.weight": (a, None)}),
        "missing_a": _write_adapter(str(d / "n.gguf"),
                                    {"blk.0.attn_q.weight": (None, b)}),
    }


@pytest.mark.parametrize("case", ["general_type", "adapter_type", "suffix",
                                  "missing_b", "missing_a"])
def test_lora_adapter_validation_matches_jax(case, tmp_path):
    path = _bad_adapters(tmp_path)[case]
    with pytest.raises(ValueError) as want:
        JLoraAdapter(path)
    with pytest.raises(ValueError) as got:
        LoraAdapter(path)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# legacy containers
# ---------------------------------------------------------------------------

LEGACY_LLAMA = {
    "ggjt3_f16": (3, None, FileFormat.GGJT_3),
    "ggjt2_q4_0": (2, q4_0_v2, FileFormat.GGJT_2),
    "ggjt1_q4_0_interleaved": (1, q4_0_v1, FileFormat.GGJT),
}


@pytest.mark.parametrize("case", sorted(LEGACY_LLAMA))
def test_legacy_llama_matches_jax(case, tmp_path, tiny_llama):  # noqa: F811
    """tests/test_legacy_formats.py's files: the port reads the same
    config and tokenizer, and its logits equal the JAX forward's on the same
    file (dense f32: 1e-4; packed: 1e-2)."""
    _, _, g = tiny_llama
    version, quant, fmt = LEGACY_LLAMA[case]
    path = str(tmp_path / f"{case}.bin")
    write_legacy(path, g, 512, 64, 32, 4, 2, 16, version=version,
                 quant=quant)
    assert check_file_format(path) is fmt
    jm, want = _jax_logits(path)
    m, got = _port_logits(path)
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(jm.cfg)
    assert m.cfg.arch == "llama"
    assert m.tokenizer.encode("tok5 tok7") == jm.tokenizer.encode("tok5 tok7")
    np.testing.assert_allclose(got, want, **F32_TOL)
    _, want = _jax_logits(path, packed=True)
    _, got = _port_logits(path, packed=True)
    np.testing.assert_allclose(got, want, **Q_TOL)


def _otherarch_file(arch, d):
    """The files tests/test_legacy_otherarch.py writes, from the same
    transformers models and seeds."""
    import transformers as tf

    def st(cls, cfg, seed):
        torch.manual_seed(seed)
        return {k: v.numpy() for k, v in cls(cfg).eval().float()
                .state_dict().items()}

    path = str(d / f"{arch}.bin")
    if arch == "gptj":
        cfg = tf.GPTJConfig(vocab_size=50400, n_embd=64, n_layer=2, n_head=4,
                            rotary_dim=16, n_positions=128, n_inner=None,
                            tie_word_embeddings=False)
        s = st(tf.GPTJForCausalLM, cfg, 61)
        keys = ("ln_1.weight", "ln_1.bias", "attn.q_proj.weight",
                "attn.k_proj.weight", "attn.v_proj.weight",
                "attn.out_proj.weight", "mlp.fc_in.weight", "mlp.fc_in.bias",
                "mlp.fc_out.weight", "mlp.fc_out.bias")
        tensors = {k: s[k] for k in (
            "transformer.wte.weight", "transformer.ln_f.weight",
            "transformer.ln_f.bias", "lm_head.weight", "lm_head.bias")}
        for i in range(2):
            tensors |= {f"transformer.h.{i}.{k}": s[f"transformer.h.{i}.{k}"]
                        for k in keys}
        jot.write_otherarch(path, "gptj", (50400, 128, 64, 4, 2, 16, 2001),
                            tensors, 50400)
    elif arch == "gptneox":
        cfg = tf.GPTNeoXConfig(vocab_size=512, hidden_size=64,
                               num_hidden_layers=2, num_attention_heads=4,
                               intermediate_size=256, rotary_pct=1.0,
                               max_position_embeddings=128,
                               use_parallel_residual=True,
                               tie_word_embeddings=False)
        s = st(tf.GPTNeoXForCausalLM, cfg, 62)
        tensors = {k: s[k] for k in (
            "gpt_neox.embed_in.weight", "gpt_neox.final_layer_norm.weight",
            "gpt_neox.final_layer_norm.bias", "embed_out.weight")}
        for i in range(2):
            hp = f"gpt_neox.layers.{i}."
            tensors |= {hp + k: s[hp + k] for k in (
                "input_layernorm.weight", "input_layernorm.bias",
                "post_attention_layernorm.weight",
                "post_attention_layernorm.bias",
                "attention.query_key_value.weight",
                "attention.query_key_value.bias",
                "attention.dense.weight", "attention.dense.bias",
                "mlp.dense_h_to_4h.weight", "mlp.dense_h_to_4h.bias",
                "mlp.dense_4h_to_h.weight", "mlp.dense_4h_to_h.bias")}
        jot.write_otherarch(path, "gptneox", (512, 128, 64, 4, 2, 16, 1, 2001),
                            tensors, 512)
    elif arch == "mpt":
        cfg = tf.MptConfig(d_model=64, n_heads=4, n_layers=2, vocab_size=512,
                           max_seq_len=128)
        cfg.attn_config.clip_qkv = 6.0
        s = st(tf.MptForCausalLM, cfg, 64)
        tensors = {k: v for k, v in s.items() if k != "lm_head.weight"}
        jot.write_otherarch(path, "mpt", (64, 128, 4, 2, 512, 8.0, 6.0, 2001),
                            tensors, 512, vocab_count=False)
    else:  # gpt2
        cfg = tf.GPT2Config(vocab_size=50257, n_embd=64, n_layer=2, n_head=4,
                            n_positions=128, tie_word_embeddings=False)
        s = st(tf.GPT2LMHeadModel, cfg, 63)
        tensors = {"model/wte": s["transformer.wte.weight"],
                   "model/wpe": s["transformer.wpe.weight"],
                   "model/ln_f/g": s["transformer.ln_f.weight"],
                   "model/ln_f/b": s["transformer.ln_f.bias"],
                   "model/lm_head": s["lm_head.weight"]}
        for i in range(2):
            hp = f"transformer.h.{i}."
            lp = f"model/h{i}/"
            tensors |= {
                lp + "ln_1/g": s[hp + "ln_1.weight"],
                lp + "ln_1/b": s[hp + "ln_1.bias"],
                lp + "ln_2/g": s[hp + "ln_2.weight"],
                lp + "ln_2/b": s[hp + "ln_2.bias"],
                # HF Conv1D stores (in, out); the ggml file keeps (out, in)
                lp + "attn/c_attn/w": s[hp + "attn.c_attn.weight"].T,
                lp + "attn/c_attn/b": s[hp + "attn.c_attn.bias"],
                lp + "attn/c_proj/w": s[hp + "attn.c_proj.weight"].T,
                lp + "attn/c_proj/b": s[hp + "attn.c_proj.bias"],
                lp + "mlp/c_fc/w": s[hp + "mlp.c_fc.weight"].T,
                lp + "mlp/c_fc/b": s[hp + "mlp.c_fc.bias"],
                lp + "mlp/c_proj/w": s[hp + "mlp.c_proj.weight"].T,
                lp + "mlp/c_proj/b": s[hp + "mlp.c_proj.bias"],
            }
        jot.write_otherarch(path, "gpt2", (50257, 128, 64, 4, 2, 2001),
                            tensors, 50257)
    return path


@pytest.mark.parametrize("arch", ["gptj", "gptneox", "mpt", "gpt2"])
def test_legacy_otherarch_matches_jax(arch, tmp_path, monkeypatch):
    path = _otherarch_file(arch, tmp_path)
    if arch == "mpt":
        # sniffing keys off d_model in {4096, 7168}: a tiny file is named
        for mod in (jsniff, jlegacy):
            monkeypatch.setattr(mod, "check_file_format",
                                lambda p: FileFormat.MPT_1)
        for mod in (tsniff, tlegacy):
            monkeypatch.setattr(mod, "check_file_format",
                                lambda p: tsniff.FileFormat.MPT_1)
    jm, want = _jax_logits(path)
    m, got = _port_logits(path)
    assert dataclasses.asdict(m.cfg) == dataclasses.asdict(jm.cfg)
    assert m.cfg.arch == arch
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_legacy_rwkv_is_refused_by_name(monkeypatch, tmp_path):
    """A legacy RWKV file goes to its reader and, by its architecture's
    name, to models/rwkv4.py's loader (refused by name until the recurrent
    models were ported; tests/test_torch_recurrent.py serves such files)."""
    path = str(tmp_path / "rwkv.bin")
    with open(path, "wb") as f:
        f.write(b"\0" * 64)
    for mod in (tsniff, tlegacy):
        monkeypatch.setattr(mod, "check_file_format",
                            lambda p: tsniff.FileFormat.RWKV_1)

    class Reader:
        def __init__(self, p):
            self.metadata = {"general.architecture": "rwkv4",
                             "rwkv4.block_count": 2,
                             "rwkv4.embedding_length": 64,
                             "rwkv4.context_length": 128,
                             "tokenizer.ggml.model": "gpt2",
                             "tokenizer.ggml.tokens": ["a", "b"],
                             "tokenizer.ggml.token_type": [1, 1]}

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(tlegacy, "LegacyRwkvReader", Reader)
    from koboldcpp_tpu_torch.models import rwkv4

    seen = []
    monkeypatch.setattr(rwkv4, "load_params",
                        lambda r, cfg, **kw: seen.append(type(r)) or {})
    m = load_model(path, device="cpu")
    assert seen == [Reader] and m.cfg.arch == "rwkv4" and m.params == {}


# ---------------------------------------------------------------------------
# KCPP_IQ_NATIVE=0
# ---------------------------------------------------------------------------

def test_iq_native_off_reexpands_to_q8_0_as_jax(monkeypatch):
    """Under KCPP_IQ_NATIVE=0 the IQ2_XS fixture's IQ tensors load as q8_0
    in both packages, with the same int8 codes and bf16 scales; the logits
    agree within 1e-2."""
    monkeypatch.setenv("KCPP_IQ_NATIVE", "0")
    path = os.path.join(PORT, "tiny-iq2_xs.gguf")
    jm, want = _jax_logits(path, packed=True)
    m, got = _port_logits(path, packed=True)
    np.testing.assert_allclose(got, want, **Q_TOL)
    n_iq = 0
    for layer, jlayer in zip(m.params["layers"], jm.params["layers"]):
        for key, qt in layer.items():
            if getattr(qt, "kind", None) != "q8_0":
                continue
            n_iq += 1
            jq = jlayer[key]
            assert jq.kind == "q8_0"
            np.testing.assert_array_equal(qt.data["q"].numpy(),
                                          np.asarray(jq.data["q"]))
            np.testing.assert_array_equal(
                qt.data["scale"].float().numpy(),
                np.asarray(jq.data["scale"], np.float32))
    assert n_iq >= 2
    monkeypatch.delenv("KCPP_IQ_NATIVE")
    native, _ = _port_logits(path, packed=True)
    assert {qt.kind for layer in native.params["layers"]
            for qt in layer.values() if hasattr(qt, "kind")} & \
        {"iq2p", "iq3px", "iq3ps", "iq1p"}


# ---------------------------------------------------------------------------
# the batched engine's switches
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fix_models():
    path = os.path.join(REF, "tiny-q4_k_m.gguf")
    return load_model(path, device="cpu"), j_load_model(path)


BATCH_CASES = {
    "paged_half": dict(paged=True, pool_fraction=0.5),
    "paged_tenth": dict(paged=True, pool_fraction=0.1),
    "paged_full_q8": dict(paged=True, pool_fraction=1.0, quantkv=1),
    "slot_shift": dict(),
    "slot_no_shift": dict(use_contextshift=False),
    "slot_q8": dict(quantkv=1),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_batched_pool_and_shift_match_jax(case, fix_models):
    kw = BATCH_CASES[case]
    m, jm = fix_models
    je = jbatch.BatchedEngine(jm, max_context=256, n_slots=4, page_size=64,
                              **kw)
    te = tbatch.BatchedEngine(m, max_context=256, n_slots=4, page_size=64,
                              device="cpu", **kw)
    try:
        assert te.use_contextshift == je.use_contextshift
        if kw.get("paged"):
            assert te.allocator.n_pages == je.allocator.n_pages
            assert te.cache.n_pages == te.allocator.n_pages
    finally:
        te.shutdown()
        je.shutdown()


@pytest.mark.parametrize("dev_sample", ["1", "0"])
def test_batch_dev_sample_switch(dev_sample, fix_models, monkeypatch):
    """KCPP_BATCH_DEV_SAMPLE=0 samples every slot on the host: no batched
    device draw; the default takes one for a stochastic request."""
    monkeypatch.setenv("KCPP_BATCH_DEV_SAMPLE", dev_sample)
    calls = []
    real = tds.sample_step_batched

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tds, "sample_step_batched", counted)
    te = tbatch.BatchedEngine(fix_models[0], max_context=256, n_slots=2,
                              device="cpu")
    try:
        r = te.generate("Once upon a time", GenParams(
            max_length=12, bypass_eos=True,
            sampler=SamplerParams(seed=4, temperature=0.9, top_p=0.9)))
        assert len(r.tokens) == 12
    finally:
        te.shutdown()
    assert bool(calls) == (dev_sample == "1")


def test_burst_variables_from_the_environment():
    code = ("from koboldcpp_tpu_torch.engine import batch_engine as b; "
            "print(b.BURST_TICKS, b.BURST_DEPTH)")
    env = dict(os.environ, KCPP_BURST_TICKS="4", KCPP_BURST_DEPTH="2",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.split() == ["4", "2"], out.stderr[-2000:]
