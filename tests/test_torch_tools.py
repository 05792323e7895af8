"""The port's perplexity and imatrix tools (koboldcpp_tpu_torch/tools/)
against the JAX package's (tools/perplexity.py, tools/imatrix.py) on the
refgguf tiny Q4_K_M fixture, on the CPU.

Perplexity: four 64-token windows, within 1e-4 relative (the JAX tool
jits its forward once: a compile of a few seconds, cheaper here than its
forward run op by op). imatrix: the per-column mean
squares of every linear weight's input over the unpacked f32 model within
1e-4 relative, the fused members' names fanned out as in JAX, and the
llama.cpp binary file read back."""
import os
import struct
import sys

import numpy as np
import pytest
import torch

from koboldcpp_tpu_torch.tools import imatrix as timatrix
from koboldcpp_tpu_torch.tools import perplexity as tppl

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

# one intra-op thread: the suite runs a worker process per core
torch.set_num_threads(1)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")
TEXT = " ".join(f"word{i % 37} part{(i * 7) % 53} of the story"
                for i in range(120))
N_CTX = 64


def test_perplexity_matches_jax(tmp_path, capsys):
    """The same windows (BOS first), the same second-half NLL: the port's
    perplexity (and its entry point, --device cpu) equals the JAX tool's
    on the fixture."""
    from perplexity import perplexity as jperplexity

    from koboldcpp_tpu.models.loader import load_model as jload
    from koboldcpp_tpu_torch.models.loader import load_model as tload

    jm, tm = jload(FIX), tload(FIX, device="cpu")
    n_tok = len(tm.tokenizer.encode(TEXT))
    assert n_tok == len(jm.tokenizer.encode(TEXT)) and n_tok >= 4 * N_CTX
    want = jperplexity(jm, TEXT, n_ctx=N_CTX, verbose=False)
    got = tppl.perplexity(tm, TEXT, n_ctx=N_CTX, verbose=True)
    assert 1.0 < got and abs(got - want) <= 1e-4 * want, (got, want)
    assert f"[{n_tok // N_CTX}/{n_tok // N_CTX}]" in capsys.readouterr().out
    # token ids in place of the text: the same windows
    assert tppl.perplexity(tm, tm.tokenizer.encode(TEXT), n_ctx=N_CTX,
                           verbose=False) == got
    path = tmp_path / "t.txt"
    path.write_text(TEXT)
    assert tppl.main([FIX, "--file", str(path), "--ctx", str(N_CTX),
                      "--device", "cpu"]) == got
    with pytest.raises(ValueError, match="need at least"):
        tppl.perplexity(tm, "short", n_ctx=N_CTX)


def test_imatrix_matches_jax(tmp_path):
    """collect() over two windows: the same tensor names (attn_k / attn_v
    and ffn_up fanned out from the fused wqkv / w_gateup) and mean squares
    within 1e-4 of the JAX tool's collect(cpu=True); the entry point
    writes the .npz and llama.cpp's binary imatrix, read back here."""
    from imatrix import collect as jcollect

    want = jcollect(FIX, TEXT, chunk=N_CTX, max_chunks=2, cpu=True)
    got = timatrix.collect(FIX, TEXT, chunk=N_CTX, max_chunks=2,
                           device="cpu")
    assert set(got) == set(want) and "blk.0.attn_v.weight" in got
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                   atol=1e-4 * np.abs(v).max())
    calib = tmp_path / "calib.txt"
    calib.write_text(TEXT)
    out, binf = tmp_path / "m.imatrix.npz", tmp_path / "m.imatrix"
    w = timatrix.main([FIX, str(calib), "-o", str(out), "--chunk",
                       str(N_CTX), "--chunks", "2", "--bin", str(binf),
                       "--device", "cpu"])
    z = np.load(out)
    assert set(z.files) == set(got)
    raw = binf.read_bytes()
    (n,), off = struct.unpack_from("<i", raw), 4
    back = {}
    for _ in range(n):
        (ln,) = struct.unpack_from("<i", raw, off)
        name = raw[off + 4:off + 4 + ln].decode()
        off += 4 + ln
        ncall, nval = struct.unpack_from("<ii", raw, off)
        off += 8
        back[name] = np.frombuffer(raw, np.float32, nval, off)
        off += 4 * nval
        assert ncall == 0
    assert struct.unpack_from("<ii", raw, off)[0] == 1
    assert set(back) == set(w)
    for k in w:
        np.testing.assert_array_equal(back[k], np.asarray(w[k], np.float32))
        np.testing.assert_array_equal(z[k], w[k])


def test_name_map_and_expansion():
    """build_name_map names each packed weight by its GGUF tensor (a fused
    weight by its first member); expand_names copies the shared input
    statistics to the fused members without overwriting."""
    class Q:
        data = {}

    a, b, c = Q(), Q(), Q()
    m = timatrix.build_name_map({"output": a, "layers": [
        {"wqkv": b, "w_gateup": c, "attn_norm": np.ones(2)}]})
    assert m == {id(a): "output.weight", id(b): "blk.0.attn_q.weight",
                 id(c): "blk.0.ffn_gate.weight"}
    one, two = np.ones(2), np.full(2, 2.0)
    out = timatrix.expand_names({"blk.0.attn_q.weight": one,
                                 "blk.0.attn_v.weight": two,
                                 "blk.0.ffn_gate.weight": one})
    assert out["blk.0.attn_k.weight"] is one
    assert out["blk.0.attn_v.weight"] is two
    assert out["blk.0.ffn_up.weight"] is one
