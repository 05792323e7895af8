"""Generate tests/fixtures/portgguf/: the Q2_K, Q3_K_M, IQ2_XS, IQ3_XXS and
IQ1_M tiny fixtures of the PyTorch port's tests and the JAX package's
logits on them.

Every GGUF file is a re-quantization of tests/fixtures/refgguf/tiny-f16.gguf
by the in-repo quantizer (no importance matrix; byte-identical from run to
run), e.g.

    python tools/quantize.py tests/fixtures/refgguf/tiny-f16.gguf \
        tests/fixtures/portgguf/tiny-q2_k.gguf q2_k

(FILES lists the formats). The IQ files mix types as the quantizer's
recipes do: tiny-iq2_xs holds IQ2_XS and Q2_K tensors, tiny-iq3_xxs
IQ3_XXS, IQ3_S (token_embd too), IQ2_S and Q3_K, tiny-iq1_m IQ1_M, IQ2_XXS
and Q2_K; every output is Q5_K.

The logits are the JAX package's `forward` (packed weights, f32 cache and
activations, on the CPU) over the refgguf manifest's 12 tokens. They are
the JAX package's own numbers, not reference-runtime goldens.

Run from the repository root when the fixtures need regenerating:

    JAX_PLATFORMS=cpu python tests/make_torch_fixtures.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tests", "fixtures", "refgguf")
OUT = os.path.join(ROOT, "tests", "fixtures", "portgguf")
FILES = {"q2_k": "tiny-q2_k.gguf", "q3_k_m": "tiny-q3_k_m.gguf",
         "iq2_xs": "tiny-iq2_xs.gguf", "iq3_xxs": "tiny-iq3_xxs.gguf",
         "iq1_m": "tiny-iq1_m.gguf"}


def jax_logits(path: str, tokens: list[int]) -> np.ndarray:
    """The JAX forward's f32 logits (T, vocab) for tokens at positions 0.."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from koboldcpp_tpu.kv.cache import init_cache
    from koboldcpp_tpu.models import llama
    from koboldcpp_tpu.models.loader import load_model

    m = load_model(path, packed=True, dtype=jnp.float32)
    cache = init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                       m.cfg.head_dim, dtype=jnp.float32)
    toks = jnp.asarray([tokens], jnp.int32)
    pos = jnp.arange(len(tokens), dtype=jnp.int32)[None]
    fwd = jax.jit(lambda p, t, s, c: llama.forward(p, m.cfg, t, s, c))
    logits, _ = fwd(m.params, toks, pos, cache)
    return np.asarray(logits, np.float32)[0]


def main() -> int:
    os.makedirs(OUT, exist_ok=True)
    tokens = json.load(open(os.path.join(REF, "manifest.json")))["tokens"]
    src = os.path.join(REF, "tiny-f16.gguf")
    for fmt, name in FILES.items():
        path = os.path.join(OUT, name)
        subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "quantize.py"),
                        src, path, fmt], check=True)
        np.save(os.path.join(OUT, f"logits-jax-{fmt}.npy"),
                jax_logits(path, tokens))
    manifest = {
        "tokens": tokens,
        "files": FILES,
        "made_by": {fmt: f"python tools/quantize.py "
                         f"tests/fixtures/refgguf/tiny-f16.gguf "
                         f"tests/fixtures/portgguf/{name} {fmt}"
                    for fmt, name in FILES.items()},
        "logits": "logits-jax-<fmt>.npy: the JAX package's forward "
                  "(koboldcpp_tpu.models.llama.forward, packed weights, f32 "
                  "cache, CPU) on `tokens` at positions 0..11, shape (12, "
                  "vocab) f32; the JAX package's numbers, not "
                  "reference-runtime goldens",
        "generator": "tests/make_torch_fixtures.py",
    }
    with open(os.path.join(OUT, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
