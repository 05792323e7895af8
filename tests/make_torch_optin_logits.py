"""Generate the JAX package's logits of the tiny fixtures under the opt-in
layout and dispatch variables, for the PyTorch port's tests and
chip_smoke.py: tests/fixtures/portgguf/optin.json and the
logits-jax-optin-<run>.npy files it names.

Each run loads one fixture under one variable (RUNS) and evaluates the
refgguf manifest's 12 tokens as a prefill of the first 11 (positions
0..10, T=11: the 2-D kernel) and then one decode step of the 12th
(position 11, T=1: the expanded K12 bodies under KCPP_KQ_LAYOUT=expanded,
the bf16 q8_0 body under KCPP_MM_I8=0; q4_k_i8 takes the 2-D kernel at
both), packed weights, f32 cache and activations, on the CPU. The file
holds the 12 rows, (12, vocab) f32. The JAX dispatch reads KCPP_MM_I8 when
it traces, so every run traces a fresh `jax.jit` with its variable set.
These are the JAX package's numbers, not reference-runtime goldens.

Run from the repository root when they need regenerating:

    JAX_PLATFORMS=cpu python tests/make_torch_optin_logits.py
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")
OUT = os.path.join(FIXTURES, "portgguf")
# run -> (fixture under tests/fixtures, the variables set for it)
RUNS = {
    "q6_k-expanded": ("refgguf/tiny-q6_k.gguf",
                      {"KCPP_KQ_LAYOUT": "expanded"}),
    "q3_k_m-expanded": ("portgguf/tiny-q3_k_m.gguf",
                        {"KCPP_KQ_LAYOUT": "expanded"}),
    "q2_k-expanded": ("portgguf/tiny-q2_k.gguf",
                      {"KCPP_KQ_LAYOUT": "expanded"}),
    "q4_k_m-q4k_i8": ("refgguf/tiny-q4_k_m.gguf",
                      {"KCPP_Q4K_LAYOUT": "i8"}),
    "q8_0-mm_bf16": ("refgguf/tiny-q8_0.gguf", {"KCPP_MM_I8": "0"}),
}


def jax_logits(path: str, tokens: list[int], env: dict) -> np.ndarray:
    """The JAX forward's f32 logits (T, vocab): a prefill of tokens[:-1],
    then tokens[-1] as one decode step, with env set."""
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp

    from koboldcpp_tpu.kv.cache import init_cache
    from koboldcpp_tpu.models import llama
    from koboldcpp_tpu.models.loader import load_model

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        m = load_model(path, packed=True, dtype=jnp.float32)
        cache = init_cache(m.cfg.n_layers, 1, 64, m.cfg.n_kv_heads,
                           m.cfg.head_dim, dtype=jnp.float32)
        fwd = jax.jit(lambda p, t, s, c: llama.forward(p, m.cfg, t, s, c))
        n = len(tokens) - 1
        pre, cache = fwd(m.params, jnp.asarray([tokens[:n]], jnp.int32),
                         jnp.arange(n, dtype=jnp.int32)[None], cache)
        last, _ = fwd(m.params, jnp.asarray([tokens[n:]], jnp.int32),
                      jnp.asarray([[n]], jnp.int32), cache)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return np.concatenate([np.asarray(pre, np.float32)[0],
                           np.asarray(last, np.float32)[0]])


def main() -> int:
    tokens = json.load(open(os.path.join(FIXTURES, "refgguf",
                                         "manifest.json")))["tokens"]
    runs = {}
    for name, (fixture, env) in RUNS.items():
        logits = f"logits-jax-optin-{name}.npy"
        np.save(os.path.join(OUT, logits),
                jax_logits(os.path.join(FIXTURES, fixture), tokens, env))
        runs[name] = {"fixture": fixture, "env": env, "logits": logits}
    manifest = {
        "tokens": tokens,
        "runs": runs,
        "logits": "the JAX package's forward (packed weights, f32 cache, "
                  "CPU) under `env`: a prefill of tokens[:-1] at positions "
                  "0..10, then tokens[-1] as one decode step at position "
                  "11; shape (12, vocab) f32",
        "generator": "tests/make_torch_optin_logits.py",
    }
    with open(os.path.join(OUT, "optin.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
