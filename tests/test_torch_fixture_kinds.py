"""The port serving the reference fixtures whose weights pack as q5_k
(tiny-q5_1) and q8_0 (tiny-q8_0) on the CPU (plain kernel versions): the
same temperature-0 text over HTTP as the JAX server, and the same greedy
tokens from the multiuser batched engine as the JAX BatchedEngine."""
import os
import threading

import jax.numpy as jnp
import pytest
import torch

from koboldcpp_tpu.engine import Engine as JEngine
from koboldcpp_tpu.engine import GenParams as JGenParams
from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatchedEngine
from koboldcpp_tpu.models.loader import load_model as j_load_model
from koboldcpp_tpu.sampling import SamplerParams as JSamplerParams
from koboldcpp_tpu.server.app import ServerSettings as JServerSettings
from koboldcpp_tpu.server.app import make_app as j_make_app
from koboldcpp_tpu_torch.engine import Engine, GenParams
from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
from koboldcpp_tpu_torch.models.loader import load_model
from koboldcpp_tpu_torch.sampling import SamplerParams
from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

# one intra-op thread: the suite runs a worker process per core, and the
# idle OpenMP threads of every worker would spin on the others' cores
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf")
PROMPTS = ["The gradient of a function, e.g. f(x), points uphill.",
           "Once upon a time", "hello world, this is a test of", "A B C D"]
GEN = {"prompt": PROMPTS[0], "max_length": 8, "temperature": 0,
       "rep_pen": 1.0}


def _path(fmt):
    return os.path.join(FIX, f"tiny-{fmt}.gguf")


@pytest.mark.parametrize("fmt,kind", [("q5_1", "q5_k"), ("q8_0", "q8_0")])
async def test_served_text_matches_jax_server(fmt, kind, aiohttp_client):
    """/api/v1/generate at temperature 0 on both servers (single-stream
    engines, bf16 caches): the same text, twice over on the port."""
    model = load_model(_path(fmt), device="cpu")
    assert model.params["layers"][0]["wqkv"].kind == kind
    port = await aiohttp_client(make_app(
        Engine(model, max_context=512, device="cpu"),
        ServerSettings(model_name=f"tiny-{fmt}")))
    ref = await aiohttp_client(j_make_app(
        JEngine(j_load_model(_path(fmt)), max_context=512,
                cache_dtype=jnp.bfloat16),
        JServerSettings(model_name=f"tiny-{fmt}")))
    texts = []
    for client in (port, port, ref):
        r = await client.post("/api/v1/generate", json=GEN)
        assert r.status == 200
        texts.append((await r.json())["results"][0]["text"])
    assert texts[0] and texts[0] == texts[1] == texts[2]


def test_multiuser_q8_0_matches_jax_batched_engine():
    """Four concurrent greedy requests through the port's BatchedEngine (4
    slots: each decode step is a (4, 1) forward, so the q8_0 projections
    run K3.q8_0) get the tokens the JAX BatchedEngine gives each request
    (its 2-D `_q8_0_kernel` in interpret mode)."""
    gp = JGenParams(max_length=8, bypass_eos=True,
                    sampler=JSamplerParams(temperature=0.0, rep_pen=1.0))
    jeng = JBatchedEngine(j_load_model(_path("q8_0")), max_context=256,
                          n_slots=4, cache_dtype=jnp.bfloat16)
    try:
        want = [jeng.generate(p, gp).tokens for p in PROMPTS]
    finally:
        jeng.shutdown()
    eng = BatchedEngine(load_model(_path("q8_0"), device="cpu"),
                        max_context=256, n_slots=4, device="cpu")
    got = [None] * len(PROMPTS)

    def run(i):
        got[i] = eng.generate(PROMPTS[i], GenParams(
            max_length=8, bypass_eos=True,
            sampler=SamplerParams(temperature=0.0, rep_pen=1.0))).tokens

    try:
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(PROMPTS))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        eng.shutdown()
    assert got == want
