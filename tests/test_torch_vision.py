"""The port's vision input (models/clip.py, the image splice in both
engines, the vision routes) against the JAX package, on the CPU in f32.

The fixtures are tests/test_clip.py's tiny transformers CLIP (56 px, 3
layers, hidden 64, a 48-wide projector) and tests/test_llava.py's tiny
llama + CLIP pair (hidden 64 / 32), written with tools/convert_clip.py and
tools/convert_hf.py. The JAX engines take 56-px images through a
monkeypatched `preprocess_image`, as the JAX tests do: the JAX function
always resizes to 336 px (pinned below as a fault of the reference); the
port resizes to the model's image_size."""
import base64
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.models import clip as jclip
from koboldcpp_tpu_torch.models import clip as tclip

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

# one intra-op thread: the suite runs a worker process per core
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

TOL = dict(rtol=1e-4, atol=1e-4)
PROMPT = [1, 5, 9, 20, 33]
NEAR_TIE = 2 ** -6


def png_b64(size=56, seed=0, shape=None):
    from PIL import Image

    rng = np.random.default_rng(seed)
    img = Image.fromarray(rng.integers(0, 255, shape or (size, size, 3),
                                       dtype=np.uint8))
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _write_clip(path, seed, image_size, hidden, layers, heads, ffn, proj_out):
    from transformers import CLIPVisionConfig, CLIPVisionModel
    from convert_clip import convert_clip_state_dict
    from koboldcpp_tpu.gguf import GGMLType

    torch.manual_seed(seed)
    cfg = CLIPVisionConfig(image_size=image_size, patch_size=14,
                           hidden_size=hidden, num_hidden_layers=layers,
                           num_attention_heads=heads, intermediate_size=ffn)
    vm = CLIPVisionModel(cfg).eval().float()
    vs = {k.replace("vision_model.vision_model.", "vision_model."): v.numpy()
          for k, v in vm.state_dict().items()}
    rng = np.random.default_rng(seed)
    proj = {
        "mm.0.weight": rng.standard_normal((proj_out, hidden)).astype(
            np.float32) * 0.05,
        "mm.0.bias": rng.standard_normal(proj_out).astype(np.float32) * 0.01,
        "mm.2.weight": rng.standard_normal((proj_out, proj_out)).astype(
            np.float32) * 0.05,
        "mm.2.bias": np.zeros(proj_out, np.float32),
    }
    convert_clip_state_dict(vs, cfg, path, proj, quant_type=GGMLType.F32)
    return path


@pytest.fixture(scope="module")
def mmproj(tmp_path_factory):
    """test_clip.py's tiny CLIP: 56 px, 3 layers, hidden 64, 2 heads."""
    return _write_clip(str(tmp_path_factory.mktemp("c") / "mmproj.gguf"), 12,
                       56, 64, 3, 2, 128, 48)


@pytest.fixture(scope="module")
def llava(tmp_path_factory):
    """test_llava.py's pair: a 2-layer llama (hidden 64, 4/2 heads, vocab
    512) and a 2-layer CLIP (hidden 32) projecting to 64."""
    from transformers import LlamaConfig, LlamaForCausalLM
    from convert_hf import convert_llama_state_dict
    from .test_model_forward import tiny_tokenizer_md

    torch.manual_seed(20)
    lcfg = LlamaConfig(vocab_size=512, hidden_size=64, intermediate_size=128,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=512,
                       tie_word_embeddings=False)
    lm = LlamaForCausalLM(lcfg).eval().float()
    d = tmp_path_factory.mktemp("lv")
    lpath = str(d / "lm.gguf")
    convert_llama_state_dict({k: v.numpy() for k, v in lm.state_dict().items()},
                             lcfg, lpath,
                             tokenizer_md=tiny_tokenizer_md(512))
    cpath = _write_clip(str(d / "mmproj.gguf"), 1, 56, 32, 2, 2, 64, 64)
    return lpath, cpath


@pytest.fixture(scope="module")
def port_pair(llava):
    from koboldcpp_tpu_torch.models.loader import load_model

    lpath, cpath = llava
    return (load_model(lpath, packed=False, dtype=torch.float32, device="cpu"),
            tclip.load_clip(cpath, device="cpu"))


def _small_pre(img):
    from PIL import Image

    img = img.convert("RGB").resize((56, 56), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - jclip.IMAGE_MEAN) / jclip.IMAGE_STD
    return x.transpose(2, 0, 1)


def _port_engine(port_pair, **kw):
    from koboldcpp_tpu_torch.engine import Engine
    from koboldcpp_tpu_torch.kv.cache import init_cache

    model, clip = port_pair
    eng = Engine(model, max_context=128, device="cpu", clip_model=clip, **kw)
    c = model.cfg
    eng.cache = init_cache(c.n_layers, 1, 128, c.n_kv_heads, c.head_dim,
                           dtype=torch.float32)
    return eng


def _greedy(n, images=(), port=True):
    if port:
        from koboldcpp_tpu_torch.engine import GenParams
        from koboldcpp_tpu_torch.sampling import SamplerParams
    else:
        from koboldcpp_tpu.engine import GenParams
        from koboldcpp_tpu.sampling import SamplerParams
    return GenParams(max_length=n, bypass_eos=True, images=list(images),
                     sampler=SamplerParams(temperature=0.0, top_k=1,
                                           rep_pen=1.0))


def _spliced(eng, prompt, images):
    """The context an image request evaluates and its embedding rows by
    position."""
    from koboldcpp_tpu_torch.engine.engine import splice_images

    if not images:
        return list(prompt), None
    return splice_images(eng.clip, eng.tokenizer.vocab.add_bos,
                         list(prompt), images)


def _same_or_near_tie(eng, prompt, images, got, want):
    """got == want, or equal up to the first step where they part, with the
    two picks' logits there (the port's, after the image) within NEAR_TIE."""
    if got == want:
        return
    i = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b), None)
    assert i is not None, (got, want)
    with torch.inference_mode():
        ctx, emb = _spliced(eng, prompt, images)
        lg = eng.eval_tokens(ctx + got[:i], 0, emb)
    gap = abs(float(lg[got[i]]) - float(lg[want[i]]))
    assert gap <= NEAR_TIE, (i, got, want, gap)


# ---------------------------------------------------------------------------
# models/clip.py against the JAX module
# ---------------------------------------------------------------------------

def test_features_and_projection_match_jax(mmproj):
    """encode_image_features and project within 1e-4 of JAX's (f32), the
    patch convolution as one product; the config read alike."""
    jm = jclip.load_clip(mmproj)
    tm = tclip.load_clip(mmproj, device="cpu")
    assert vars(tm.cfg) == vars(jm.cfg)
    assert tm.cfg.n_patches == 16 and tm.cfg.n_run == 2
    px = np.random.default_rng(1).standard_normal((2, 3, 56, 56)).astype(
        np.float32)
    want = np.asarray(jclip.encode_image_features(jm.params, jm.cfg,
                                                  jnp.asarray(px)))
    with torch.inference_mode():
        got = tclip.encode_image_features(tm.params, tm.cfg,
                                          torch.from_numpy(px))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(
        tclip.project(tm.params, got).numpy(),
        np.asarray(jclip.project(jm.params, jnp.asarray(want))), **TOL)
    np.testing.assert_allclose(tm.image_embed(px[0]).numpy(),
                               np.asarray(jm.image_embed(px[0])), **TOL)


@pytest.mark.parametrize("shape", [(100, 80, 3), (20, 20, 3), (336, 500, 3)])
def test_preprocess_and_decode_bit_equal_at_336(shape):
    """At 336 px (the JAX size) both functions equal JAX's bit for bit."""
    from PIL import Image

    b64 = png_b64(seed=3, shape=shape)
    img = Image.open(io.BytesIO(base64.b64decode(b64)))
    np.testing.assert_array_equal(tclip.preprocess_image(img),
                                  jclip.preprocess_image(img))
    for data in (b64, "data:image/png;base64," + b64):
        got = tclip.decode_image_base64(data)
        assert got.shape == (3, 336, 336)
        np.testing.assert_array_equal(got, jclip.decode_image_base64(data))


def test_preprocess_image_size_fault_of_the_reference(mmproj):
    """The JAX `preprocess_image` always resizes to 336 px, so the JAX
    ClipModel raises on an mmproj whose image_size is 56 (a 577-row input
    against a 17-row position table); the port resizes to the model's size
    and serves it, equal to the JAX model on the right-sized pixels."""
    jm = jclip.load_clip(mmproj)
    tm = tclip.load_clip(mmproj, device="cpu")
    b64 = png_b64(seed=4, size=90)
    with pytest.raises(Exception):
        np.asarray(jm.image_embed(jclip.decode_image_base64(b64)))
    got = tm.embed_base64(b64)
    assert got.shape == (16, 48)
    px = tclip.decode_image_base64(b64, 56)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jm.image_embed(px))[0], **TOL)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_engine(llava):
    from koboldcpp_tpu.engine import Engine as JEngine
    from koboldcpp_tpu.models.loader import load_model as j_load_model

    lpath, cpath = llava
    return JEngine(j_load_model(lpath, packed=False, dtype=jnp.float32),
                   max_context=128, cache_dtype=jnp.float32,
                   clip_model=jclip.load_clip(cpath))


@pytest.mark.parametrize("n_images", [1, 2])
def test_engine_tokens_match_jax(port_pair, jax_engine, monkeypatch,
                                 n_images):
    """Greedy tokens after one image (16 patch rows after BOS) and after two
    (32), the port's Engine against the JAX one; the context holds the
    sentinels, and a text request afterwards re-evaluates past them."""
    monkeypatch.setattr(jclip, "preprocess_image", _small_pre)
    images = [png_b64(seed=s) for s in range(n_images)]
    jax_engine.reset_context()
    want = jax_engine.generate(PROMPT, _greedy(8, images, port=False)).tokens
    eng = _port_engine(port_pair)
    got = eng.generate(PROMPT, _greedy(8, images)).tokens
    assert eng.context_tokens.count(eng.IMG_SENTINEL) == 16 * n_images
    assert eng.context_tokens[:len(PROMPT) + 16 * n_images] == _spliced(
        eng, PROMPT, images)[0]
    _same_or_near_tie(eng, PROMPT, images, got, want)
    # the image moves the reply; a following text request serves
    eng.reset_context()
    assert eng.generate(PROMPT, _greedy(8)).tokens != got


@pytest.fixture(scope="module")
def jax_batched(llava):
    from koboldcpp_tpu.engine.batch_engine import BatchedEngine as JBatched
    from koboldcpp_tpu.models.loader import load_model as j_load_model

    lpath, cpath = llava
    model = j_load_model(lpath, packed=False, dtype=jnp.float32)
    clip = jclip.load_clip(cpath)
    engines = {paged: JBatched(model, max_context=128, n_slots=2,
                               cache_dtype=jnp.float32, paged=paged,
                               page_size=16, clip_model=clip)
               for paged in (False, True)}
    yield engines
    for e in engines.values():
        e.shutdown()


def _requests():
    """One image request and one text request, submitted together."""
    return [(PROMPT, [png_b64(seed=7)]), ([1, 44, 45, 46], [])]


def _serve(eng, reqs, port=True):
    subs = [eng.submit(p, _greedy(6, imgs, port=port)) for p, imgs in reqs]
    for r in subs:
        assert r.done.wait(120)
    return [r.result.tokens for r in subs]


def test_batched_slot_tokens_match_jax(port_pair, jax_batched, monkeypatch):
    """The port's BatchedEngine on an f32 slot cache against the JAX one:
    an image request (prefilled alone, one row a chunk, embeddings spliced)
    beside a text request."""
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
    from koboldcpp_tpu_torch.kv.cache import init_cache

    monkeypatch.setattr(jclip, "preprocess_image", _small_pre)
    model, clip = port_pair
    want = _serve(jax_batched[False], _requests(), port=False)
    eng = BatchedEngine(model, max_context=128, n_slots=2, device="cpu",
                        clip_model=clip)
    c = model.cfg
    eng.cache = init_cache(c.n_layers, 2, 128, c.n_kv_heads, c.head_dim,
                           dtype=torch.float32)
    try:
        got = _serve(eng, _requests())
    finally:
        eng.shutdown()
    single = _port_engine(port_pair)
    for (prompt, images), g, w in zip(_requests(), got, want):
        _same_or_near_tie(single, prompt, images or [], g, w)


def test_paged_pool_splices_like_the_slot_cache(port_pair):
    """The port's paged pool (bf16) serves the image request with its image:
    the same tokens as its slot cache (bf16), both engines with one image
    slot and one text slot in flight."""
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine

    model, clip = port_pair
    out = {}
    for paged in (False, True):
        eng = BatchedEngine(model, max_context=128, n_slots=2, device="cpu",
                            paged=paged, page_size=16, clip_model=clip)
        try:
            out[paged] = _serve(eng, _requests())
        finally:
            eng.shutdown()
    assert out[True] == out[False]


def test_paged_llava_fault_of_the_reference(jax_batched, monkeypatch):
    """The JAX paged BatchedEngine drops the image (its `_prefill_chunk`
    takes the paged branch before the image one, and `forward_paged` has no
    input_embeds): the image request's tokens equal those of the prompt
    with token 0 at every one of its 16 image rows, and differ from the
    JAX slot cache's, which uses the image."""
    monkeypatch.setattr(jclip, "preprocess_image", _small_pre)
    img = [png_b64(seed=7)]
    paged, slot = jax_batched[True], jax_batched[False]
    for e in (paged, slot):
        e.reset_context()
    with_image = _serve(paged, [(PROMPT, img)], port=False)[0]
    n_bos = int(paged.tokenizer.vocab.add_bos)
    zeros = _serve(paged, [(PROMPT[:n_bos] + [0] * 16 + PROMPT[n_bos:], [])],
                   port=False)[0]
    assert with_image == zeros
    assert _serve(slot, [(PROMPT, img)], port=False)[0] != with_image


def test_stochastic_image_requests_serve(port_pair):
    """A seeded stochastic request with a repetition penalty after an image
    (the device sampler's rep-pen window holds the sentinels, mapped to its
    spare column) gives the same tokens twice single-stream, and serves in
    a batched slot (whose device sampler draws from the engine's own
    generator)."""
    from koboldcpp_tpu_torch.engine import GenParams
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
    from koboldcpp_tpu_torch.sampling import SamplerParams

    gp = GenParams(max_length=6, bypass_eos=True, images=[png_b64(seed=8)],
                   sampler=SamplerParams(temperature=0.8, top_p=0.9,
                                         rep_pen=1.2, seed=5))
    eng = _port_engine(port_pair)
    assert eng._fast_stoch_ok(gp, None)
    first = eng.generate(PROMPT, gp).tokens
    assert len(first) == 6 and eng.generate(PROMPT, gp).tokens == first
    beng = BatchedEngine(port_pair[0], max_context=128, n_slots=2,
                         device="cpu", clip_model=port_pair[1])
    try:
        runs = [beng.generate(PROMPT, gp) for _ in range(2)]
    finally:
        beng.shutdown()
    assert all(not r.stop_reason.startswith("error") for r in runs)
    assert all(len(r.tokens) == 6 and max(r.tokens) < 512 for r in runs)


def test_recurrent_branch_refuses_images(port_pair):
    """An image request on a branch without the llama cache raises
    ValueError naming the branch (the JAX engine would run it through
    models/llama.forward with the wrong cache); without images it serves."""
    from koboldcpp_tpu_torch.engine import Engine
    from koboldcpp_tpu_torch.models.loader import load_model

    path = os.path.join(os.path.dirname(__file__), "fixtures", "portgguf",
                        "tiny-mamba-q4_k_m.gguf")
    eng = Engine(load_model(path, device="cpu"), max_context=64, device="cpu",
                 clip_model=port_pair[1])
    with pytest.raises(ValueError, match="recurrent"):
        eng.generate([1, 5, 9], _greedy(2, [png_b64()]))
    assert len(eng.generate([1, 5, 9], _greedy(2)).tokens) == 2


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

async def test_vision_routes(port_pair, aiohttp_client):
    """/api/extra/version says vision (and txt2img with an SD model only);
    /sdapi/v1/interrogate captions (the
    LLaVA prompt with the image, 503 without a vision model); an OpenAI
    chat request's image_url data part reaches GenParams.images."""
    from koboldcpp_tpu_torch.engine import Engine
    from koboldcpp_tpu_torch.server.app import ServerSettings, make_app

    eng = _port_engine(port_pair)
    seen = []
    orig = eng.generate

    def spy(prompt, params, on_token=None):
        seen.append(list(params.images))
        return orig(prompt, params, on_token)

    eng.generate = spy
    client = await aiohttp_client(make_app(eng, ServerSettings()))
    v = await (await client.get("/api/extra/version")).json()
    assert v["vision"] is True and v["transcribe"] is False
    assert v["txt2img"] is False  # no SD model
    from koboldcpp_tpu_torch.models import sd as tsd
    from .test_sd import TINY
    from .test_torch_sd import port_cfg

    sd = tsd.SDModel(port_cfg(TINY), tsd.init_random_sd_params(
        port_cfg(TINY)), device="cpu")
    sd_client = await aiohttp_client(make_app(eng, ServerSettings(
        sd_model=sd)))
    v = await (await sd_client.get("/api/extra/version")).json()
    assert v["txt2img"] is True and v["vision"] is True
    b64 = png_b64(seed=5)
    r = await client.post("/sdapi/v1/interrogate",
                          json={"image": b64, "max_length": 4})
    assert r.status == 200 and isinstance((await r.json())["caption"], str)
    assert seen[-1] == [b64]
    r = await client.post("/v1/chat/completions", json={
        "max_tokens": 3, "temperature": 0, "messages": [{
            "role": "user", "content": [
                {"type": "text", "text": "what is this?"},
                {"type": "image_url",
                 "image_url": {"url": "data:image/png;base64," + b64}}]}]})
    assert r.status == 200
    assert (await r.json())["choices"][0]["message"]["content"] is not None
    assert seen[-1] == [b64]
    plain = Engine(port_pair[0], max_context=64, device="cpu")
    client = await aiohttp_client(make_app(plain, ServerSettings()))
    assert (await (await client.get("/api/extra/version")).json())[
        "vision"] is False
    r = await client.post("/sdapi/v1/interrogate", json={"image": b64})
    assert r.status == 503


# ---------------------------------------------------------------------------
# the weights' other routes in: params_from_jax and the synthetic makers
# ---------------------------------------------------------------------------

def test_params_from_jax_and_the_synthetic_maker(mmproj):
    """params_from_jax carries the JAX module's flat tree across (numpy in,
    the loader's f32 tensors out); the synthetic maker draws every tensor
    the loader names, at the shapes an mmproj of that config has, and
    embeds; without a device both entry points need the card."""
    from koboldcpp_tpu_torch.models import synthetic
    from koboldcpp_tpu_torch.models.convert import params_from_jax

    jm = jclip.load_clip(mmproj)
    tm = tclip.load_clip(mmproj, device="cpu")
    conv = params_from_jax({k: np.asarray(v) for k, v in jm.params.items()})
    assert conv.keys() == tm.params.keys()
    for k, v in conv.items():
        assert v.dtype == torch.float32 and torch.equal(v, tm.params[k]), k
    syn = synthetic.synthetic_clip(tm.cfg, llm_hidden=48, device="cpu")
    assert {k: tuple(v.shape) for k, v in syn.params.items()} == {
        k: tuple(v.shape) for k, v in tm.params.items()}
    emb = syn.embed_base64(png_b64(seed=6, size=70))
    assert emb.shape == (16, 48) and torch.isfinite(emb).all()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tclip.load_clip(mmproj)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.synthetic_clip(tm.cfg, llm_hidden=48)


def test_synthetic_lm_on_device_layout(port_pair):
    """synthetic_q4_k_m_on_device gives synthetic_params' q4_k_m layout
    (the same keys, kinds and shapes, on a narrow config); it serves an
    image request."""
    from koboldcpp_tpu_torch.engine import Engine
    from koboldcpp_tpu_torch.models import synthetic
    from koboldcpp_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(arch="llama", vocab_size=512, hidden_size=256,
                      n_layers=2, n_heads=4, n_kv_heads=2, head_dim=64,
                      intermediate_size=512, rope_dim=64)
    m = synthetic.synthetic_q4_k_m_on_device(cfg, seed=1, device="cpu")
    ref = synthetic.synthetic_params(cfg, "q4_k_m", device="cpu")

    def layout(p):
        return {k: (v.kind, tuple(v.shape), sorted(v.data))
                if hasattr(v, "kind") else tuple(v.shape)
                for k, v in p.items() if k != "layers"}

    assert layout(m.params) == layout(ref)
    assert layout(m.params["layers"][1]) == layout(ref["layers"][1])
    clip = synthetic.synthetic_clip(port_pair[1].cfg, llm_hidden=256,
                                    device="cpu")
    eng = Engine(m, max_context=256, device="cpu", clip_model=clip)
    r = eng.generate([1, 5, 6], _greedy(4, [png_b64()]))
    assert len(r.tokens) == 4 and all(0 <= t < 512 for t in r.tokens)
