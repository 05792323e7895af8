"""The port's SDXL pipeline, its TAESD decoder and the text towers'
activation, against the JAX package and transformers, on the CPU in f32.

SDXL: tests/test_sdxl.py's TINY_XL (per-level transformer depth, linear
projections, two text towers, the pooled add_embedding) drawn by the JAX
`init_random_sd_params`; the XL tests give the port's bigG tower the JAX
module's quick_gelu (`tower_act` patched, `jax_act`), so that the whole
pipeline computes the JAX function (the port's own choice, upstream's
gelu, is held against transformers in
`test_openclip_gelu_fault_of_the_reference`). TAESD:
tests/test_taesd.py's torch replica of the published architecture.
Tolerances as tests/test_torch_sd.py's: 1e-4 of the output's scale, one
uint8 level for images; the JAX side runs its SDModel's jitted
functions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.models import sd as jsd
from koboldcpp_tpu.models import taesd as jtaesd
from koboldcpp_tpu_torch.models import sd as tsd
from koboldcpp_tpu_torch.models import taesd as ttaesd
from koboldcpp_tpu_torch.models.convert import params_from_jax

from .test_sdxl import TINY_XL
from .test_taesd import _torch_taesd
from .test_torch_sd import close, nchw, nhwc, port_cfg, same_image

# one intra-op thread: the suite runs a worker process per core
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def xl():
    jp = jsd.init_random_sd_params(TINY_XL, seed=1)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    jm = jsd.SDModel(TINY_XL, jp)
    tm = tsd.SDModel(port_cfg(TINY_XL), params_from_jax(np_params),
                     device="cpu")
    return jm, tm


@pytest.fixture
def jax_act(monkeypatch):
    """The JAX module's quick_gelu in every tower."""
    monkeypatch.setattr(tsd, "tower_act", lambda cfg, prefix="text.":
                        "quick_gelu")


def test_xl_towers_and_unet_match_jax(xl, jax_act):
    """Both towers' penultimate states side by side and the pooled bigG
    output (encode_prompt), and the UNet with pooled + time-id
    conditioning."""
    jm, tm = xl
    jctx, jpool = jm.encode_prompt("x")
    tctx, tpool = tm.encode_prompt("x")
    assert tctx.shape == (1, 8, 48) and tpool.shape == (1, 32)
    close(tctx, jctx)
    close(tpool, jpool)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    tids = np.array([[64, 64, 0, 0, 64, 64]], np.float32)
    want = jm._unet(params=jm.params, latents=jnp.asarray(x),
                    t=jnp.asarray([500], jnp.int32), context=jctx,
                    pooled=jpool, time_ids=jnp.asarray(tids))
    got = tsd.unet_apply(tm.params, tm.cfg, nchw(x), torch.tensor([500]),
                         tctx, pooled=tpool, time_ids=torch.from_numpy(tids))
    close(nhwc(got), want)


@pytest.mark.parametrize("name", ["euler a", "dpm++ 2m"])
def test_xl_txt2img_matches_jax(xl, jax_act, name):
    jm, tm = xl
    kw = dict(width=64, height=64, steps=2, cfg_scale=2.0, sampler=name,
              seed=7)
    same_image(tm.txt2img("a", **kw), jm.txt2img("a", **kw))


def _hf_tower(act: str, with_projection: bool):
    """A tiny transformers CLIP text model and its tensors under the
    converter's names ("text2." with the projection, else "text.")."""
    from transformers import (CLIPTextConfig, CLIPTextModel,
                              CLIPTextModelWithProjection)

    torch.manual_seed(71)
    hcfg = CLIPTextConfig(vocab_size=100, hidden_size=32,
                          intermediate_size=128, num_hidden_layers=3,
                          num_attention_heads=2, max_position_embeddings=8,
                          projection_dim=24, hidden_act=act,
                          eos_token_id=99, bos_token_id=98)
    cls = CLIPTextModelWithProjection if with_projection else CLIPTextModel
    model = cls(hcfg).eval().float()
    st = {k: v.numpy() for k, v in model.state_dict().items()}
    pre, T = ("text2." if with_projection else "text."), "text_model."
    p = {pre + "tok_embd": st[T + "embeddings.token_embedding.weight"],
         pre + "pos_embd": st[T + "embeddings.position_embedding.weight"],
         pre + "ln_final.weight": st[T + "final_layer_norm.weight"],
         pre + "ln_final.bias": st[T + "final_layer_norm.bias"]}
    for i in range(3):
        hp = f"{T}encoder.layers.{i}."
        for a, b in (("ln1", "layer_norm1"), ("ln2", "layer_norm2"),
                     ("q", "self_attn.q_proj"), ("k", "self_attn.k_proj"),
                     ("v", "self_attn.v_proj"), ("out", "self_attn.out_proj"),
                     ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            p[f"{pre}{i}.{a}.weight"] = st[hp + b + ".weight"]
            p[f"{pre}{i}.{a}.bias"] = st[hp + b + ".bias"]
    if with_projection:
        p["text2.projection"] = st["text_projection.weight"]
    return model, p


def test_openclip_gelu_fault_of_the_reference():
    """The OpenCLIP towers (SDXL's bigG, SD 2.x's OpenCLIP-H) compute exact
    gelu in their MLPs (their diffusers configs: hidden_act "gelu"); the
    JAX `clip_text_apply` computes quick_gelu in every tower. On a tiny
    transformers CLIPTextModelWithProjection with hidden_act="gelu" the
    port's bigG tower (its default act) gives transformers' last hidden
    state, pooled projection and penultimate state within 1e-4; the JAX
    tower departs by more than 1e-2 of the output's scale. OpenAI's CLIP-L
    (SD 1.x, SDXL's first tower) keeps quick_gelu in the port, and
    transformers agrees; a 1024-wide text tower (SD 2.x) takes gelu."""
    cfg = tsd.SDConfig(text_vocab=100, text_ctx=8, text_dim=32,
                       text_layers=3, text_heads=2, text2_dim=32,
                       text2_layers=3, text2_heads=2, pooled_dim=24)
    assert tsd.tower_act(cfg, "text2.") == "gelu"
    assert tsd.tower_act(cfg) == "quick_gelu"
    assert tsd.tower_act(tsd.SDConfig(text_dim=1024)) == "gelu"
    toks = np.array([[98, 5, 9, 42, 7, 60, 3, 99]], np.int64)
    model, p = _hf_tower("gelu", True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    with torch.no_grad():
        ref = model(torch.from_numpy(toks), output_hidden_states=True)
    kw = dict(prefix="text2.", n_layers=3, n_heads=2)
    got = tsd.clip_text_apply(tp, cfg, torch.from_numpy(toks), **kw)
    close(got, ref.last_hidden_state)
    close(got[:, 7] @ tp["text2.projection"].t(), ref.text_embeds)
    close(tsd.clip_text_apply(tp, cfg, torch.from_numpy(toks), skip_last=1,
                              final_ln=False, **kw), ref.hidden_states[-2])
    jcfg = jsd.SDConfig(text_vocab=100, text_ctx=8, text2_dim=32,
                        text2_layers=3, text2_heads=2, pooled_dim=24)
    jax_out = np.asarray(jsd.clip_text_apply(
        {k: jnp.asarray(v) for k, v in p.items()}, jcfg,
        jnp.asarray(toks, jnp.int32), **kw))
    want = ref.last_hidden_state.numpy()
    assert np.abs(jax_out - want).max() > 1e-2 * np.abs(want).max()
    model, p = _hf_tower("quick_gelu", False)
    with torch.no_grad():
        ref = model(torch.from_numpy(toks)).last_hidden_state
    close(tsd.clip_text_apply({k: torch.from_numpy(v) for k, v in p.items()},
                              cfg, torch.from_numpy(toks)), ref)


@pytest.fixture(scope="module")
def taesd_state():
    torch.manual_seed(0)
    return {k: v.numpy() for k, v in _torch_taesd().state_dict().items()}


def test_taesd_matches_jax(taesd_state, tmp_path):
    """The decoder and encoder against the JAX ones on the same weights
    (params_from_jax carries the JAX tree across as the loader's tensors),
    the latent scaling, and the loader's file forms: a .pt state dict
    (torch.load, weights only), a .safetensors, a decoder-only file (keys
    "1.weight" ..., prefixed "decoder.")."""
    from safetensors.numpy import save_file

    jp = jtaesd.load_taesd(taesd_state)
    tp = ttaesd.load_taesd(taesd_state, device="cpu")
    moved = params_from_jax({k: np.asarray(v) for k, v in jp.items()})
    assert set(moved) == set(tp)
    for k in tp:
        np.testing.assert_array_equal(moved[k].numpy(), tp[k].numpy())
    rng = np.random.default_rng(0)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    img = rng.random((1, 32, 32, 3)).astype(np.float32)
    close(nhwc(ttaesd.decoder_apply(tp, nchw(z))),
          jtaesd.decoder_apply(jp, jnp.asarray(z)))
    close(nhwc(ttaesd.encoder_apply(tp, nchw(img))),
          jtaesd.encoder_apply(jp, jnp.asarray(img)))
    x = rng.standard_normal((2, 4, 4, 4)).astype(np.float32) * 4
    close(nhwc(ttaesd.scale_latents(nchw(x))),
          jtaesd.scale_latents(jnp.asarray(x)))
    close(ttaesd.unscale_latents(torch.from_numpy(x)),
          jtaesd.unscale_latents(jnp.asarray(x)))
    pt = str(tmp_path / "taesd.pt")
    torch.save({k: torch.from_numpy(v) for k, v in taesd_state.items()}, pt)
    st = str(tmp_path / "taesd.safetensors")
    save_file(taesd_state, st)
    dec = str(tmp_path / "taesd_decoder.safetensors")
    save_file({k[len("decoder."):]: v for k, v in taesd_state.items()
               if k.startswith("decoder.")}, dec)
    for src in (pt, st):
        got = ttaesd.load_taesd(src, device="cpu")
        assert set(got) == set(tp)
        for k in tp:
            assert got[k].dtype == torch.float32
            np.testing.assert_array_equal(got[k].numpy(), tp[k].numpy())
    got = ttaesd.load_taesd(dec, device="cpu")
    assert set(got) == {k for k in tp if k.startswith("decoder.")}


def test_sdmodel_taesd_decode_matches_jax(taesd_state):
    """txt2img with TAESD set decodes through it (8x the latents, [0, 1]
    to uint8), as the JAX pipeline does."""
    from .test_sd import TINY

    jm = jsd.SDModel(TINY, jsd.init_random_sd_params(TINY, seed=0))
    jm.set_taesd(taesd_state)
    tm = tsd.SDModel(port_cfg(TINY), params_from_jax(
        {k: np.asarray(v) for k, v in jm.params.items()}), device="cpu")
    tm.set_taesd(taesd_state)
    kw = dict(steps=2, width=64, height=64, seed=3, cfg_scale=1.0)
    got = tm.txt2img("x", **kw)
    assert got.shape == (64, 64, 3)
    same_image(got, jm.txt2img("x", **kw))
