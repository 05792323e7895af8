"""The port's Stable Diffusion (models/sd.py, the A1111 routes, the
--sdmodel flags) against the JAX package, on the CPU in f32.

The weights are tests/test_sd.py's TINY config drawn by the JAX
`init_random_sd_params` and carried across by `params_from_jax`. The JAX
side runs its SDModel's jitted functions: on this CPU the whole tiny
pipeline compiles in ~2.5 s, where running it op by op compiled each op
for ~20 s. Modules are held within 1e-4 of the output's scale
(max |got - want| <= 1e-4 max |want|), images within one uint8 level (the
f32 rounding of the two packages may move a pixel across a level). Every
pipeline runs at 8 x 8 latents (64 px requested; the tiny VAE decodes 16
px and encodes a 16 px image to 8 x 8), the shapes of the module test, so
that the JAX functions compile once."""
import base64
import dataclasses
import io
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.models import sd as jsd
from koboldcpp_tpu_torch import cli
from koboldcpp_tpu_torch.models import sd as tsd
from koboldcpp_tpu_torch.models.convert import params_from_jax
from koboldcpp_tpu_torch.server import app as tapp

from .test_sd import TINY

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

# one intra-op thread: the suite runs a worker process per core
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

REL = 1e-4
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")


def port_cfg(cfg, **kw) -> tsd.SDConfig:
    return tsd.SDConfig(**{**dataclasses.asdict(cfg), **kw})


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err, scale = np.abs(got - want).max(), np.abs(want).max()
    assert err <= rel * scale, (err, scale)


def same_image(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def nchw(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def pair():
    jp = jsd.init_random_sd_params(TINY, seed=0)
    np_params = {k: np.asarray(v) for k, v in jp.items()}
    jm = jsd.SDModel(TINY, jp)
    tm = tsd.SDModel(port_cfg(TINY), params_from_jax(np_params), device="cpu")
    return jm, tm, np_params


def test_params_from_jax_and_the_port_init(pair):
    """params_from_jax carries the flat tree across as f32 tensors; the
    port's `init_random_sd_params` draws the same weights from the same
    seed."""
    _, tm, np_params = pair
    mine = tsd.init_random_sd_params(port_cfg(TINY), seed=0)
    assert set(mine) == set(np_params) == set(tm.params)
    for k, v in np_params.items():
        assert tm.params[k].dtype == torch.float32
        np.testing.assert_array_equal(tm.params[k].numpy(), v)
        np.testing.assert_array_equal(mine[k].numpy(), v)


def test_modules_match_jax(pair):
    """The text tower, the UNet, the VAE decoder and encoder (with and
    without its noise) against the JAX functions."""
    jm, tm, _ = pair
    rng = np.random.default_rng(0)
    tok = np.array([[1, 5, 9, 42, 7, 3, 2, 0]], np.int32)
    close(tsd.clip_text_apply(tm.params, tm.cfg, torch.from_numpy(tok)),
          jm._text(params=jm.params, tokens=jnp.asarray(tok)))
    x = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    ctx = rng.standard_normal((1, 8, 32)).astype(np.float32)
    want = jm._unet(params=jm.params, latents=jnp.asarray(x),
                    t=jnp.asarray([500], jnp.int32), context=jnp.asarray(ctx))
    got = tsd.unet_apply(tm.params, tm.cfg, nchw(x), torch.tensor([500]),
                         torch.from_numpy(ctx))
    close(nhwc(got), want)
    z = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    close(nhwc(tsd.vae_decode(tm.params, tm.cfg, nchw(z))),
          jm._vae(params=jm.params, z=jnp.asarray(z)))
    img = rng.uniform(-1, 1, (1, 16, 16, 3)).astype(np.float32)
    noise = rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
    for n in (None, noise):
        want = jsd.vae_encode(jm.params, TINY, jnp.asarray(img),
                              None if n is None else jnp.asarray(n))
        got = tsd.vae_encode(tm.params, tm.cfg, nchw(img),
                             None if n is None else nchw(n))
        close(nhwc(got), want)


class _FakeKD:
    """A denoiser of known form (x0 = x / (sigma^2 + 1) + tanh(x) / 10) for
    both packages, so that the samplers' arithmetic and noise draws are
    held alone."""

    def __init__(self, lib):
        self.lib = lib

    def denoise(self, x, sigma, cond, uncond, cfg_scale):
        return x / (sigma ** 2 + 1.0) + self.lib.tanh(x) / 10


@pytest.mark.parametrize("name", sorted(jsd.SAMPLERS))
def test_sampler_matches_jax(name):
    """Every sampler name over a fixed sigma ladder (Karras, 6 steps, then
    0) and a fixed noise stream: the port draws the JAX module's numpy
    stream in its NHWC order."""
    assert set(tsd.SAMPLERS) == set(jsd.SAMPLERS)
    x0 = np.random.default_rng(1).standard_normal((1, 4, 4, 4)).astype(
        np.float32) * 10
    sigmas = np.append(jsd.karras_sigmas(6), 0.0).astype(np.float32)
    want = jsd.SAMPLERS[name](_FakeKD(jnp), jnp.asarray(x0), sigmas, None,
                              None, 1.0, np.random.default_rng(3))
    got = tsd.SAMPLERS[name](_FakeKD(torch), nchw(x0), sigmas, None, None,
                             1.0, np.random.default_rng(3))
    close(nhwc(got), want)


@pytest.mark.parametrize("name", sorted(jsd.SAMPLERS))
def test_txt2img_matches_jax(pair, name):
    """A whole seeded txt2img (2 steps, classifier-free guidance 2.0) under
    every sampler name gives the JAX pipeline's image."""
    jm, tm, _ = pair
    kw = dict(width=64, height=64, steps=2, cfg_scale=2.0, sampler=name,
              seed=5)
    same_image(tm.txt2img("x", **kw), jm.txt2img("x", **kw))


def test_img2img_and_seeds(pair):
    """img2img (denoise 0.75) gives the JAX image; one seed repeats its
    bytes, another seed changes them."""
    jm, tm, _ = pair
    init = np.random.default_rng(4).integers(0, 256, (16, 16, 3), np.uint8)
    kw = dict(denoise=0.75, steps=4, cfg_scale=2.0, sampler="euler a",
              seed=3)
    got = tm.img2img(init, "x", **kw)
    same_image(got, jm.img2img(init, "x", **kw))
    np.testing.assert_array_equal(got, tm.img2img(init, "x", **kw))
    a = tm.txt2img("x", width=64, height=64, steps=3, seed=11)
    np.testing.assert_array_equal(a, tm.txt2img("x", width=64, height=64,
                                                steps=3, seed=11))
    assert (a != tm.txt2img("x", width=64, height=64, steps=3,
                            seed=12)).any()


def test_true_f32_scope():
    """true_f32 turns TF32 off for convolutions and matmuls inside its
    block only."""
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.enabled)
    with tsd.true_f32():
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.enabled == before[2]
    assert (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.enabled) == before


def _lora_file(tmp_path, rng) -> str:
    from convert_sd_lora import convert_sd_lora_state_dict

    r = 4
    target_u = "down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
    target_t = "text_encoder.text_model.encoder.layers.0.self_attn.q_proj"
    state = {
        f"unet.{target_u}.lora_A.weight": rng.standard_normal((r, 32)),
        f"unet.{target_u}.lora_B.weight": rng.standard_normal((32, r)),
        f"{target_t}.lora_A.weight": rng.standard_normal((r, 32)),
        f"{target_t}.lora_B.weight": rng.standard_normal((32, r)),
        "some.unknown.key": np.zeros(1),
    }
    path = str(tmp_path / "sdlora.gguf")
    convert_sd_lora_state_dict({k: v.astype(np.float32)
                                for k, v in state.items()}, path, alpha=8.0)
    return path


def _vae_file(tmp_path, np_params, rng) -> str:
    from safetensors.numpy import save_file

    path = str(tmp_path / "vae.safetensors")
    save_file({k[len("vae."):]: rng.standard_normal(v.shape).astype(
        np.float32) for k, v in np_params.items() if k.startswith("vae.")},
        path)
    return path


def test_lora_merge_and_vae_override_match_jax(tmp_path, pair):
    """--sdlora merges the same deltas as the JAX `apply_sd_lora` (two
    tensors of a GGUF adapter); --sdvae replaces the same tensors as the
    JAX `load_sd_vae` and refuses a tensor of another shape."""
    jm, tm, np_params = pair
    rng = np.random.default_rng(3)
    lora, vae = _lora_file(tmp_path, rng), _vae_file(tmp_path, np_params, rng)
    jp, tp = dict(jm.params), dict(tm.params)
    assert tsd.apply_sd_lora(tp, lora, 0.5) == jsd.apply_sd_lora(jp, lora,
                                                                 0.5) == 2
    assert tsd.load_sd_vae(tp, vae) == jsd.load_sd_vae(jp, vae) > 0
    for k in ("down_blocks.0.attentions.0.transformer_blocks.0.attn1.to_q"
              ".weight", "text.0.q.weight", "vae.decoder.conv_in.weight"):
        assert not np.array_equal(tp[k].numpy(), np_params[k])
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-6)
    from safetensors.numpy import save_file

    bad = str(tmp_path / "bad.safetensors")
    save_file({"decoder.conv_in.weight": np.zeros((3, 3), np.float32)}, bad)
    with pytest.raises(ValueError):
        tsd.load_sd_vae(dict(tm.params), bad)


def write_sd_gguf(path: str, np_params: dict) -> str:
    """TINY as a GGUF written by the port's writer copy."""
    from koboldcpp_tpu_torch.gguf import GGMLType, GGUFWriter

    w = GGUFWriter(path, architecture="sd")
    for key, v in (("sd.unet.model_channels", 32), ("sd.unet.res_blocks", 1),
                   ("sd.unet.heads", 2), ("sd.context_dim", 32),
                   ("sd.text.layers", 2), ("sd.text.heads", 2),
                   ("sd.text.dim", 32), ("sd.vae.ch", 16),
                   ("sd.text.vocab", 100), ("sd.text.ctx", 8)):
        w.add(key, np.uint32(v))
    for key, v in (("sd.unet.channel_mult", [1, 2]),
                   ("sd.unet.attn_levels", [0, 1]), ("sd.vae.ch_mult", [1, 2])):
        w.add(key, np.array(v, np.uint32))
    for name, arr in np_params.items():
        w.add_tensor(name, np.asarray(arr, np.float32), GGMLType.F32)
    w.write()
    return path


def test_gguf_written_by_the_port_loads(tmp_path, pair):
    """A GGUF from the port's writer loads through the port's `load_sd`
    and through the JAX one (the config and every tensor as written), and
    gives the JAX pipeline's image."""
    jm, tm, np_params = pair
    path = write_sd_gguf(str(tmp_path / "sd.gguf"), np_params)
    m = tsd.load_sd(path, device="cpu")
    assert m.cfg == port_cfg(TINY) and m.device.type == "cpu"
    for k, v in np_params.items():
        np.testing.assert_array_equal(m.params[k].numpy(), v)
    j = jsd.load_sd(path)
    assert j.cfg == TINY
    for k, v in np_params.items():
        np.testing.assert_array_equal(np.asarray(j.params[k]), v)
    kw = dict(width=64, height=64, steps=2, cfg_scale=1.0, seed=5)
    same_image(m.txt2img("x", **kw), jm.txt2img("x", **kw))


def _png(img: np.ndarray) -> str:
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _unpng(b64: str) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


async def _both(aiohttp_client, jmodel, tmodel, **settings):
    from koboldcpp_tpu.server import app as japp

    j = await aiohttp_client(japp.make_app(
        cli.NullEngine(), japp.ServerSettings(sd_model=jmodel, **settings)))
    t = await aiohttp_client(tapp.make_app(
        cli.NullEngine(), tapp.ServerSettings(sd_model=tmodel, **settings)))
    return j, t


async def test_sd_routes_match_jax(pair, aiohttp_client):
    """txt2img (64 px at least: 8 x 8 latents, a 16 px image from the tiny
    VAE) and img2img give the JAX server's images; version says txt2img;
    the discovery routes answer as JAX's; /sdui is its page."""
    jm, tm, _ = pair
    j, t = await _both(aiohttp_client, jm, tm)
    body = {"prompt": "a test", "width": 16, "height": 16, "steps": 2,
            "cfg_scale": 1.0, "seed": 3}
    imgs = []
    for c in (t, j):
        r = await c.post("/sdapi/v1/txt2img", json=body)
        assert r.status == 200
        imgs.append(_unpng((await r.json())["images"][0]))
    assert imgs[0].shape == (16, 16, 3)
    same_image(*imgs)
    init = _png(np.full((16, 16, 3), 128, np.uint8))
    body = {"prompt": "x", "init_images": ["data:image/png;base64," + init],
            "steps": 2, "denoising_strength": 0.5, "cfg_scale": 1.0,
            "seed": 1}
    imgs = []
    for c in (t, j):
        r = await c.post("/sdapi/v1/img2img", json=body)
        assert r.status == 200
        imgs.append(_unpng((await r.json())["images"][0]))
    same_image(*imgs)
    r = await t.post("/sdapi/v1/img2img", json={"init_images": ["!!"]})
    assert r.status == 400
    assert (await (await t.get("/api/extra/version")).json())["txt2img"]
    for path in ("/sdapi/v1/sd-models", "/sdapi/v1/options",
                 "/sdapi/v1/samplers", "/sdapi/v1/latent-upscale-modes",
                 "/sdapi/v1/upscalers"):
        got, want = await t.get(path), await j.get(path)
        assert got.status == 200 and await got.json() == await want.json()
    got, want = await t.get("/sdui"), await j.get("/sdui")
    assert got.status == 200 and await got.text() == await want.text()
    assert "<html" in (await got.text()).lower()


async def test_sd_routes_without_a_model(aiohttp_client):
    c = await aiohttp_client(tapp.make_app(cli.NullEngine(),
                                           tapp.ServerSettings()))
    for path in ("/sdapi/v1/txt2img", "/sdapi/v1/img2img"):
        assert (await c.post(path, json={"prompt": "x"})).status == 503
    assert not (await (await c.get("/api/extra/version")).json())["txt2img"]


class _Recorder:
    """Records the arguments a route passes to the model."""

    def __init__(self):
        self.calls = []

    def txt2img(self, prompt, **kw):
        self.calls.append((prompt, kw))
        return np.zeros((8, 8, 3), np.uint8)

    def img2img(self, init, prompt, **kw):
        self.calls.append((init.shape, prompt, kw))
        return np.zeros((8, 8, 3), np.uint8)


@pytest.mark.parametrize("clamped", [0, 512, 768])
async def test_clamp_sd_matches_jax(aiohttp_client, clamped):
    """_clamp_sd (steps 1..80, at least 64 px, the longer side at most
    1024, or the --sdclamped limit and 40 steps, kept to multiples of 64)
    and the arguments of both routes, as the JAX server passes them."""
    recs = (_Recorder(), _Recorder())
    j, t = await _both(aiohttp_client, recs[0], recs[1], sd_clamped=clamped)
    init = _png(np.zeros((8, 8, 3), np.uint8))
    for body in ({"width": 2000, "height": 1000, "steps": 100},
                 {"width": 30, "height": 30, "steps": 0, "prompt": "p",
                  "negative_prompt": "n", "cfg_scale": 3, "seed": 9,
                  "sampler_name": "Heun"},
                 {"width": 512, "height": 768},
                 {"width": 1000, "height": 1000, "steps": 60}):
        for c in (j, t):
            assert (await c.post("/sdapi/v1/txt2img", json=body)).status == 200
            assert (await c.post("/sdapi/v1/img2img", json={
                **body, "init_images": [init]})).status == 200
    assert recs[1].calls == recs[0].calls and len(recs[1].calls) == 8


def test_cli_serves_sdmodel(tmp_path, pair, monkeypatch, capsys):
    """--sdmodel with --sdvae, --sdlora / --sdloramult, --sdtaesd and
    --sdclamped load in the JAX launcher's order beside a text model;
    --sdmodel alone serves the image routes over the API shell;
    --sdvaeauto without weights says so; --ignoremissing skips a missing
    SD file."""
    from safetensors.numpy import save_file

    from .test_taesd import _torch_taesd

    _, tm, np_params = pair
    rng = np.random.default_rng(5)
    path = write_sd_gguf(str(tmp_path / "sd.gguf"), np_params)
    lora, vae = _lora_file(tmp_path, rng), _vae_file(tmp_path, np_params, rng)
    torch.manual_seed(0)
    taesd = str(tmp_path / "taesd.safetensors")
    save_file({k: v.numpy() for k, v in _torch_taesd().state_dict().items()},
              taesd)
    seen = {}

    def fake(engine, **kw):
        seen.update(engine=engine, **kw)

    monkeypatch.setattr(tapp, "run_server", fake)
    assert cli.main(["--sdmodel", path, "--device", "cpu"]) == 0
    assert isinstance(seen["engine"], cli.NullEngine)
    assert isinstance(seen["settings"].sd_model, tsd.SDModel)
    assert "serving the image routes" in capsys.readouterr().out
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--sdmodel", path, "--sdvae", vae, "--sdlora", lora,
                     "--sdloramult", "0.5", "--sdtaesd", taesd,
                     "--sdclamped"]) == 0
    out = capsys.readouterr().out
    settings = seen["settings"]
    m = settings.sd_model
    assert settings.sd_clamped == 512 and m.taesd is not None
    assert "SD LoRA" in out and "merged 2 tensors" in out
    assert "SD VAE" in out and "Loading TAESD" in out
    want = dict(tm.params)
    tsd.load_sd_vae(want, vae)
    tsd.apply_sd_lora(want, lora, 0.5)
    for k in ("text.0.q.weight", "vae.decoder.conv_in.weight"):
        np.testing.assert_array_equal(m.params[k].numpy(), want[k].numpy())
    assert m.txt2img("x", width=64, height=64, steps=1,
                     seed=1).shape == (64, 64, 3)  # TAESD: 8x the latents
    assert cli.main(["--sdmodel", path, "--sdvaeauto", "--device",
                     "cpu"]) == 0
    assert "--sdvaeauto requires --sdtaesd" in capsys.readouterr().out
    assert seen["settings"].sd_model.taesd is None
    missing = str(tmp_path / "nope.gguf")
    assert cli.main([FIX, "--device", "cpu", "--contextsize", "128",
                     "--sdmodel", missing, "--ignoremissing"]) == 0
    assert "skipping missing sdmodel" in capsys.readouterr().out
    assert seen["settings"].sd_model is None


def test_sd_entry_points_need_a_gpu_unless_told_cpu(tmp_path, pair):
    """load_sd, synthetic_sd, load_taesd and the tools run on the card
    unless the caller asks for the CPU: here, without one, they raise."""
    if torch.cuda.is_available():
        pytest.skip("checks the path taken on a machine without a GPU")
    from koboldcpp_tpu_torch.models import taesd as ttaesd
    from koboldcpp_tpu_torch.models.synthetic import synthetic_sd
    from koboldcpp_tpu_torch.tools import imatrix, perplexity

    from .test_taesd import _torch_taesd

    path = write_sd_gguf(str(tmp_path / "sd.gguf"), pair[2])
    text = tmp_path / "t.txt"
    text.write_text("once upon a time")
    for call in (lambda: tsd.load_sd(path),
                 lambda: synthetic_sd(port_cfg(TINY)),
                 lambda: ttaesd.load_taesd(_torch_taesd().state_dict()),
                 lambda: perplexity.main([FIX, "--file", str(text)]),
                 lambda: imatrix.collect(FIX, "once upon a time")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert tsd.load_sd(path, device="cpu").device.type == "cpu"
