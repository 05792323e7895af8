"""The port's speech input (models/whisper.py, the transcribe routes, the
launcher's --mmproj / --whispermodel) against the JAX package, on the CPU
in f32.

The fixture is tests/test_whisper.py's tiny transformers Whisper (vocab
200, d_model 64, 2 + 2 layers) written with tools/convert_whisper.py, with
its special ids inside the vocabulary (eot 3, sot 2, language 100,
transcribe 116, no-timestamps 120, timestamps 121..199)."""
import base64
import io
import os
import sys
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from koboldcpp_tpu.models import whisper as jw
from koboldcpp_tpu_torch import cli
from koboldcpp_tpu_torch.models import whisper as tw
from koboldcpp_tpu_torch.server import app as tapp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

# one intra-op thread: the suite runs a worker process per core
torch.set_num_threads(1)

pytest_plugins = ("aiohttp.pytest_plugin",)

TOL = dict(rtol=1e-4, atol=1e-4)
FIX = os.path.join(os.path.dirname(__file__), "fixtures", "refgguf",
                   "tiny-q4_k_m.gguf")


@pytest.fixture(scope="module")
def wpath(tmp_path_factory):
    from transformers import WhisperConfig, WhisperForConditionalGeneration
    from convert_whisper import convert_whisper_state_dict
    from koboldcpp_tpu.gguf import GGMLType

    torch.manual_seed(11)
    cfg = WhisperConfig(
        vocab_size=200, num_mel_bins=80, d_model=64,
        encoder_layers=2, encoder_attention_heads=2,
        decoder_layers=2, decoder_attention_heads=2,
        encoder_ffn_dim=128, decoder_ffn_dim=128,
        max_source_positions=1500, max_target_positions=448,
        eos_token_id=3, decoder_start_token_id=2, pad_token_id=0)
    model = WhisperForConditionalGeneration(cfg).eval().float()
    path = str(tmp_path_factory.mktemp("w") / "whisper.gguf")
    convert_whisper_state_dict(
        {k: v.numpy() for k, v in model.state_dict().items()}, cfg, path,
        quant_type=GGMLType.F32, tokenizer_md={
            "whisper.no_timestamps_id": np.uint32(120),
            "whisper.transcribe_id": np.uint32(116),
            "whisper.translate_id": np.uint32(115),
            "whisper.lang_en_id": np.uint32(100)})
    return path


@pytest.fixture(scope="module")
def pair(wpath):
    return jw.load_whisper(wpath), tw.load_whisper(wpath, device="cpu")


def _audio(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * tw.SAMPLE_RATE)) / tw.SAMPLE_RATE
    return (0.3 * np.sin(2 * np.pi * 330 * t) * np.sin(2 * np.pi * 0.5 * t)
            + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)


def _wav(sig, sr=16000, width=2, channels=1):
    x = np.repeat(sig[:, None], channels, axis=1).reshape(-1)
    if width == 2:
        data = (x * 32767).astype(np.int16).tobytes()
    else:
        data = (x * 127 + 128).astype(np.uint8).tobytes()
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# the frontend, bit for bit
# ---------------------------------------------------------------------------

def test_frontend_bit_equal():
    """mel_filterbank, log_mel_spectrogram (a 3.2 s signal) and
    pad_or_trim_mel equal JAX's bit for bit."""
    np.testing.assert_array_equal(tw.mel_filterbank(), jw.mel_filterbank())
    np.testing.assert_array_equal(tw.mel_filterbank(40, 400, 8000),
                                  jw.mel_filterbank(40, 400, 8000))
    sig = _audio(3.2, 0)
    mel = tw.log_mel_spectrogram(sig)
    np.testing.assert_array_equal(mel, jw.log_mel_spectrogram(sig))
    for n in (100, 3000):
        np.testing.assert_array_equal(tw.pad_or_trim_mel(mel, n),
                                      jw.pad_or_trim_mel(mel, n))


@pytest.mark.parametrize("sr, width, channels", [(16000, 2, 1),
                                                 (16000, 1, 1),
                                                 (44100, 2, 2)],
                         ids=["16bit", "8bit", "stereo44k"])
def test_decode_wav_bit_equal(sr, width, channels):
    sig = _audio(0.5, 1)[: int(0.5 * sr)]
    b64 = base64.b64encode(_wav(sig, sr, width, channels)).decode()
    for data in (b64, "data:audio/wav;base64," + b64):
        got = tw.decode_wav_base64(data)
        np.testing.assert_array_equal(got, jw.decode_wav_base64(data))
    assert got.dtype == np.float32


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def test_encode_and_decode_match_jax(pair):
    """encode (the convolutions as shifted products) and the full decode
    within 1e-4 of JAX's; decode's last row alone equals its full pass."""
    jm, tm = pair
    mel = np.random.default_rng(0).standard_normal((1, 80, 3000)).astype(
        np.float32)
    want = np.asarray(jm._encode(params=jm.params, mel=jnp.asarray(mel)))
    with torch.inference_mode():
        enc = tw.encode(tm.params, tm.cfg, torch.from_numpy(mel))
        np.testing.assert_allclose(enc.numpy(), want, **TOL)
        toks = np.array([[2, 100, 116, 120, 5, 9, 42]], np.int64)
        got = tw.decode(tm.params, tm.cfg, torch.from_numpy(toks), enc)
        last = tw.decode(tm.params, tm.cfg, torch.from_numpy(toks), enc,
                         last_only=True)
    ref = np.asarray(jm._decode(params=jm.params,
                                tokens=jnp.asarray(toks, jnp.int32),
                                enc_out=jnp.asarray(want)))
    np.testing.assert_allclose(got.numpy(), ref, **TOL)
    np.testing.assert_allclose(last.numpy()[0, 0], got.numpy()[0, -1],
                               rtol=0, atol=1e-5)


def test_transcribe_tokens_match_jax(pair):
    jm, tm = pair
    audio = _audio(2.0, 2)
    want = jm.transcribe_tokens(audio, max_tokens=6, language_id=100)
    assert tm.transcribe_tokens(audio, max_tokens=6, language_id=100) == want
    assert tm.transcribe(audio, max_tokens=6, language_id=100) == \
        jm.transcribe(audio, max_tokens=6, language_id=100)


def test_timestamp_rules_equal_jax(pair):
    """_apply_timestamp_rules and _suppress_mask on seeded logits after
    several sampled histories, bit for bit."""
    jm, tm = pair
    rng = np.random.default_rng(3)
    tb = tm.ts_begin
    for hist in ([], [130, 7, 8], [130, 7, 140, 141], [140, 7], [tb + 3]):
        lg = (rng.standard_normal(200) * 3).astype(np.float32)
        np.testing.assert_array_equal(tm._apply_timestamp_rules(lg, hist),
                                      jm._apply_timestamp_rules(lg, hist))
    for ts in (True, False):
        np.testing.assert_array_equal(tm._suppress_mask(ts),
                                      jm._suppress_mask(ts))


def _recorded(model, audio, **kw):
    """transcribe_verbose's result and each window pass's (prompt,
    temperature, tokens, average logprob)."""
    calls = []
    orig = model._decode_window

    def rec(enc, prompt, temp, *a):
        out, avg_lp, text = orig(enc, prompt, temp, *a)
        calls.append((list(prompt), temp, list(out), avg_lp))
        return out, avg_lp, text

    model._decode_window = rec
    try:
        return model.transcribe_verbose(audio, **kw), calls
    finally:
        del model._decode_window


@pytest.mark.parametrize("ts", [True, False], ids=["timestamps", "text"])
def test_transcribe_verbose_45s_matches_jax(pair, ts):
    """A 45 s signal through the 30 s window loop at temperature 0, with
    timestamps (the window advanced by the last one, conditioning on the
    previous window's text) and without: every pass's prompt and tokens
    equal JAX's, its average logprob within 1e-4, and the text and
    segments equal."""
    jm, tm = pair
    audio = _audio(45.0, 4)
    kw = dict(max_tokens=8, language_id=100, temperatures=(0.0,),
              with_timestamps=ts)
    want, want_calls = _recorded(jm, audio, **kw)
    got, got_calls = _recorded(tm, audio, **kw)
    assert got == want
    assert len(got_calls) == len(want_calls) >= 2
    for g, w in zip(got_calls, want_calls):
        assert g[:3] == w[:3]
        assert abs(g[3] - w[3]) <= 1e-4
    assert any(c[2] for c in got_calls) or not ts  # the tiny model's
    # text mode ends each window at once (eot), its timestamp mode does not


# ---------------------------------------------------------------------------
# the routes and the launcher
# ---------------------------------------------------------------------------

async def test_transcribe_routes(pair, aiohttp_client):
    """JSON audio_data and file, a multipart upload (OpenAI), 400 without
    audio or on a body that is no WAV, 503 without a model; the version
    route says transcribe."""
    from aiohttp import FormData

    from koboldcpp_tpu_torch.cli import NullEngine

    _, tm = pair
    sig = _audio(1.5, 5)
    raw = _wav(sig)
    b64 = base64.b64encode(raw).decode()
    want = tm.transcribe(tw.decode_wav_base64(b64))
    client = await aiohttp_client(tapp.make_app(
        NullEngine(), tapp.ServerSettings(whisper_model=tm)))
    v = await (await client.get("/api/extra/version")).json()
    assert v["transcribe"] is True and v["vision"] is False
    for path, body in (("/api/extra/transcribe", {"audio_data": b64}),
                       ("/v1/audio/transcriptions", {"file": b64})):
        r = await client.post(path, json=body)
        assert r.status == 200 and (await r.json()) == {"text": want}
    form = FormData()
    form.add_field("file", raw, filename="a.wav", content_type="audio/wav")
    form.add_field("model", "whisper-1")
    r = await client.post("/v1/audio/transcriptions", data=form)
    assert r.status == 200 and (await r.json()) == {"text": want}
    assert (await client.post("/api/extra/transcribe", json={})).status == 400
    r = await client.post("/api/extra/transcribe",
                          json={"audio_data": base64.b64encode(
                              b"not a wav").decode()})
    assert r.status == 400
    client = await aiohttp_client(tapp.make_app(NullEngine(),
                                                tapp.ServerSettings()))
    for path in ("/api/extra/transcribe", "/v1/audio/transcriptions"):
        r = await client.post(path, json={"audio_data": b64})
        assert r.status == 503


class _Served(Exception):
    pass


def test_cli_loads_mmproj_and_whisper(wpath, tmp_path, monkeypatch, capsys):
    """--mmproj and --whispermodel load into the engine and the settings
    (single-stream and --multiuser); --ignoremissing skips a missing one;
    --sdmodel loads beside them into the server settings."""
    from koboldcpp_tpu_torch.engine.batch_engine import BatchedEngine
    from .test_torch_vision import _write_clip

    mm = _write_clip(str(tmp_path / "mmproj.gguf"), 3, 56, 32, 2, 2, 64, 64)
    seen = {}

    def fake(engine, **kw):
        seen.update(engine=engine, **kw)
        raise _Served

    monkeypatch.setattr(tapp, "run_server", fake)
    base = [FIX, "--device", "cpu", "--contextsize", "128"]
    for extra in ([], ["--multiuser", "2"]):
        with pytest.raises(_Served):
            cli.main(base + extra + ["--mmproj", mm, "--whispermodel", wpath])
        eng, settings = seen["engine"], seen["settings"]
        assert eng.clip.cfg.image_size == 56
        assert settings.whisper_model.cfg.vocab_size == 200
        assert isinstance(eng, BatchedEngine) == bool(extra)
        if extra:
            eng.shutdown()
    missing = str(tmp_path / "nope.gguf")
    with pytest.raises(_Served):
        cli.main(base + ["--mmproj", missing, "--whispermodel", missing,
                         "--ignoremissing"])
    out = capsys.readouterr().out
    assert "skipping missing mmproj" in out
    assert "skipping missing whispermodel" in out
    assert seen["engine"].clip is None
    assert seen["settings"].whisper_model is None
    from koboldcpp_tpu_torch.models import sd as tsd
    from .test_sd import TINY
    from .test_torch_sd import port_cfg, write_sd_gguf

    sd = write_sd_gguf(str(tmp_path / "sd.gguf"), {
        k: v.numpy() for k, v in tsd.init_random_sd_params(
            port_cfg(TINY)).items()})
    with pytest.raises(_Served):
        cli.main(base + ["--whispermodel", wpath, "--sdmodel", sd])
    assert seen["settings"].whisper_model is not None
    assert seen["settings"].sd_model.cfg == port_cfg(TINY)
    assert "Loading SD model" in capsys.readouterr().out


def test_params_from_jax_and_the_synthetic_maker(pair, wpath):
    """params_from_jax carries the JAX module's flat tree across (f32
    tensors equal to the loader's); the synthetic maker draws every tensor
    the loader names at the fixture's shapes, and transcribes; without a
    device both entry points need the card."""
    from koboldcpp_tpu_torch.models import synthetic
    from koboldcpp_tpu_torch.models.convert import params_from_jax

    jm, tm = pair
    conv = params_from_jax({k: np.asarray(v) for k, v in jm.params.items()})
    assert conv.keys() == tm.params.keys()
    for k, v in conv.items():
        assert v.dtype == torch.float32 and torch.equal(v, tm.params[k]), k
    syn = synthetic.synthetic_whisper(tm.cfg, ffn=128, device="cpu")
    assert {k: tuple(v.shape) for k, v in syn.params.items()} == {
        k: tuple(v.shape) for k, v in tm.params.items()}
    ids = syn.transcribe_tokens(_audio(1.0, 6), max_tokens=3,
                                language_id=100)
    assert len(ids) <= 3 and all(0 <= i < 200 for i in ids)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tw.load_whisper(wpath)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic.synthetic_whisper(tm.cfg, ffn=128)
