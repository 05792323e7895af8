"""Whisper speech-to-text in PyTorch.

Port of koboldcpp_tpu/models/whisper.py (the reference's whisper.cpp
integration): the log-mel frontend (numpy, a verbatim copy of the JAX
module's), the encoder (two convolutions + transformer) and decoder
(causal self-attention + cross-attention) on the device in f32, and the
transcription loops on the host (greedy single window; 30 s windows with
timestamps, the temperature fallback ladder and cross-window conditioning).
Weights load from the JAX package's GGUF container
(tools/convert_whisper.py converts HF checkpoints).

The JAX module's products are einsums and XLA convolutions outside any
Pallas kernel, so the port has no kernel here: `torch.matmul` in f32, and
each k = 3 convolution is three shifted products (cuDNN's convolution would
take TF32 on the card by default). `decode` is the full non-cached pass;
a row's logits do not depend on later rows, so the loops run it over the
tokens so far (no bucket padding) and project only the last row.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf import GGUFReader
from ..ops.norms import layer_norm

Params = dict[str, Any]

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
N_MELS = 80
CHUNK_SECONDS = 30


@dataclass
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 384
    enc_layers: int = 4
    enc_heads: int = 6
    dec_layers: int = 4
    dec_heads: int = 6
    n_audio_ctx: int = 1500
    n_text_ctx: int = 448
    vocab_size: int = 51865
    eot_id: int = 50257
    sot_id: int = 50258
    transcribe_id: int = 50359
    translate_id: int = 50358
    no_timestamps_id: int = 50363
    lang_en_id: int = 50259


# ---------------------------------------------------------------------------
# audio frontend
# ---------------------------------------------------------------------------

def mel_filterbank(n_mels: int = N_MELS, n_fft: int = N_FFT,
                   sr: int = SAMPLE_RATE) -> np.ndarray:
    """Slaney-style mel filterbank (matches whisper's filters)."""
    fmin, fmax = 0.0, sr / 2

    def hz_to_mel(f):
        f = np.asarray(f, dtype=np.float64)
        mel = f / (200.0 / 3)
        logstep = np.log(6.4) / 27.0
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / logstep, mel)

    def mel_to_hz(m):
        m = np.asarray(m, dtype=np.float64)
        logstep = np.log(6.4) / 27.0
        return np.where(m >= 15.0, 1000.0 * np.exp(logstep * (m - 15.0)), m * (200.0 / 3))

    mels = np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2)
    hz = mel_to_hz(mels)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)))
    for i in range(n_mels):
        lower = (bins - hz[i]) / max(hz[i + 1] - hz[i], 1e-10)
        upper = (hz[i + 2] - bins) / max(hz[i + 2] - hz[i + 1], 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(lower, upper))
    enorm = 2.0 / (hz[2:n_mels + 2] - hz[:n_mels])
    fb *= enorm[:, None]
    return fb.astype(np.float32)


def log_mel_spectrogram(audio: np.ndarray, n_mels: int = N_MELS) -> np.ndarray:
    """float32 mono 16 kHz -> (n_mels, T) log-mel, whisper normalization."""
    audio = np.asarray(audio, dtype=np.float32)
    window = np.hanning(N_FFT + 1)[:-1].astype(np.float32)
    pad = N_FFT // 2
    x = np.pad(audio, (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - N_FFT) // HOP
    idx = np.arange(N_FFT)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx] * window
    spec = np.abs(np.fft.rfft(frames, axis=-1)) ** 2  # (T, n_fft/2+1)
    mel = mel_filterbank(n_mels) @ spec.T  # (n_mels, T)
    # drop the last frame like whisper (it uses stft[..., :-1])
    mel = mel[:, :-1] if mel.shape[1] > 1 else mel
    log_spec = np.log10(np.maximum(mel, 1e-10))
    log_spec = np.maximum(log_spec, log_spec.max() - 8.0)
    return ((log_spec + 4.0) / 4.0).astype(np.float32)


def pad_or_trim_mel(mel: np.ndarray, n_frames: int = 3000) -> np.ndarray:
    if mel.shape[1] >= n_frames:
        return mel[:, :n_frames]
    return np.pad(mel, ((0, 0), (0, n_frames - mel.shape[1])))


def decode_wav_base64(b64: str) -> np.ndarray:
    """base64 WAV -> float32 mono 16 kHz (the transcribe endpoints' input,
    reference koboldcpp.py accepts base64 wav)."""
    import base64
    import io
    import wave

    raw = base64.b64decode(b64.split(",")[-1])
    with wave.open(io.BytesIO(raw)) as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        data = w.readframes(n)
    if width == 2:
        x = np.frombuffer(data, np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(data, np.int32).astype(np.float32) / 2147483648.0
    else:
        x = (np.frombuffer(data, np.uint8).astype(np.float32) - 128.0) / 128.0
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if sr != SAMPLE_RATE:  # linear resample
        t = np.linspace(0, len(x) - 1, int(len(x) * SAMPLE_RATE / sr))
        x = np.interp(t, np.arange(len(x)), x).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

def _mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_heads: int,
         mask: torch.Tensor | None = None) -> torch.Tensor:
    B, Tq, D = q.shape
    Tk = k.shape[1]
    H = n_heads
    hd = D // H
    qh = q.reshape(B, Tq, H, hd).transpose(1, 2).float()
    kh = k.reshape(B, Tk, H, hd).transpose(1, 2).float()
    vh = v.reshape(B, Tk, H, hd).transpose(1, 2).float()
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(
            scores, torch.finfo(torch.float32).min))
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.matmul(p.float(), vh)
    return out.transpose(1, 2).reshape(B, Tq, D).to(q.dtype)


def _lin(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    y = torch.matmul(x.float(), p[name + ".weight"].float().t()).to(x.dtype)
    if name + ".bias" in p:
        y = y + p[name + ".bias"].to(y.dtype)
    return y


def _attn_block(x: torch.Tensor, p: Params, prefix: str, n_heads: int,
                kv: torch.Tensor | None = None,
                mask: torch.Tensor | None = None) -> torch.Tensor:
    """Pre-LN attention block. kv=None => self-attention."""
    h = layer_norm(x, p[prefix + "_ln.weight"], p[prefix + "_ln.bias"])
    src = h if kv is None else kv
    q = _lin(h, p, prefix + ".q")
    k = _lin(src, p, prefix + ".k")
    v = _lin(src, p, prefix + ".v")
    out = _mha(q, k, v, n_heads, mask)
    return x + _lin(out, p, prefix + ".out")


def _ffn_block(x: torch.Tensor, p: Params, prefix: str) -> torch.Tensor:
    h = layer_norm(x, p[prefix + "_ln.weight"], p[prefix + "_ln.bias"])
    h = _lin(h, p, prefix + ".fc1")
    h = F.gelu(h.float()).to(x.dtype)
    return x + _lin(h, p, prefix + ".fc2")


def _conv3(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """The k = 3, padding 1 convolution over time as three shifted products:
    x (B, T, Cin), w (Cout, Cin, 3) -> (B, T_out, Cout), T_out = (T - 1)
    // stride + 1; output frame t reads input frames stride t - 1 .. + 1."""
    T = x.shape[1]
    t_out = (T - 1) // stride + 1
    xp = F.pad(x.float(), (0, 0, 1, 1))
    y = None
    for j in range(3):
        xs = xp[:, j:j + stride * (t_out - 1) + 1:stride]
        yj = torch.matmul(xs, w[:, :, j].float().t())
        y = yj if y is None else y + yj
    return y


def encode(params: Params, cfg: WhisperConfig, mel: torch.Tensor
           ) -> torch.Tensor:
    """mel: (B, n_mels, 3000) -> (B, 1500, d)."""
    x = mel.float().transpose(1, 2)  # (B, T, n_mels), conv over T
    x = F.gelu(_conv3(x, params["enc.conv1.weight"], 1)
               + params["enc.conv1.bias"])
    x = F.gelu(_conv3(x, params["enc.conv2.weight"], 2)
               + params["enc.conv2.bias"])
    x = x + params["enc.pos"][None, :x.shape[1]]
    for i in range(cfg.enc_layers):
        pre = f"enc.{i}."
        x = _attn_block(x, params, pre + "attn", cfg.enc_heads)
        x = _ffn_block(x, params, pre + "ffn")
    return layer_norm(x, params["enc.ln.weight"], params["enc.ln.bias"])


def decode(params: Params, cfg: WhisperConfig, tokens: torch.Tensor,
           enc_out: torch.Tensor, last_only: bool = False) -> torch.Tensor:
    """Full (non-cached) decoder pass: tokens (B, T) -> logits (B, T, V) f32,
    or (B, 1, V) of the last row with last_only."""
    B, T = tokens.shape
    emb = params["dec.tok_embd"]
    x = emb[tokens] + params["dec.pos"][None, :T]
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=tokens.device))[None, None]
    for i in range(cfg.dec_layers):
        pre = f"dec.{i}."
        x = _attn_block(x, params, pre + "attn", cfg.dec_heads, mask=causal)
        x = _attn_block(x, params, pre + "cross", cfg.dec_heads, kv=enc_out)
        x = _ffn_block(x, params, pre + "ffn")
    if last_only:
        x = x[:, -1:]
    x = layer_norm(x, params["dec.ln.weight"], params["dec.ln.bias"])
    return torch.matmul(x.float(), emb.float().t())


def _compression_ratio(text: str) -> float:
    import zlib

    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


# whisper's temperature fallback ladder + quality gates (whisper.cpp
# whisper_full params / openai-whisper transcribe defaults)
FALLBACK_TEMPERATURES = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
COMPRESSION_RATIO_THRESHOLD = 2.4
LOGPROB_THRESHOLD = -1.0
MAX_INITIAL_TS = 50  # 1.0 s at 0.02 s per timestamp token
FRAMES_PER_TS = 2    # mel frames per timestamp unit (100 frames/s, 0.02 s)


class WhisperModel:
    """The model on one device (params already there) and its host-side
    transcription loops."""

    def __init__(self, cfg: WhisperConfig, params: Params, tokenizer=None,
                 device: torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = device or torch.device("cpu")

    def _encode(self, mel: np.ndarray) -> torch.Tensor:
        """(n_mels, 3000) -> the encoder's (1, 1500, d) on the device."""
        with torch.inference_mode():
            return encode(self.params, self.cfg,
                          torch.from_numpy(np.ascontiguousarray(
                              mel[None], np.float32)).to(self.device))

    def _last_logits(self, enc: torch.Tensor, toks: list[int]) -> np.ndarray:
        """The decoder's logits (V,) f32 after the tokens so far."""
        with torch.inference_mode():
            tok = torch.tensor([toks], dtype=torch.int64, device=self.device)
            return decode(self.params, self.cfg, tok, enc,
                          last_only=True)[0, -1].cpu().numpy()

    @property
    def ts_begin(self) -> int:
        return self.cfg.no_timestamps_id + 1

    @property
    def sot_prev_id(self) -> int:
        # <|startofprev|> sits 2 below <|notimestamps|> in both the
        # multilingual and English-only vocab layouts
        return self.cfg.no_timestamps_id - 2

    def _suppress_mask(self, with_timestamps: bool) -> np.ndarray:
        """-inf additive mask for tokens never sampled: specials between eot
        and the timestamp range (sot/lang/task/prev/nospeech), and the
        no-timestamps token when timestamps are on."""
        cfg = self.cfg
        m = np.zeros(cfg.vocab_size, np.float32)
        lo = min(cfg.eot_id + 1, cfg.vocab_size)
        hi = min(cfg.no_timestamps_id + 1, cfg.vocab_size)
        m[lo:hi] = -np.inf
        if not with_timestamps and self.ts_begin < cfg.vocab_size:
            m[self.ts_begin:] = -np.inf
        return m

    def _apply_timestamp_rules(self, logits: np.ndarray,
                               sampled: list[int]) -> np.ndarray:
        """openai-whisper ApplyTimestampRules: timestamps appear in pairs,
        are non-decreasing, and when their total probability beats every
        text token the step must emit a timestamp."""
        cfg = self.cfg
        tb = self.ts_begin
        lg = logits.copy()
        is_ts = [t >= tb for t in sampled]
        if sampled:
            if is_ts[-1] and not (len(sampled) >= 2 and is_ts[-2]):
                # just closed a text run: next is a timestamp or eot
                keep_eot = lg[cfg.eot_id]
                lg[:tb] = -np.inf
                lg[cfg.eot_id] = keep_eot
            elif is_ts[-1] and len(sampled) >= 2 and is_ts[-2]:
                lg[tb:] = -np.inf  # pair complete: text must follow
        ts_seen = [t for t in sampled if t >= tb]
        if ts_seen:
            lg[tb:ts_seen[-1]] = -np.inf  # monotone timestamps
        else:
            lg[tb + MAX_INITIAL_TS + 1:] = -np.inf  # max_initial_timestamp
        # probability-mass rule
        x = lg - lg.max()
        logprobs = x - np.log(np.exp(x).sum())
        ts_mass = np.logaddexp.reduce(logprobs[tb:]) if tb < len(lg) else -np.inf
        max_text = logprobs[:tb].max()
        if ts_mass > max_text:
            lg[:tb] = -np.inf
        return lg

    def _decode_window(self, enc, prompt: list[int], temperature: float,
                       max_tokens: int, with_timestamps: bool,
                       rng: np.random.Generator):
        """One decode pass over an encoded window. Returns
        (generated tokens incl timestamps, avg_logprob, text)."""
        cfg = self.cfg
        toks = list(prompt)
        out: list[int] = []
        sum_lp, n_lp = 0.0, 0
        suppress = self._suppress_mask(with_timestamps)
        for step in range(max_tokens):
            logits = self._last_logits(enc, toks)
            logits = logits + suppress
            if step == 0:  # suppress blank at start (openai suppress_blank)
                if self.tokenizer is not None:
                    for sp_tok in self.tokenizer.encode(" "):
                        if 0 <= sp_tok < len(logits):
                            logits[sp_tok] = -np.inf
            if with_timestamps:
                logits = self._apply_timestamp_rules(logits, out)
            if temperature > 0:
                x = (logits / temperature)
                x = x - x.max()
                p = np.exp(x)
                p /= p.sum()
                nxt = int(rng.choice(len(p), p=p))
            else:
                nxt = int(logits.argmax())
            x = logits - logits.max()
            lp = float(x[nxt] - np.log(np.exp(x).sum()))
            sum_lp += lp
            n_lp += 1
            if nxt == cfg.eot_id or len(toks) >= cfg.n_text_ctx - 1:
                break
            toks.append(nxt)
            out.append(nxt)
        avg_lp = sum_lp / max(n_lp, 1)
        # text = everything below the timestamp range (specials are
        # suppressed, eot never enters `out`)
        text = self._detok([t for t in out if t < self.ts_begin])
        return out, avg_lp, text

    def _detok(self, ids: list[int]) -> str:
        if self.tokenizer is None:
            return " ".join(map(str, ids))
        return self.tokenizer.decode(ids)

    def transcribe_tokens(self, audio: np.ndarray, max_tokens: int = 224,
                          language_id: int | None = None,
                          translate: bool = False) -> list[int]:
        """Single-window greedy decode without timestamps (back-compat API;
        bit-matches the r1 behavior)."""
        cfg = self.cfg
        mel = pad_or_trim_mel(log_mel_spectrogram(audio, cfg.n_mels))
        enc = self._encode(mel)
        prompt = [cfg.sot_id, language_id or cfg.lang_en_id,
                  cfg.translate_id if translate else cfg.transcribe_id,
                  cfg.no_timestamps_id]
        toks = list(prompt)
        out: list[int] = []
        for _ in range(max_tokens):
            nxt = int(self._last_logits(enc, toks).argmax())
            if nxt == cfg.eot_id or len(toks) >= cfg.n_text_ctx - 1:
                break
            toks.append(nxt)
            out.append(nxt)
        return out

    def transcribe_verbose(self, audio: np.ndarray, max_tokens: int = 224,
                           language_id: int | None = None,
                           translate: bool = False,
                           temperatures=FALLBACK_TEMPERATURES,
                           with_timestamps: bool = True,
                           condition_on_previous: bool = True,
                           seed: int = 0) -> dict:
        """Full transcription pipeline (whisper.cpp whisper_full /
        openai-whisper transcribe): 30 s windows advanced by the last decoded
        timestamp, temperature fallback on bad compression-ratio/logprob,
        cross-window conditioning on previous text, per-segment timestamps.

        Returns {"text", "segments": [{"start", "end", "text"}]}.
        """
        cfg = self.cfg
        mel = log_mel_spectrogram(audio, cfg.n_mels)
        total = mel.shape[1]
        tb = self.ts_begin
        seek = 0
        all_text: list[str] = []
        segments: list[dict] = []
        prev_text_tokens: list[int] = []
        rng = np.random.default_rng(seed)
        while seek < total:
            window = pad_or_trim_mel(mel[:, seek:seek + 3000])
            n_frames = min(3000, total - seek)
            enc = self._encode(window)
            base = [cfg.sot_id, language_id or cfg.lang_en_id,
                    cfg.translate_id if translate else cfg.transcribe_id]
            if not with_timestamps:
                base.append(cfg.no_timestamps_id)
            prompt = list(base)
            if condition_on_previous and prev_text_tokens:
                keep = cfg.n_text_ctx // 2 - 1
                prompt = ([self.sot_prev_id] + prev_text_tokens[-keep:] + base)
            out, avg_lp, text = [], -np.inf, ""
            for ti, temp in enumerate(temperatures):
                out, avg_lp, text = self._decode_window(
                    enc, prompt, temp, max_tokens, with_timestamps, rng)
                ok = (_compression_ratio(text) <= COMPRESSION_RATIO_THRESHOLD
                      and avg_lp >= LOGPROB_THRESHOLD)
                if ok or ti == len(temperatures) - 1:
                    break
                # openai also drops the conditioning text when retrying hot
                if temp >= 0.5:
                    prompt = list(base)
            t0 = seek / 100.0  # mel frames at 100/s
            if with_timestamps:
                # split generated stream into [ts, text..., ts] segments
                cur_start = None
                cur: list[int] = []
                last_ts = None
                for t in out:
                    if t >= tb:
                        ts_time = (t - tb) * 0.02
                        last_ts = t
                        if cur_start is None:
                            cur_start = ts_time
                        elif cur:
                            segments.append({
                                "start": round(t0 + cur_start, 2),
                                "end": round(t0 + ts_time, 2),
                                "text": self._detok(cur)})
                            cur = []
                            cur_start = None
                        else:  # consecutive timestamps: new segment start
                            cur_start = ts_time
                    else:
                        cur.append(t)
                if cur:  # trailing text without a closing timestamp
                    segments.append({
                        "start": round(t0 + (cur_start or 0.0), 2),
                        "end": round(t0 + n_frames / 100.0, 2),
                        "text": self._detok(cur)})
                # advance to the last timestamp if the window ended on one,
                # else consume the whole window
                if last_ts is not None and out and out[-1] >= tb:
                    adv = (last_ts - tb) * FRAMES_PER_TS
                else:
                    adv = 3000
                # forward-progress guard (openai seeks a full window when a
                # pass yields no usable timestamps): never advance < 1 s
                seek += min(max(adv, 100), 3000)
            else:
                segments.append({"start": round(t0, 2),
                                 "end": round(t0 + n_frames / 100.0, 2),
                                 "text": text})
                seek += 3000
            text_tokens = [t for t in out if t < self.ts_begin]
            all_text.append(self._detok(text_tokens))
            prev_text_tokens = (prev_text_tokens + text_tokens
                                )[-(cfg.n_text_ctx // 2 - 1):]
        return {"text": "".join(all_text), "segments": segments}

    def transcribe(self, audio: np.ndarray, **kw) -> str:
        """Transcribe; long audio loops 30 s windows with the fallback
        ladder, short audio keeps the fast single-window greedy path."""
        if len(audio) <= CHUNK_SECONDS * SAMPLE_RATE:
            ids = self.transcribe_tokens(audio, **kw)
            return self._detok(ids)
        kw.setdefault("with_timestamps", True)
        return self.transcribe_verbose(audio, **kw)["text"]



def load_whisper(path: str, device: str | torch.device | None = None
                 ) -> WhisperModel:
    """Load from the GGUF container (tools/convert_whisper.py) onto `device`
    (default cuda; raises without a GPU unless device="cpu"), every tensor
    as f32."""
    from ..tokenizers import Tokenizer

    dev = resolve_device(device)
    with GGUFReader(path) as r:
        md = r.metadata
        cfg = WhisperConfig(
            n_mels=int(md.get("whisper.n_mels", 80)),
            d_model=int(md.get("whisper.d_model", 384)),
            enc_layers=int(md.get("whisper.encoder_layers", 4)),
            enc_heads=int(md.get("whisper.encoder_heads", 6)),
            dec_layers=int(md.get("whisper.decoder_layers", 4)),
            dec_heads=int(md.get("whisper.decoder_heads", 6)),
            n_audio_ctx=int(md.get("whisper.n_audio_ctx", 1500)),
            n_text_ctx=int(md.get("whisper.n_text_ctx", 448)),
            vocab_size=int(md.get("whisper.vocab_size", 51865)),
            eot_id=int(md.get("whisper.eot_id", 50257)),
            sot_id=int(md.get("whisper.sot_id", 50258)),
            transcribe_id=int(md.get("whisper.transcribe_id", 50359)),
            translate_id=int(md.get("whisper.translate_id", 50358)),
            no_timestamps_id=int(md.get("whisper.no_timestamps_id", 50363)),
            lang_en_id=int(md.get("whisper.lang_en_id", 50259)),
        )
        params = {name: torch.from_numpy(np.array(
            r.tensor_data(name), np.float32)).to(dev) for name in r.tensors}
        tok = None
        if md.get("tokenizer.ggml.tokens") is not None:
            tok = Tokenizer.from_metadata(md)
    return WhisperModel(cfg, params, tok, dev)
