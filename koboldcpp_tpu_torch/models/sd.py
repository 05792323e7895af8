"""Stable Diffusion 1.x / 2.x / SDXL in PyTorch: CLIP text towers, UNet, VAE,
the k-diffusion samplers and the txt2img / img2img pipeline.

Port of koboldcpp_tpu/models/sd.py (the reference's stable-diffusion.cpp
fork behind the A1111 API). Plain functions on tensors over a flat param
dict keyed by the diffusers names of tools/convert_sd.py's GGUF, on an
explicit device. The blocks run in NCHW (the JAX module's NHWC permuted):
latents are (B, 4, h, w) and images (B, 3, H, W); `SDModel.txt2img` /
`img2img` return uint8 (H, W, 3) as the JAX ones do.

Precision: everything is f32, as in the JAX package (its GGUF reader
dequantizes every tensor to f32, and no Pallas kernel runs here, so the
port has no kernel either). On the card cuDNN's convolutions take TF32 by
default; `true_f32()` turns TF32 off for convolutions and matmuls around
every SDModel call (the text paths are left as they are), so the card
computes the same f32 function as the CPU. Attention is the plain f32
softmax(Q K^T) V of the JAX `_attn`.

Seeds: the JAX pipeline draws every noise tensor (the initial latents,
img2img's noise, the ancestral samplers' draws) from one host
`np.random.default_rng(seed)` in NHWC shape; the port draws the same
stream in the same order and shapes and moves each draw to the device, so
one seed gives the same image in both packages (seed < 0 stays random).

One departure from the JAX module: its `clip_text_apply` runs quick_gelu
in every tower, where the published OpenCLIP towers (SD 2.x's 1024-wide
OpenCLIP-H and SDXL's bigG, whose diffusers configs name
`hidden_act: "gelu"`, as stable-diffusion.cpp's clip.hpp computes) take
the exact gelu; only OpenAI's CLIP-L (SD 1.x, SDXL's first tower) uses
quick_gelu. The port decides a tower's activation from the config
(`tower_act`: the text2 tower and a 1024-wide text tower take gelu;
ROADMAP §3 pins the JAX module's choice as a fault of the reference).
"""
from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from functools import partial
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..gguf import GGUFReader

Params = dict[str, Any]


@dataclass
class SDConfig:
    # UNet
    in_channels: int = 4
    model_channels: int = 320
    channel_mult: tuple[int, ...] = (1, 2, 4, 4)
    num_res_blocks: int = 2
    attn_levels: tuple[int, ...] = (0, 1, 2)  # levels with cross-attn
    n_heads: int = 8
    context_dim: int = 768
    # CLIP text
    text_vocab: int = 49408
    text_ctx: int = 77
    text_dim: int = 768
    text_layers: int = 12
    text_heads: int = 12
    # SDXL: per-level transformer depth, heads of attn_head_dim, linear
    # projections, the add_embedding and the OpenCLIP-bigG tower
    transformer_depth: tuple[int, ...] = ()  # per level; () = depth 1
    attn_head_dim: int = 0    # XL: heads = channels // 64
    linear_proj: bool = False  # XL use_linear_projection
    add_embed_dim: int = 0    # XL add_embedding in-dim (pooled + 6*256 = 2816)
    pooled_dim: int = 0       # XL pooled text dim (1280)
    text2_dim: int = 0        # OpenCLIP-bigG tower
    text2_layers: int = 0
    text2_heads: int = 0
    # VAE
    vae_ch: int = 128
    vae_ch_mult: tuple[int, ...] = (1, 2, 4, 4)
    latent_channels: int = 4
    scale_factor: float = 0.18215


def tower_act(cfg: SDConfig, prefix: str = "text.") -> str:
    """The activation of a text tower's MLP: exact gelu for the OpenCLIP
    towers (the text2 tower, SDXL's bigG; a 1024-wide text tower, SD 2.x's
    OpenCLIP-H), quick_gelu for OpenAI's CLIP-L."""
    return ("gelu" if prefix == "text2." or cfg.text_dim == 1024
            else "quick_gelu")


@contextlib.contextmanager
def true_f32():
    """TF32 off for cuDNN convolutions and CUDA matmuls inside the block
    (the SD path runs true f32 on the card, as on the CPU)."""
    cudnn = torch.backends.cudnn
    matmul = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul


# ---------------------------------------------------------------------------
# primitive blocks (diffusers tensor naming)
# ---------------------------------------------------------------------------

def group_norm(x, weight, bias, groups=32, eps=1e-5):
    """x: (B, C, H, W); f32 statistics (mean, population variance) over
    each group's C / g channels and H * W positions (a single value at a
    1 x 1 map, which F.group_norm refuses, normalizes to 0)."""
    B, C, H, W = x.shape
    xf = x.float().reshape(B, min(groups, C), -1)
    mean = xf.mean(-1, keepdim=True)
    var = xf.var(-1, unbiased=False, keepdim=True)
    xf = ((xf - mean) * torch.rsqrt(var + eps)).reshape(B, C, H, W)
    return (xf * _chan(weight[None]) + _chan(bias[None])).to(x.dtype)


def conv2d(x, p, name, stride=1, padding=1):
    """The (O, I, kh, kw) weight as stored."""
    return F.conv2d(x, p[name + ".weight"], p[name + ".bias"], stride,
                    padding)


def linear(x, p, name):
    return F.linear(x, p[name + ".weight"], p.get(name + ".bias"))


def timestep_embedding(t, dim):
    half = dim // 2
    freqs = torch.exp(-math.log(10000) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _chan(v):
    """A (B, C) vector broadcast over (B, C, H, W)."""
    return v[:, :, None, None]


def resnet_block(x, temb, p, pre):
    h = group_norm(x, p[pre + "norm1.weight"], p[pre + "norm1.bias"])
    h = conv2d(F.silu(h), p, pre + "conv1")
    if pre + "time_emb_proj.weight" in p:
        h = h + _chan(linear(F.silu(temb), p, pre + "time_emb_proj"))
    h = group_norm(h, p[pre + "norm2.weight"], p[pre + "norm2.bias"])
    h = conv2d(F.silu(h), p, pre + "conv2")
    if pre + "conv_shortcut.weight" in p:
        x = conv2d(x, p, pre + "conv_shortcut", padding=0)
    return x + h


def _attn(q, k, v, n_heads):
    """softmax(Q K^T / sqrt(hd)) V over (B, T, D) rows, f32."""
    B, Tq, D = q.shape
    hd = D // n_heads
    qh = q.reshape(B, Tq, n_heads, hd).transpose(1, 2)
    kh = k.reshape(B, -1, n_heads, hd).transpose(1, 2)
    vh = v.reshape(B, -1, n_heads, hd).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (hd ** -0.5)
    o = torch.matmul(torch.softmax(s, dim=-1), vh)
    return o.transpose(1, 2).reshape(B, Tq, D)


def _ln(x, p, name, eps=1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p[name + ".weight"],
                        p[name + ".bias"], eps).to(x.dtype)


def transformer_block(x, ctx, p, pre, n_heads):
    """diffusers BasicTransformerBlock: self-attn, cross-attn, GEGLU ff."""
    h = _ln(x, p, pre + "norm1")
    h = _attn(linear(h, p, pre + "attn1.to_q"), linear(h, p, pre + "attn1.to_k"),
              linear(h, p, pre + "attn1.to_v"), n_heads)
    x = x + linear(h, p, pre + "attn1.to_out.0")
    h = _ln(x, p, pre + "norm2")
    h = _attn(linear(h, p, pre + "attn2.to_q"), linear(ctx, p, pre + "attn2.to_k"),
              linear(ctx, p, pre + "attn2.to_v"), n_heads)
    x = x + linear(h, p, pre + "attn2.to_out.0")
    h = _ln(x, p, pre + "norm3")
    g, u = linear(h, p, pre + "ff.net.0.proj").chunk(2, dim=-1)
    return x + linear(g * F.gelu(u), p, pre + "ff.net.2")


def spatial_transformer(x, ctx, p, pre, n_heads, depth=1, linear_proj=False):
    B, C, H, W = x.shape
    h = group_norm(x, p[pre + "norm.weight"], p[pre + "norm.bias"])
    if linear_proj:  # SDXL use_linear_projection
        h = linear(h.flatten(2).transpose(1, 2), p, pre + "proj_in")
    else:
        h = conv2d(h, p, pre + "proj_in", padding=0).flatten(2).transpose(1, 2)
    for di in range(depth):
        h = transformer_block(h, ctx, p, pre + f"transformer_blocks.{di}.",
                              n_heads)
    if linear_proj:
        h = linear(h, p, pre + "proj_out").transpose(1, 2).reshape(B, C, H, W)
    else:
        h = conv2d(h.transpose(1, 2).reshape(B, C, H, W), p, pre + "proj_out",
                   padding=0)
    return x + h


def _upsample2(x):
    """Nearest-neighbour 2x."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------

def _st_args(cfg: SDConfig, lvl: int, ch: int):
    depth = cfg.transformer_depth[lvl] if cfg.transformer_depth else 1
    heads = ch // cfg.attn_head_dim if cfg.attn_head_dim else cfg.n_heads
    return dict(n_heads=heads, depth=depth, linear_proj=cfg.linear_proj)


def unet_apply(params: Params, cfg: SDConfig, latents: torch.Tensor,
               t: torch.Tensor, context: torch.Tensor,
               pooled: torch.Tensor | None = None,
               time_ids: torch.Tensor | None = None) -> torch.Tensor:
    """latents: (B, 4, h, w); t: (B,); context: (B, 77, ctx_dim). SDXL adds
    pooled (B, pooled_dim) + time_ids (B, 6) micro-conditioning through
    add_embedding into the time embedding. Returns eps (B, 4, h, w)."""
    p = params
    temb = timestep_embedding(t, cfg.model_channels)
    temb = linear(F.silu(linear(temb, p, "time_embedding.linear_1")),
                  p, "time_embedding.linear_2")
    if cfg.add_embed_dim and pooled is not None:
        B = pooled.shape[0]
        ids_emb = timestep_embedding(time_ids.reshape(-1), 256).reshape(B, -1)
        add = torch.cat([pooled, ids_emb], dim=-1)
        temb = temb + linear(F.silu(linear(add, p, "add_embedding.linear_1")),
                             p, "add_embedding.linear_2")

    h = conv2d(latents, p, "conv_in")
    hs = [h]
    n_levels = len(cfg.channel_mult)
    for lvl in range(n_levels):
        for ri in range(cfg.num_res_blocks):
            h = resnet_block(h, temb, p, f"down_blocks.{lvl}.resnets.{ri}.")
            if lvl in cfg.attn_levels:
                h = spatial_transformer(
                    h, context, p, f"down_blocks.{lvl}.attentions.{ri}.",
                    **_st_args(cfg, lvl, h.shape[1]))
            hs.append(h)
        if lvl < n_levels - 1:
            h = conv2d(h, p, f"down_blocks.{lvl}.downsamplers.0.conv", stride=2)
            hs.append(h)

    h = resnet_block(h, temb, p, "mid_block.resnets.0.")
    h = spatial_transformer(h, context, p, "mid_block.attentions.0.",
                            **_st_args(cfg, n_levels - 1, h.shape[1]))
    h = resnet_block(h, temb, p, "mid_block.resnets.1.")

    for ui, lvl in enumerate(reversed(range(n_levels))):
        for ri in range(cfg.num_res_blocks + 1):
            h = torch.cat([h, hs.pop()], dim=1)
            h = resnet_block(h, temb, p, f"up_blocks.{ui}.resnets.{ri}.")
            if lvl in cfg.attn_levels:
                h = spatial_transformer(
                    h, context, p, f"up_blocks.{ui}.attentions.{ri}.",
                    **_st_args(cfg, lvl, h.shape[1]))
        if lvl > 0:
            h = conv2d(_upsample2(h), p, f"up_blocks.{ui}.upsamplers.0.conv")

    h = group_norm(h, p["conv_norm_out.weight"], p["conv_norm_out.bias"])
    return conv2d(F.silu(h), p, "conv_out")


# ---------------------------------------------------------------------------
# CLIP text encoder (causal)
# ---------------------------------------------------------------------------

def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def clip_text_apply(params: Params, cfg: SDConfig, tokens: torch.Tensor,
                    prefix: str = "text.", n_layers: int | None = None,
                    n_heads: int | None = None, skip_last: int = 0,
                    final_ln: bool = True) -> torch.Tensor:
    """CLIP text tower. prefix selects the tower ("text." / "text2.");
    skip_last=1 returns the penultimate hidden states (SDXL conditioning,
    "clip skip"); final_ln applies the tower's final LayerNorm. The MLP's
    activation is `tower_act(cfg, prefix)`."""
    p = params
    n_layers = (cfg.text_layers if n_layers is None else n_layers) - skip_last
    nh = cfg.text_heads if n_heads is None else n_heads
    act = F.gelu if tower_act(cfg, prefix) == "gelu" else quick_gelu
    T = tokens.shape[1]
    x = p[prefix + "tok_embd"][tokens.long()] + p[prefix + "pos_embd"][None, :T]
    causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
    for i in range(n_layers):
        pre = f"{prefix}{i}."
        h = _ln(x, p, pre + "ln1")
        B, _, D = h.shape
        hd = D // nh
        q, k, v = (linear(h, p, pre + n).reshape(B, T, nh, hd).transpose(1, 2)
                   for n in ("q", "k", "v"))
        s = torch.matmul(q, k.transpose(-1, -2)) * (hd ** -0.5)
        s = torch.where(causal, s, torch.finfo(torch.float32).min)
        o = torch.matmul(torch.softmax(s, dim=-1), v)
        x = x + linear(o.transpose(1, 2).reshape(B, T, D), p, pre + "out")
        h = act(linear(_ln(x, p, pre + "ln2"), p, pre + "fc1"))
        x = x + linear(h, p, pre + "fc2")
    return _ln(x, p, prefix + "ln_final") if final_ln else x


# ---------------------------------------------------------------------------
# VAE
# ---------------------------------------------------------------------------

def vae_attn(x, p, pre):
    B, C, H, W = x.shape
    h = group_norm(x, p[pre + "group_norm.weight"], p[pre + "group_norm.bias"])
    h = h.flatten(2).transpose(1, 2)
    o = _attn(linear(h, p, pre + "to_q"), linear(h, p, pre + "to_k"),
              linear(h, p, pre + "to_v"), 1)
    o = linear(o, p, pre + "to_out.0")
    return x + o.transpose(1, 2).reshape(B, C, H, W)


def vae_encode(params: Params, cfg: SDConfig, img: torch.Tensor,
               noise: torch.Tensor | None = None) -> torch.Tensor:
    """img (B, 3, H, W) in [-1, 1] -> latents (B, 4, H/f, W/f) (img2img):
    the distribution's mean (+ noise * std), times scale_factor."""
    p = params
    h = conv2d(img, p, "vae.encoder.conv_in")
    n_levels = len(cfg.vae_ch_mult)
    for di in range(n_levels):
        for ri in range(2):
            h = resnet_block(h, None, p,
                             f"vae.encoder.down_blocks.{di}.resnets.{ri}.")
        if di < n_levels - 1:
            h = conv2d(h, p, f"vae.encoder.down_blocks.{di}.downsamplers.0.conv",
                       stride=2)
    h = resnet_block(h, None, p, "vae.encoder.mid_block.resnets.0.")
    h = vae_attn(h, p, "vae.encoder.mid_block.attentions.0.")
    h = resnet_block(h, None, p, "vae.encoder.mid_block.resnets.1.")
    h = group_norm(h, p["vae.encoder.conv_norm_out.weight"],
                   p["vae.encoder.conv_norm_out.bias"])
    moments = conv2d(F.silu(h), p, "vae.encoder.conv_out")
    moments = conv2d(moments, p, "vae.quant_conv", padding=0)
    mean, logvar = moments.chunk(2, dim=1)
    if noise is not None:
        mean = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * noise
    return mean * cfg.scale_factor


def vae_decode(params: Params, cfg: SDConfig, z: torch.Tensor) -> torch.Tensor:
    """z: (B, 4, h, w) -> images (B, 3, 8h, 8w) in [-1, 1]."""
    p = params
    h = conv2d(z / cfg.scale_factor, p, "vae.post_quant_conv", padding=0)
    h = conv2d(h, p, "vae.decoder.conv_in")
    h = resnet_block(h, None, p, "vae.decoder.mid_block.resnets.0.")
    h = vae_attn(h, p, "vae.decoder.mid_block.attentions.0.")
    h = resnet_block(h, None, p, "vae.decoder.mid_block.resnets.1.")
    n_levels = len(cfg.vae_ch_mult)
    for ui in range(n_levels):
        for ri in range(3):
            h = resnet_block(h, None, p,
                             f"vae.decoder.up_blocks.{ui}.resnets.{ri}.")
        if ui < n_levels - 1:
            h = conv2d(_upsample2(h), p,
                       f"vae.decoder.up_blocks.{ui}.upsamplers.0.conv")
    h = group_norm(h, p["vae.decoder.conv_norm_out.weight"],
                   p["vae.decoder.conv_norm_out.bias"])
    return conv2d(F.silu(h), p, "vae.decoder.conv_out")


# ---------------------------------------------------------------------------
# schedules + samplers (the reference adapter's name set)
# ---------------------------------------------------------------------------

def linear_beta_schedule(n=1000, beta_start=0.00085, beta_end=0.012):
    betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5, n,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def karras_sigmas(n_steps, sigma_min=0.0292, sigma_max=14.6146, rho=7.0):
    ramp = np.linspace(0, 1, n_steps)
    return ((sigma_max ** (1 / rho) + ramp *
             (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
            ).astype(np.float32)


def noise_like(rng, x: torch.Tensor) -> torch.Tensor:
    """A standard normal draw of x's shape from the numpy stream, drawn in
    the JAX module's NHWC order (B, h, w, C) and moved to x's device as
    NCHW."""
    B, C, H, W = x.shape
    n = rng.standard_normal((B, H, W, C)).astype(np.float32)
    return torch.from_numpy(n).permute(0, 3, 1, 2).to(x.device, x.dtype)


class KDiffusion:
    """k-diffusion wrapper: eps-model over sigma-space with CFG."""

    def __init__(self, denoise_fn, alphas_cum):
        self.fn = denoise_fn
        ac = np.asarray(alphas_cum, np.float64)
        self.sigmas_all = np.sqrt((1 - ac) / ac).astype(np.float32)

    def sigma_to_t(self, sigma):
        return float(np.abs(self.sigmas_all - sigma).argmin())

    def denoise(self, x, sigma, cond, uncond, cfg_scale):
        c_in = 1.0 / math.sqrt(sigma ** 2 + 1)
        t = torch.full((x.shape[0],), int(self.sigma_to_t(sigma)),
                       dtype=torch.int32, device=x.device)
        eps_c = self.fn(x * c_in, t, cond)
        if uncond is not None and cfg_scale != 1.0:
            eps_u = self.fn(x * c_in, t, uncond)
            eps = eps_u + cfg_scale * (eps_c - eps_u)
        else:
            eps = eps_c
        return x - sigma * eps


def sample_euler(kd, x, sigmas, cond, uncond, cfg_scale, rng, ancestral=False):
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        d = (x - denoised) / s
        if ancestral and sn > 0:
            su = min(sn, math.sqrt(sn ** 2 * (s ** 2 - sn ** 2) / s ** 2))
            sd = math.sqrt(max(sn ** 2 - su ** 2, 0.0))
            x = x + d * (sd - s)
            x = x + noise_like(rng, x) * su
        else:
            x = x + d * (sn - s)
    return x


def sample_heun(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        d = (x - denoised) / s
        if sn == 0:
            x = x + d * (sn - s)
        else:
            x2 = x + d * (sn - s)
            denoised2 = kd.denoise(x2, sn, cond, uncond, cfg_scale)
            d2 = (x2 - denoised2) / sn
            x = x + (d + d2) / 2 * (sn - s)
    return x


def sample_dpmpp_2m(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    old_denoised = None
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        t, tn = -math.log(s), -math.log(max(sn, 1e-10))
        h = tn - t
        if old_denoised is None or sn == 0:
            x = (sn / s) * x - (math.exp(-h) - 1) * denoised if sn > 0 else denoised
        else:
            r = (t - (-math.log(s_last))) / h
            dd = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
            x = (sn / s) * x - (math.exp(-h) - 1) * dd
        old_denoised = denoised
        s_last = s
    return x


def sample_dpmpp_2m_v2(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    """Modified DPM++ (2M) "v2": the second-order correction uses r =
    h_max / h_min and a midpoint exp term b = exp(-(h_max + h_min) / 2) - 1
    instead of plain h."""
    old_denoised = None
    s_last = None
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        t, tn = -math.log(s), -math.log(max(sn, 1e-10))
        h = tn - t
        a = sn / s
        if old_denoised is None or sn == 0:
            x = a * x - (math.exp(-h) - 1.0) * denoised
        else:
            h_last = t - (-math.log(s_last))
            h_min, h_max = min(h_last, h), max(h_last, h)
            r = h_max / h_min
            b = math.exp(-(h_max + h_min) / 2.0) - 1.0
            dd = (1 + 1 / (2 * r)) * denoised - (1 / (2 * r)) * old_denoised
            x = a * x - b * dd
        old_denoised = denoised
        s_last = s
    return x


def sample_dpm2(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    """DPM2 (k-diffusion sample_dpm_2): midpoint second-order step."""
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        d = (x - denoised) / s
        if sn == 0:
            x = x + d * (sn - s)
        else:
            s_mid = math.exp(0.5 * (math.log(s) + math.log(sn)))
            x2 = x + d * (s_mid - s)
            denoised2 = kd.denoise(x2, s_mid, cond, uncond, cfg_scale)
            x = x + (x2 - denoised2) / s_mid * (sn - s)
    return x


def sample_dpmpp_2s_a(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    """DPM++ (2s) ancestral (k-diffusion sample_dpmpp_2s_ancestral)."""
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        if sn == 0:
            x = x + (x - denoised) / s * (sn - s)
            continue
        su = min(sn, math.sqrt(sn ** 2 * (s ** 2 - sn ** 2) / s ** 2))
        sd = math.sqrt(max(sn ** 2 - su ** 2, 0.0))
        t, tn = -math.log(s), -math.log(max(sd, 1e-10))
        h = tn - t
        s_mid = math.exp(-(t + h / 2))
        x2 = (s_mid / s) * x - math.expm1(-h / 2) * denoised
        denoised2 = kd.denoise(x2, s_mid, cond, uncond, cfg_scale)
        x = (sd / s) * x - math.expm1(-h) * denoised2
        if su > 0:
            x = x + noise_like(rng, x) * su
    return x


def _ipndm_step(kd, x, s, sn, cond, uncond, cfg_scale, hist, order_cap=4):
    """Adams-Bashforth multistep over d = (x - D) / s (iPNDM)."""
    denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
    hist.append((x - denoised) / s)
    if len(hist) > 4:
        hist.pop(0)
    order = min(len(hist), order_cap)
    if order == 1:
        dd = hist[-1]
    elif order == 2:
        dd = (3 * hist[-1] - hist[-2]) / 2
    elif order == 3:
        dd = (23 * hist[-1] - 16 * hist[-2] + 5 * hist[-3]) / 12
    else:
        dd = (55 * hist[-1] - 59 * hist[-2] + 37 * hist[-3]
              - 9 * hist[-4]) / 24
    return x + dd * (sn - s)


def sample_ipndm(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    hist: list = []
    for i in range(len(sigmas) - 1):
        x = _ipndm_step(kd, x, float(sigmas[i]), float(sigmas[i + 1]),
                        cond, uncond, cfg_scale, hist)
    return x


def sample_ipndm_v(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    """Variable-step iPNDM: the second-order coefficients follow the sigma
    spacing; third order and up take the uniform-step AB3 weights."""
    d_hist: list = []
    h_hist: list = []
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        denoised = kd.denoise(x, s, cond, uncond, cfg_scale)
        h = sn - s
        d_hist.append((x - denoised) / s)
        h_hist.append(h)
        if len(d_hist) > 4:
            d_hist.pop(0)
            h_hist.pop(0)
        order = len(d_hist)
        if order == 1:
            dd = d_hist[-1]
        elif order == 2:
            h0, h1 = h_hist[-1], h_hist[-2]
            r = h1 / h0 if h0 else 1.0
            dd = (1 + 1 / (2 * r)) * d_hist[-1] - (1 / (2 * r)) * d_hist[-2]
        else:
            dd = (23 * d_hist[-1] - 16 * d_hist[-2] + 5 * d_hist[-3]) / 12
        x = x + dd * h
    return x


def sample_lcm(kd, x, sigmas, cond, uncond, cfg_scale, rng):
    """Latent Consistency Model sampler: each step replaces x with the
    denoised prediction, then re-injects fresh noise at the next sigma."""
    for i in range(len(sigmas) - 1):
        s, sn = float(sigmas[i]), float(sigmas[i + 1])
        x = kd.denoise(x, s, cond, uncond, cfg_scale)
        if sn > 0:
            x = x + noise_like(rng, x) * sn
    return x


SAMPLERS = {
    "euler": partial(sample_euler, ancestral=False),
    "euler a": partial(sample_euler, ancestral=True),
    "euler_a": partial(sample_euler, ancestral=True),
    "heun": sample_heun,
    "dpm2": sample_dpm2,
    "dpm++ 2s a": sample_dpmpp_2s_a,
    "dpm++2s_a": sample_dpmpp_2s_a,
    "dpm++ 2m": sample_dpmpp_2m,
    "dpm++2m": sample_dpmpp_2m,
    "dpm++ 2m v2": sample_dpmpp_2m_v2,
    "dpm++2mv2": sample_dpmpp_2m_v2,
    "ipndm": sample_ipndm,
    "ipndm_v": sample_ipndm_v,
    "lcm": sample_lcm,
}


# ---------------------------------------------------------------------------
# pipeline
# ---------------------------------------------------------------------------

class SDModel:
    """The pipeline on one device (params already there)."""

    def __init__(self, cfg: SDConfig, params: Params, tokenizer=None,
                 device: torch.device | str | None = None):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.device = (torch.device(device) if device is not None
                       else next(iter(params.values())).device)
        self.is_xl = cfg.text2_layers > 0
        self.alphas_cum = linear_beta_schedule()
        self.taesd = None  # fast VAE replacement (--sdtaesd)

    def set_taesd(self, path_or_state):
        """Decode through TAESD in place of the VAE (--sdtaesd)."""
        from .taesd import load_taesd

        self.taesd = load_taesd(path_or_state, device=self.device)

    def _tokenize(self, prompt: str) -> tuple[list[int], int]:
        if self.tokenizer is not None:
            ids = self.tokenizer.encode(prompt, add_bos=False)[: self.cfg.text_ctx - 2]
            bos, eos = 49406, 49407
            toks = [bos] + ids + [eos] * (self.cfg.text_ctx - 1 - len(ids))
            eot = 1 + len(ids)
        else:
            toks = [0] * self.cfg.text_ctx
            eot = self.cfg.text_ctx - 1
        return toks, eot

    def encode_prompt(self, prompt: str):
        """(1, 77, context_dim); SDXL: (context, pooled (1, pooled_dim))."""
        toks, eot = self._tokenize(prompt)
        tok = torch.tensor([toks], dtype=torch.int64, device=self.device)
        p, cfg = self.params, self.cfg
        with true_f32(), torch.inference_mode():
            if not self.is_xl:
                return clip_text_apply(p, cfg, tok)
            # SDXL: both towers' penultimate hidden states side by side;
            # pooled from the bigG tower's EOT row through text_projection
            h1 = clip_text_apply(p, cfg, tok, skip_last=1, final_ln=False)
            h2 = clip_text_apply(p, cfg, tok, prefix="text2.",
                                 n_layers=cfg.text2_layers,
                                 n_heads=cfg.text2_heads, skip_last=1,
                                 final_ln=False)
            full2 = clip_text_apply(p, cfg, tok, prefix="text2.",
                                    n_layers=cfg.text2_layers,
                                    n_heads=cfg.text2_heads)
            pooled = full2[:, eot] @ p["text2.projection"].t()
            return torch.cat([h1, h2], dim=-1), pooled

    def _unet(self, x, t, cond, time_ids=None):
        if self.is_xl:
            ctx, pooled = cond
            return unet_apply(self.params, self.cfg, x, t, ctx, pooled,
                              time_ids)
        return unet_apply(self.params, self.cfg, x, t, cond)

    def txt2img(self, prompt: str, negative_prompt: str = "", width: int = 512,
                height: int = 512, steps: int = 20, cfg_scale: float = 7.0,
                sampler: str = "euler a", seed: int = -1,
                init_latents: torch.Tensor | None = None,
                denoise: float = 1.0) -> np.ndarray:
        """A uint8 (H, W, 3) image. init_latents (1, 4, h, w): img2img."""
        with true_f32(), torch.inference_mode():
            return self._generate(prompt, negative_prompt, width, height,
                                  steps, cfg_scale, sampler, seed,
                                  init_latents, denoise)

    def _generate(self, prompt, negative_prompt, width, height, steps,
                  cfg_scale, sampler, seed, init_latents, denoise):
        cfgm = self.cfg
        rng = np.random.default_rng(None if seed < 0 else seed)
        cond = self.encode_prompt(prompt)
        uncond = (self.encode_prompt(negative_prompt) if cfg_scale != 1.0
                  else None)
        if init_latents is not None:
            h, w = init_latents.shape[2], init_latents.shape[3]
        else:
            h, w = height // 8, width // 8
        tids = None
        if self.is_xl:
            # micro-conditioning: (orig_h, orig_w, crop_t, crop_l, tgt_h, tgt_w)
            tids = torch.tensor([[h * 8, w * 8, 0, 0, h * 8, w * 8]],
                                dtype=torch.float32, device=self.device)
        kd = KDiffusion(partial(self._unet, time_ids=tids), self.alphas_cum)
        sigmas = np.append(karras_sigmas(steps), 0.0).astype(np.float32)
        shape = (1, cfgm.latent_channels, h, w)
        if init_latents is not None:  # img2img: start part-way down the ladder
            start = max(0, int(len(sigmas) * (1 - denoise)) - 1)
            sigmas = sigmas[start:]
            x = (init_latents.to(self.device)
                 + noise_like(rng, torch.empty(shape, device=self.device))
                 * float(sigmas[0]))
        else:
            x = (noise_like(rng, torch.empty(shape, device=self.device))
                 * float(sigmas[0]))
        sampler_fn = SAMPLERS.get(sampler.lower(), SAMPLERS["euler a"])
        x = sampler_fn(kd, x, sigmas, cond, uncond, cfg_scale, rng)
        if self.taesd is not None and "decoder.1.weight" in self.taesd:
            from .taesd import decoder_apply

            img = decoder_apply(self.taesd, x)[0]  # [0, 1]
            return _to_uint8(img * 255.0)
        img = vae_decode(self.params, cfgm, x)[0]
        return _to_uint8((img + 1.0) * 127.5)

    def img2img(self, init_image: np.ndarray, prompt: str,
                denoise: float = 0.75, **kw) -> np.ndarray:
        """init_image: uint8 (H, W, 3). The A1111 img2img path."""
        img = torch.from_numpy(init_image.astype(np.float32) / 127.5 - 1.0)
        img = img.permute(2, 0, 1)[None].to(self.device)
        with true_f32(), torch.inference_mode():
            latents = vae_encode(self.params, self.cfg, img)
        return self.txt2img(prompt, init_latents=latents,
                            denoise=max(0.05, min(1.0, denoise)), **kw)


def _to_uint8(img: torch.Tensor) -> np.ndarray:
    """(3, H, W) -> uint8 (H, W, 3), clipped to 0..255 and truncated, as
    numpy's astype does."""
    return img.clamp(0, 255).permute(1, 2, 0).cpu().numpy().astype(np.uint8)


def init_random_sd_params(cfg: SDConfig, seed: int = 0,
                          scale: float = 0.05) -> Params:
    """Random f32 params on the CPU with the exact tensor layout unet_apply
    / clip_text_apply / vae_encode / vae_decode consume, drawn in the JAX
    module's order from np.random.default_rng(seed) (the same weights as
    its `init_random_sd_params`)."""
    rng = np.random.default_rng(seed)
    return _sd_layout(cfg, {}, lambda shape: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)), "cpu")


def _sd_layout(cfg: SDConfig, p: Params, W, device) -> Params:
    """Fill p with every tensor of the layout: W(shape) for the weights
    (in the JAX init's order), ones / zeros for the norms and biases."""
    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)

    def conv(name, o, i, k=3):
        p[name + ".weight"] = W((o, i, k, k))
        p[name + ".bias"] = zeros(o)

    def lin(name, o, i):
        p[name + ".weight"] = W((o, i))
        p[name + ".bias"] = zeros(o)

    def gn(name, c):
        p[name + ".weight"] = torch.ones(c, dtype=torch.float32, device=device)
        p[name + ".bias"] = zeros(c)

    def resnet(pre, i, o, tdim=None):
        gn(pre + "norm1", i)
        conv(pre + "conv1", o, i)
        if tdim:
            lin(pre + "time_emb_proj", o, tdim)
        gn(pre + "norm2", o)
        conv(pre + "conv2", o, o)
        if i != o:
            conv(pre + "conv_shortcut", o, i, k=1)

    def st(pre, ch, lvl=0):
        gn(pre + "norm", ch)
        if cfg.linear_proj:
            lin(pre + "proj_in", ch, ch)
            lin(pre + "proj_out", ch, ch)
        else:
            conv(pre + "proj_in", ch, ch, k=1)
            conv(pre + "proj_out", ch, ch, k=1)
        depth = cfg.transformer_depth[lvl] if cfg.transformer_depth else 1
        for di in range(depth):
            tb = pre + f"transformer_blocks.{di}."
            for n in ("norm1", "norm2", "norm3"):
                gn(tb + n, ch)
            for n in ("attn1.to_q", "attn1.to_k", "attn1.to_v", "attn1.to_out.0"):
                lin(tb + n, ch, ch)
            lin(tb + "attn2.to_q", ch, ch)
            lin(tb + "attn2.to_k", ch, cfg.context_dim)
            lin(tb + "attn2.to_v", ch, cfg.context_dim)
            lin(tb + "attn2.to_out.0", ch, ch)
            lin(tb + "ff.net.0.proj", 8 * ch, ch)
            lin(tb + "ff.net.2", ch, 4 * ch)

    # ---- UNet ----
    mc = cfg.model_channels
    tdim = mc * 4
    lin("time_embedding.linear_1", tdim, mc)
    lin("time_embedding.linear_2", tdim, tdim)
    if cfg.add_embed_dim:  # SDXL micro-conditioning MLP
        lin("add_embedding.linear_1", tdim, cfg.add_embed_dim)
        lin("add_embedding.linear_2", tdim, tdim)
    conv("conv_in", mc, cfg.in_channels)
    chs = [mc]
    ch = mc
    n_levels = len(cfg.channel_mult)
    for lvl, mult in enumerate(cfg.channel_mult):
        out = mc * mult
        for ri in range(cfg.num_res_blocks):
            resnet(f"down_blocks.{lvl}.resnets.{ri}.", ch, out, tdim)
            ch = out
            if lvl in cfg.attn_levels:
                st(f"down_blocks.{lvl}.attentions.{ri}.", ch, lvl)
            chs.append(ch)
        if lvl < n_levels - 1:
            conv(f"down_blocks.{lvl}.downsamplers.0.conv", ch, ch)
            chs.append(ch)
    resnet("mid_block.resnets.0.", ch, ch, tdim)
    st("mid_block.attentions.0.", ch, n_levels - 1)
    resnet("mid_block.resnets.1.", ch, ch, tdim)
    for ui, lvl in enumerate(reversed(range(n_levels))):
        out = mc * cfg.channel_mult[lvl]
        for ri in range(cfg.num_res_blocks + 1):
            skip = chs.pop()
            resnet(f"up_blocks.{ui}.resnets.{ri}.", ch + skip, out, tdim)
            ch = out
            if lvl in cfg.attn_levels:
                st(f"up_blocks.{ui}.attentions.{ri}.", ch, lvl)
        if lvl > 0:
            conv(f"up_blocks.{ui}.upsamplers.0.conv", ch, ch)
    gn("conv_norm_out", ch)
    conv("conv_out", cfg.in_channels, ch)

    # ---- text encoders ----
    def tower(prefix, d, n_layers):
        p[prefix + "tok_embd"] = W((cfg.text_vocab, d))
        p[prefix + "pos_embd"] = W((cfg.text_ctx, d))
        for i in range(n_layers):
            pre = f"{prefix}{i}."
            gn(pre + "ln1", d)
            gn(pre + "ln2", d)
            for n in ("q", "k", "v", "out"):
                lin(pre + n, d, d)
            lin(pre + "fc1", 4 * d, d)
            lin(pre + "fc2", d, 4 * d)
        gn(prefix + "ln_final", d)

    tower("text.", cfg.text_dim, cfg.text_layers)
    if cfg.text2_layers:  # SDXL bigG tower + projection
        tower("text2.", cfg.text2_dim, cfg.text2_layers)
        p["text2.projection"] = W((cfg.pooled_dim or cfg.text2_dim,
                                   cfg.text2_dim))

    # ---- VAE encoder ----
    vch = cfg.vae_ch
    ch = vch * cfg.vae_ch_mult[0]
    conv("vae.encoder.conv_in", ch, 3)
    for di, mult in enumerate(cfg.vae_ch_mult):
        out = vch * mult
        for ri in range(2):
            resnet(f"vae.encoder.down_blocks.{di}.resnets.{ri}.", ch, out)
            ch = out
        if di < len(cfg.vae_ch_mult) - 1:
            conv(f"vae.encoder.down_blocks.{di}.downsamplers.0.conv", ch, ch)
    resnet("vae.encoder.mid_block.resnets.0.", ch, ch)
    gn("vae.encoder.mid_block.attentions.0.group_norm", ch)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        lin(f"vae.encoder.mid_block.attentions.0.{n}", ch, ch)
    resnet("vae.encoder.mid_block.resnets.1.", ch, ch)
    gn("vae.encoder.conv_norm_out", ch)
    conv("vae.encoder.conv_out", 2 * cfg.latent_channels, ch)
    conv("vae.quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)

    # ---- VAE decoder ----
    rev = list(reversed(cfg.vae_ch_mult))
    top = vch * rev[0]
    conv("vae.post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    conv("vae.decoder.conv_in", top, cfg.latent_channels)
    resnet("vae.decoder.mid_block.resnets.0.", top, top)
    gn("vae.decoder.mid_block.attentions.0.group_norm", top)
    for n in ("to_q", "to_k", "to_v", "to_out.0"):
        lin(f"vae.decoder.mid_block.attentions.0.{n}", top, top)
    resnet("vae.decoder.mid_block.resnets.1.", top, top)
    ch = top
    for ui in range(len(rev)):
        out = vch * rev[ui]
        for ri in range(3):
            resnet(f"vae.decoder.up_blocks.{ui}.resnets.{ri}.", ch, out)
            ch = out
        if ui < len(rev) - 1:
            conv(f"vae.decoder.up_blocks.{ui}.upsamplers.0.conv", ch, ch)
    gn("vae.decoder.conv_norm_out", ch)
    conv("vae.decoder.conv_out", 3, ch)
    return p


def apply_sd_lora(params: Params, path: str, multiplier: float = 1.0) -> int:
    """Merge a GGUF SD-LoRA adapter (tools/convert_sd_lora.py) into the flat
    SD params in place: W += mult * (alpha / r) * B @ A (the product in
    numpy f32, as the JAX module forms it). Returns the number of tensors
    patched."""
    with GGUFReader(path) as r:
        md = r.metadata
        if str(md.get("general.type", "")) != "adapter" or str(
                md.get("adapter.type", "")) != "lora":
            raise ValueError(f"{path} is not a LoRA adapter GGUF")
        a = md.get("adapter.lora.alpha", 0.0)
        alpha = float(a.item() if hasattr(a, "item") else a or 0.0)
        pairs: dict[str, dict[str, np.ndarray]] = {}
        for name in r.tensors:
            if name.endswith(".lora_a"):
                pairs.setdefault(name[:-7], {})["a"] = np.asarray(
                    r.tensor_data(name), np.float32)
            elif name.endswith(".lora_b"):
                pairs.setdefault(name[:-7], {})["b"] = np.asarray(
                    r.tensor_data(name), np.float32)
    n = 0
    for base, pr in pairs.items():
        if base not in params:
            continue
        A, B = pr["a"], pr["b"]
        scale = multiplier * (alpha / A.shape[0] if alpha else 1.0)
        delta = scale * (B @ A)
        w = params[base]
        if delta.shape != tuple(w.shape):
            raise ValueError(
                f"LoRA delta shape {delta.shape} != {tuple(w.shape)} for {base}")
        params[base] = (w.float() + torch.from_numpy(delta).to(w.device)
                        ).to(w.dtype)
        n += 1
    return n


def load_sd_vae(params: Params, vae_path: str) -> int:
    """Replace the model's VAE weights with a standalone VAE file (--sdvae):
    a GGUF from tools/convert_sd.py (tensors already under "vae.") or a
    diffusers-layout .safetensors. Returns the tensors replaced."""
    new: dict[str, np.ndarray] = {}
    if vae_path.endswith(".safetensors"):
        from safetensors.numpy import load_file
        for name, arr in load_file(vae_path).items():
            new[name if name.startswith("vae.") else "vae." + name] = arr
    else:
        with GGUFReader(vae_path) as r:
            for name in r.tensors:
                key = name if name.startswith("vae.") else "vae." + name
                new[key] = r.tensor_data(name)
    n = 0
    unmatched = []
    for key, arr in new.items():
        if key in params:
            if tuple(params[key].shape) != tuple(arr.shape):
                raise ValueError(f"--sdvae tensor {key} shape {arr.shape} != "
                                 f"model {tuple(params[key].shape)}")
            params[key] = torch.from_numpy(np.array(arr, np.float32)).to(
                params[key].device)
            n += 1
        else:
            unmatched.append(key)
    if n == 0:
        raise ValueError(f"--sdvae {vae_path}: no vae.* tensors matched the model")
    if unmatched:
        # a wrong-architecture VAE with partial key overlap would otherwise be
        # half-applied silently
        if len(unmatched) > n:
            raise ValueError(
                f"--sdvae {vae_path}: {len(unmatched)} of {len(new)} tensors "
                f"have no counterpart in the model (e.g. {unmatched[0]}) — "
                "wrong VAE architecture?")
        print(f"[sdvae] warning: {len(unmatched)} of {len(new)} VAE tensors "
              f"not present in the model were skipped (e.g. {unmatched[0]})")
    return n


def config_from_metadata(md: dict) -> SDConfig:
    def ints(key, default):
        return tuple(int(x) for x in np.asarray(md.get(key, default)))

    return SDConfig(
        model_channels=int(md.get("sd.unet.model_channels", 320)),
        num_res_blocks=int(md.get("sd.unet.res_blocks", 2)),
        n_heads=int(md.get("sd.unet.heads", 8)),
        context_dim=int(md.get("sd.context_dim", 768)),
        text_layers=int(md.get("sd.text.layers", 12)),
        text_heads=int(md.get("sd.text.heads", 12)),
        text_dim=int(md.get("sd.text.dim", 768)),
        vae_ch=int(md.get("sd.vae.ch", 128)),
        text_vocab=int(md.get("sd.text.vocab", 49408)),
        text_ctx=int(md.get("sd.text.ctx", 77)),
        latent_channels=int(md.get("sd.latent_channels", 4)),
        vae_ch_mult=ints("sd.vae.ch_mult", [1, 2, 4, 4]),
        transformer_depth=ints("sd.unet.transformer_depth", []),
        attn_head_dim=int(md.get("sd.unet.attn_head_dim", 0)),
        linear_proj=bool(md.get("sd.unet.linear_proj", False)),
        add_embed_dim=int(md.get("sd.unet.add_embed_dim", 0)),
        pooled_dim=int(md.get("sd.text2.pooled_dim", 0)),
        text2_dim=int(md.get("sd.text2.dim", 0)),
        text2_layers=int(md.get("sd.text2.layers", 0)),
        text2_heads=int(md.get("sd.text2.heads", 0)),
        channel_mult=ints("sd.unet.channel_mult", [1, 2, 4, 4]),
        attn_levels=ints("sd.unet.attn_levels", [0, 1, 2]),
    )


def load_sd(path: str, loras: list[tuple[str, float]] | None = None,
            vae_path: str | None = None,
            device: str | torch.device | None = None) -> SDModel:
    """Load an SD GGUF (tools/convert_sd.py) onto `device` (default cuda;
    raises without a GPU unless device="cpu"), every tensor as f32, then
    the --sdvae override and the --sdlora merges."""
    from ..tokenizers import Tokenizer

    dev = resolve_device(device)
    with GGUFReader(path) as r:
        md = r.metadata
        cfg = config_from_metadata(md)
        params = {name: torch.from_numpy(np.array(
            r.tensor_data(name), np.float32)).to(dev) for name in r.tensors}
        tok = None
        if md.get("tokenizer.ggml.tokens") is not None:
            tok = Tokenizer.from_metadata(md)
    if vae_path:
        n = load_sd_vae(params, vae_path)
        print(f"SD VAE {vae_path}: replaced {n} tensors")
    for lp, mult in (loras or []):
        n = apply_sd_lora(params, lp, mult)
        print(f"SD LoRA {lp}: merged {n} tensors (x{mult})")
    return SDModel(cfg, params, tok, dev)
