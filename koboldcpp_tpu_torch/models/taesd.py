"""TAESD: the tiny autoencoder for fast SD latent decode / encode
(--sdtaesd, --sdvaeauto).

Port of koboldcpp_tpu/models/taesd.py (the reference's TinyAutoEncoder,
tae.hpp): 3-conv residual blocks, stride-2 down / nearest-up 2x, the tanh
latent clamp. The state-dict naming follows the public taesd.py
checkpoints ("encoder.N...", "decoder.N...", blocks as "N.conv.{0,2,4}"),
so taesd_encoder / decoder files load directly. NCHW, f32, on an explicit
device (SDModel runs it inside `sd.true_f32()`).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

LATENT_MAGNITUDE = 3.0
LATENT_SHIFT = 0.5


def _conv(x, p, key, stride=1, padding=1):
    return F.conv2d(x, p[key + ".weight"], p.get(key + ".bias"), stride,
                    padding)


def _block(x, p, key):
    """TAEBlock: relu(conv3(relu(conv3(relu(conv3 x)))) + skip)."""
    h = F.relu(_conv(x, p, key + ".conv.0"))
    h = F.relu(_conv(h, p, key + ".conv.2"))
    h = _conv(h, p, key + ".conv.4")
    if key + ".skip.weight" in p:
        x = _conv(x, p, key + ".skip", padding=0)
    return F.relu(h + x)


def _upsample2(x):
    """Nearest-neighbour 2x (torch nn.Upsample's default)."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def decoder_apply(p: dict, z: torch.Tensor) -> torch.Tensor:
    """z: (B, 4, h, w) scaled SD latents -> (B, 3, 8h, 8w) image in [0, 1]
    (about). Sequential indices per taesd.py: 0=Clamp 1=conv 2=ReLU
    3-5=Block 6=Up 7=conv 8-10=Block 11=Up 12=conv 13-15=Block 16=Up
    17=conv 18=Block 19=conv."""
    x = torch.tanh(z / LATENT_MAGNITUDE) * LATENT_MAGNITUDE
    x = F.relu(_conv(x, p, "decoder.1"))
    for i in (3, 4, 5):
        x = _block(x, p, f"decoder.{i}")
    x = _conv(_upsample2(x), p, "decoder.7")
    for i in (8, 9, 10):
        x = _block(x, p, f"decoder.{i}")
    x = _conv(_upsample2(x), p, "decoder.12")
    for i in (13, 14, 15):
        x = _block(x, p, f"decoder.{i}")
    x = _conv(_upsample2(x), p, "decoder.17")
    x = _block(x, p, "decoder.18")
    return _conv(x, p, "decoder.19")


def encoder_apply(p: dict, img: torch.Tensor) -> torch.Tensor:
    """img: (B, 3, H, W) in [0, 1] -> (B, 4, H/8, W/8) scaled latents.
    Indices: 0=conv 1=Block 2=conv/s2 3-5=Block 6=conv/s2 7-9=Block
    10=conv/s2 11-13=Block 14=conv."""
    x = _conv(img, p, "encoder.0")
    x = _block(x, p, "encoder.1")
    x = _conv(x, p, "encoder.2", stride=2)
    for i in (3, 4, 5):
        x = _block(x, p, f"encoder.{i}")
    x = _conv(x, p, "encoder.6", stride=2)
    for i in (7, 8, 9):
        x = _block(x, p, f"encoder.{i}")
    x = _conv(x, p, "encoder.10", stride=2)
    for i in (11, 12, 13):
        x = _block(x, p, f"encoder.{i}")
    return _conv(x, p, "encoder.14")


def scale_latents(x):
    """Raw latents -> [0, 1] (taesd.py scale_latents)."""
    return (x / (2 * LATENT_MAGNITUDE) + LATENT_SHIFT).clamp(0, 1)


def unscale_latents(x):
    return (x - LATENT_SHIFT) * (2 * LATENT_MAGNITUDE)


def load_taesd(path_or_state, device=None) -> dict:
    """TAESD weights from a .safetensors / .pt file or a state dict (numpy
    arrays or tensors), as f32 tensors on `device` (default cuda; raises
    without a GPU unless device="cpu"). Takes combined files
    ("decoder.1.weight") and single-net ones ("1.weight" from
    taesd_decoder.safetensors: prefixed "decoder." when a "1.*" key is
    present, else "encoder.")."""
    if isinstance(path_or_state, dict):
        state = path_or_state
    elif str(path_or_state).endswith(".safetensors"):
        from safetensors.numpy import load_file

        state = load_file(path_or_state)
    else:
        state = torch.load(path_or_state, map_location="cpu",
                           weights_only=True)
    dev = resolve_device(device)
    out = {}
    for k, v in state.items():
        v = torch.as_tensor(np.asarray(v.float() if torch.is_tensor(v) else v,
                                       dtype=np.float32))
        if not (k.startswith("encoder.") or k.startswith("decoder.")):
            prefix = "decoder." if any(
                kk.split(".")[0] == "1" for kk in state) else "encoder."
            k = prefix + k
        out[k] = v.to(dev)
    return out
