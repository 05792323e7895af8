"""CLIP ViT vision encoder + LLaVA projector in PyTorch.

Port of koboldcpp_tpu/models/clip.py (the reference's clip.cpp / llava.cpp):
encodes an image into `n_patches` embedding rows in the LLM's hidden space,
which the engines splice into the token stream after BOS. Loads mmproj GGUF
files in clip.cpp's tensor naming (v.blk.*, mm.*), every tensor as f32 on
the engine's device.

Everything is f32, as in the JAX module (its einsums run outside any Pallas
kernel, so the port has no kernel here either): the products are
`torch.matmul` in f32, and the stride-P patch convolution with kernel P is
a reshape plus one such product (cuDNN's convolution would take TF32 on the
card by default).

One departure from the JAX module: `preprocess_image` resizes to the
model's own `image_size` (clip.cpp's rule), where the JAX one always takes
336 px and so cannot serve an mmproj of another size (ROADMAP §3).
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

# CLIP's standard preprocessing constants
IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclass
class ClipVisionConfig:
    image_size: int = 336
    patch_size: int = 14
    hidden_size: int = 1024
    n_layers: int = 24
    n_heads: int = 16
    intermediate_size: int = 4096
    projection_dim: int = 4096  # LLM hidden size
    eps: float = 1e-5
    select_layer: int = -2  # llava uses the penultimate layer's patches

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def n_run(self) -> int:
        """Blocks that run: up to the selected layer."""
        return (self.n_layers + self.select_layer + 1 if self.select_layer < 0
                else self.n_layers)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def _lin(x: torch.Tensor, p: Params, name: str) -> torch.Tensor:
    y = torch.matmul(x.float(), p[name + ".weight"].float().t()).to(x.dtype)
    if name + ".bias" in p:
        y = y + p[name + ".bias"].to(y.dtype)
    return y


def _attn(x: torch.Tensor, p: Params, prefix: str, n_heads: int
          ) -> torch.Tensor:
    B, T, D = x.shape
    hd = D // n_heads
    q, k, v = (_lin(x, p, prefix + n).view(B, T, n_heads, hd).transpose(1, 2)
               for n in ("attn_q", "attn_k", "attn_v"))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * hd ** -0.5
    a = torch.softmax(scores, dim=-1).to(x.dtype)
    out = torch.matmul(a.float(), v.float()).transpose(1, 2).reshape(B, T, D)
    return _lin(out.to(x.dtype), p, prefix + "attn_out")


def patch_embed(params: Params, cfg: ClipVisionConfig,
                pixels: torch.Tensor) -> torch.Tensor:
    """The VALID stride-P convolution with kernel P: (B, 3, H, W) ->
    (B, gh * gw, hidden), each patch's 3 * P * P pixels (channel, row,
    column order, the kernel's) times the flattened kernel."""
    B, C, H, W = pixels.shape
    P = cfg.patch_size
    gh, gw = H // P, W // P
    x = pixels[:, :, :gh * P, :gw * P].reshape(B, C, gh, P, gw, P)
    x = x.permute(0, 2, 4, 1, 3, 5).reshape(B, gh * gw, C * P * P)
    w = params["v.patch_embd.weight"]  # (hidden, 3, P, P)
    return torch.matmul(x.float(), w.reshape(w.shape[0], -1).float().t())


def encode_image_features(params: Params, cfg: ClipVisionConfig,
                          pixels: torch.Tensor) -> torch.Tensor:
    """pixels: (B, 3, H, W) normalized. Returns (B, n_patches, hidden) from
    the selected layer (class token dropped, llava convention)."""
    B = pixels.shape[0]
    h = patch_embed(params, cfg, pixels)
    cls = params["v.class_embd"].to(h.dtype).expand(B, 1, cfg.hidden_size)
    x = torch.cat([cls, h], dim=1)
    x = x + params["v.position_embd.weight"][None, :x.shape[1]].to(x.dtype)
    x = layer_norm(x, params["v.pre_ln.weight"], params["v.pre_ln.bias"],
                   cfg.eps)
    for i in range(cfg.n_run):
        pre = f"v.blk.{i}."
        r = x
        x = layer_norm(x, params[pre + "ln1.weight"], params[pre + "ln1.bias"],
                       cfg.eps)
        x = r + _attn(x, params, pre, cfg.n_heads)
        r = x
        x = layer_norm(x, params[pre + "ln2.weight"], params[pre + "ln2.bias"],
                       cfg.eps)
        x = quick_gelu(_lin(x, params, pre + "ffn_up"))
        x = r + _lin(x, params, pre + "ffn_down")
    return x[:, 1:]  # drop the class token


def project(params: Params, feats: torch.Tensor) -> torch.Tensor:
    """LLaVA MLP projector: (B, n_patches, vision_hidden) -> (...,
    llm_hidden): mm.0, exact gelu, mm.2."""
    x = _lin(feats, params, "mm.0")
    x = F.gelu(x.float()).to(feats.dtype)
    return _lin(x, params, "mm.2")


def preprocess_image(img, size: int = 336) -> np.ndarray:
    """PIL image -> normalized (3, size, size) float32 (CLIP bicubic
    resize to the model's image_size)."""
    from PIL import Image

    img = img.convert("RGB").resize((size, size), Image.BICUBIC)
    x = np.asarray(img, np.float32) / 255.0
    x = (x - IMAGE_MEAN) / IMAGE_STD
    return x.transpose(2, 0, 1)


def decode_image_base64(b64: str, size: int = 336) -> np.ndarray:
    """A base64 image (a data: URL prefix is dropped) -> preprocess_image."""
    import base64
    import io

    from PIL import Image

    raw = base64.b64decode(b64.split(",")[-1])
    return preprocess_image(Image.open(io.BytesIO(raw)), size)


class ClipModel:
    """The vision tower and projector on one device (params already
    there)."""

    def __init__(self, cfg: ClipVisionConfig, params: Params,
                 device: torch.device):
        self.cfg = cfg
        self.params = params
        self.device = device

    def image_embed(self, pixels: np.ndarray) -> torch.Tensor:
        """(3, S, S) or (B, 3, S, S) -> (B, n_patches, llm_hidden) f32 on the
        model's device."""
        x = torch.as_tensor(np.asarray(pixels, np.float32))
        if x.dim() == 3:
            x = x[None]
        with torch.inference_mode():
            x = x.to(self.device)
            return project(self.params,
                           encode_image_features(self.params, self.cfg, x))

    def embed_base64(self, b64: str) -> torch.Tensor:
        """One base64 image at the model's size -> (n_patches, llm_hidden)."""
        return self.image_embed(decode_image_base64(
            b64, self.cfg.image_size))[0]


def config_from_metadata(md: dict) -> ClipVisionConfig:
    return ClipVisionConfig(
        image_size=int(md.get("clip.vision.image_size", 336)),
        patch_size=int(md.get("clip.vision.patch_size", 14)),
        hidden_size=int(md.get("clip.vision.embedding_length", 1024)),
        n_layers=int(md.get("clip.vision.block_count", 24)),
        n_heads=int(md.get("clip.vision.attention.head_count", 16)),
        intermediate_size=int(md.get("clip.vision.feed_forward_length", 4096)),
        eps=float(md.get("clip.vision.attention.layer_norm_epsilon", 1e-5)),
    )


def load_clip(path: str, device: str | torch.device | None = None
              ) -> ClipModel:
    """Load an mmproj GGUF (clip.cpp naming) onto `device` (default cuda;
    raises without a GPU unless device="cpu"), every tensor as f32."""
    dev = resolve_device(device)
    with GGUFReader(path) as r:
        cfg = config_from_metadata(r.metadata)
        params = {name: torch.from_numpy(np.array(
            r.tensor_data(name), np.float32)).to(dev) for name in r.tensors}
    if "v.class_embd" in params:
        params["v.class_embd"] = params["v.class_embd"].reshape(-1)
    return ClipModel(cfg, params, dev)
