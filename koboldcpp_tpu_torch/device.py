"""Device resolution: the port runs on CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import subprocess

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """None -> cuda:0, raising when no GPU is present (no silent CPU fallback).
    An explicit "cpu" (as the tests pass) runs the plain PyTorch versions."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_info() -> str:
    """The card's name and power limit, as `nvidia-smi` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=30)
    return out.stdout.strip().splitlines()[0]
