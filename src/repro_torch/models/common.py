"""Shared model building blocks: device and dtype helpers, initializers,
RMSNorm and RoPE (counterpart of the reference's ``models/common.py``).

Numerics follow the reference exactly: RMSNorm runs in f32 whatever the
input dtype, RoPE uses the half-split rotation with f32 angles.
"""
from __future__ import annotations

from typing import Optional, Sequence, Union

import torch

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """The port's device rule: ``None`` means the card.  Asking for CUDA on
    a machine without one raises; nothing quietly falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: repro_torch entry points run on the "
            "GPU unless the caller passes device='cpu'")
    return dev


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def normal_init(gen: torch.Generator, shape: Sequence[int], dtype: torch.dtype,
                scale: float = 0.02, fan_in: int = 0,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Normal weights drawn in f32 from ``gen``, cast to ``dtype``."""
    if fan_in:
        scale = fan_in ** -0.5
    x = torch.randn(tuple(shape), generator=gen, dtype=torch.float32,
                    device=device)
    return (scale * x).to(dtype)


def init_rmsnorm(d: int, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> dict:
    return {"scale": torch.ones(d, dtype=dtype, device=device)}


def rms_norm(x: torch.Tensor, params: dict, eps: float = 1e-6) -> torch.Tensor:
    """Computed in f32 regardless of input dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (..., S, H, N) with positions (..., S)."""
    n = x.shape[-1]
    half = n // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    freqs = torch.pow(theta, exps)      # a Python base: no host->device copy
    angles = positions[..., None].float() * freqs       # (..., S, half)
    cos = torch.cos(angles)[..., None, :]               # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)
