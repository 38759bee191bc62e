"""MLP: the SwiGLU dense kind (counterpart of the reference's
``models/mlp.py``; GeGLU/GELU wait in ROADMAP Q11, MoE in Q8 and the RWKV
channel mix in Q7)."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config.model import ModelConfig
from repro_torch.models.common import normal_init


def _check_kind(cfg: ModelConfig) -> None:
    if cfg.num_experts:
        raise NotImplementedError("MoE MLPs are not ported yet (ROADMAP Q8)")
    if cfg.mlp_kind != "swiglu":
        raise NotImplementedError(
            f"mlp_kind={cfg.mlp_kind!r} is not ported yet (ROADMAP Q7/Q11)")


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device: Optional[torch.device] = None) -> dict:
    _check_kind(cfg)
    d, f = cfg.d_model, cfg.d_ff
    return {
        "wi": normal_init(gen, (d, f), dtype, fan_in=d, device=device),
        "wg": normal_init(gen, (d, f), dtype, fan_in=d, device=device),
        "wo": normal_init(gen, (f, d), dtype, fan_in=f, device=device),
    }


def apply_mlp(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    _check_kind(cfg)
    h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    return h @ params["wo"]
