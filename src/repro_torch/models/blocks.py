"""Residual blocks (counterpart of the reference's ``models/blocks.py``).

This slice ports the global-attention kind (``MIX_ATTN``); the other mixer
kinds raise ``NotImplementedError`` naming their ROADMAP item.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config.model import MIX_ATTN, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import mlp as mlp_mod
from repro_torch.models.common import init_rmsnorm, rms_norm


def _check_kind(kind: str) -> None:
    if kind != MIX_ATTN:
        raise NotImplementedError(
            f"mixer kind {kind!r} is not ported yet (ROADMAP Q7/Q9)")


def init_block(gen: torch.Generator, kind: str, cfg: ModelConfig,
               dtype: torch.dtype, device: Optional[torch.device] = None
               ) -> dict:
    _check_kind(kind)
    return {"norm1": init_rmsnorm(cfg.d_model, dtype, device),
            "norm2": init_rmsnorm(cfg.d_model, dtype, device),
            "mixer": attn_mod.init_attention(gen, cfg, dtype, device),
            "mlp": mlp_mod.init_mlp(gen, cfg, dtype, device)}


def init_block_state(kind: str, cfg: ModelConfig, batch: int, capacity: int,
                     dtype: torch.dtype, device: Optional[torch.device] = None
                     ) -> dict:
    """Decode-time state for one block: its KV cache."""
    _check_kind(kind)
    return {"cache": attn_mod.init_cache(cfg, batch, capacity, dtype, device)}


def apply_block(
    params: dict,
    kind: str,
    x: torch.Tensor,                     # (B, S, D)
    positions: torch.Tensor,             # (B, S)
    cfg: ModelConfig,
    *,
    state: Optional[dict] = None,
    page_table: Optional[torch.Tensor] = None,   # (B, M) paged-KV table
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (x_out, state).  The state's cache is updated in place."""
    _check_kind(kind)
    h = rms_norm(x, params["norm1"], cfg.norm_eps)
    cache = None if state is None else state["cache"]
    out, _ = attn_mod.self_attention(
        params["mixer"], h, positions, cfg, cache=cache,
        page_table=page_table, use_kernel=use_kernel)
    x = x + out
    h2 = rms_norm(x, params["norm2"], cfg.norm_eps)
    return x + mlp_mod.apply_mlp(params["mlp"], h2, cfg), state
