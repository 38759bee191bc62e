"""Plain PyTorch paged attention: the versions the CUDA kernels are held
against, and the path CPU tensors take (counterpart of the reference's
``kernels/paged_attention/ref.py``).

  q        (B, J, G, N)    one query token per row, pre-scaled
  kp, vp   (P, page, J, N) physical page pool (page 0 = scratch)
  table    (B, M)          block table: logical page -> physical page
  lengths  (B,)            valid entries per row (current pos + 1)

It gathers each row's logical (M*page) view, masks ``t < length`` and runs
the same direct ``attend`` as the dense-cache path.  The int8 variant takes
int8 pools with their (P, page, J) f32 scales and dequantizes the gathered
view first.
"""
from __future__ import annotations

import torch

from repro_torch.models.attention import attend, kv_dequantize


def paged_attention_ref(
    q: torch.Tensor,          # (B, J, G, N)
    kp: torch.Tensor,         # (P, page, J, N)
    vp: torch.Tensor,         # (P, page, J, N)
    table: torch.Tensor,      # (B, M) int32
    lengths: torch.Tensor,    # (B,) int32
    *,
    cap: float = 0.0,
) -> torch.Tensor:            # (B, J, G, N)
    B, M = table.shape
    page = kp.shape[1]
    T = M * page
    kg = kp[table].reshape(B, T, *kp.shape[2:])
    vg = vp[table].reshape(B, T, *vp.shape[2:])
    t = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.where(t < lengths[:, None], t, -1)
    q_pos = (lengths[:, None] - 1).to(torch.int32)
    return attend(q[:, None], kg, vg, q_pos, k_pos, cap=cap)[:, 0]


def paged_attention_quant_ref(
    q: torch.Tensor,          # (B, J, G, N)
    kp: torch.Tensor,         # (P, page, J, N) int8
    vp: torch.Tensor,         # (P, page, J, N) int8
    ksc: torch.Tensor,        # (P, page, J) f32
    vsc: torch.Tensor,        # (P, page, J) f32
    table: torch.Tensor,      # (B, M) int32
    lengths: torch.Tensor,    # (B,) int32
    *,
    cap: float = 0.0,
) -> torch.Tensor:            # (B, J, G, N)
    """Gather int8 pages and scales through the block table, dequantize
    to f32, cast to ``q``'s dtype (as the reference does) and ``attend``."""
    B, M = table.shape
    page = kp.shape[1]
    T = M * page
    kg = kv_dequantize(kp[table].reshape(B, T, *kp.shape[2:]),
                       ksc[table].reshape(B, T, *ksc.shape[2:]))
    vg = kv_dequantize(vp[table].reshape(B, T, *vp.shape[2:]),
                       vsc[table].reshape(B, T, *vsc.shape[2:]))
    t = torch.arange(T, dtype=torch.int32, device=q.device)[None, :]
    k_pos = torch.where(t < lengths[:, None], t, -1)
    q_pos = (lengths[:, None] - 1).to(torch.int32)
    return attend(q[:, None], kg.to(q.dtype), vg.to(q.dtype), q_pos, k_pos,
                  cap=cap)[:, 0]
