"""Paged decode attention: the wrappers the model calls, one for pools in
q's dtype (kernel K1) and one for int8 pools with f32 scales (K2).

A CUDA tensor goes to the hand-written kernel (``kernel.py``) or raises: a
shape outside ``supported()`` / ``supported_quant()`` is a ``ValueError``
naming the shape, never a quiet detour.  A CPU tensor takes the plain
version (``ref.py``), which is what the tests on machines without a card
run.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.paged_attention.kernel import (
    MAX_G, MAX_N, paged_attention_cuda, paged_attention_quant_cuda)
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_quant_ref, paged_attention_ref)

# Kernel launches made through ``paged_attention`` (K1) and
# ``paged_attention_quant`` (K2); plain-version calls on CPU tensors do not
# count.  A run that wants to show its path went through a kernel resets
# these to 0 before the run and reads them after.
launches = 0
quant_launches = 0


def supported(q: torch.Tensor, kp: torch.Tensor, *, cap: float = 0.0) -> bool:
    """Shapes and types the kernel takes; never wider than the reference's
    gate (no softcap, ``N % 8 == 0``, ``page % 8 == 0``)."""
    if cap and cap > 0.0:
        return False
    if q.ndim != 4 or kp.ndim != 4:
        return False
    _, J, G, N = q.shape
    _, page, Jk, Nk = kp.shape
    return (N % 8 == 0 and page % 8 == 0 and Jk == J and Nk == N
            and N <= MAX_N and G <= MAX_G
            and q.dtype in (torch.float32, torch.bfloat16)
            and kp.dtype == q.dtype)


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    table: torch.Tensor, lengths: torch.Tensor, *,
                    cap: float = 0.0) -> torch.Tensor:
    """q (B,J,G,N) pre-scaled; pool (P,page,J,N); table (B,M) int32;
    lengths (B,) int32 -> (B,J,G,N) in q's dtype."""
    global launches
    if q.device.type == "cpu":
        return paged_attention_ref(q, kp, vp, table, lengths, cap=cap)
    if not supported(q, kp, cap=cap):
        raise ValueError(
            f"paged_attention kernel does not take q {tuple(q.shape)} "
            f"{q.dtype} with pool {tuple(kp.shape)} {kp.dtype} and "
            f"cap={cap} (needs cap 0, N % 8 == 0, page % 8 == 0, "
            f"N <= {MAX_N}, G <= {MAX_G}, f32 or bf16)")
    out = paged_attention_cuda(q, kp, vp, table, lengths)
    launches += 1
    return out


def supported_quant(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    ksc: torch.Tensor, vsc: torch.Tensor, *,
                    cap: float = 0.0) -> bool:
    """What the int8-pool kernel takes: the reference's gate (no softcap,
    ``N % 8 == 0``, ``page % 8 == 0``), plus int8 ``kp``/``vp``, f32
    ``ksc``/``vsc`` of shape (P, page, J), and q in f32 or bf16."""
    if cap and cap > 0.0:
        return False
    if q.ndim != 4 or kp.ndim != 4:
        return False
    _, J, G, N = q.shape
    _, page, Jk, Nk = kp.shape
    return (N % 8 == 0 and page % 8 == 0 and Jk == J and Nk == N
            and N <= MAX_N and G <= MAX_G
            and q.dtype in (torch.float32, torch.bfloat16)
            and kp.dtype == torch.int8 and vp.dtype == torch.int8
            and vp.shape == kp.shape
            and ksc.dtype == torch.float32 and vsc.dtype == torch.float32
            and ksc.shape == kp.shape[:3] and vsc.shape == kp.shape[:3])


def paged_attention_quant(q: torch.Tensor, kp: torch.Tensor,
                          vp: torch.Tensor, ksc: torch.Tensor,
                          vsc: torch.Tensor, table: torch.Tensor,
                          lengths: torch.Tensor, *,
                          cap: float = 0.0) -> torch.Tensor:
    """q (B,J,G,N) pre-scaled; int8 pool (P,page,J,N) with f32 scales
    (P,page,J); table (B,M) int32; lengths (B,) int32 -> (B,J,G,N) in q's
    dtype."""
    global quant_launches
    if q.device.type == "cpu":
        return paged_attention_quant_ref(q, kp, vp, ksc, vsc, table,
                                         lengths, cap=cap)
    if not supported_quant(q, kp, vp, ksc, vsc, cap=cap):
        raise ValueError(
            f"paged_attention_quant kernel does not take q "
            f"{tuple(q.shape)} {q.dtype} with pool {tuple(kp.shape)} "
            f"{kp.dtype}, scales {tuple(ksc.shape)} {ksc.dtype} and "
            f"cap={cap} (needs cap 0, N % 8 == 0, page % 8 == 0, "
            f"N <= {MAX_N}, G <= {MAX_G}, f32 or bf16 q, int8 pools, f32 "
            "(P, page, J) scales)")
    out = paged_attention_quant_cuda(q, kp, vp, ksc, vsc, table, lengths)
    quant_launches += 1
    return out
