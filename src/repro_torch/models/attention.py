"""Attention: GQA self-attention with RoPE over a dense per-slot cache or a
paged K/V pool (counterpart of the reference's ``models/attention.py``).

Cache layout (per self-attention layer):
  {"k": (B, C, J, N), "v": (B, C, J, N), "pos": (B, C) int32}
``pos`` holds absolute token positions (-1 = empty).

Paged layout (per layer, shared by every slot):
  {"kp": (P, page, J, N), "vp": (P, page, J, N)}
plus, for int8 pages, per-(entry, head) f32 scales
  {"ksc": (P, page, J), "vsc": (P, page, J)}
addressed through a (B, M) block table; physical page 0 is the scratch page.

Where the reference rebuilds caches functionally, the port writes them in
place (``index_put_`` on the caller's tensors): the functional form would
copy a whole page pool per layer per decode step.  This slice ports the
direct ``attend`` path; the chunked online-softmax path (taken by the
reference above 2048 tokens) waits in ROADMAP Q6 and sliding windows (the
ring branch of ``cache_write``) in Q7.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.config.model import ModelConfig
from repro_torch.models.common import normal_init, rope

NEG_INF = -1e30


# ----------------------------------------------------------------------------
# Parameters
# ----------------------------------------------------------------------------

def init_attention(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
                   device: Optional[torch.device] = None) -> dict:
    d, h, j, n = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": normal_init(gen, (d, h, n), dtype, fan_in=d, device=device),
        "wk": normal_init(gen, (d, j, n), dtype, fan_in=d, device=device),
        "wv": normal_init(gen, (d, j, n), dtype, fan_in=d, device=device),
        "wo": normal_init(gen, (h, n, d), dtype, fan_in=h * n, device=device),
    }


# ----------------------------------------------------------------------------
# Core attention math
# ----------------------------------------------------------------------------

def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return logits
    return cap * torch.tanh(logits / cap)


def _direct_attend(q, k, v, mask, cap: float):
    # q: (B,S,J,G,N)  k, v: (B,T,J,N)  mask: (B,S,T)
    s = torch.einsum("bsjgn,btjn->bjgst", q.float(), k.float())
    s = softcap(s, cap)
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bjgst,btjn->bsjgn", p.to(v.dtype), v)


def attend(
    q: torch.Tensor,            # (B, S, J, G, N) — pre-scaled by 1/sqrt(N)
    k: torch.Tensor,            # (B, T, J, N)
    v: torch.Tensor,            # (B, T, J, N)
    q_pos: torch.Tensor,        # (B, S) int32
    k_pos: torch.Tensor,        # (B, T) int32; -1 marks an empty entry
    *,
    cap: float = 0.0,
) -> torch.Tensor:              # (B, S, J, G, N)
    """Causal masked attention, f32 scores and softmax; the probabilities
    are cast to ``v``'s dtype before the PV product, as in the reference."""
    mask = (k_pos[:, None, :] >= 0) & (k_pos[:, None, :] <= q_pos[:, :, None])
    return _direct_attend(q, k, v, mask, cap)


# ----------------------------------------------------------------------------
# Self-attention layer op (projections + rope + cache + attend)
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, capacity: int, dtype: torch.dtype,
               device: Optional[torch.device] = None) -> dict:
    j, n = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros(batch, capacity, j, n, dtype=dtype, device=device),
        "v": torch.zeros(batch, capacity, j, n, dtype=dtype, device=device),
        "pos": torch.full((batch, capacity), -1, dtype=torch.int32,
                          device=device),
    }


def _project_qkv(params: dict, x: torch.Tensor, positions: torch.Tensor,
                 cfg: ModelConfig):
    h, j, n = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = h // j
    B, S, D = x.shape
    q = (x @ params["wq"].reshape(D, h * n)).reshape(B, S, h, n)
    k = (x @ params["wk"].reshape(D, j * n)).reshape(B, S, j, n)
    v = (x @ params["wv"].reshape(D, j * n)).reshape(B, S, j, n)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    q = q.reshape(B, S, j, g, n) * (n ** -0.5)
    return q, k, v


def self_attention(
    params: dict,
    x: torch.Tensor,                      # (B, S, D)
    positions: torch.Tensor,              # (B, S) int32
    cfg: ModelConfig,
    *,
    cache: Optional[dict] = None,
    page_table: Optional[torch.Tensor] = None,   # (B, M) int32, paged decode
    use_kernel: bool = True,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (output (B,S,D), the cache written in place or None)."""
    q, k, v = _project_qkv(params, x, positions, cfg)
    if cache is not None and "kp" in cache:
        paged_cache_write(cache, k, v, positions, page_table)
        out = paged_attend(q, cache, positions, page_table,
                           cap=cfg.attn_logit_softcap, use_kernel=use_kernel)
    elif cache is None:
        out = attend(q, k, v, positions, positions,
                     cap=cfg.attn_logit_softcap)
    else:
        cache_write(cache, k, v, positions)
        out = attend(q, cache["k"], cache["v"], positions, cache["pos"],
                     cap=cfg.attn_logit_softcap)
    B, S = x.shape[:2]
    o = out.reshape(B, S, -1) @ params["wo"].reshape(-1, cfg.d_model)
    return o, cache


def cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                positions: torch.Tensor) -> dict:
    """Write S new entries at slots ``pos % C`` of each row, in place."""
    C = cache["k"].shape[1]
    B, S = k.shape[:2]
    if S > C:
        raise NotImplementedError(
            f"a {S}-token write into a {C}-entry cache ring-wraps: that is "
            "the sliding-window path (ROADMAP Q7)")
    rows = torch.arange(B, device=k.device)[:, None]
    slots = positions % C
    cache["k"][rows, slots] = k.to(cache["k"].dtype)
    cache["v"][rows, slots] = v.to(cache["v"].dtype)
    cache["pos"][rows, slots] = positions.to(torch.int32)
    return cache


# ----------------------------------------------------------------------------
# Paged cache (block-table addressed physical page pool; serve.kvpool is the
# host-side allocator, physical page 0 is its reserved scratch page)
# ----------------------------------------------------------------------------

KV_QUANT_MODES = ("none", "int8")
# Guards the division against all-zero entries (fresh pages, padded rows):
# the dequantized value is exactly 0 either way, so the floor only avoids
# 0/0.
_KV_SCALE_FLOOR = 1e-8


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(entry, head) int8 quantization over the head dim:
    ``x (..., N) -> (int8 values (..., N), f32 scales (...))`` with
    ``scale = max|x| / 127`` floored, round half to even, clip to +-127.
    The same f32 arithmetic as the reference, so equal inputs give equal
    bits."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.clamp(amax / 127.0, min=_KV_SCALE_FLOOR)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Inverse of ``kv_quantize``: ``(..., N) int8 x (...) f32 -> (..., N)
    f32``."""
    return q.float() * scale[..., None]


def init_paged_cache(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: torch.dtype, kv_quant: str = "none",
                     device: Optional[torch.device] = None) -> dict:
    """Physical K/V page pool shared by every slot (one per layer).  Entry
    ``t`` of a row's logical view is live iff ``t < length``.

    ``kv_quant="int8"`` stores int8 values with per-(entry, head) f32
    scales in ``ksc``/``vsc`` (``(P, page, J)``): ``J*(N + 4)`` bytes per
    entry and tensor.  The scale leaves ride the same page movers as the
    values (``read_page``/``write_page``), so spill and fault-in carry
    them."""
    if kv_quant not in KV_QUANT_MODES:
        raise ValueError(f"kv_quant must be one of {KV_QUANT_MODES}, "
                         f"got {kv_quant!r}")
    j, n = cfg.num_kv_heads, cfg.head_dim
    shape = (num_pages, page_size, j, n)
    if kv_quant == "int8":
        return {
            "kp": torch.zeros(shape, dtype=torch.int8, device=device),
            "vp": torch.zeros(shape, dtype=torch.int8, device=device),
            "ksc": torch.zeros(shape[:3], dtype=torch.float32, device=device),
            "vsc": torch.zeros(shape[:3], dtype=torch.float32, device=device),
        }
    return {"kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device)}


def paged_cache_write(cache: dict, k: torch.Tensor, v: torch.Tensor,
                      positions: torch.Tensor, table: torch.Tensor) -> dict:
    """Row ``b``'s token at position ``p`` lands in physical page
    ``table[b, p // page]`` at offset ``p % page``, written in place.

    Released rows have their table row pointed at the scratch page (0), and
    ``logical`` is clamped to ``M - 1``, so their garbage writes never touch
    a live page; duplicate scratch indices in the scatter are harmless."""
    B, S = k.shape[:2]
    page = cache["kp"].shape[1]
    M = table.shape[1]
    rows = torch.arange(B, device=k.device)[:, None]
    logical = torch.clamp(positions // page, max=M - 1)
    phys = table[rows, logical].reshape(-1)               # (B*S,)
    off = (positions % page).reshape(-1)                  # (B*S,)
    kf = k.reshape(B * S, *k.shape[2:])
    vf = v.reshape(B * S, *v.shape[2:])
    if "ksc" in cache:
        # Quantize-on-write: new entries land as int8 values plus their
        # per-(entry, head) scales, like prefilled pages.
        kq, ks = kv_quantize(kf)
        vq, vs = kv_quantize(vf)
        cache["kp"][phys, off] = kq
        cache["vp"][phys, off] = vq
        cache["ksc"][phys, off] = ks
        cache["vsc"][phys, off] = vs
        return cache
    cache["kp"][phys, off] = kf.to(cache["kp"].dtype)
    cache["vp"][phys, off] = vf.to(cache["vp"].dtype)
    return cache


def paged_attend(q: torch.Tensor, cache: dict, positions: torch.Tensor,
                 table: torch.Tensor, *, cap: float = 0.0,
                 use_kernel: bool = True) -> torch.Tensor:
    """Single-token decode attention over the page pool.  q (B, 1, J, G, N)
    pre-scaled.

    With ``use_kernel`` it goes through the paged-attention kernels
    (``kernels/paged_attention``; the int8 one when the pool carries scale
    leaves): on the card that launches the CUDA kernel or raises; CPU
    tensors take its plain version.  Otherwise it runs that plain version
    (gather, dequantize for int8 pools, ``attend``) on any device."""
    if q.shape[1] != 1:
        raise NotImplementedError(
            "multi-token paged attention (speculative verify) is not ported "
            "yet (ROADMAP Q4)")
    from repro_torch.kernels.paged_attention import ops as pa_ops
    from repro_torch.kernels.paged_attention import ref as pa_ref
    lengths = positions[:, -1] + 1                        # just wrote up to
    if "ksc" in cache:
        fn = (pa_ops.paged_attention_quant if use_kernel
              else pa_ref.paged_attention_quant_ref)
        return fn(q[:, 0], cache["kp"], cache["vp"], cache["ksc"],
                  cache["vsc"], table, lengths, cap=cap)[:, None]
    fn = pa_ops.paged_attention if use_kernel else pa_ref.paged_attention_ref
    return fn(q[:, 0], cache["kp"], cache["vp"], table, lengths,
              cap=cap)[:, None]
