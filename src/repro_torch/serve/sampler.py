"""Token sampling: greedy / temperature / top-k / top-p, per slot
(counterpart of the reference's ``serve/sampler.py``).

Greedy is ``argmax`` (first maximum on ties, as in the reference), so greedy
outputs compare exactly across the two packages.  The stochastic path draws
from a ``torch.Generator`` seeded from ``ServeConfig.seed``; it cannot
reproduce the reference's ``jax.random`` stream, only its filters and its
distribution.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.config.run import ServeConfig

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs (defaults come from the engine's config)."""
    temperature: float = 0.0         # <= 0 -> greedy
    top_k: int = 0                   # 0 -> disabled
    top_p: float = 1.0               # 1 -> disabled
    eos_id: int = -1                 # -1 -> never stops on EOS

    @staticmethod
    def from_config(scfg: ServeConfig) -> "SamplingParams":
        return SamplingParams(temperature=scfg.temperature, top_k=scfg.top_k,
                              top_p=scfg.top_p, eos_id=scfg.eos_id)


def _stochastic_slots(logits: torch.Tensor, gen: torch.Generator,
                      temperature: torch.Tensor, top_k: torch.Tensor,
                      top_p: torch.Tensor) -> torch.Tensor:
    """Row-wise temperature / top-k / top-p sampling."""
    V = logits.shape[-1]
    scaled = logits.float() / torch.clamp(temperature, min=1e-6)[:, None]
    # top-k: threshold at each row's k-th largest (disabled rows keep all)
    k = torch.clamp(top_k, 0, V).long()
    desc = torch.sort(scaled, dim=-1, descending=True).values
    kth = torch.gather(desc, 1, torch.clamp(k - 1, 0, V - 1)[:, None])
    scaled = torch.where((k[:, None] > 0) & (scaled < kth), NEG_INF, scaled)
    # top-p on the (possibly top-k-filtered) logits
    desc = torch.sort(scaled, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(desc, dim=-1), dim=-1)
    cutoff_idx = torch.sum(cum < top_p[:, None], dim=-1, keepdim=True)
    cutoff = torch.gather(desc, 1, torch.clamp(cutoff_idx, 0, V - 1))
    scaled = torch.where((top_p[:, None] < 1.0) & (scaled < cutoff),
                         NEG_INF, scaled)
    probs = torch.softmax(scaled, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def sample_slots(logits: torch.Tensor, gen: torch.Generator,
                 temperature: torch.Tensor, top_k: torch.Tensor,
                 top_p: torch.Tensor, stochastic: bool) -> torch.Tensor:
    """logits (B, V) + per-slot (B,) params -> (B,) int32 tokens.

    Rows with ``temperature <= 0`` decode greedily.  ``stochastic`` is the
    host's knowledge that some slot samples (the engine keeps the slots'
    temperatures on the host too): without it the step is one argmax, and
    no device value is read back to decide."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if not stochastic:
        return greedy
    toks = _stochastic_slots(logits, gen, temperature, top_k, top_p)
    return torch.where(temperature <= 0.0, greedy, toks)
