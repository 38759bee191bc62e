"""Serve step builders (counterpart of the serve half of the reference's
``train/steps.py``; the train step is ROADMAP Q6).

Each builder returns a plain callable run eagerly.  Decode states are
updated in place (see ``models.transformer``); lengths and prefix-hit
lengths arrive as host integers, so no step reads a device scalar back.
"""
from __future__ import annotations

from repro_torch.config.model import ModelConfig
from repro_torch.models.transformer import (
    ExecPolicy, forward, init_decode_state, invalidate_positions_from,
    load_prefix_pages)


def make_bucket_prefill_step(cfg: ModelConfig,
                             policy: ExecPolicy = ExecPolicy()):
    """Solo prefill for the admission plane: ``batch["tokens"]`` is a
    right-padded (1, S) bucket, ``batch["length"]`` the true prompt length.
    Returns the state with pad entries invalidated and ``pos`` set to the
    true length, plus the logits at the last real token."""
    def prefill_step(params, states, batch):
        logits, new_states = forward(
            params, cfg, batch["tokens"], batch["positions"],
            policy=policy, states=states)
        length = batch["length"]
        invalidate_positions_from(new_states, length)
        new_states["pos"].fill_(length)
        return new_states, logits[:, length - 1]
    return prefill_step


def make_decode_step(cfg: ModelConfig, policy: ExecPolicy = ExecPolicy()):
    def decode_step(params, states, batch):
        logits, new_states = forward(
            params, cfg, batch["tokens"], batch["positions"],
            policy=policy, states=states)
        return new_states, logits[:, -1]
    return decode_step


def make_paged_prefill_step(cfg: ModelConfig, capacity: int,
                            policy: ExecPolicy = ExecPolicy()):
    """Continuation prefill against the paged pool: the reused prefix is
    gathered from the pool into a fresh batch-1 dense cache
    (``load_prefix_pages``) and only the suffix bucket is prefilled, at
    positions offset by ``hit_len``.  Returns (solo dense state, logits at
    the last real token); the caller scatters the solo cache into pages."""
    def prefill_step(params, pstate, batch):
        # batch: tokens (1, S) right-padded suffix bucket, positions (1, S) =
        # hit_len + arange(S), length: total true L, hit_len, table (M,)
        hit_len = batch["hit_len"]
        solo = init_decode_state(cfg, 1, capacity,
                                 device=batch["tokens"].device)
        solo = load_prefix_pages(solo, pstate, batch["table"], hit_len)
        logits, new_solo = forward(
            params, cfg, batch["tokens"], batch["positions"],
            policy=policy, states=solo)
        length = batch["length"]
        invalidate_positions_from(new_solo, length)
        new_solo["pos"].fill_(length)
        return new_solo, logits[:, length - hit_len - 1]
    return prefill_step


def make_paged_decode_step(cfg: ModelConfig,
                           policy: ExecPolicy = ExecPolicy()):
    """Batched decode reading/writing K/V through the block table."""
    def decode_step(params, pstate, batch, table):
        logits, new_states = forward(
            params, cfg, batch["tokens"], batch["positions"],
            policy=policy, states=pstate, page_table=table)
        return new_states, logits[:, -1]
    return decode_step
