"""Device programs for the serve fast path (counterpart of the reference's
``serve/programs.py``): bucket admit + batched decode, each in a dense and
a paged (block-table) variant, and the page movers of the cold tier.

The reference jits each program once and shares the compilation; here each
is a plain callable, run eagerly, built once per engine.  Programs update
the decode states and the per-slot device mirrors (token, position,
sampling parameters) in place and return the sampled tokens, still on the
device.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.config.model import ModelConfig
from repro_torch.models.transformer import (
    ExecPolicy, init_decode_state, insert_decode_slot, read_page,
    scatter_solo_pages, write_page)
from repro_torch.serve.sampler import sample_slots
from repro_torch.train.steps import (
    make_bucket_prefill_step, make_decode_step, make_paged_decode_step,
    make_paged_prefill_step)

Mirrors = Dict[str, torch.Tensor]


def _sample_admitted(last_logits: torch.Tensor, gen: torch.Generator,
                     batch: Dict[str, Any]) -> torch.Tensor:
    """Sample the first token of one admitted request (batch of 1)."""
    dev = last_logits.device
    temp = torch.full((1,), batch["temp"], dtype=torch.float32, device=dev)
    top_k = torch.full((1,), batch["top_k"], dtype=torch.int32, device=dev)
    top_p = torch.full((1,), batch["top_p"], dtype=torch.float32, device=dev)
    return sample_slots(last_logits, gen, temp, top_k, top_p,
                        stochastic=batch["temp"] > 0.0)


def _set_mirrors(mirrors: Mirrors, slot: int, tok: torch.Tensor,
                 batch: Dict[str, Any]) -> None:
    mirrors["tok"][slot] = tok[0]
    mirrors["pos"][slot] = batch["length"]
    mirrors["temp"][slot] = batch["temp"]
    mirrors["top_k"][slot] = batch["top_k"]
    mirrors["top_p"][slot] = batch["top_p"]


def admit_program(cfg: ModelConfig, policy: ExecPolicy, capacity: int):
    """One admission: init a fresh solo state, bucket-prefill the prompt,
    sample the first token, copy the state into the running batch at
    ``slot`` and update the slot's mirrors."""
    prefill = make_bucket_prefill_step(cfg, policy)

    def admit(params, states, batch, slot, gen, mirrors):
        solo = init_decode_state(cfg, 1, capacity,
                                 device=batch["tokens"].device)
        solo, last_logits = prefill(params, solo, batch)
        tok = _sample_admitted(last_logits, gen, batch)
        insert_decode_slot(states, solo, slot)
        _set_mirrors(mirrors, slot, tok, batch)
        return tok
    return admit


def decode_program(cfg: ModelConfig, policy: ExecPolicy):
    """One serve step: batched decode + per-slot sampling.  Tokens and
    positions come from the device mirrors, so the step moves nothing
    host->device."""
    decode = make_decode_step(cfg, policy)

    def step(params, states, gen, mirrors, stochastic):
        batch = {"tokens": mirrors["tok"][:, None],
                 "positions": mirrors["pos"][:, None]}
        _, logits = decode(params, states, batch)
        toks = sample_slots(logits, gen, mirrors["temp"], mirrors["top_k"],
                            mirrors["top_p"], stochastic)
        mirrors["tok"] = toks
        mirrors["pos"] += 1
        return toks
    return step


def paged_admit_program(cfg: ModelConfig, policy: ExecPolicy, capacity: int):
    """Paged admission: gather the reused prefix pages into a solo dense
    cache, prefill only the suffix bucket, sample the first token, scatter
    the new pages into the pool, update the slot's mirrors.  Prefix-hit
    pages map to the scratch page in ``assign``, so shared (copy-on-write)
    pages are never rewritten."""
    prefill = make_paged_prefill_step(cfg, capacity, policy)

    def admit(params, pstate, batch, gen, mirrors):
        solo, last_logits = prefill(params, pstate, batch)
        tok = _sample_admitted(last_logits, gen, batch)
        scatter_solo_pages(pstate, solo, batch["assign"])
        _set_mirrors(mirrors, batch["slot"], tok, batch)
        return tok
    return admit


def paged_decode_program(cfg: ModelConfig, policy: ExecPolicy):
    """Batched decode through the block table: K/V reads and the new
    token's write go to physical pool pages.  The caller copies the table
    host->device once per step (every layer reads the same tensor)."""
    decode = make_paged_decode_step(cfg, policy)

    def step(params, pstate, gen, mirrors, table, stochastic):
        batch = {"tokens": mirrors["tok"][:, None],
                 "positions": mirrors["pos"][:, None]}
        _, logits = decode(params, pstate, batch, table)
        toks = sample_slots(logits, gen, mirrors["temp"], mirrors["top_k"],
                            mirrors["top_p"], stochastic)
        mirrors["tok"] = toks
        mirrors["pos"] += 1
        return toks
    return step


def read_page_program():
    """Spill: copy one physical page out of every pool (fresh tensors,
    safe to hand to the sidecar while the pool keeps being written)."""
    return read_page


def write_page_program():
    """Fault-in: write a spilled page back into every pool, in place."""
    return write_page
