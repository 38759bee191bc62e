"""The decoder-only LM (counterpart of the reference's
``models/transformer.py``).

Parameters keep the reference's tree: stacked per pattern slot with a
leading ``reps`` axis (``layers.0.mixer.wq`` is ``(reps, D, H, N)``),
unstacked ``tail`` blocks for ``num_layers % len(pattern)``.  The
``Transformer`` module registers that tree as-is, so its ``state_dict``
keys are the reference's paths and conversion is a leaf-by-leaf copy
(``repro_torch.convert``).  The layer stack is a Python loop over ``reps``
indexing the stacked leaves (``lax.scan`` has no counterpart in eager
PyTorch).

Decode states keep the reference's tree too (``slots``/``tail``/``pos``),
but are updated in place: a forward with ``states`` writes its K/V into the
caller's tensors and returns the same tree.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.config.model import MIX_ATTN, ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import blocks as blk
from repro_torch.models.common import (
    DeviceLike, dtype_of, init_rmsnorm, normal_init, resolve_device, rms_norm)


@dataclasses.dataclass(frozen=True)
class ExecPolicy:
    """Execution knobs.  ``use_kernel`` routes single-token paged decode
    through the hand-written paged-attention kernel (the reference's Pallas
    switch, which defaults off; here the kernel is the default)."""
    use_kernel: bool = True


def _reps_rem(cfg: ModelConfig) -> Tuple[int, int]:
    p = len(cfg.pattern)
    return cfg.num_layers // p, cfg.num_layers % p


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.is_encoder_decoder or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.arch_id}: encoder-decoder and frontend models are not "
            "ported yet (ROADMAP Q9)")


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _stacked(tree, reps: int):
    """A per-layer state tree with a leading ``reps`` axis, fresh memory."""
    return _tree_map(
        lambda a: a.unsqueeze(0).expand(reps, *a.shape).clone(), tree)


def _stack_trees(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return torch.stack(trees)


# ----------------------------------------------------------------------------
# Init
# ----------------------------------------------------------------------------

def init_params(cfg: ModelConfig, seed: int = 0,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random parameters drawn from a ``torch.Generator`` seeded with
    ``seed`` on ``device`` (``None``: the card)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dtype = dtype_of(cfg.dtype)
    reps, rem = _reps_rem(cfg)
    params: Dict[str, Any] = {
        "embed": normal_init(gen, (cfg.vocab_size, cfg.d_model), dtype,
                             device=dev),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, dev),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = normal_init(
            gen, (cfg.d_model, cfg.vocab_size), dtype, fan_in=cfg.d_model,
            device=dev)
    params["layers"] = {
        str(i): _stack_trees([blk.init_block(gen, kind, cfg, dtype, dev)
                              for _ in range(reps)])
        for i, kind in enumerate(cfg.pattern)} if reps else {}
    params["tail"] = {
        str(i): blk.init_block(gen, cfg.pattern[i], cfg, dtype, dev)
        for i in range(rem)}
    return params


def init_decode_state(cfg: ModelConfig, batch: int, capacity: int,
                      device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked per-slot block states + tail states (dense KV caches)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    reps, rem = _reps_rem(cfg)

    return {
        "slots": {str(i): _stacked(blk.init_block_state(
                      kind, cfg, batch, capacity, dtype, dev), reps)
                  for i, kind in enumerate(cfg.pattern)} if reps else {},
        "tail": {str(i): blk.init_block_state(cfg.pattern[i], cfg, batch,
                                              capacity, dtype, dev)
                 for i in range(rem)},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def insert_decode_slot(state: Dict[str, Any], solo: Dict[str, Any],
                       slot: int) -> Dict[str, Any]:
    """Copy a batch-1 decode state into row ``slot`` of a batched state, in
    place.  Stacked ("slots") leaves carry the batch on axis 1, "tail"
    leaves on axis 0."""
    def put(dst_tree, src_tree, axis):
        for k, dst in dst_tree.items():
            src = src_tree[k]
            if isinstance(dst, dict):
                put(dst, src, axis)
            elif axis == 1:
                dst[:, slot] = src[:, 0].to(dst.dtype)
            else:
                dst[slot] = src[0].to(dst.dtype)
    put(state["slots"], solo["slots"], 1)
    put(state["tail"], solo["tail"], 0)
    return state


# ----------------------------------------------------------------------------
# Paged decode state (block-table KV paging; serve.kvpool is the host-side
# allocator and serve.engines.PagedEngine the admission plane)
# ----------------------------------------------------------------------------

def supports_paging(cfg: ModelConfig) -> bool:
    """Block-table KV paging covers global-attention decoder-only archs."""
    return (all(k == MIX_ATTN for k in cfg.pattern)
            and not cfg.is_encoder_decoder
            and cfg.mlp_kind != "rwkv_cmix"
            and cfg.frontend == "none")


def init_paged_decode_state(cfg: ModelConfig, num_pages: int, page_size: int,
                            kv_quant: str = "none",
                            device: DeviceLike = None) -> Dict[str, Any]:
    """Like ``init_decode_state`` but the caches are shared physical page
    pools (no batch axis): slot residency is whatever the block tables map."""
    if not supports_paging(cfg):
        raise ValueError(f"{cfg.arch_id}: paging needs all-global-attention "
                         "decoder-only archs (the snapshot backend for the "
                         "others is ROADMAP Q7)")
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    reps, rem = _reps_rem(cfg)

    def pool():
        return {"cache": attn_mod.init_paged_cache(
            cfg, num_pages, page_size, dtype, kv_quant=kv_quant, device=dev)}

    return {
        "slots": {str(i): _stacked(pool(), reps)
                  for i in range(len(cfg.pattern))} if reps else {},
        "tail": {str(i): pool() for i in range(rem)},
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def read_page(pstate: Dict[str, Any], page: int) -> Dict[str, Any]:
    """Copy physical page ``page`` out of every layer's pool, scale leaves
    included: the spill payload.  The copies are fresh tensors enqueued on
    the current stream, so they hold the page as it is now whatever later
    programs write into the pool.  Stacked ("slots") leaves carry the page
    axis at 1, unstacked ("tail") at 0."""
    return {"slots": _tree_map(lambda a: a[:, page].clone(), pstate["slots"]),
            "tail": _tree_map(lambda a: a[page].clone(), pstate["tail"])}


def write_page(pstate: Dict[str, Any], page: int, blob: Dict[str, Any]
               ) -> Dict[str, Any]:
    """Fault a spilled page's content back into every layer's pool, in
    place.  ``blob`` is what ``read_page`` returned, on the device or
    staged to (pinned) host memory; a host copy is enqueued without
    blocking the caller."""
    def put(dst_tree, src_tree, axis):
        for k, dst in dst_tree.items():
            if isinstance(dst, dict):
                put(dst, src_tree[k], axis)
            else:
                view = dst[:, page] if axis == 1 else dst[page]
                view.copy_(src_tree[k], non_blocking=True)
    put(pstate["slots"], blob["slots"], 1)
    put(pstate["tail"], blob["tail"], 0)
    return pstate


def load_prefix_pages(solo: Dict[str, Any], pstate: Dict[str, Any],
                      table_row: torch.Tensor, hit_len: int
                      ) -> Dict[str, Any]:
    """Seed a fresh batch-1 dense decode state with a reused prefix: gather
    the row's pages from every pool into the solo cache and mark
    ``[0, hit_len)`` valid.  Unassigned logical pages point at the scratch
    page, so the gathered garbage is masked off by ``pos``.  Int8 pools
    dequantize on the way out (the solo cache is in the model dtype)."""
    def seed(dense_leaf, pool_cache, key, skey, pool_axis):
        gathered = torch.index_select(pool_cache[key], pool_axis, table_row)
        if skey in pool_cache:
            gathered = attn_mod.kv_dequantize(
                gathered,
                torch.index_select(pool_cache[skey], pool_axis, table_row))
        return gathered.reshape(dense_leaf.shape).to(dense_leaf.dtype)

    def fix(solo_cache, pool_cache, pool_axis):
        C = solo_cache["pos"].shape[-1]
        t = torch.arange(C, dtype=torch.int32, device=table_row.device)
        pos = torch.where(t < hit_len, t, -1)
        return {"cache": {
            "k": seed(solo_cache["k"], pool_cache, "kp", "ksc", pool_axis),
            "v": seed(solo_cache["v"], pool_cache, "vp", "vsc", pool_axis),
            "pos": pos.expand(solo_cache["pos"].shape).clone()}}

    out = dict(solo)
    out["slots"] = {i: fix(solo["slots"][i]["cache"],
                           pstate["slots"][i]["cache"], 1)
                    for i in solo["slots"]}
    out["tail"] = {i: fix(solo["tail"][i]["cache"],
                          pstate["tail"][i]["cache"], 0)
                   for i in solo["tail"]}
    out["pos"] = torch.full((), hit_len, dtype=torch.int32,
                            device=table_row.device)
    return out


def scatter_solo_pages(pstate: Dict[str, Any], solo: Dict[str, Any],
                       assign: torch.Tensor) -> Dict[str, Any]:
    """Admission's device half: scatter a prefilled solo dense cache into
    the pools at the pages ``assign`` maps (logical -> physical; scratch
    page 0 for prefix hits and logical pages past the allocation, so shared
    pages are never rewritten).  Int8 pools quantize on the way in, values
    and scales under the same indices.  Written in place with
    ``index_put_``."""
    M = assign.shape[0]

    def put(pool_leaf, paged, pool_axis):
        if pool_axis == 1:
            pool_leaf[:, assign] = paged.to(pool_leaf.dtype)
        else:
            pool_leaf[assign] = paged.to(pool_leaf.dtype)

    def scat(pool_cache, dense_leaf, key, skey, pool_axis):
        page = pool_cache[key].shape[pool_axis + 1]
        lead = tuple(dense_leaf.shape[:pool_axis])           # (reps,) or ()
        paged = dense_leaf.reshape(lead + (M, page)
                                   + tuple(dense_leaf.shape[pool_axis + 2:]))
        if skey in pool_cache:
            paged, scales = attn_mod.kv_quantize(paged)
            put(pool_cache[skey], scales, pool_axis)
        put(pool_cache[key], paged, pool_axis)

    for group, axis in (("slots", 1), ("tail", 0)):
        for i in pstate[group]:
            pool, dense = pstate[group][i]["cache"], solo[group][i]["cache"]
            scat(pool, dense["k"], "kp", "ksc", axis)
            scat(pool, dense["v"], "vp", "vsc", axis)
    return pstate


def invalidate_positions_from(states: Dict[str, Any], length
                              ) -> Dict[str, Any]:
    """Mark attention-cache entries holding positions >= ``length`` empty
    (``pos`` -1), in place: bucket prefill right-pads the prompt, and the
    pads' own cache entries must never be attended to by later steps."""
    def visit(tree):
        for k, leaf in tree.items():
            if isinstance(leaf, dict):
                visit(leaf)
            elif k == "pos" and leaf.ndim >= 2:
                leaf.masked_fill_(leaf >= length, -1)
    visit(states)
    return states


# ----------------------------------------------------------------------------
# Layer stack execution
# ----------------------------------------------------------------------------

def _run_stack(layer_params: dict, tail_params: dict, pattern, x, positions,
               cfg: ModelConfig, policy: ExecPolicy, *,
               states: Optional[dict] = None,
               page_table: Optional[torch.Tensor] = None) -> torch.Tensor:
    reps = layer_params["0"]["norm1"]["scale"].shape[0] if layer_params else 0
    for r in range(reps):
        for i, kind in enumerate(pattern):
            p = _tree_map(lambda a, r=r: a[r], layer_params[str(i)])
            st = (_tree_map(lambda a, r=r: a[r], states["slots"][str(i)])
                  if states is not None else None)
            x, _ = blk.apply_block(p, kind, x, positions, cfg, state=st,
                                   page_table=page_table,
                                   use_kernel=policy.use_kernel)
    for i in sorted(tail_params, key=int):
        st = states["tail"][i] if states is not None else None
        x, _ = blk.apply_block(tail_params[i], pattern[int(i)], x, positions,
                               cfg, state=st, page_table=page_table,
                               use_kernel=policy.use_kernel)
    return x


def _embed(params, cfg: ModelConfig, tokens):
    h = params["embed"][tokens]
    if cfg.scale_embeddings:
        h = h * (cfg.d_model ** 0.5)
    return h


def logits_from_hidden(params, cfg: ModelConfig, h) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (h @ w).to(dtype_of(cfg.logit_dtype))


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                 # (B, S)
    positions: Optional[torch.Tensor] = None,
    *,
    policy: ExecPolicy = ExecPolicy(),
    states: Optional[dict] = None,
    page_table: Optional[torch.Tensor] = None,
    return_hidden: bool = False,
) -> Tuple[torch.Tensor, Optional[dict]]:
    """Returns (logits | hidden, states).

    Train-style: ``states=None``; prefill: a fresh state; decode: S == 1
    with states.  ``page_table`` (B, M) routes attention-cache reads/writes
    through the paged pool (states from ``init_paged_decode_state``).  The
    reference's third output, the MoE aux loss, belongs to training (M6).
    """
    _check_supported(cfg)
    B, S = tokens.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    h = _embed(params, cfg, tokens)
    h = _run_stack(params["layers"], params["tail"], cfg.pattern, h,
                   positions, cfg, policy, states=states,
                   page_table=page_table)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if states is not None:
        states["pos"] = positions[0, -1].to(torch.int32) + 1
    if return_hidden:
        return h, states
    return logits_from_hidden(params, cfg, h), states


# ----------------------------------------------------------------------------
# nn.Module view of the parameter tree
# ----------------------------------------------------------------------------

class _ParamTree(nn.Module):
    """Registers a nested dict of tensors as parameters and submodules under
    the dict's own keys, so ``state_dict`` keys are the tree's paths."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for name, leaf in tree.items():
            if isinstance(leaf, dict):
                self.add_module(name, _ParamTree(leaf))
            else:
                self.register_parameter(
                    name, nn.Parameter(leaf, requires_grad=False))

    def tree(self) -> Dict[str, Any]:
        """The parameters as the reference's nested dict."""
        out: Dict[str, Any] = dict(self._parameters)
        out.update({name: m.tree() for name, m in self.named_children()})
        return out


class Transformer(_ParamTree):
    """The LM as an ``nn.Module`` over the reference's parameter tree."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        params = dict(params)
        params.setdefault("layers", {})
        params.setdefault("tail", {})
        super().__init__(params)
        self.cfg = cfg

    @classmethod
    def init(cls, cfg: ModelConfig, seed: int = 0,
             device: DeviceLike = None) -> "Transformer":
        return cls(cfg, init_params(cfg, seed=seed, device=device))

    @classmethod
    def from_state_dict(cls, cfg: ModelConfig,
                        state_dict: Dict[str, torch.Tensor]) -> "Transformer":
        tree: Dict[str, Any] = {}
        for key, leaf in state_dict.items():
            *path, name = key.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[name] = leaf
        return cls(cfg, tree)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None, *,
                policy: ExecPolicy = ExecPolicy(),
                states: Optional[dict] = None,
                page_table: Optional[torch.Tensor] = None,
                return_hidden: bool = False):
        return forward(self.tree(), self.cfg, tokens, positions,
                       policy=policy, states=states, page_table=page_table,
                       return_hidden=return_hidden)
