"""Model configuration system (the port's own copy of the reference's
``config/model.py``; framework-free, so it is copied rather than shared).

One rich ``ModelConfig`` dataclass expresses every assigned architecture:
dense GQA transformers, sliding-window variants, MoE, cross-attention VLMs,
RG-LRU hybrids, encoder-decoder audio models, and attention-free RWKV6.

Layer heterogeneity (e.g. recurrentgemma's 1:2 attention:RG-LRU pattern,
llama-vision's interleaved cross-attention) is expressed with a repeating
``pattern`` of mixer kinds; the model stacks parameters per pattern slot and
loops over pattern repetitions.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

# Mixer kinds usable in ``ModelConfig.pattern``.
MIX_ATTN = "attn"            # global self-attention (GQA/MQA/MHA)
MIX_ATTN_LOCAL = "attn_local"  # sliding-window self-attention
MIX_ATTN_CROSS = "attn_cross"  # self-attn + cross-attn (VLM layers)
MIX_RGLRU = "rglru"          # RG-LRU recurrent block (recurrentgemma)
MIX_RWKV6 = "rwkv6"          # RWKV6 time-mix (attention-free)

MIXER_KINDS = (MIX_ATTN, MIX_ATTN_LOCAL, MIX_ATTN_CROSS, MIX_RGLRU, MIX_RWKV6)

# Families (metadata only; behaviour is driven by the fields below).
FAMILIES = ("dense", "moe", "vlm", "hybrid", "audio", "ssm")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # -- identity ---------------------------------------------------------
    arch_id: str
    family: str

    # -- core dims --------------------------------------------------------
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads

    # -- layer pattern ----------------------------------------------------
    # Repeating pattern of mixer kinds; the L layers are pattern[i % len].
    pattern: Tuple[str, ...] = (MIX_ATTN,)

    # -- attention --------------------------------------------------------
    rope_theta: float = 10_000.0
    sliding_window: int = 0           # 0 -> global; used by MIX_ATTN_LOCAL
    attn_logit_softcap: float = 0.0   # 0 -> disabled
    qkv_bias: bool = False

    # -- mlp --------------------------------------------------------------
    mlp_kind: str = "swiglu"          # "swiglu" | "geglu" | "gelu"
    # MoE (num_experts == 0 -> dense)
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    # "flat": one global (E*C, D) dispatch buffer (baseline; expert compute
    #   shards only over the expert axis).  "batched": per-batch-row buffers
    #   (B, E, C_b, D) so expert compute shards over data x model — the
    #   §Perf hillclimb result for the MoE cells.
    moe_dispatch: str = "flat"
    # "model": expert-parallel over the model axis (baseline EP).
    # "replicate": replicate expert weights — scatter/gather stay local to
    #   the data shard (zero model-axis MoE collectives); right call when
    #   experts are small (olmoe: 805MB total — §Perf).
    moe_expert_sharding: str = "model"

    # -- recurrent mixers -------------------------------------------------
    rglru_width: int = 0              # 0 -> d_model
    rglru_conv_width: int = 4
    rwkv_head_size: int = 64

    # -- embeddings / norm --------------------------------------------------
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # gemma-style normalisation of the embedding output by sqrt(d_model)
    scale_embeddings: bool = False

    # -- encoder-decoder ----------------------------------------------------
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0       # 0 -> num_layers when enc-dec

    # -- modality frontend (stub per assignment spec) -----------------------
    # "none" | "vision" (precomputed patch embeddings) | "audio" (frames)
    frontend: str = "none"
    frontend_seq_len: int = 0         # #patches / #frames fed by the stub
    frontend_dim: int = 0             # embedding dim emitted by the stub

    # -- numerics ------------------------------------------------------------
    dtype: str = "bfloat16"           # compute/params dtype
    logit_dtype: str = "float32"

    # ---------------------------------------------------------------------
    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        for kind in self.pattern:
            if kind not in MIXER_KINDS:
                raise ValueError(f"unknown mixer kind {kind!r}")
        if self.num_experts and not self.experts_per_token:
            raise ValueError("MoE configs need experts_per_token")
        if self.head_dim == 0 and self.num_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.rglru_width == 0:
            object.__setattr__(self, "rglru_width", self.d_model)
        if self.is_encoder_decoder and self.num_encoder_layers == 0:
            object.__setattr__(self, "num_encoder_layers", self.num_layers)

    # -- derived -----------------------------------------------------------
    @property
    def attends_globally(self) -> bool:
        """True if any layer uses unbounded-context attention (quadratic)."""
        return any(k in (MIX_ATTN, MIX_ATTN_CROSS) for k in self.pattern)

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic archs: state/window does not grow with context."""
        return not self.attends_globally

    @property
    def has_decoder(self) -> bool:
        """Encoder-only models have no decode step; all assigned archs do."""
        return True

    @property
    def layer_kinds(self) -> Tuple[str, ...]:
        n = len(self.pattern)
        return tuple(self.pattern[i % n] for i in range(self.num_layers))

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def rwkv_num_heads(self) -> int:
        return self.d_model // self.rwkv_head_size

    def param_count(self) -> int:
        """Total parameter count (embedding + blocks + head)."""
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        n_emb = v * d
        if not self.tie_embeddings:
            n_emb *= 2
        total = n_emb
        gated = self.mlp_kind in ("swiglu", "geglu")
        for kind in self.layer_kinds:
            total += self._block_params(kind, gated)
        if self.is_encoder_decoder:
            for _ in range(self.num_encoder_layers):
                total += self._block_params(MIX_ATTN, gated)
        total += self.d_model  # final norm
        return total

    def _mlp_params(self, gated: bool) -> int:
        d, f = self.d_model, self.d_ff
        per_expert = d * f * (3 if gated else 2)
        if self.num_experts:
            return self.num_experts * per_expert + d * self.num_experts
        return per_expert

    def _block_params(self, kind: str, gated: bool) -> int:
        d = self.d_model
        n = 2 * d  # two norms
        if kind in (MIX_ATTN, MIX_ATTN_LOCAL, MIX_ATTN_CROSS):
            attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if kind == MIX_ATTN_CROSS:
                attn *= 2
                n += 2 * d
        elif kind == MIX_RGLRU:
            w = self.rglru_width
            # in/out proj (x,y branches), conv1d, gates, recurrent params
            attn = 2 * d * w + w * d + self.rglru_conv_width * w + 2 * w * w + 2 * w
        elif kind == MIX_RWKV6:
            attn = 4 * d * d + d * d  # r,k,v,g + output
            attn += 6 * d + 2 * self.rwkv_head_size * self.d_model  # decay/mix/ln
        else:
            raise ValueError(kind)
        return n + attn + self._mlp_params(gated)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if not self.num_experts:
            return self.param_count()
        gated = self.mlp_kind in ("swiglu", "geglu")
        per_expert = self.d_model * self.d_ff * (3 if gated else 2)
        inactive = (self.num_experts - self.experts_per_token) * per_expert
        n_moe_layers = sum(1 for _ in self.layer_kinds)
        return self.param_count() - inactive * n_moe_layers

    # -- reduced config for CPU smoke tests --------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family: same pattern/features, small dims."""
        n_pat = len(self.pattern)
        layers = max(n_pat, 2)
        heads = max(2, min(4, self.num_heads))
        kv = max(1, min(heads, self.num_kv_heads, 2))
        head_dim = 16
        d_model = 64
        changes = dict(
            num_layers=layers,
            d_model=d_model,
            num_heads=heads,
            num_kv_heads=kv,
            head_dim=head_dim,
            d_ff=128,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 32) if self.sliding_window else 0,
            num_experts=min(4, self.num_experts),
            experts_per_token=min(2, self.experts_per_token),
            capacity_factor=8.0,   # no capacity drops in tiny tests
            rglru_width=d_model if self.rglru_width else 0,
            rwkv_head_size=16,
            num_encoder_layers=2 if self.is_encoder_decoder else 0,
            frontend_seq_len=8 if self.frontend != "none" else 0,
            frontend_dim=d_model if self.frontend != "none" else 0,
            dtype="float32",
        )
        return dataclasses.replace(self, **changes)
