"""Tiny and ~100M configs for examples and CPU end-to-end training."""
from repro_torch.config import ModelConfig, register


@register("repro-tiny")
def tiny() -> ModelConfig:
    """~2M params: quickstart / CI."""
    return ModelConfig(
        arch_id="repro-tiny",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=384,
        vocab_size=2048,
        mlp_kind="swiglu",
        tie_embeddings=True,
        dtype="float32",
    )


@register("repro-100m")
def m100() -> ModelConfig:
    """~110M params: the end-to-end train example (examples/train_lm.py)."""
    return ModelConfig(
        arch_id="repro-100m",
        family="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=4,
        head_dim=64,
        d_ff=2048,
        vocab_size=32_000,
        mlp_kind="swiglu",
        tie_embeddings=True,
        dtype="float32",
    )
