"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152.

Llama-architecture small model. [hf:HuggingFaceTB/SmolLM-360M; hf]
"""
from repro_torch.config import ModelConfig, register


@register("smollm-360m")
def config() -> ModelConfig:
    return ModelConfig(
        arch_id="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49_152,
        mlp_kind="swiglu",
        rope_theta=10_000.0,
        tie_embeddings=True,
    )
