from repro_torch.config.model import (
    MIX_ATTN, MIX_ATTN_CROSS, MIX_ATTN_LOCAL, MIX_RGLRU, MIX_RWKV6,
    ModelConfig)
from repro_torch.config.registry import get_config, list_archs, register
from repro_torch.config.run import EngineMode, ServeConfig

__all__ = [
    "EngineMode", "ModelConfig", "ServeConfig",
    "get_config", "list_archs", "register",
    "MIX_ATTN", "MIX_ATTN_LOCAL", "MIX_ATTN_CROSS", "MIX_RGLRU", "MIX_RWKV6",
]
