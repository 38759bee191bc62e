"""Architecture registry: ``--arch <id>`` resolution (the port's copy)."""
from __future__ import annotations

from typing import Callable, Dict, List

from repro_torch.config.model import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]) -> Callable[[], ModelConfig]:
        if arch_id in _REGISTRY:
            raise ValueError(f"duplicate arch id {arch_id!r}")
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]()


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded() -> None:
    # Importing repro_torch.configs registers every ported architecture.
    import repro_torch.configs  # noqa: F401
