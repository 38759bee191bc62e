"""Engine selection: one ``EngineMode`` enum, one ``make_engine`` factory
(counterpart of the reference's ``serve/factory.py``)."""
from __future__ import annotations

from repro_torch.config.model import ModelConfig
from repro_torch.config.run import EngineMode, ServeConfig
from repro_torch.models.transformer import ExecPolicy, Transformer
from repro_torch.serve.engines import ContinuousEngine, PagedEngine

# Modes the port does not serve yet, with the ROADMAP item that brings them.
_NOT_PORTED = {
    EngineMode.FIXED: "the fixed-batch baseline (ROADMAP M14)",
    EngineMode.DISAGGREGATED: "disaggregated prefill/decode (ROADMAP Q3)",
    EngineMode.CLUSTER: "the multi-replica cluster (ROADMAP Q5)",
}


def resolve_engine_mode(scfg: ServeConfig) -> EngineMode:
    """The configured engine mode; ``""`` defaults to continuous batching.
    Raises ValueError for a mode string outside ``EngineMode``."""
    if scfg.engine_mode:
        return EngineMode(scfg.engine_mode)
    return EngineMode.CONTINUOUS


def make_engine(cfg: ModelConfig, model: Transformer, scfg: ServeConfig,
                policy: ExecPolicy = ExecPolicy()) -> ContinuousEngine:
    """Build the serve engine ``scfg`` asks for."""
    mode = resolve_engine_mode(scfg)
    if mode in _NOT_PORTED:
        raise NotImplementedError(
            f"engine_mode={mode.value!r}: {_NOT_PORTED[mode]} is not ported "
            "yet")
    if mode == EngineMode.PAGED:
        return PagedEngine(cfg, model, scfg, policy)
    return ContinuousEngine(cfg, model, scfg, policy)
