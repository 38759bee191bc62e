"""The port's serving engines against the reference's, and their own
invariants, on the CPU.

The reference's ``PagedEngine`` and the port's serve the same prompts with
the same (converted) ``repro-tiny`` parameters: greedy tokens must be
identical.  Both run with their default cold tier, which the pool here
never runs short enough to use (``tests/test_torch_kv_quant.py`` drives
spill and fault-in).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax

from repro.config import ServeConfig as JaxServeConfig
from repro.config import TrainConfig
from repro.config import get_config as jax_get_config
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro.train.steps import init_train_state
from repro_torch.config import ServeConfig, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models.transformer import Transformer
from repro_torch.serve import ContinuousEngine, PagedEngine, make_engine

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# The reference's paged-engine test geometry (test_serve_paged.py _scfg).
SCFG = dict(max_batch=2, max_seq_len=96, prefill_buckets=(8, 16), page_size=8)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("repro-tiny")
    jparams = init_train_state(jax.random.PRNGKey(0), jcfg,
                               TrainConfig())["params"]
    cfg = get_config("repro-tiny")
    model = Transformer.from_state_dict(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jparams, cfg, model


def _scfg(**kw):
    return ServeConfig(**dict(SCFG, **kw))


def _prompts(vocab, seed=7):
    """Prompts sharing a two-page prefix, one sharing a single page, and an
    unrelated one."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, 16).astype(np.int32)
    return [np.concatenate([base, rng.integers(0, vocab, 5)]),
            np.concatenate([base, rng.integers(0, vocab, 9)]),
            rng.integers(0, vocab, 13),
            np.concatenate([base[:8], rng.integers(0, vocab, 3)]),
            np.concatenate([base, rng.integers(0, vocab, 2)])]


def _outputs(engine, prompts, n):
    reqs = engine.generate(prompts, n)
    out = [reqs[i].output for i in range(len(prompts))]
    engine.close()
    return out


def test_paged_engine_matches_reference_greedy(tiny):
    jcfg, jparams, cfg, model = tiny
    prompts = _prompts(cfg.vocab_size)
    ref = _outputs(JaxPagedEngine(jcfg, jparams, JaxServeConfig(**SCFG)),
                   prompts, 6)
    eng = PagedEngine(cfg, model, _scfg())
    got = _outputs(eng, prompts, 6)
    assert got == ref
    assert eng.pool.stats()["prefix_hit_pages"] > 0


def test_prefix_cache_on_equals_off_and_dense(tiny):
    _, _, cfg, model = tiny
    prompts = _prompts(cfg.vocab_size, seed=11)
    on = _outputs(PagedEngine(cfg, model, _scfg()), prompts, 7)
    off = _outputs(PagedEngine(cfg, model, _scfg(prefix_cache=False)),
                   prompts, 7)
    dense = _outputs(ContinuousEngine(cfg, model, _scfg()), prompts, 7)
    assert on == off == dense


def test_every_page_is_freed_when_the_engine_drains(tiny):
    _, _, cfg, model = tiny
    eng = PagedEngine(cfg, model, _scfg(prefix_cache=False))
    reqs = eng.generate(_prompts(cfg.vocab_size, seed=3), 5)
    assert all(len(r.output) == 5 for r in reqs.values())
    st = eng.pool.stats()
    assert st["active"] == 0 and st["free"] == st["pages"] - 1
    assert (eng.backend._table == 0).all()
    eng.close()


def test_submit_after_close_raises(tiny):
    _, _, cfg, model = tiny
    eng = make_engine(cfg, model, _scfg(engine_mode="paged"))
    assert isinstance(eng, PagedEngine)
    eng.close()
    with pytest.raises(RuntimeError, match="closed"):
        eng.submit(np.arange(4, dtype=np.int32), 2)


def test_slice_boundaries_raise_not_implemented(tiny):
    _, _, cfg, model = tiny
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        PagedEngine(cfg, model, dataclasses.replace(_scfg(), speculative=True))
    for mode in ("cluster", "disaggregated", "fixed"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            make_engine(cfg, model, _scfg(engine_mode=mode))
    with pytest.raises(NotImplementedError, match="ROADMAP Q3"):
        PagedEngine(cfg, model, _scfg(), handoff_endpoints=[{}])
    eng = PagedEngine(cfg, model, _scfg())
    for call in (lambda: eng.backend.export_handoff(None, 0, 1, 0),
                 lambda: eng.backend.import_handoff(None, None)):
        with pytest.raises(NotImplementedError, match="ROADMAP Q3"):
            call()
    eng.close()


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("repro-tiny")
    with pytest.raises(RuntimeError, match="CUDA"):
        Transformer.init(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)})
