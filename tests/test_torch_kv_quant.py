"""The port's int8 KV pages and host-memory cold tier against the
reference's, on the CPU.

Both packages get the same numpy inputs (``np.random.default_rng``) and,
for the engines, the same ``repro-tiny`` parameters converted leaf by leaf.
On the CPU the port's ``ops.paged_attention_quant`` runs its plain version
(gather, dequantize, direct attend); the reference's runs the Pallas kernel
in interpret mode.  The CUDA kernel itself is held against the plain
version on the card by ``chip_smoke.py``.

Tolerances:
  * ``kv_quantize``: bit-identical int8 values and f32 scales (the same f32
    arithmetic: ``amax / 127``, the floor, round half to even, clip).
  * int8 paged attention: 2e-5 absolute in f32, 2e-2 in bf16 (as the
    reference's kernel test; in bf16 the reference casts the probabilities
    to bf16 before the PV product, the Pallas kernel keeps them in f32).
  * int8 pools written by the two packages from model activations: int8
    values equal, or off by one only where the reference's ``x / scale`` lies
    within 1e-4 of a rounding tie (activations agree to ~1e-6, not to the
    bit); scales within 1e-5 relative; logits within 1e-4 absolute (f32).
  * engines: identical greedy tokens across packages and between the cold
    tier and a prefix-cache-off engine; int8 against the port's dense engine
    at least ``INT8_EXACT_MATCH_FLOOR`` of the tokens, as in the reference.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import ServeConfig as JaxServeConfig
from repro.config import TrainConfig
from repro.config import get_config as jax_get_config
from repro.kernels.paged_attention import ops as jax_ops
from repro.models import transformer as jtf
from repro.models.attention import kv_dequantize as jax_kv_dequantize
from repro.models.attention import kv_quantize as jax_kv_quantize
from repro.serve.engine import PagedEngine as JaxPagedEngine
from repro.train import steps as jsteps
from repro.train.steps import init_train_state
from repro_torch.config import ServeConfig, get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops
from repro_torch.kernels.paged_attention import ref as pa_ref
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttf
from repro_torch.serve import ContinuousEngine, PagedEngine
from repro_torch.serve.kvpool import ColdTier
from repro_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
POOL_TIE = 1e-4
SCALE_RTOL = 1e-5
LOGIT_TOL = 1e-4
INT8_EXACT_MATCH_FLOOR = 0.60
CPU = torch.device("cpu")

# The reference's paged-engine test geometry (test_serve_paged.py _scfg).
SCFG = dict(max_batch=2, max_seq_len=96, prefill_buckets=(8, 16), page_size=8)


def _t(a):
    return tensor_from_numpy(np.asarray(a), CPU)


@pytest.fixture(scope="module")
def tiny():
    jcfg = jax_get_config("repro-tiny")
    jparams = init_train_state(jax.random.PRNGKey(0), jcfg,
                               TrainConfig())["params"]
    cfg = get_config("repro-tiny")
    model = ttf.Transformer.from_state_dict(
        cfg, params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu"))
    return jcfg, jparams, cfg, model


def _prompt(rng, vocab, n):
    return rng.integers(0, vocab, n).astype(np.int32)


def _outputs(engine, prompts, n):
    reqs = engine.generate(prompts, n)
    out = [reqs[i].output for i in range(len(prompts))]
    engine.close()
    return out


# ----------------------------------------------------------------------------
# kv_quantize / kv_dequantize
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_is_bit_identical_to_reference(dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 8, 3, 32)).astype(np.float32)
    x[0, 0] = 0.0                                  # all-zero rows
    x[1, 2, 1] = 0.0
    x[2] *= 40.0                                   # a wide dynamic range
    jx = jnp.asarray(x).astype(dtype)
    jq, js = jax_kv_quantize(jx)
    tq, ts = tattn.kv_quantize(_t(jx))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy().view(np.int32),
                          np.asarray(js).view(np.int32))
    back = tattn.kv_dequantize(tq, ts)
    assert np.array_equal(back.numpy().view(np.int32),
                          np.asarray(jax_kv_dequantize(jq, js)).view(np.int32))
    assert np.all(back[0, 0].numpy() == 0.0)


# ----------------------------------------------------------------------------
# int8 paged attention: plain version against the reference's Pallas kernel
# ----------------------------------------------------------------------------

def _quant_inputs(dtype, page, seed=0):
    """The reference's int8 kernel-test geometry (T = page * M = 32)."""
    rng = np.random.default_rng(seed)
    B, J, G, N, P = 3, 2, 2, 32, 12
    M = 32 // page
    q = rng.standard_normal((B, J, G, N)).astype(np.float32) * N ** -0.5
    kf = rng.standard_normal((P, page, J, N)).astype(np.float32)
    vf = rng.standard_normal((P, page, J, N)).astype(np.float32)
    table = rng.integers(1, P, (B, M)).astype(np.int32)
    lengths = np.asarray([5, 17, 32], np.int32)
    jq = jnp.asarray(q).astype(dtype)
    kp, ksc = jax_kv_quantize(jnp.asarray(kf))
    vp, vsc = jax_kv_quantize(jnp.asarray(vf))
    jin = (jq, kp, vp, ksc, vsc, jnp.asarray(table), jnp.asarray(lengths))
    return jin, tuple(_t(a) for a in jin)


@pytest.mark.parametrize("page", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_quant_matches_reference(dtype, page):
    jin, tin = _quant_inputs(dtype, page)
    ref = np.asarray(jax_ops.paged_attention_quant(*jin), np.float32)
    plain = pa_ref.paged_attention_quant_ref(*tin)
    before = (pa_ops.launches, pa_ops.quant_launches)
    out = pa_ops.paged_attention_quant(*tin)
    assert (pa_ops.launches, pa_ops.quant_launches) == before   # CPU: plain
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    for got in (plain, out):
        err = float(np.max(np.abs(got.float().numpy() - ref)))
        assert err < TOL[dtype], err
    oracle = np.asarray(jax_ops.paged_attention_quant_ref(*jin), np.float32)
    assert float(np.max(np.abs(out.float().numpy() - oracle))) < TOL[dtype]


def test_supported_quant_gate():
    _, (q, kp, vp, ksc, vsc, *_) = _quant_inputs("float32", 8)
    assert pa_ops.supported_quant(q, kp, vp, ksc, vsc)
    assert not pa_ops.supported_quant(q, kp, vp, ksc, vsc, cap=30.0)
    assert not pa_ops.supported_quant(q[..., :28], kp[..., :28],
                                      vp[..., :28], ksc, vsc)     # N % 8
    _, (q4, kp4, vp4, ksc4, vsc4, *_) = _quant_inputs("float32", 4)
    assert not pa_ops.supported_quant(q4, kp4, vp4, ksc4, vsc4)   # page % 8
    assert not pa_ops.supported_quant(q, kp.float(), vp, ksc, vsc)
    assert not pa_ops.supported_quant(q, kp, vp, ksc.double(), vsc)
    assert not pa_ops.supported_quant(q, kp, vp, ksc[..., :1], vsc)
    assert not pa_ops.supported_quant(q.double(), kp, vp, ksc, vsc)
    assert not pa_ops.supported(q, kp)             # int8 never takes K1


def test_quant_non_cpu_tensors_launch_or_raise_never_fall_back():
    """A tensor that is not on the CPU never reaches the plain version: an
    unsupported shape raises naming it, and the kernel entry refuses
    anything that is not a CUDA tensor (checked before any build)."""
    meta = torch.device("meta")
    q = torch.empty(2, 2, 2, 60, device=meta)
    kp = torch.empty(6, 8, 2, 60, dtype=torch.int8, device=meta)
    sc = torch.empty(6, 8, 2, device=meta)
    table = torch.empty(2, 3, dtype=torch.int32, device=meta)
    lengths = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=r"\(2, 2, 2, 60\)"):
        pa_ops.paged_attention_quant(q, kp, kp, sc, sc, table, lengths)
    q8 = torch.empty(2, 2, 2, 64, device=meta)
    kp8 = torch.empty(6, 8, 2, 64, dtype=torch.int8, device=meta)
    with pytest.raises(ValueError, match="meta"):
        pa_ops.paged_attention_quant(q8, kp8, kp8, sc, sc, table, lengths)
    _, tin = _quant_inputs("float32", 8)
    with pytest.raises(ValueError, match="cpu"):
        pa_kernel.paged_attention_quant_cuda(*tin)


# ----------------------------------------------------------------------------
# int8 pools written from model activations, against the reference
# ----------------------------------------------------------------------------

def _check_int8_pool(jstate, tstate, jsolo=None, assign=None):
    """Values equal or off by one at rounding ties; scales close.  Ties are
    located from the reference's pre-quantization values when given (the
    solo dense cache that was scattered through ``assign``)."""
    for group, axis in (("slots", 1), ("tail", 0)):
        for i in jstate[group]:
            jc, tc = jstate[group][i]["cache"], tstate[group][i]["cache"]
            for key, skey, dkey in (("kp", "ksc", "k"), ("vp", "vsc", "v")):
                jv = np.asarray(jc[key]).astype(np.int32)
                tv = tc[key].numpy().astype(np.int32)
                js, ts = np.asarray(jc[skey]), tc[skey].numpy()
                sl = (slice(None), slice(1, None)) if axis else slice(1, None)
                np.testing.assert_allclose(ts[sl], js[sl], rtol=SCALE_RTOL,
                                           atol=0)
                diff = np.abs(jv - tv)[sl]
                assert diff.max() <= 1, (group, i, key)
                if diff.max() == 0:
                    continue
                assert jsolo is not None, (group, i, key, "off by one")
                dense = np.asarray(jsolo[group][i]["cache"][dkey])
                lead = dense.shape[:axis]
                paged = dense.reshape(lead + (len(assign), -1)
                                      + dense.shape[axis + 2:])
                for logical, phys in enumerate(assign):
                    if phys == 0:
                        continue
                    idx = ((slice(None), phys) if axis else (phys,))
                    src = ((slice(None), logical) if axis else (logical,))
                    d = np.abs(jv[idx] - tv[idx])
                    r = paged[src] / js[idx][..., None]
                    frac = np.abs(np.abs(r - np.floor(r)) - 0.5)
                    assert np.all(frac[d == 1] < POOL_TIE), (group, i, key)


def test_int8_paged_prefill_and_decode_match_reference(tiny):
    jcfg, jparams, tcfg, model = tiny
    tparams = model.tree()
    page, M = 8, 8
    P = 2 * M + 1
    rng = np.random.default_rng(2)
    a = _prompt(rng, jcfg.vocab_size, 19)
    b = np.concatenate([a[:page], _prompt(rng, jcfg.vocab_size, 5)])
    # Row 1 shares row 0's first page (a prefix hit, dequantized on load).
    table = np.stack([np.arange(1, M + 1),
                      np.concatenate([[1], np.arange(M + 1, 2 * M)])
                      ]).astype(np.int32)
    jstate = jtf.init_paged_decode_state(jcfg, P, page, kv_quant="int8")
    tstate = ttf.init_paged_decode_state(tcfg, P, page, kv_quant="int8",
                                         device="cpu")
    jprefill = jsteps.make_paged_prefill_step(jcfg, M * page)
    tprefill = tsteps.make_paged_prefill_step(tcfg, M * page)
    for row, prompt, hit_len in ((0, a, 0), (1, b, page)):
        suffix = prompt[hit_len:]
        S = 16 if len(suffix) <= 16 else 32
        toks = np.zeros((1, S), np.int32)
        toks[0, :len(suffix)] = suffix
        pos = (hit_len + np.arange(S, dtype=np.int32))[None]
        assign = table[row].copy()
        assign[:hit_len // page] = 0
        assign[-(-(len(prompt) + 8) // page):] = 0
        jsolo, jlast = jprefill(jparams, jstate, {
            "tokens": jnp.asarray(toks), "positions": jnp.asarray(pos),
            "length": jnp.asarray(len(prompt), jnp.int32),
            "hit_len": jnp.asarray(hit_len, jnp.int32),
            "table": jnp.asarray(table[row])})
        tsolo, tlast = tprefill(tparams, tstate, {
            "tokens": torch.from_numpy(toks),
            "positions": torch.from_numpy(pos),
            "length": len(prompt), "hit_len": hit_len,
            "table": torch.from_numpy(table[row].copy())})
        assert float(np.max(np.abs(np.asarray(jlast)
                                   - tlast.numpy()))) < LOGIT_TOL
        jstate = jtf.scatter_solo_pages(jstate, jsolo, jnp.asarray(assign))
        ttf.scatter_solo_pages(tstate, tsolo, torch.from_numpy(assign))
        _check_int8_pool(jstate, tstate, jsolo, assign)
        # Within the port the pool holds kv_quantize of its own solo cache,
        # bit for bit.
        for group, axis in (("slots", 1), ("tail", 0)):
            for i in tstate[group]:
                pool = tstate[group][i]["cache"]
                dense = tsolo[group][i]["cache"]["k"]
                lead = tuple(dense.shape[:axis])
                want, want_s = tattn.kv_quantize(dense.reshape(
                    lead + (M, page) + tuple(dense.shape[axis + 2:])))
                for logical, phys in enumerate(assign):
                    if phys == 0:
                        continue
                    got = pool["kp"][:, phys] if axis else pool["kp"][phys]
                    got_s = pool["ksc"][:, phys] if axis else pool["ksc"][phys]
                    ref = want[:, logical] if axis else want[logical]
                    ref_s = want_s[:, logical] if axis else want_s[logical]
                    assert torch.equal(got, ref) and torch.equal(got_s, ref_s)

    jdecode = jsteps.make_paged_decode_step(jcfg)
    tdecode = tsteps.make_paged_decode_step(tcfg)
    tok = np.asarray([int(a[-1]), int(b[-1])], np.int32)
    pos = np.asarray([len(a), len(b)], np.int32)
    for _ in range(6):
        jstate, jlogits = jdecode(
            jparams, jstate, {"tokens": jnp.asarray(tok)[:, None],
                              "positions": jnp.asarray(pos)[:, None]},
            jnp.asarray(table))
        _, tlogits = tdecode(
            tparams, tstate, {"tokens": torch.from_numpy(tok.copy())[:, None],
                              "positions": torch.from_numpy(pos)[:, None]},
            torch.from_numpy(table))
        assert float(np.max(np.abs(np.asarray(jlogits)
                                   - tlogits.numpy()))) < LOGIT_TOL
        tok = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)
        pos = pos + 1
    _check_int8_pool(jstate, tstate)


def test_paged_cache_write_quantizes_each_entry(tiny):
    """Decode's quantize-on-write lands ``kv_quantize`` of each new entry,
    bit for bit, at the page and offset the block table gives."""
    _, _, cfg, _ = tiny
    rng = np.random.default_rng(6)
    cache = tattn.init_paged_cache(cfg, 9, 8, torch.float32,
                                   kv_quant="int8", device="cpu")
    assert cache["kp"].dtype == torch.int8 and cache["ksc"].shape == (9, 8, 2)
    k = torch.from_numpy(rng.standard_normal((2, 1, 2, 32)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 1, 2, 32)).astype(np.float32))
    table = torch.tensor([[3, 5], [7, 2]], dtype=torch.int32)
    positions = torch.tensor([[11], [4]], dtype=torch.int32)
    tattn.paged_cache_write(cache, k, v, positions, table)
    for row, (phys, off) in enumerate(((5, 3), (7, 4))):
        for key, skey, x in (("kp", "ksc", k), ("vp", "vsc", v)):
            want, want_s = tattn.kv_quantize(x[row, 0])
            assert torch.equal(cache[key][phys, off], want)
            assert torch.equal(cache[skey][phys, off], want_s)


# ----------------------------------------------------------------------------
# engines
# ----------------------------------------------------------------------------

def test_int8_paged_engine_matches_reference_greedy(tiny):
    jcfg, jparams, cfg, model = tiny
    rng = np.random.default_rng(9)
    prefix = _prompt(rng, cfg.vocab_size, 16)
    prompts = [_prompt(rng, cfg.vocab_size, n) for n in (5, 11, 17, 24)]
    prompts += [np.concatenate([prefix, _prompt(rng, cfg.vocab_size, k)])
                for k in (5, 9)]
    ref = _outputs(JaxPagedEngine(jcfg, jparams,
                                  JaxServeConfig(**SCFG, kv_quant="int8")),
                   prompts, 8)
    eng = PagedEngine(cfg, model, ServeConfig(**SCFG, kv_quant="int8"))
    got = _outputs(eng, prompts, 8)
    assert got == ref
    assert eng.pool.stats()["prefix_hit_pages"] > 0
    assert eng.backend.stats()["cold_pages"] == 0


def test_int8_paged_engine_tracks_dense_greedy(tiny):
    """The reference's floor: one early argmax flip makes the rest of that
    request's greedy rollout diverge, so the token-level rate understates
    per-step agreement."""
    _, _, cfg, model = tiny
    rng = np.random.default_rng(9)
    prompts = [_prompt(rng, cfg.vocab_size, n) for n in (5, 11, 17, 24)]
    d = _outputs(ContinuousEngine(cfg, model, ServeConfig(**SCFG)),
                 prompts, 8)
    p = _outputs(PagedEngine(cfg, model, ServeConfig(**SCFG,
                                                     kv_quant="int8")),
                 prompts, 8)
    match = total = 0
    for a, b in zip(p, d):
        assert len(a) == len(b) == 8
        match += sum(x == y for x, y in zip(a, b))
        total += 8
    assert match / total >= INT8_EXACT_MATCH_FLOOR, (match, total)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_cold_tier_spill_and_fault_roundtrip(tiny, kv_quant):
    """Evicted prefix pages spill to the host tier through the sidecar and
    fault back on the next prefix hit, reproducing exact outputs."""
    _, _, cfg, model = tiny
    rng = np.random.default_rng(4)
    prefix = _prompt(rng, cfg.vocab_size, 24)
    p1 = np.concatenate([prefix, _prompt(rng, cfg.vocab_size, 5)])
    p2 = np.concatenate([prefix, _prompt(rng, cfg.vocab_size, 7)])
    eng = PagedEngine(cfg, model, ServeConfig(
        **SCFG, num_pages=16, cold_pages=64, kv_quant=kv_quant))
    r1 = eng.submit(p1, 6)
    eng.run()
    # Flood with unrelated prompts: cached prefix pages lose the LRU race.
    for _ in range(6):
        eng.submit(_prompt(rng, cfg.vocab_size, 30), 8)
    eng.run()
    assert eng.executor.drain()
    assert eng.pool.stats()["spills"] > 0 and len(eng.cold) > 0
    assert eng.stats()["cold_pages"] == len(eng.cold)
    for blob in eng.cold.blobs():                 # staged by the sidecar
        assert set(blob) == {"slots", "tail"}
        leaf = blob["slots"]["0"]["cache"]["kp"]
        assert leaf.shape == (cfg.num_layers, 8, 2, 32)
        assert set(blob["slots"]["0"]["cache"]) == (
            {"kp", "vp", "ksc", "vsc"} if kv_quant == "int8"
            else {"kp", "vp"})
    r2 = eng.submit(p2, 6)                        # prefix faults back in
    eng.run()
    assert eng.pool.stats()["faults"] > 0
    assert eng.executor.stats()["failed"] == 0

    cold_off = PagedEngine(cfg, model, ServeConfig(
        **SCFG, prefix_cache=False, kv_quant=kv_quant))
    s1 = cold_off.submit(p1, 6)
    s2 = cold_off.submit(p2, 6)
    cold_off.run()
    assert eng.request(r1).output == cold_off.request(s1).output
    assert eng.request(r2).output == cold_off.request(s2).output
    eng.close()
    cold_off.close()


def test_kv_quant_mode_validated(tiny):
    _, _, cfg, model = tiny
    with pytest.raises(ValueError, match="kv_quant"):
        PagedEngine(cfg, model, ServeConfig(**SCFG, kv_quant="fp4"))
    with pytest.raises(ValueError, match="kv_quant"):
        tattn.init_paged_cache(cfg, 4, 8, torch.float32, kv_quant="fp4",
                               device="cpu")


def test_probe_counts_hot_and_cold_prefix_pages(tiny):
    _, _, cfg, model = tiny
    rng = np.random.default_rng(4)
    prefix = _prompt(rng, cfg.vocab_size, 24)
    eng = PagedEngine(cfg, model, ServeConfig(**SCFG, num_pages=16,
                                              cold_pages=64))
    eng.generate([np.concatenate([prefix, _prompt(rng, cfg.vocab_size, 5)])],
                 4)
    handle = eng.backend.prepare_probe(prefix)
    assert eng.backend.probe(handle) == (3, 24)    # hot: three full pages
    eng.generate([_prompt(rng, cfg.vocab_size, 30) for _ in range(6)], 8)
    assert eng.executor.drain()
    hot = sum(eng.pool.probe(c) for c in handle)
    cold = sum(eng.cold.contains(c) for c in handle)
    assert cold > 0 and hot + cold == 3
    assert eng.backend.probe(handle) == (3, 24)    # hot or cold
    assert eng.pool.stats()["faults"] == 0         # probing never faults
    eng.close()


def test_cold_tier_capacity_and_replace():
    tier = ColdTier(capacity_pages=2)
    tier.put(b"k1", "dev1")
    tier.put(b"k2", "dev2")
    tier.replace(b"k1", "host1")                # sidecar staged to host
    assert not tier.dropped and tier.blobs() == ["host1", "dev2"]
    tier.put(b"k3", "dev3")                     # LRU k1 dropped
    assert tier.dropped == 1 and tier.take(b"k1") is None
    tier.replace(b"k1", "late")                 # stale staging: no-op
    assert tier.take(b"k1") is None and not tier.contains(b"k1")
    assert tier.take(b"k2") == "dev2"
    assert tier.take(b"k2") is None             # take pops
    assert len(tier) == 1 and tier.rejected == 0


def test_cold_tier_zero_capacity_rejects_and_overflow_keeps_new_entry():
    tier = ColdTier(capacity_pages=0)
    tier.put(b"k", "blob")
    assert len(tier) == 0 and tier.take(b"k") is None
    assert tier.dropped == 0 and tier.rejected == 1
    one = ColdTier(capacity_pages=1)
    one.put(b"k1", "a")
    one.put(b"k2", "b")                          # overflow drops k1, not k2
    assert one.dropped == 1 and one.take(b"k1") is None
    assert one.take(b"k2") == "b"
