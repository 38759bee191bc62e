"""The port's model against the reference on converted parameters.

The reference's ``init_params`` draws the weights; ``convert`` copies them
leaf by leaf into the port.  Both packages then get the same token ids and
positions, and the test diffs the logits and every page-pool leaf of:

  * the train-style forward (``states=None``),
  * a paged prefill into a fresh pool, then a second prefill that reuses
    the first prompt's leading page through ``load_prefix_pages``
    (nonzero ``hit_len``),
  * 8 batched paged decode steps over both rows.

Tolerance: 1e-4 absolute on logits and pool entries, all in f32.  Run
with ``-s`` to print the largest difference each test measured.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.config import get_config as jax_get_config
from repro.models import transformer as jtf
from repro.train import steps as jsteps
from repro_torch.config import get_config
from repro_torch.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.train import steps as tsteps

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = 1e-4
CPU = torch.device("cpu")


def _configs(name):
    """(reference config, port config, page size) for one parity case."""
    if name == "repro-tiny":
        return jax_get_config(name), get_config(name), 8
    # SmolLM-360M's geometry (15/5 heads, head_dim 64, d_model 960,
    # d_ff 2560) at 2 layers, a 4096-token vocab and f32.
    narrow = dict(num_layers=2, vocab_size=4096, dtype="float32")
    return (dataclasses.replace(jax_get_config("smollm-360m"), **narrow),
            dataclasses.replace(get_config("smollm-360m"), **narrow), 16)


@pytest.fixture(scope="module", params=["repro-tiny", "smollm-narrow"])
def pair(request):
    jcfg, tcfg, page = _configs(request.param)
    jparams = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    np_tree = jax.tree.map(np.asarray, jparams)
    model = ttf.Transformer.from_state_dict(
        tcfg, params_from_numpy(np_tree, device="cpu"))
    return jcfg, jparams, tcfg, model.tree(), page


def _close(a, b, what):
    err = float(np.max(np.abs(np.asarray(a, np.float32)
                              - torch.as_tensor(b).float().numpy())))
    assert err < TOL, (what, err)
    return err


def test_state_dict_keys_are_the_reference_paths(pair):
    jcfg, jparams, tcfg, tparams, _ = pair
    flat = ttf.Transformer(tcfg, tparams).state_dict()
    paths = {".".join(str(k.key) for k in path): leaf.shape
             for path, leaf in jax.tree_util.tree_leaves_with_path(jparams)}
    assert {k: tuple(v.shape) for k, v in flat.items()} == paths
    assert "layers.0.mixer.wq" in flat


def test_train_forward_matches(pair):
    jcfg, jparams, tcfg, tparams, _ = pair
    tokens = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 24)).astype(np.int32)
    jlogits, _, _ = jtf.forward(jparams, jcfg, jnp.asarray(tokens))
    tlogits, _ = ttf.forward(tparams, tcfg, torch.from_numpy(tokens))
    print(f"\n{tcfg.arch_id} train logits: max abs diff "
          f"{_close(jlogits, tlogits, 'train logits'):.3g}")


def _leaves(pstate):
    """Every pool leaf without the scratch page 0, whose content is garbage
    by design (duplicate scatter indices land there in either order)."""
    out = {}
    for group, axis in (("slots", 1), ("tail", 0)):
        for i, st in pstate[group].items():
            for key, leaf in st["cache"].items():
                out[f"{group}.{i}.{key}"] = (leaf[:, 1:] if axis else
                                             leaf[1:])
    return out


def _compare_pools(jstate, tstate, what):
    jl, tl = _leaves(jstate), _leaves(tstate)
    assert jl.keys() == tl.keys()
    return max(_close(jl[key], tl[key], f"{what}: {key}") for key in jl)


def test_paged_prefill_prefix_reuse_and_decode_match(pair):
    jcfg, jparams, tcfg, tparams, page = pair
    M = 64 // page                       # capacity 64 tokens per row
    P = 2 * M + 1
    rng = np.random.default_rng(2)
    a = rng.integers(0, jcfg.vocab_size, 19).astype(np.int32)
    b = np.concatenate([a[:page], rng.integers(0, jcfg.vocab_size, 5)
                        ]).astype(np.int32)
    # Row 0 owns pages 1..M, row 1 shares row 0's first page (prefix hit)
    # and owns pages M+1..2M-1 after it.
    table = np.stack([np.arange(1, M + 1),
                      np.concatenate([[1], np.arange(M + 1, 2 * M)])
                      ]).astype(np.int32)

    jstate = jtf.init_paged_decode_state(jcfg, P, page)
    tstate = ttf.init_paged_decode_state(tcfg, P, page, device="cpu")
    errs = {"logits": 0.0, "pool": 0.0}
    jprefill = jsteps.make_paged_prefill_step(jcfg, M * page)
    tprefill = tsteps.make_paged_prefill_step(tcfg, M * page)
    for row, prompt, hit_len in ((0, a, 0), (1, b, page)):
        S = 16 if len(prompt) - hit_len <= 16 else 32
        suffix = prompt[hit_len:]
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
            "tokens": torch.from_numpy(toks), "positions": torch.from_numpy(pos),
            "length": len(prompt), "hit_len": hit_len,
            "table": torch.from_numpy(table[row].copy())})
        errs["logits"] = max(errs["logits"], _close(
            jlast, tlast, f"prefill logits row {row}"))
        jstate = jtf.scatter_solo_pages(jstate, jsolo, jnp.asarray(assign))
        ttf.scatter_solo_pages(tstate, tsolo, torch.from_numpy(assign))
        errs["pool"] = max(errs["pool"], _compare_pools(
            jstate, tstate, f"pool after prefill {row}"))

    jdecode = jsteps.make_paged_decode_step(jcfg)
    tdecode = tsteps.make_paged_decode_step(tcfg)
    tok = np.asarray([int(a[-1]), int(b[-1])], np.int32)
    pos = np.asarray([len(a), len(b)], np.int32)
    for step in range(8):
        jstate, jlogits = jdecode(
            jparams, jstate, {"tokens": jnp.asarray(tok)[:, None],
                              "positions": jnp.asarray(pos)[:, None]},
            jnp.asarray(table))
        _, tlogits = tdecode(
            tparams, tstate, {"tokens": torch.from_numpy(tok.copy())[:, None],
                              "positions": torch.from_numpy(pos)[:, None]},
            torch.from_numpy(table))
        errs["logits"] = max(errs["logits"], _close(
            jlogits, tlogits, f"decode logits step {step}"))
        tok = np.asarray(jnp.argmax(jlogits, axis=-1), np.int32)
        pos = pos + 1
    errs["pool"] = max(errs["pool"], _compare_pools(
        jstate, tstate, "pool after decode"))
    assert int(tstate["pos"]) == int(jstate["pos"])
    print(f"\n{tcfg.arch_id} paged prefill + decode: max abs diff logits "
          f"{errs['logits']:.3g}, pool {errs['pool']:.3g}")


def test_bf16_leaves_convert_bit_exactly():
    leaf = jax.random.normal(jax.random.PRNGKey(3), (4, 33)).astype(
        jnp.bfloat16)
    host = np.asarray(leaf)
    assert host.dtype.name == "bfloat16"
    t = tensor_from_numpy(host, CPU)
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy(),
                          host.view(np.int16))
    assert np.array_equal(t.float().numpy(), host.astype(np.float32))
    sd = params_from_numpy({"embed": host, "final_norm": {"scale": host[0]}},
                           device="cpu", dtype=torch.float32)
    assert sd["final_norm.scale"].dtype == torch.float32
    assert sd["embed"].shape == (4, 33)
