"""The port's paged-attention wrapper against the reference's.

On the CPU the port's ``ops.paged_attention`` runs its plain version
(gather + direct attend); the reference's runs the Pallas kernel in
interpret mode.  Both get the same numpy inputs.  The CUDA kernel itself
is held against the plain version on the card by ``chip_smoke.py``.

Tolerances (as ``tests/test_kernels.py``): 2e-5 absolute in f32, 2e-2 in
bf16 (the reference casts the probabilities to bf16 before the PV
product, the Pallas kernel keeps them in f32).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.paged_attention import ops as jax_ops
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_ref
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels.paged_attention import kernel as pa_kernel
from repro_torch.kernels.paged_attention import ops as pa_ops

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

TOL = {"float32": 2e-5, "bfloat16": 2e-2}

# (B, J, G, N, P, page, M, lengths, dead rows): the reference's paged-kernel
# test geometry, then the SmolLM-360M geometry (J=5, G=3, N=64, page 16)
# with lengths 1, page, page+1 and full, plus a released row whose table
# points at the scratch page and whose length runs past the table.
CASES = [
    (3, 2, 2, 32, 12, 8, 4, [5, 17, 32], 0),
    (5, 5, 3, 64, 12, 16, 4, [1, 16, 17, 64, 100], 1),
]


def _inputs(case, dtype, seed=0):
    B, J, G, N, P, page, M, lengths, dead = case
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, J, G, N)).astype(np.float32) * N ** -0.5
    kp = rng.standard_normal((P, page, J, N)).astype(np.float32)
    vp = rng.standard_normal((P, page, J, N)).astype(np.float32)
    table = np.stack([rng.permutation(np.arange(1, P))[:M]
                      for _ in range(B)]).astype(np.int32)
    if dead:
        table[-dead:] = 0
    lengths = np.asarray(lengths, np.int32)
    # Cast once on the JAX side so both packages see identical bf16 bits.
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, kp, vp))
    return (jq, jk, jv, jnp.asarray(table), jnp.asarray(lengths)), tuple(
        tensor_from_numpy(np.asarray(a), torch.device("cpu"))
        for a in (jq, jk, jv, table, lengths))


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("case", CASES, ids=["ref-geometry", "smollm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_paged_attention_matches_reference(case, dtype):
    jin, tin = _inputs(case, dtype)
    before = pa_ops.launches
    out = pa_ops.paged_attention(*tin)
    assert pa_ops.launches == before         # CPU tensors: plain version
    assert out.dtype == tin[0].dtype and out.shape == tin[0].shape
    got = out.float().numpy()
    assert _err(got, jax_ops.paged_attention(*jin)) < TOL[dtype]
    assert _err(got, jax_ref(*jin)) < TOL[dtype]


def test_supported_gate_matches_reference_divisibility():
    _, (q, kp, *_) = _inputs(CASES[1], "float32")
    assert pa_ops.supported(q, kp)
    assert not pa_ops.supported(q[..., :60], kp[..., :60])    # N % 8
    assert not pa_ops.supported(q, kp[:, :12])                # page % 8
    assert not pa_ops.supported(q, kp, cap=30.0)
    assert not pa_ops.supported(q.double(), kp.double())


def test_non_cpu_tensors_launch_or_raise_never_fall_back():
    """A tensor that is not on the CPU never reaches the plain version: an
    unsupported shape raises, and the kernel entry refuses anything that is
    not a CUDA tensor (checked before any build)."""
    meta = torch.device("meta")
    q = torch.empty(2, 2, 2, 60, device=meta)
    kp = torch.empty(6, 8, 2, 60, device=meta)
    table = torch.empty(2, 3, dtype=torch.int32, device=meta)
    lengths = torch.empty(2, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match=r"\(2, 2, 2, 60\)"):
        pa_ops.paged_attention(q, kp, kp, table, lengths)
    q8 = torch.empty(2, 2, 2, 64, device=meta)
    kp8 = torch.empty(6, 8, 2, 64, device=meta)
    with pytest.raises(ValueError, match="meta"):
        pa_ops.paged_attention(q8, kp8, kp8, table, lengths)
    _, tin = _inputs(CASES[0], "float32")
    with pytest.raises(ValueError, match="cpu"):
        pa_kernel.paged_attention_cuda(*tin)
