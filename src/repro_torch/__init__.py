"""``repro_torch`` — the PyTorch/CUDA port of the ``repro`` serving system.

A package of its own beside the JAX reference: it imports ``torch``, numpy
and the standard library, never ``jax`` and never ``repro``.  Entry points
run on the card (``device=None`` means ``"cuda"``) unless the caller asks
for the CPU; each kernel of the reference is a kernel written by hand for
Hopper (``kernels/``, ``csrc/``).
"""
