"""Hand-written Hopper kernels, one directory each, in the reference's
three-file shape: ``kernel.py`` (build + launch of the CUDA source under
``repro_torch/csrc/``), ``ops.py`` (the wrapper: ``supported()`` gate,
launch counter, plain version for CPU tensors) and ``ref.py`` (the plain
PyTorch version)."""
