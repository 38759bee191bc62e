"""Importing this package registers every architecture the port serves.

The slice covers the dense global-attention decoders; the other archs of
the reference's ``configs/`` come with their mixers and MLP kinds (ROADMAP Q7-Q9,
Q11)."""
from repro_torch.configs import smollm_360m, tiny  # noqa: F401
