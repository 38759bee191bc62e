"""Parameter conversion from the reference's tree, leaf by leaf.

The reference's parameters, pulled to the host as numpy arrays (for
instance ``jax.tree.map(np.asarray, params)``), become the port's
``state_dict``: the same paths joined with dots, the same shapes.  bf16
leaves arrive as numpy's ``bfloat16`` extension dtype, which torch cannot
read directly; they cross through a ``uint16`` view of the same bits.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.common import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray, device: torch.device,
                      dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        t = t.view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: Dict[str, Any], device: DeviceLike = None,
                      dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays -> flat ``state_dict`` on ``device``
    (``None``: the card), optionally cast to ``dtype``."""
    dev = resolve_device(device)
    out: Dict[str, torch.Tensor] = {}

    def visit(node, prefix):
        for key, leaf in node.items():
            path = f"{prefix}{key}"
            if isinstance(leaf, dict):
                visit(leaf, path + ".")
            else:
                out[path] = tensor_from_numpy(np.asarray(leaf), dev, dtype)
    visit(tree, "")
    return out
