"""State-dict layout shared by the models' converters."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def unstack_blocks(state) -> Dict[str, torch.Tensor]:
    """A state dict in the JAX package's layout, per-layer tensors stacked
    as ``{"blocks.x": [L, ...]}``, -> the port's per-layer modules'
    ``{"blocks.<i>.x": [...]}``, as tensors (tensors given are sliced
    where they lie: a state made on the card is loaded from there)."""
    out = {}
    for k, v in state.items():
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v)))
        if k.startswith("blocks."):
            for i in range(v.shape[0]):
                out[f"blocks.{i}.{k[len('blocks.'):]}"] = v[i]
        else:
            out[k] = v
    return out
