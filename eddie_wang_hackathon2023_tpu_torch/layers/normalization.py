"""LayerNorm and RMSNorm with fp32 statistics (the JAX package's
``layers/normalization.py``)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import layer_norm, rms_norm
from .linear import frozen


class LayerNorm(nn.Module):

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 dtype=torch.float32):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        self.weight = frozen((normalized_shape,), dtype)
        self.bias = frozen((normalized_shape,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


class RmsNorm(nn.Module):
    """No mean subtraction and no bias (LLaMA)."""

    def __init__(self, normalized_shape: int, eps: float = 1e-6,
                 dtype=torch.float32):
        super().__init__()
        self.normalized_shape = normalized_shape
        self.eps = eps
        self.weight = frozen((normalized_shape,), dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)
