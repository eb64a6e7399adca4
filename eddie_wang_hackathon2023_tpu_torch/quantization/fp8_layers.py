"""The FP8 (e4m3) quantise-dequantise linear family (the JAX package's
``quantization/fp8_layers.py``): the float weight is kept, and each
forward rounds the activations and the weight to e4m3 with their
per-tensor scaling factors (the saturating cast), dequantises both to fp32
and multiplies them with fp32 accumulation, so the numerics are real e4m3
rounding while the product runs in fp32.  Plain PyTorch: no kernel of the
JAX package sits behind these layers (XLA runs their graph there).  Under
tensor parallelism (JAX ``fp8_layers.py:63-97``) ``FP8Linear`` splits its
out-features and ``FP8RowLinear`` its in-features (the fp32 partial
products summed over the group before the cast, the bias after); the
per-tensor scales are replicated."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import ACT2FN
from ..layers.linear import TensorParallel, frozen
from ..ops.attention import FP8, FP8_MAX


def quantize_fp8(x: torch.Tensor, scale) -> torch.Tensor:
    """x / scale, clipped to +-FP8_MAX, cast to e4m3 (the JAX package's
    ``quantize_fp8``)."""
    scaled = x.float() / scale
    return torch.clamp(scaled, -FP8_MAX, FP8_MAX).to(FP8)


def dequantize_fp8(q: torch.Tensor, scale,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def fp8_qdq(x: torch.Tensor, scale, dtype=None) -> torch.Tensor:
    """The quantise-dequantise round trip around an FP8 matmul operand."""
    return dequantize_fp8(quantize_fp8(x, scale), scale,
                          dtype or torch.float32)


def fp8_scales_from_amax(amax: float) -> float:
    """A per-tensor scaling factor from a calibration amax: amax / FP8_MAX
    (quantising divides by it)."""
    return max(float(amax), 1e-8) / FP8_MAX


class FP8Linear(TensorParallel, nn.Module):
    """y = qdq(x) qdq(W)^T + b, weight [out, in], the fp32 product cast to
    x's dtype, then the bias in that dtype."""
    TP_DIMS = {"col": {"weight": 0, "bias": 0}, "row": {"weight": 1}}

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = frozen((out_features, in_features), dtype)
        self.activation_scaling_factor = frozen((1,), torch.float32)
        self.weights_scaling_factor = frozen((1,), torch.float32)
        self.bias = frozen((out_features,), dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xq = fp8_qdq(x, self.activation_scaling_factor)
        wq = fp8_qdq(self.weight, self.weights_scaling_factor)
        return self.tp_finish(torch.matmul(xq, wq.t()), x.dtype)


class FP8RowLinear(FP8Linear):
    """The row-parallel layer of the JAX package; the same function here."""


class FP8MLP(nn.Module):
    """proj(act(fc(x))) over :class:`FP8Linear` and :class:`FP8RowLinear`."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 hidden_act: str = "gelu", bias: bool = True,
                 dtype=torch.float32):
        super().__init__()
        if hidden_act not in ACT2FN:
            raise ValueError(f"unsupported activation: {hidden_act}")
        self.fc = FP8Linear(hidden_size, ffn_hidden_size, bias=bias,
                            dtype=dtype)
        self.proj = FP8RowLinear(ffn_hidden_size, hidden_size, bias=bias,
                                 dtype=dtype)
        self.hidden_act = hidden_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(ACT2FN[self.hidden_act](self.fc(x)))
