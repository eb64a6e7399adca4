"""SmoothQuant W8A8 layers (the JAX package's
``quantization/smoothquant_layers.py``): int8 [in, out] weights with
per-channel (or per-tensor) step scales; activations quantised per token
on the fly, or with a static step.  Also its offline numpy helpers
(``smooth_quantize_weights``, ``apply_smoothing``, ``smooth_gemm``),
copied: the same arithmetic gives the same bits."""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..layers.linear import frozen
from .functional import (quantize, quantize_per_token, smooth_quant_gemm,
                         smooth_quant_layer_norm)
from .mode import QuantMode

_DEFAULT_MODE = QuantMode.use_smooth_quant(per_token=True, per_channel=True)


def _quantize_input(x, quant_mode: QuantMode, act_scale):
    """Float activations -> (int8, step); a tuple from a
    :class:`SmoothQuantLayerNorm` passes through."""
    if isinstance(x, tuple):
        return x
    if quant_mode.has_per_token_dynamic_scaling():
        return quantize_per_token(x)
    return quantize(x, 1.0 / act_scale), act_scale


class SmoothQuantLinear(nn.Module):
    """int8-activation x int8-weight linear.  The output is cast to
    ``dtype`` (fp32 when None, as in the JAX package)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=None,
                 quant_mode: QuantMode = _DEFAULT_MODE):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.quant_mode = quant_mode
        self.dtype = dtype
        self.qweight = frozen((in_features, out_features), torch.int8)
        n_scale = (out_features if quant_mode.has_per_channel_scaling()
                   else 1)
        self.per_channel_scale = frozen((n_scale,), torch.float32)
        self.act_scale = (None if quant_mode.has_per_token_dynamic_scaling()
                          else frozen((1,), torch.float32))
        self.bias = frozen((out_features,), dtype or torch.float32) \
            if bias else None

    def forward(self, x):
        x_q, sx = _quantize_input(x, self.quant_mode, self.act_scale)
        out = smooth_quant_gemm(x_q, self.qweight, sx,
                                self.per_channel_scale)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out.to(self.dtype or torch.float32)


class SmoothQuantRowLinear(SmoothQuantLinear):
    """Row-parallel variant in the JAX package; the same function here."""


class SmoothQuantLayerNorm(nn.Module):
    """LayerNorm that emits int8 + per-token scales."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5,
                 dtype=torch.float32,
                 quant_mode: QuantMode = _DEFAULT_MODE):
        super().__init__()
        self.eps = eps
        self.quant_mode = quant_mode
        self.weight = frozen((normalized_shape,), dtype)
        self.bias = frozen((normalized_shape,), dtype)
        self.act_scale = (None if quant_mode.has_per_token_dynamic_scaling()
                          else frozen((1,), torch.float32))

    def forward(self, x):
        return smooth_quant_layer_norm(
            x, self.weight, self.bias, self.eps,
            dynamic_act_scaling=self.quant_mode
            .has_per_token_dynamic_scaling(),
            act_scale=(None if self.act_scale is None
                       else 1.0 / self.act_scale))


class SmoothQuantQKVLinear(nn.Module):
    """Fused head-major SmoothQuant QKV projection: qweight [in, 3*H*hd].

    ``dtype`` sets the dtype of q, k, v and of the bias (fp32 when None).
    Both packages build it with dtype None, so the SmoothQuant encoder hands
    fp32 q, k, v to flash attention (the kernel's fp32-operand entry on the
    card)."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 bias: bool = True, dtype=None,
                 quant_mode: QuantMode = _DEFAULT_MODE):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_heads
        self.head_dim = head_dim
        self.quant_mode = quant_mode
        self.dtype = dtype
        out = 3 * num_heads * head_dim
        self.qweight = frozen((hidden_size, out), torch.int8)
        n_scale = out if quant_mode.has_per_channel_scaling() else 1
        self.per_channel_scale = frozen((n_scale,), torch.float32)
        self.act_scale = (None if quant_mode.has_per_token_dynamic_scaling()
                          else frozen((1,), torch.float32))
        self.bias = frozen((3, num_heads, head_dim), dtype or torch.float32) \
            if bias else None

    def forward(self, x):
        x_q, sx = _quantize_input(x, self.quant_mode, self.act_scale)
        b, l = x_q.shape[0], x_q.shape[1]
        out = smooth_quant_gemm(x_q, self.qweight, sx,
                                self.per_channel_scale)
        out = out.to(self.dtype or torch.float32)
        qkv = out.reshape(b, l, 3, self.num_heads, self.head_dim)
        if self.bias is not None:
            qkv = qkv + self.bias.to(qkv.dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def smooth_quantize_weights(w, per_channel: bool = True):
    """Offline: float [out, in] -> (int8 [in, out], step scales)."""
    wt = np.asarray(w, np.float32).T  # [in, out]
    if per_channel:
        amax = np.abs(wt).max(axis=0)
    else:
        amax = np.asarray([np.abs(wt).max()])
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(wt / scale[None, :] if per_channel else wt / scale),
                -127, 127).astype(np.int8)
    return q, scale


def apply_smoothing(scales, gemm_weight, layernorm_weight=None,
                    layernorm_bias=None):
    """Divide the LayerNorm's output channels by ``scales`` and multiply
    them into the following GEMM's input channels (outlier migration):
    ``gemm_weight`` [out, in] -> a dict of the smoothed arrays."""
    scales = np.asarray(scales, np.float32)
    out = dict()
    out["gemm_weight"] = np.asarray(gemm_weight, np.float32) * scales[None, :]
    if layernorm_weight is not None:
        out["layernorm_weight"] = np.asarray(layernorm_weight,
                                             np.float32) / scales
    if layernorm_bias is not None:
        out["layernorm_bias"] = np.asarray(layernorm_bias, np.float32) / scales
    return out


def smooth_gemm(gemm_weight, act_amax, layernorm_weight=None,
                layernorm_bias=None, alpha: float = 0.5):
    """The smoothing scales s = amax_x^alpha / amax_w^(1 - alpha) per input
    channel (clipped below at 1e-5) and :func:`apply_smoothing` with them:
    (scales, smoothed arrays)."""
    w = np.asarray(gemm_weight, np.float32)
    w_amax = np.abs(w).max(axis=0)
    a_amax = np.asarray(act_amax, np.float32)
    scales = np.clip(a_amax ** alpha / np.maximum(w_amax, 1e-8) ** (1 - alpha),
                     1e-5, None)
    return scales, apply_smoothing(scales, w, layernorm_weight, layernorm_bias)
