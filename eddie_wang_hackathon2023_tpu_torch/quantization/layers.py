"""int8 weight-only quantised layers (the int8 part of the JAX package's
``quantization/layers.py``): qweight [in, out] K-major int8 and one fp32
scale per output channel."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.linear import frozen
from ..ops.quant_matmul import weight_only_quant_matmul


class WeightOnlyQuantLinear(nn.Module):

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.bits = 8
        self.qweight = frozen((in_features, out_features), torch.int8)
        self.per_channel_scale = frozen((out_features,), torch.float32)
        self.bias = frozen((out_features,), dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = weight_only_quant_matmul(x, self.qweight,
                                       self.per_channel_scale)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class WeightOnlyQuantRowLinear(WeightOnlyQuantLinear):
    """Row-parallel variant in the JAX package; the same function here."""


class WeightOnlyQuantQKVLinear(nn.Module):
    """Fused head-major QKV projection: qweight [in, 3*H*hd] int8, scales
    [3*H*hd], bias [3, H, hd].  With fewer KV heads (MQA/GQA, the JAX
    package's ``quantization/layers.py:87-151``) one fused qweight
    [in, (H + 2*Hkv)*hd] with the columns ordered q | k | v, and the bias
    split into ``bias`` [H, hd] and ``kv_bias`` [2, Hkv, hd] as in the float
    layer.  Returns q [B, L, H, hd], k and v [B, L, Hkv, hd]."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 bias: bool = True, dtype=torch.float32,
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim
        hk = self.num_kv_heads
        if num_heads % hk:
            raise ValueError(f"{num_heads} heads over {hk} KV heads")
        equal = hk == num_heads
        out = (3 * num_heads if equal else num_heads + 2 * hk) * head_dim
        self.qweight = frozen((hidden_size, out), torch.int8)
        self.per_channel_scale = frozen((out,), torch.float32)
        if equal:
            self.bias = (frozen((3, num_heads, head_dim), dtype) if bias
                         else None)
        else:
            self.bias = frozen((num_heads, head_dim), dtype) if bias else None
            self.kv_bias = frozen((2, hk, head_dim), dtype) if bias else None

    def forward(self, x: torch.Tensor):
        b, l, _ = x.shape
        h, hk, hd = self.num_heads, self.num_kv_heads, self.head_dim
        out = weight_only_quant_matmul(x, self.qweight,
                                       self.per_channel_scale)
        if hk == h:
            qkv = out.reshape(b, l, 3, h, hd)
            if self.bias is not None:
                qkv = qkv + self.bias.to(qkv.dtype)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = out[..., :h * hd].reshape(b, l, h, hd)
        kv = out[..., h * hd:].reshape(b, l, 2, hk, hd)
        if self.bias is not None:
            q = q + self.bias.to(q.dtype)
            kv = kv + self.kv_bias.to(kv.dtype)
        return q, kv[:, :, 0], kv[:, :, 1]
