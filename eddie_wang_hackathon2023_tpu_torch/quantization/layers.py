"""Weight-only quantised layers (the JAX package's
``quantization/layers.py:25-151``): int8 qweight [in, out] K-major with one
fp32 scale per output channel, or int4 (``bits`` 4) packed [in/2, out]
with per-channel scales [out] or, with ``group_size`` G, group scales
[in/G, out].

Tensor parallelism (``layers.linear.TensorParallel``): column-parallel
layers hold their rank's output columns of ``qweight``, of the scales and
of the bias; row-parallel ones their rank's K rows (an int4 weight
re-packed over them) and, grouped, the scales' rows of those K rows (JAX
``quantization/layers.py:47-63,112-127``); the per-channel scale is
applied before the all-reduce (it is linear in the sum), the bias after.
The ranks sum fp32 partials: int8's fp32 accumulator, scaled; int4's the
kernel's output, which the kernel rounds to the activation dtype on each
rank (one rounding a rank, where the unsharded kernel rounds once).
The fused QKV projection holds the output columns of its rank's heads."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..layers.linear import TensorParallel, frozen
from ..ops.quant_matmul import weight_only_quant_matmul


def _quant_params(in_features: int, out_features: int, bits: int,
                  group_size: int):
    """(qweight, per_channel_scale) of a weight-only linear."""
    if bits not in (4, 8):
        raise ValueError(f"{bits}-bit weights: only 8 and 4 exist")
    k = in_features if bits == 8 else in_features // 2
    scale = ((in_features // group_size, out_features) if group_size
             else (out_features,))
    return (frozen((k, out_features), torch.int8),
            frozen(scale, torch.float32))


class WeightOnlyQuantLinear(TensorParallel, nn.Module):
    TP_DIMS = {"col": {"qweight": 1, "per_channel_scale": -1, "bias": 0},
               "row": {"qweight": 0, "per_channel_scale": 0}}

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32, bits: int = 8,
                 group_size: int = 0):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.bits = bits
        # int4 group-wise scale granularity along K (0: per output channel)
        self.group_size = group_size if bits == 4 else 0
        self.qweight, self.per_channel_scale = _quant_params(
            in_features, out_features, bits, self.group_size)
        self.bias = frozen((out_features,), dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # row-parallel: the ranks sum fp32 partials
        out = weight_only_quant_matmul(x, self.qweight,
                                       self.per_channel_scale, self.bits,
                                       fp32=self.row_parallel)
        return self.tp_finish(out, x.dtype)


class WeightOnlyQuantRowLinear(WeightOnlyQuantLinear):
    """Row-parallel variant in the JAX package; the same function
    unsharded."""


class WeightOnlyQuantQKVLinear(nn.Module):
    """Fused head-major QKV projection: qweight [in, 3*H*hd] int8 (int4:
    [in/2, 3*H*hd]), scales [3*H*hd] (grouped int4: [in/G, 3*H*hd]), bias
    [3, H, hd].  With fewer KV heads (MQA/GQA, the JAX package's
    ``quantization/layers.py:87-151``) one fused qweight
    [in, (H + 2*Hkv)*hd] with the columns ordered q | k | v, and the bias
    split into ``bias`` [H, hd] and ``kv_bias`` [2, Hkv, hd] as in the float
    layer.  Returns q [B, L, H, hd], k and v [B, L, Hkv, hd]."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 bias: bool = True, dtype=torch.float32,
                 num_kv_heads: Optional[int] = None, bits: int = 8,
                 group_size: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim
        self.bits = bits
        self.group_size = group_size if bits == 4 else 0
        hk = self.num_kv_heads
        # the separate-KV layout (a tensor-parallel shard may hold as many
        # KV heads as query heads and keep it)
        self.separate_kv = hk != num_heads
        if num_heads % hk:
            raise ValueError(f"{num_heads} heads over {hk} KV heads")
        equal = hk == num_heads
        out = (3 * num_heads if equal else num_heads + 2 * hk) * head_dim
        self.qweight, self.per_channel_scale = _quant_params(
            hidden_size, out, bits, self.group_size)
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
                                       self.per_channel_scale, self.bits)
        if not self.separate_kv:
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
