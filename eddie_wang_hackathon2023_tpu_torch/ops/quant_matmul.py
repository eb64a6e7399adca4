"""Weight-only quantised matmul, int8 and int4 (the JAX package's
``ops/quant_matmul.py``).  The JAX package gives int8 no hand kernel
(XLA's convert+matmul fusion); here it is a plain PyTorch matmul.  int4
goes through the TPU kernel's port, :mod:`.int4_quant_matmul` (the kernel
on a CUDA tensor, its plain version on a CPU one)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..functional import matmul_fp32

# int4 group size along K: the JAX package's default
# (``PluginConfig.get_int4_group_size``, ``plugin.py:138-144``)
INT4_GROUP_SIZE = 128


def quantize_weights_int8(w) -> Tuple[np.ndarray, np.ndarray]:
    """w [K, N] float -> (q [K, N] int8, scales [N] float32): symmetric
    per-column amax/127.  ``np.round`` rounds half to even, exactly as the
    JAX package's quantiser does."""
    w = np.asarray(w, dtype=np.float32)
    amax = np.max(np.abs(w), axis=0)  # [N]
    scales = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.round(w / scales[None, :]), -127, 127).astype(np.int8)
    return q, scales


def quantize_weights_int4(w, group_size: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """w [K, N] float -> (packed [K/2, N] int8, scales [N] or [K/G, N]
    float32), the JAX package's numpy code unchanged: values ``np.round``ed
    (half to even) and clipped to [-7, 7], scales amax/7 (1.0 where amax is
    0), one per output channel or, with ``group_size`` G, one per G rows of
    K.  Half-split packing: byte i holds row i in its low nibble and row
    i + K/2 in its high nibble.  K must be even (and divisible by G)."""
    w = np.asarray(w, dtype=np.float32)
    k, n = w.shape
    assert k % 2 == 0, "int4 packing requires even in-features"
    if group_size:
        assert k % group_size == 0, (k, group_size)
        gc = k // group_size
        wg = w.reshape(gc, group_size, n)
        amax = np.max(np.abs(wg), axis=1)                     # [gc, N]
        scales = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.round(wg / scales[:, None, :]), -7,
                    7).astype(np.int8).reshape(k, n)
    else:
        amax = np.max(np.abs(w), axis=0)
        scales = np.where(amax > 0, amax / 7.0, 1.0).astype(np.float32)
        q = np.clip(np.round(w / scales[None, :]), -7, 7).astype(np.int8)
    lo = q[:k // 2] & 0xF
    hi = (q[k // 2:] & 0xF) << 4
    return (lo | hi).astype(np.int8), scales


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] packed int8 -> [..., K, N] int8 in [-8, 7]: the
    sign-extended low nibbles (rows [0, K/2)), then the high ones (rows
    [K/2, K)) (a stack of matrices or the megakernel's panels, each
    half-split alike).  The shifts run on int32, as the TPU kernel's do,
    so no int8 shift overflows."""
    p = packed.to(torch.int32)
    lo = (p << 28) >> 28
    hi = (p << 24) >> 28
    return torch.cat([lo, hi], dim=-2).to(torch.int8)


def weight_only_quant_matmul(x: torch.Tensor, qweight: torch.Tensor,
                             scales: torch.Tensor, bits: int = 8,
                             fp32: bool = False) -> torch.Tensor:
    """x [..., K] @ a weight-only quantised [K, N] -> [..., N] in x's
    dtype.  int8 (``bits`` 8, scales [N]): the weight is cast (not scaled)
    to the activation dtype, the product is accumulated in fp32, the
    per-out-channel scale is applied to the fp32 accumulator, and the
    result is rounded once to x's dtype, as in the JAX package
    (``preferred_element_type=float32``).  int4 (``bits`` 4, ``qweight``
    packed [K/2, N], scales [N] or [G, N]): the TPU kernel's function,
    :func:`.int4_quant_matmul.quant_matmul_int4`.  ``fp32``: the result in
    fp32, for a row-parallel partial that the ranks sum before the one
    rounding (int8: the scaled accumulator, not rounded; int4: the
    kernel's output, rounded to x's dtype as the kernel writes it, then
    widened)."""
    if bits == 4:
        from .int4_quant_matmul import quant_matmul_int4
        out = quant_matmul_int4(x, qweight, scales)
        return out.float() if fp32 else out
    if bits != 8:
        raise ValueError(f"{bits}-bit weights: only 8 and 4 exist")
    if scales.dim() != 1:
        raise ValueError("int8 weights take per-channel scales [N]")
    acc = matmul_fp32(x, qweight.to(x.dtype)) * scales.float()
    return acc if fp32 else acc.to(x.dtype)
