"""Ops with numeric contracts, the subset of the JAX package's
``functional.py`` that the Whisper and decoder-only paths use.  Plain
PyTorch: none of these is a TPU kernel."""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# the activations the decoder configs name (the part of the JAX package's
# ``ACT2FN``, ``functional.py:81-93``, that its decoder megakernel takes):
# "gelu" is the tanh approximation, "gelu_exact" the erf one
ACT2FN = {"gelu": gelu, "gelu_exact": F.gelu, "relu": F.relu,
          "silu": F.silu}


def layer_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
               bias: Optional[torch.Tensor] = None,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics whatever the input
    dtype; the result is cast back to the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        y = y * weight.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype)


def conv1d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None, stride: int = 1,
           padding: int = 0) -> torch.Tensor:
    """x [B, C_in, L], weight [C_out, C_in, K] (torch layout, as the JAX
    package stores it).  The bias is added in the activation dtype."""
    out = F.conv1d(x, weight.to(x.dtype), None, stride=stride,
                   padding=padding)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None]
    return out


def round_half_away(x: torch.Tensor) -> torch.Tensor:
    """Round half away from zero, written as the JAX package writes it.
    ``torch.round`` rounds half to even and gives other int8 values on
    ties."""
    return torch.trunc(x + torch.where(x >= 0, 0.5, -0.5).to(x.dtype))


def matmul_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ w [K, N] accumulated and returned in fp32, as
    ``preferred_element_type=float32`` does: rounded once, not to the
    operands' dtype first.  A bf16/fp16 product on the card asks cuBLAS
    for fp32 output (``aten::mm.dtype``); elsewhere the operands are upcast,
    which is exact for bf16 and int8 values."""
    if x.is_cuda and x.dtype in (torch.bfloat16, torch.float16) \
            and w.dtype == x.dtype:
        out = torch.ops.aten.mm.dtype(x.reshape(-1, x.shape[-1]), w,
                                      torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])
    return torch.matmul(x.float(), w.float())


def causal_bias(q_len: int, k_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """Additive causal bias [q_len, k_len]: query i attends keys
    <= i + (k_len - q_len); -inf above that diagonal."""
    q = torch.arange(q_len, device=device)[:, None]
    k = torch.arange(k_len, device=device)[None, :]
    bias = torch.zeros((q_len, k_len), dtype=dtype, device=device)
    return bias.masked_fill(k > q + (k_len - q_len), float("-inf"))


def sinusoids(length: int, channels: int,
              max_timescale: float = 10000.0) -> np.ndarray:
    """Whisper's encoder positional embedding (numpy, as in the JAX
    package)."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment
                            * np.arange(channels // 2))
    scaled_time = np.arange(length)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                          axis=1).astype(np.float32)
