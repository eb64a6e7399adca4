"""Ops with numeric contracts, the subset of the JAX package's
``functional.py`` that the Whisper and decoder-only paths use (ALiBi's
slopes and biases too).  Plain PyTorch: none of these is a TPU kernel."""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated GELU (``jax.nn.gelu(approximate=True)``)."""
    return F.gelu(x, approximate="tanh")


# the activations the decoder configs name (the part of the JAX package's
# ``ACT2FN``, ``functional.py:81-93``, that the decoder families use):
# "gelu" and "gelu_new" are the tanh approximation, "gelu_exact" the erf one
ACT2FN = {"gelu": gelu, "gelu_new": gelu, "gelu_exact": F.gelu,
          "relu": F.relu, "silu": F.silu}


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


def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor] = None,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last axis (no mean, no bias) with fp32 statistics;
    the result is cast back to the input dtype."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if weight is not None:
        y = y * weight.float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def rope_freqs(rotary_dim: int, theta: float, device: torch.device
               ) -> torch.Tensor:
    """The rotary frequencies [rotary_dim // 2] fp32, ``1 / theta **
    (arange(half) / half)`` as the JAX package computes them, made once on
    the CPU and kept on ``device`` (no host copy a step)."""
    half = rotary_dim // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32)
                             / half))
    return freqs.to(device)


def rope_angles(positions: torch.Tensor, rotary_dim: int,
                theta: float = 10000.0):
    """(cos, sin) [..., seq, rotary_dim // 2] fp32 of the angles position x
    :func:`rope_freqs` (positions [..., seq]); one pair serves every layer
    of a step."""
    freqs = rope_freqs(rotary_dim, float(theta), positions.device)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               neox_style: bool = True) -> torch.Tensor:
    """x [..., seq, n_heads, head_dim] rotated by :func:`rope_angles`' cos
    and sin [..., seq, half]: the first 2 * half channels (GPT-NeoX halves,
    or GPT-J interleaved pairs) in fp32, the rest passed through; the
    result has x's dtype."""
    half = cos.shape[-1]
    rd = 2 * half
    cos, sin = cos[..., None, :], sin[..., None, :]
    xf = x[..., :rd].float()
    if neox_style:
        x1, x2 = xf[..., :half], xf[..., half:]
        out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    else:
        x1, x2 = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                          dim=-1).reshape(xf.shape)
    return torch.cat([out.to(x.dtype), x[..., rd:]], dim=-1)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
         rotary_dim: Optional[int] = None,
         neox_style: bool = True) -> torch.Tensor:
    """Rotary position embedding (the JAX package's ``rope``): x [..., seq,
    n_heads, head_dim], positions [..., seq]; ``rotary_dim`` channels
    rotate (all by default)."""
    cos, sin = rope_angles(positions, rotary_dim or x.shape[-1], theta)
    return apply_rope(x, cos, sin, neox_style)


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


def generate_alibi_slopes(num_heads: int) -> np.ndarray:
    """ALiBi head slopes [1, num_heads, 1, 1] fp32 (the JAX package's
    ``functional.py:284-295``): the geometric series of the closest power
    of two below ``num_heads``, then every other power of the next one's
    for the heads left over."""
    closest_power_of_2 = 2 ** int(np.floor(np.log2(num_heads)))
    base = 2 ** (-(2 ** -(np.log2(closest_power_of_2) - 3)))
    slopes = base ** np.arange(1, 1 + closest_power_of_2)
    if closest_power_of_2 != num_heads:
        extra_base = 2 ** (-(2 ** -(np.log2(2 * closest_power_of_2) - 4)))
        num_remaining = min(closest_power_of_2,
                            num_heads - closest_power_of_2)
        extra_powers = np.arange(1, 1 + 2 * num_remaining, 2)
        slopes = np.concatenate([slopes, extra_base ** extra_powers])
    return slopes.astype(np.float32).reshape(1, num_heads, 1, 1)


@functools.lru_cache(maxsize=None)
def alibi_slopes(num_heads: int, device: torch.device) -> torch.Tensor:
    """:func:`generate_alibi_slopes` as a tensor kept on ``device`` (made
    once, no host copy a step)."""
    return torch.from_numpy(generate_alibi_slopes(num_heads)).to(device)


def generate_alibi_biases(slopes, key_length: int) -> torch.Tensor:
    """The additive ALiBi bias [1, H, 1, key_length] fp32: each head's
    slope times the absolute key column (not taken relative to a row's
    start: under left padding the two differ by a constant a row, which
    the softmax ignores)."""
    slopes = torch.as_tensor(slopes, dtype=torch.float32)
    cols = torch.arange(key_length, dtype=torch.float32,
                        device=slopes.device).reshape(1, 1, 1, -1)
    return slopes * cols


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
