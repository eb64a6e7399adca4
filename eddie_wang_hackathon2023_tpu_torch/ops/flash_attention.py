"""Context-phase fused attention (flash attention).

Counterpart of ``ops/flash_attention.py`` ``flash_mha`` in the JAX package.
On a CUDA tensor it launches the kernel of ``csrc/flash_attention.cu``
(non-causal, head dim 64; bf16 operands, or fp32 operands at fp32
accuracy, as the SmoothQuant encoder gives them); on a CPU tensor it runs
the plain version,
``multihead_attention`` with a length mask, as the JAX package does off the
TPU.  ``kv_valid_len`` is the pad-once contract: the caller carries the
sequence padded to the kernel's block multiple and only the first N keys
are real.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .attention import length_mask_bias, multihead_attention

# launches of the CUDA kernel, counted where the wrapper launches it, per
# entry (bf16 operands, fp32 operands)
launches = {"flash_attention": 0, "flash_attention_f32": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def plain_flash_mha(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_mha`."""
    lq, lk = q.shape[2], k.shape[2]
    valid = lk if kv_valid_len is None else min(int(kv_valid_len), lk)
    bias = None
    if causal:
        from ..functional import causal_bias
        bias = causal_bias(lq, lk, device=q.device)
    if valid < lk:
        lm = length_mask_bias(
            torch.full((q.shape[0],), valid, dtype=torch.int32,
                       device=q.device), lk)
        bias = lm if bias is None else bias + lm
    return multihead_attention(q, k, v, bias=bias, scale=scale)


def flash_mha(q, k, v, causal: bool = False, scale: Optional[float] = None,
              kv_valid_len: Optional[int] = None,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D].

    On the card the operands may be strided views (last dim contiguous,
    rows 16-byte aligned).  ``out``, when given, is a [B,H,Lq,D] view the
    kernel writes into (e.g. a transposed [B,Lq,H,D] buffer)."""
    if not q.is_cuda:
        res = plain_flash_mha(q, k, v, causal, scale, kv_valid_len)
        if out is not None:
            out.copy_(res)
            return out
        return res
    if causal:
        raise NotImplementedError("causal flash attention is not ported yet")
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D != 64:
        raise NotImplementedError(f"flash kernel is built for head dim 64, "
                                  f"got {D}")
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError("flash kernel takes bf16 or fp32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    f32 = q.dtype == torch.float32
    valid = Lk if kv_valid_len is None else min(int(kv_valid_len), Lk)
    if out is None:
        out = torch.empty((B, H, Lq, D), dtype=q.dtype, device=q.device)
    if out.dtype != q.dtype:
        raise TypeError(f"flash output must be {q.dtype}")
    per16 = 16 // q.element_size()     # elements in 16 bytes
    strides = []
    for t in (q, k, v, out):
        if t.stride(3) != 1:
            raise ValueError("flash kernel needs a contiguous last dim")
        if t.data_ptr() % 16 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError("flash kernel needs 16-byte aligned rows")
        strides += list(t.stride()[:3])
    strides_arr = (ctypes.c_longlong * 12)(*strides)
    if scale is None:
        scale = 1.0 / (D ** 0.5)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    lib = _build.load("flash_attention")
    entry = lib.flash_attention_f32 if f32 else lib.flash_attention
    _build.check(entry(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, H, Lq, Lk, D, valid,
        ctypes.cast(strides_arr, ctypes.c_void_p), float(scale), stream),
        "flash_attention")
    launches["flash_attention_f32" if f32 else "flash_attention"] += 1
    return out
