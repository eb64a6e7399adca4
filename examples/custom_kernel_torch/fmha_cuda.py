"""A user-written CUDA attention kernel for the port's custom-attention hook.

The PyTorch port's twin of ``examples/custom_kernel/pallas_fmha.py``: the
same tiled online-softmax fused attention, written in CUDA C++ for the H100
(``fmha.cu``, built by nvcc for ``sm_90a`` at first use into the repo's
``build/kernels/``, loaded with ctypes).  Install it with

    from eddie_wang_hackathon2023_tpu_torch.ops.flash_attention import \\
        set_custom_mha
    set_custom_mha(custom_flash_mha)

and every context-attention call of every model routes through it.

:func:`custom_flash_mha` launches the kernel for CUDA tensors and runs
:func:`plain_custom_flash_mha`, the same function in plain PyTorch, for CPU
tensors.  Both keep the Pallas kernel's contract: fp32 arithmetic, keys at
or past ``kv_valid_len`` masked, the causal mask top-left (key c of query
row r masked unless c <= r), a row with no live key 0, and block sizes
``min(block_m, Lq)`` and ``min(block_n, Lk)`` that must divide the lengths.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Optional

import torch

from eddie_wang_hackathon2023_tpu_torch.ops import _build

NEG = -1e30

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGS = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _F, _P]
_build.register("custom_fmha", Path(__file__).with_name("fmha.cu"),
                {"custom_fmha": _ARGS, "custom_fmha_f32": _ARGS})

# launches of the kernel, counted where the wrapper launches it, per entry
# (bf16 or fp32 operands)
launches = {"custom_fmha": 0, "custom_fmha_f32": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _check_blocks(lq: int, lk: int, block_m: int, block_n: int) -> None:
    bm, bn = min(block_m, lq), min(block_n, lk)
    if lq % bm or lk % bn:
        raise ValueError(f"pad sequences to block multiples: Lq {lq} by "
                         f"{bm}, Lk {lk} by {bn}")


def fmha_plan(lq: int, dtype) -> dict:
    """The launch of ``fmha.cu`` for a call of ``lq`` query rows in
    ``dtype``, which the wrapper passes to the entry (the number of keys and
    the causal mask change no choice): ceil(lq / 16) warps of 16 query rows
    a block, at most 4, and the row blocks that cover ``lq``.  Its variant
    names the kernel: "fp32" (the fp32 entry's, 3xTF32), else the bf16
    entry's "short" (one row block, lq <= 64) or "tiled"."""
    warps = min(4, -(-lq // 16))
    blocks = -(-lq // (16 * warps))
    variant = ("fp32" if dtype == torch.float32
               else "short" if blocks == 1 else "tiled")
    return dict(variant=variant, rows=16 * warps, warps=warps,
                row_blocks=blocks)


def plain_custom_flash_mha(q, k, v, *, causal: bool = False,
                           scale: Optional[float] = None,
                           kv_valid_len: Optional[int] = None,
                           block_m: int = 128,
                           block_n: int = 128) -> torch.Tensor:
    """The plain PyTorch version of :func:`custom_flash_mha`."""
    lq, lk = q.shape[2], k.shape[2]
    _check_blocks(lq, lk, block_m, block_n)
    valid = lk if kv_valid_len is None else int(kv_valid_len)
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    cols = torch.arange(lk, device=q.device)[None, :]
    mask = cols < valid
    if causal:
        mask = mask & (cols <= torch.arange(lq, device=q.device)[:, None])
    s = s.masked_fill(~mask, NEG)
    p = torch.where(mask, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
    out = (torch.einsum("bhqk,bhkd->bhqd", p, v.float())
           / p.sum(-1, keepdim=True).clamp_min(1e-30))
    return out.to(q.dtype)


def custom_flash_mha(q, k, v, *, causal: bool = False,
                     scale: Optional[float] = None,
                     kv_valid_len: Optional[int] = None, block_m: int = 128,
                     block_n: int = 128) -> torch.Tensor:
    """Drop-in for ``set_custom_mha``: q [B,H,Lq,D], k/v [B,H,Lk,D] ->
    [B,H,Lq,D] in q's dtype.  On the card q, k, v are bf16 or fp32 of one
    dtype, D is 64, and they may be strided views with a contiguous last
    dim; bf16 rows must start on 16 bytes (the tensor-core kernel copies
    them 16 bytes at a time)."""
    if not q.is_cuda:
        return plain_custom_flash_mha(q, k, v, causal=causal, scale=scale,
                                      kv_valid_len=kv_valid_len,
                                      block_m=block_m, block_n=block_n)
    B, H, Lq, D = q.shape
    Lk = k.shape[2]
    _check_blocks(Lq, Lk, block_m, block_n)
    if k.shape != (B, H, Lk, D) or v.shape != k.shape:
        raise ValueError(f"q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if D != 64:
        raise NotImplementedError(f"the kernel is built for head dim 64, "
                                  f"got {D}")
    if not (q.dtype == k.dtype == v.dtype
            and q.dtype in (torch.bfloat16, torch.float32)):
        raise TypeError("the kernel takes bf16 or fp32 q, k, v of one "
                        f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if B * H > 65535:
        raise ValueError(f"B * H = {B * H} is past the grid's 65535")
    f32 = q.dtype == torch.float32
    for t in (q, k, v):
        if t.stride(3) != 1:
            raise ValueError("the kernel needs a contiguous last dim")
        if not f32 and (t.data_ptr() % 16 or any(
                st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                if n > 1)):
            raise ValueError("the bf16 kernel needs rows that start on 16 "
                             "bytes: pointer and strides multiples of 8 "
                             f"elements, got {t.data_ptr() % 16} and "
                             f"{tuple(t.stride())}")
    out = torch.empty((B, H, Lq, D), dtype=q.dtype, device=q.device)
    strides = []
    for t in (q, k, v, out):
        strides += list(t.stride()[:3])
    strides_arr = (ctypes.c_longlong * 12)(*strides)
    valid = Lk if kv_valid_len is None else int(kv_valid_len)
    kv_lim = max(0, min(valid, Lk))
    if scale is None:
        scale = 1.0 / math.sqrt(D)
    plan = fmha_plan(Lq, q.dtype)
    lib = _build.load("custom_fmha")
    entry = lib.custom_fmha_f32 if f32 else lib.custom_fmha
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(entry(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        B, H, Lq, Lk, D, kv_lim, int(causal), plan["warps"],
        plan["row_blocks"], ctypes.cast(strides_arr, ctypes.c_void_p),
        float(scale), stream), "custom_fmha")
    launches["custom_fmha_f32" if f32 else "custom_fmha"] += 1
    return out
