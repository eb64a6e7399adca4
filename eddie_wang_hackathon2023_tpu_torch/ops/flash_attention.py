"""Context-phase fused attention (flash attention).

Counterpart of ``ops/flash_attention.py`` ``flash_mha`` in the JAX package.
On a CUDA tensor it launches the kernel of ``csrc/flash_attention.cu``
(head dim 64; bf16 operands, or fp32 operands at fp32 accuracy, as the
SmoothQuant encoder gives them; bf16 non-causal calls take its Hopper
design, wgmma products fed by TMA; bf16 causal calls take 64-row blocks
whose keys are spread over warps by :func:`causal_plan`, which the wrapper
passes to the kernel): every non-causal call, and causal calls
of ``MIN_FLASH_LEN`` query rows or more, where the JAX package takes its
TPU kernel.  Shorter causal calls, causal calls at other head dims and CPU
tensors take the plain version, ``multihead_attention`` with a causal and
a length mask, as the JAX package does off the TPU; a non-causal call at
another head dim raises, as that kernel mode is not ported.
``kv_valid_len`` is the pad-once contract: the caller carries the sequence
padded to the kernel's block multiple and only the first N keys are real.

A user-written kernel can take every call instead (:func:`set_custom_mha`,
the JAX package's extension point; ``examples/custom_kernel_torch/`` plugs
a hand-written CUDA FMHA in this way).
"""
from __future__ import annotations

import ctypes
from typing import Callable, Optional

import torch

from . import _build
from .attention import length_mask_bias, multihead_attention

# below this many query rows the built-in dispatch keeps the plain version
# (the JAX package's ``_MIN_FLASH_LEN``)
MIN_FLASH_LEN = 128

# launches of the CUDA kernel, counted where the wrapper launches it, per
# entry (bf16 or fp32 operands, causal or not); ``custom_mha``: calls routed
# to the installed user kernel
launches = {"flash_attention": 0, "flash_attention_f32": 0,
            "flash_attention_causal": 0, "flash_attention_causal_f32": 0,
            "custom_mha": 0}

# the user kernel installed by set_custom_mha, or None
_custom_mha: Optional[Callable] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def set_custom_mha(fn: Optional[Callable]) -> None:
    """Install ``fn(q, k, v, *, causal, scale, kv_valid_len) -> [B,H,Lq,D]``
    as the context-attention kernel of every :func:`flash_mha` call (None
    restores the built-in dispatch), as the JAX package's
    ``set_custom_mha`` does."""
    global _custom_mha
    _custom_mha = fn


def plain_flash_mha(q, k, v, causal: bool = False,
                    scale: Optional[float] = None,
                    kv_valid_len: Optional[int] = None) -> torch.Tensor:
    """The plain PyTorch version of :func:`flash_mha`: with ``causal``,
    query i attends keys <= i + (Lk - Lq) (``functional.causal_bias``)."""
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


def hopper_config() -> dict:
    """The bf16 non-causal entry's design as the built library reports it
    on the current card: ``rows`` (query rows a block), ``stages`` (K/V
    tiles in flight) and ``blocks_per_sm`` (blocks of the compiled kernel
    that one SM holds, from the CUDA occupancy query)."""
    out = (ctypes.c_int * 3)()
    _build.check(_build.load("flash_attention").flash_attention_hopper_config(
        ctypes.cast(out, ctypes.c_void_p)), "flash_attention_hopper_config")
    return dict(zip(("rows", "stages", "blocks_per_sm"), out))


def causal_plan(lq: int, lk: int, valid: int, heads: int,
                sms: int = 132) -> dict:
    """The launch of the causal entry for a call of ``lq`` query rows over
    ``lk`` keys, the first ``valid`` of them live, for ``heads`` (batch
    times heads) on a card of ``sms`` SMs, which the wrapper passes to the
    kernel (it refuses any other): ``rows``, 64 query rows a block (the
    grid is ``row_blocks`` of them a head), and ``splits``, the warps over
    which each 16-row group's keys are spread, 64 keys a warp's tile
    (past ``splits`` tiles they come in rounds).  While the grid has fewer
    blocks than the card has SMs, the keys go over up to 4 warps, so that
    the longest block walks one tile; past that the grid fills the card,
    and one warp a row group walks its keys alone."""
    blocks = -(-lq // 64)
    splits = 1 if heads * blocks >= sms else min(4, -(-min(valid, lk) // 64))
    return dict(rows=64, splits=splits, row_blocks=blocks)


def _sms(device) -> int:
    """The SMs of the card that holds ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def kernel_takes(q, k, causal: bool = False,
                 min_causal_rows: int = MIN_FLASH_LEN) -> bool:
    """The built-in dispatch's static shape test: the kernel for every
    non-causal call on a CUDA tensor (it refuses head dims other than 64),
    and for a causal one of ``min_causal_rows`` query rows or more
    (``MIN_FLASH_LEN`` unless the caller asks for fewer) at head dim 64
    with no more query rows than keys, so that every row has a key; the
    rest keep the plain version."""
    if not q.is_cuda:
        return False
    lq, lk, d = q.shape[2], k.shape[2], q.shape[3]
    return not causal or (lq >= min_causal_rows and d == 64 and lq <= lk)


def flash_mha(q, k, v, causal: bool = False, scale: Optional[float] = None,
              kv_valid_len: Optional[int] = None,
              out: Optional[torch.Tensor] = None,
              min_causal_rows: int = MIN_FLASH_LEN) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D].

    An installed user kernel (:func:`set_custom_mha`) takes every call;
    otherwise the kernel where :func:`kernel_takes` (causal calls from
    ``min_causal_rows`` query rows), else the plain version.  On the card
    the kernel's operands may be strided views (last dim contiguous, rows
    16-byte aligned).  ``out``, when given, is a [B,H,Lq,D] view the
    result is written into (e.g. a transposed [B,Lq,H,D] buffer): the
    kernel writes it directly; a user kernel's or the plain version's
    result is copied into it."""
    if _custom_mha is not None:
        res = _custom_mha(q, k, v, causal=causal, scale=scale,
                          kv_valid_len=kv_valid_len)
        launches["custom_mha"] += 1
        if out is None:
            return res
        out.copy_(res)
        return out
    if not kernel_takes(q, k, causal, min_causal_rows):
        res = plain_flash_mha(q, k, v, causal, scale, kv_valid_len)
        if out is not None:
            out.copy_(res)
            return out
        return res
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
    args = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)]
    args += [B, H, Lq, Lk, D, valid, int(causal)]
    if not f32:
        # the bf16 entry takes the causal plan (none for a call that is not)
        plan = causal_plan(Lq, Lk, valid, B * H, _sms(q.device)) \
            if causal else None
        args += [plan["rows"], plan["splits"]] if plan else [0, 0]
    entry = lib.flash_attention_f32 if f32 else lib.flash_attention
    _build.check(entry(*args, ctypes.cast(strides_arr, ctypes.c_void_p),
                       float(scale), stream), "flash_attention")
    launches["flash_attention" + ("_causal" if causal else "")
             + ("_f32" if f32 else "")] += 1
    return out
