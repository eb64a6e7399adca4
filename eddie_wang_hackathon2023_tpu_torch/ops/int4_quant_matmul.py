"""int4 weight-only dequant matmul: the counterpart of the JAX package's
``ops/pallas_quant_matmul.py`` (``quant_matmul_int4_pallas`` :56, the TPU
kernel ``_kernel_int4`` :25).

``x [..., K] @ W`` where W is int4 packed ``[K/2, N]`` int8 in half-split
nibbles (byte i: row i low, row i + K/2 high; see
:func:`.quant_matmul.quantize_weights_int4`), with per-out-channel scales
``[N]`` or group scales ``[G, N]`` (G groups of K/G rows), in x's dtype.
Its numerics are the TPU kernel's:
* one group (``[N]`` or ``[1, N]`` scales): the unpacked integers enter
  the product as they are, accumulated in fp32, and the fp32 scale
  multiplies the fp32 accumulator before the single rounding to x's dtype;
* G > 1 groups: each weight element becomes ``q * scale`` in x's dtype,
  the scale rounded to x's dtype first, and the products accumulate in
  fp32 and round once.

On a CUDA tensor :func:`quant_matmul_int4` launches the kernel of
``csrc/int4_quant_matmul.cu`` (bf16 only; other dtypes and shapes the
kernel does not take raise); on a CPU tensor it runs the plain version,
:func:`plain_quant_matmul_int4`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build
from .quant_matmul import unpack_int4
from ..functional import matmul_fp32

# launches of the kernel, counted where the wrapper launches it (one per
# call: a split of K is reduced inside the same launch)
launches = {"int4_quant_matmul": 0}

# the kernel's tiles: 128 output columns a block, 16 rows an m-tile, 64
# unpacked rows of K (32 packed rows, both nibbles) a chunk
TILE_N, TILE_M, CHUNK_K = 128, 16, 64
# a split of K keeps at least this many chunks at decode (one m-tile a
# block) and at the prefill (four): there a tile row of blocks already
# fills the card, and a split pays only on long K
MIN_CHUNKS_PER_SPLIT = {1: 4, 4: 32}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _groups(scales: torch.Tensor, n: int) -> int:
    """The number of scale groups along K (1: per output channel)."""
    if scales.dim() == 1:
        if scales.shape[0] != n:
            raise ValueError(f"scales {tuple(scales.shape)} for N {n}")
        return 1
    if scales.dim() != 2 or scales.shape[1] != n:
        raise ValueError(f"scales {tuple(scales.shape)} for N {n}")
    return scales.shape[0]


def plain_quant_matmul_int4(x: torch.Tensor, qweight: torch.Tensor,
                            scales: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of the TPU kernel's function: unpack,
    then for one group the fp32 scale on the fp32 accumulator, for G > 1
    groups each K-group of the weight scaled in x's dtype before an
    fp32-accumulated product; rounded once to x's dtype."""
    w = unpack_int4(qweight)
    k, n = w.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} for packed weight "
                         f"{tuple(qweight.shape)}")
    groups = _groups(scales, n)
    if groups == 1:
        acc = matmul_fp32(x, w.to(x.dtype))
        return (acc * scales.reshape(n).float()).to(x.dtype)
    if k % groups:
        raise ValueError(f"K {k} is not a multiple of {groups} groups")
    wf = w.to(x.dtype).reshape(groups, k // groups, n) * \
        scales[:, None, :].to(x.dtype)
    return matmul_fp32(x, wf.reshape(k, n)).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int, int]:
    """(m-tiles a block, splits of K, chunks a split) for an [m, k] x
    [k, n] product on ``sms`` multiprocessors: four m-tiles a block above
    32 rows (the prefill), one below (decode); K split along chunk
    boundaries until the grid has about two blocks per multiprocessor,
    each split keeping at least MIN_CHUNKS_PER_SPLIT[m-tiles] chunks
    (``tools/int4_kernel_probe.py`` times the alternatives)."""
    mt = 1 if m <= 2 * TILE_M else 4
    tiles = -(-m // (TILE_M * mt)) * -(-n // TILE_N)
    chunks = k // CHUNK_K
    splits = max(1, min(-(-2 * sms // tiles),
                        chunks // MIN_CHUNKS_PER_SPLIT[mt]))
    per = -(-chunks // splits)
    return mt, -(-chunks // per), per


_COUNTERS = {}


def _tile_counters(device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 counter per output tile, kept per device: the kernel
    leaves every counter it uses at zero again."""
    c = _COUNTERS.get(device)
    if c is None or c.numel() < n:
        c = torch.zeros(max(n, 4096), dtype=torch.int32, device=device)
        _COUNTERS[device] = c
    return c


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (the kernel copies 16-byte
    vectors); a view that starts elsewhere is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def quant_matmul_int4(x: torch.Tensor, qweight: torch.Tensor,
                      scales: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ packed int4 [K/2, N] with scales [N] or [G, N] ->
    [..., N] in x's dtype.  On a CUDA tensor: the kernel, on
    ``torch.cuda.current_stream()``; x bf16, K a multiple of 64, each group
    a multiple of 32 rows; anything else raises.  On a CPU tensor: the
    plain version."""
    if not x.is_cuda:
        return plain_quant_matmul_int4(x, qweight, scales)
    *lead, k = x.shape
    kh, n = qweight.shape
    if qweight.dtype != torch.int8 or 2 * kh != k:
        raise ValueError(f"packed weight {tuple(qweight.shape)} "
                         f"{qweight.dtype} for x {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"the int4 kernel takes bf16 activations, not "
                        f"{x.dtype}")
    groups = _groups(scales, n)
    if k % CHUNK_K or k % groups or (k // groups) % (CHUNK_K // 2):
        raise ValueError(f"K {k} in {groups} group(s): the kernel needs K a "
                         f"multiple of {CHUNK_K} and groups of a multiple "
                         f"of {CHUNK_K // 2} rows")
    if (qweight.device != x.device or scales.device != x.device
            or scales.dtype != torch.float32):
        raise ValueError("packed weight and fp32 scales on x's device")
    m = x.numel() // k
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    # operands held in locals until the launch is enqueued: a temporary
    # freed first could be reused and overwritten on the stream
    x2 = _aligned(x.reshape(m, k))
    qw = _aligned(qweight)
    sc = _aligned(scales)
    mt, splits, per = split_plan(m, n, k, _sm_count(x.device.index or 0))
    tiles = -(-m // (TILE_M * mt)) * -(-n // TILE_N)
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    counters = _tile_counters(x.device, tiles) if splits > 1 else None
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(_build.load("int4_quant_matmul").int4_quant_matmul(
        _ptr(x2), _ptr(qw), _ptr(sc), m, n, k, groups, mt, splits, per,
        _ptr(ws), _ptr(counters), _ptr(out), stream), "int4_quant_matmul")
    launches["int4_quant_matmul"] += 1
    return out
