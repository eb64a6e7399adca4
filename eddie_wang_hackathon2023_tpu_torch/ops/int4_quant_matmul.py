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
kernel does not take raise): its decode entry for M <= DECODE_MAX_M with
:func:`decode_plan` (K over the warps of a block and a thread-block
cluster), its prefill entry above with :func:`prefill_plan` (the rows of x
a block takes on `wgmma`, and its ring's stages).  On a CPU tensor it runs
the plain version, :func:`plain_quant_matmul_int4`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from . import _build
from .quant_matmul import unpack_int4
from ..functional import matmul_fp32

# launches of the kernel, counted where the wrapper launches it (one per
# call: a split of K is reduced inside the same launch)
launches = {"int4_quant_matmul": 0}

# K is walked in chunks of CHUNK_K rows (32 packed rows, both nibbles) at
# least; TILE_N output columns a block in both entries
TILE_N, TILE_M, CHUNK_K = 128, 16, 64
# the prefill entry (M above DECODE_MAX_M): blocks of TILE_N output columns
# (two consumer warpgroups of 64) and `rows` rows of x, one of PREFILL_ROWS
# (the wgmma's n, each an instantiation); stages of PREFILL_CHUNK packed
# rows (two x boxes of rows x 64 bf16, the packed bytes, four fp32 scale
# rows) in a ring of 2 to PREFILL_MAX_STAGES within PREFILL_SMEM.  A tile
# costs PREFILL_TILE_COST rows of x beyond its own (the ring's fill and
# drain, the epilogue, the unpacking a small tile does not hide), so the
# plan weighs a wave of small tiles against fewer waves of larger ones
PREFILL_ROWS = (32, 64, 80, 128, 160, 256)
PREFILL_CHUNK = 64
PREFILL_MAX_STAGES = 8
PREFILL_SMEM = 227 * 1024
PREFILL_TILE_COST = 32
# the decode entry takes M up to DECODE_MAX_M: 128 output columns a warp
# and a block, K walked in steps of 8 packed rows, 4 or 8 warps a block, a
# cluster of up to 8 blocks along K; shared memory of (warps + cluster - 1)
# blocks' partial sums (4 KB each an n8 tile of rows) within 227 KB
DECODE_MAX_M = 2 * TILE_M
DECODE_STEP = 8
DECODE_MAX_SMEM = 227 * 1024


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


def prefill_stage_bytes(rows: int) -> int:
    """Shared memory of one stage of the prefill entry's ring."""
    return 2 * rows * 128 + PREFILL_CHUNK * TILE_N + 4 * TILE_N * 4


def prefill_smem(rows: int, stages: int) -> int:
    """The prefill entry's shared memory: 1 KB to align the stages to the
    swizzle's period, the stages, two mbarriers a stage."""
    return 1024 + stages * prefill_stage_bytes(rows) + 16 * stages


def prefill_stages(rows: int) -> int:
    """The most stages (at most PREFILL_MAX_STAGES) whose ring fits."""
    return max(s for s in range(1, PREFILL_MAX_STAGES + 1)
               if prefill_smem(rows, s) <= PREFILL_SMEM)


def prefill_plan(m: int, n: int, k: int, sms: int) -> Dict[str, int]:
    """The prefill entry's plan for an [m, k] x [k, n] product on ``sms``
    multiprocessors: blocks of TILE_N output columns and ``rows`` rows of x
    (``tiles`` blocks, one tile each) and a ring of ``stages`` stages.
    ``rows`` is the one of PREFILL_ROWS with the least waves x (rows +
    PREFILL_TILE_COST), the larger on a tie: at the SantaCoder-1B linears
    at M 512 one wave of 126 or 128 tiles (``tools/int4_kernel_probe.py``
    times the alternatives).  The stages: as many as fit (at most
    PREFILL_MAX_STAGES, at most one a chunk, at least 2).  The C entry
    refuses any other rows and any ring that does not fit."""
    cols = -(-n // TILE_N)

    def cost(r):
        tiles = cols * -(-m // r)
        return (-(-tiles // sms) * (r + PREFILL_TILE_COST), -r)

    rows = min(PREFILL_ROWS, key=cost)
    chunks = -(-(k // 2) // PREFILL_CHUNK)
    stages = max(2, min(chunks, prefill_stages(rows)))
    return dict(rows=rows, stages=stages, tiles=cols * -(-m // rows))


def _decode_tiles(m: int) -> int:
    """n8 tiles of rows the decode entry's instantiation carries."""
    t = -(-m // 8)
    return t if t <= 2 else 4


def decode_plan(m: int, n: int, k: int, sms: int) -> Dict[str, int]:
    """The decode entry's plan for an [m, k] x [k, n] product, m <= 32, on
    ``sms`` multiprocessors: ``cluster`` blocks along K for every 128
    output columns, ``warps`` warps a block (8, or 4 where K has fewer than
    8 steps), each walking ``steps`` steps of 8 packed rows, so that
    cluster * warps * steps * 8 = k / 2.  Among the clusters (1, 2, 4, 8)
    that keep one block an SM, the smallest whose warps keep all their
    steps' loads in flight at once (steps <= the kernel's depth: 4, 2 and
    1 steps at 1, 2 and 4 n8 tiles of rows), else the largest; one block
    an SM past the card's SMs (``tools/int4_kernel_probe.py`` times the
    alternatives).  The partial sums' shared memory bounds the cluster.
    The C entry refuses any other plan."""
    if not 1 <= m <= DECODE_MAX_M or k % CHUNK_K:
        raise ValueError(f"no decode plan for m {m}, k {k}")
    steps_total = k // 2 // DECODE_STEP
    warps = 8 if steps_total % 8 == 0 else 4
    tiles = -(-n // TILE_N)
    nt = _decode_tiles(m)
    depth = {1: 4, 2: 2, 4: 1}[nt]
    fits = [c for c in (1, 2, 4, 8)
            if steps_total % (warps * c) == 0
            and (warps + c - 1) * 8 * nt * 32 * 16 <= DECODE_MAX_SMEM]
    one_wave = [c for c in fits if tiles * c <= sms] or fits[:1]
    in_flight = [c for c in one_wave
                 if steps_total // (warps * c) <= depth]
    cluster = in_flight[0] if in_flight else one_wave[-1]
    return dict(cluster=cluster, warps=warps,
                steps=steps_total // (warps * cluster))


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
    sms = _sm_count(x.device.index or 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _build.load("int4_quant_matmul")
    if m <= DECODE_MAX_M:
        plan = decode_plan(m, n, k, sms)
        err = lib.int4_quant_matmul_decode(
            _ptr(x2), _ptr(qw), _ptr(sc), m, n, k, groups, plan["cluster"],
            plan["warps"], plan["steps"], _ptr(out), stream)
    else:
        plan = prefill_plan(m, n, k, sms)
        err = lib.int4_quant_matmul(
            _ptr(x2), _ptr(qw), _ptr(sc), m, n, k, groups, plan["rows"],
            plan["stages"], _ptr(out), stream)
    _build.check(err, "int4_quant_matmul")
    launches["int4_quant_matmul"] += 1
    return out
