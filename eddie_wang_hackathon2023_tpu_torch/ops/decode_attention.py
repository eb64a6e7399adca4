"""Single-token decode attention with the fused int8 out-projection, its
beam-search mode and its MQA/GQA mode, and paged decode attention.

Counterpart of ``ops/pallas_decode_attention.py`` ``fused_decode_attention``
(:767) in the JAX package, for the modes the Whisper and decoder-only paths
use.  On a CUDA tensor the wrapper launches the kernels of
``csrc/decode_attention.cu`` (attention, then the out-projection GEMV over
the whole card with :func:`gemv_plan`, passed to the kernel; with
``beam_indirection``, the beam entry that reads each position through the
cache-indirection table, the TPU kernel's ``_beam_kernel`` :213: each
source row of a group read once for all its beams, the columns split over
a cluster by :func:`beam_plan`, passed to the kernel) or, when q
has more heads than the cache, the grouped kernel of
``csrc/gqa_decode_attention.cu`` (the TPU kernel's ``_gqa_kernel`` :410,
on the tensor cores, a cache past :data:`GQA_COLS` columns split over a
cluster of :func:`gqa_splits` blocks of :func:`gqa_slice_width` columns,
both passed to the kernel); on
a CPU tensor it runs the plain version, :func:`plain_decode_attention`
(``cached_decode_attention`` followed by ``weight_only_quant_matmul``, or
``beam_indirect_decode_attention``).  The tail, fp8 and group-shared-cache
modes of the TPU kernel are not ported and raise ``NotImplementedError``.
Without beams the attention kernel splits the sequence over a thread-block
cluster of :func:`decode_splits` blocks; :func:`plain_split_decode_attention`
repeats its arithmetic step by step (the card tests hold the kernel equal
to it bit for bit; no path calls it).

:func:`fused_paged_decode_attention` is the counterpart of
``paged_decode_attention_pallas`` (:682): one-token attention off the
block-paged pool through the block table, on a CUDA tensor by the kernel of
``csrc/paged_decode_attention.cu`` (the TPU kernel's ``_paged_kernel``
:612; its grid, cluster, slices, warps and query heads a block from
:func:`paged_plan`, passed to the kernel), on a CPU tensor by
:func:`plain_paged_decode_attention`.  :func:`fused_paged_window_attention`
is the same source's window entry (mixed context+generation admission: W
query tokens a row with per-row causal offsets), which replaces the JAX
package's XLA formulation (``ops/paged_attention.py:95``); on a CPU tensor
:func:`plain_paged_window_attention`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build
from .attention import (NEG, beam_indirect_decode_attention,
                        cached_decode_attention, layer_kv_views)
from .int4_quant_matmul import _sm_count
from .paged_attention import paged_decode_attention
from .quant_matmul import weight_only_quant_matmul

# launches of each CUDA kernel, counted where the wrapper launches it (the
# attention kernel per cache dtype: each dtype is its own instantiation; the
# beam entry, the grouped kernel and the paged kernel, whose main paths have
# a bf16 cache, count both of their dtypes)
launches = {"decode_attention_bf16": 0, "decode_attention_int8": 0,
            "out_proj_gemv": 0, "beam_decode_attention": 0,
            "gqa_decode_attention": 0, "paged_decode_attention": 0,
            "paged_window_attention": 0}


# kernel 1 without beams splits the S columns of the cache over a cluster
# of blocks (csrc/decode_attention.cu): SPLIT_COLS columns a block or more,
# at most MAX_SPLITS blocks.  A block has 256 threads in 8 warps of 32.
SPLIT_COLS = 256
MAX_SPLITS = 8
_THREADS, _WARP = 256, 32


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def decode_splits(S: int) -> int:
    """The blocks of kernel 1's cluster over a cache of S columns: fixed by
    the static S, since the valid length lives on the device."""
    return max(1, min(-(-S // SPLIT_COLS), MAX_SPLITS))


def split_width(S: int, splits: int) -> int:
    """Columns of each block's slice: ceil(S / splits) rounded up to 4."""
    return (-(-S // splits) + 3) // 4 * 4


# the wrapper gives one block of the grouped kernel (csrc/
# gqa_decode_attention.cu) up to GQA_COLS cache columns, and splits longer
# caches over a cluster of at most MAX_SPLITS blocks
GQA_COLS = 128


def gqa_splits(S: int) -> int:
    """The blocks of the grouped kernel's cluster over a cache of S columns
    (one up to GQA_COLS columns): fixed by the static S, never by the
    lengths, which live on the device."""
    return max(1, min(-(-S // GQA_COLS), MAX_SPLITS))


def gqa_slice_width(S: int, splits: int) -> int:
    """Columns of each block's slice in the grouped kernel, which the
    wrapper passes to it: ceil(S / splits) rounded up to 16 (one mma
    step)."""
    return (-(-S // splits) + 15) // 16 * 16


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _pad16(n: int) -> int:
    return (n + 15) // 16 * 16


# the beam entry (csrc/decode_attention.cu): a block takes BEAM_ROWS query
# beams (the mma's m; a wider beam is cut into tiles of them) and walks its
# slice in rounds of at most BEAM_COLS columns, and its source rows in
# rounds where all of them do not fit, so that the panels fit KERNEL_SMEM,
# what a block may take beside its static shared memory; a group's source
# rows are split over BEAM_ROW_SPLITS blocks where the cluster has room
# (more blocks halve each one's copies, but every block of the cluster adds
# its messages)
BEAM_ROWS = 16
BEAM_COLS = 256
BEAM_ROW_SPLITS = 2
KERNEL_SMEM = 226 * 1024


def beam_smem_bytes(qn: int, rows: int, D: int, cols: int, itemsize: int,
                    blocks: int) -> int:
    """Shared memory of a block of the beam entry (``beam_layout`` in the
    source) with at most qn query beams, in a cluster of ``blocks``: the K
    and V panels [rows][Dp][pitch] of the source rows of a round, the
    table's columns and the selected scores [qn][cols], P [16][cols + 8]
    and q [16][Dp + 8] in bf16, the fresh K/V [qn][D] fp32, each row's
    max, sum and fresh score, the cluster's maxima and sums, each group of
    warps' partial contexts [8 // (Dp / 16)][16][Dp], rank 0's partial
    contexts [splits][16][Dp]."""
    Dp = (D + 15) // 16 * 16
    pitch = cols + 8 if itemsize == 2 else cols + 16
    rows16, warps = BEAM_ROWS, _THREADS // _WARP
    return (2 * _pad16(rows * Dp * pitch * itemsize) + 2 * _pad16(4 * qn * cols)
            + _pad16(2 * rows16 * (cols + 8)) + _pad16(2 * rows16 * (Dp + 8))
            + 2 * _pad16(4 * qn * D) + 3 * _pad16(4 * rows16)
            + 2 * _pad16(4 * MAX_SPLITS * rows16)
            + _pad16(4 * (warps // (Dp // 16)) * rows16 * Dp)
            + (_pad16(4 * blocks * rows16 * Dp) if blocks > 1 else 0))


@functools.lru_cache(maxsize=None)
def beam_plan(S: int, bw: int, D: int, itemsize: int) -> dict:
    """The beam entry's plan over a cache of S columns (S a multiple of 4),
    beam width bw (any), head dim D and cache elements of ``itemsize``
    bytes, which the wrapper passes to the kernel: ``splits`` =
    :func:`decode_splits` column slices (from the static S, never the
    lengths) of ``width`` = :func:`split_width` columns, each walked in
    ``rounds`` rounds of ``cols`` columns, times ``rs`` splits of the
    group's bw source rows (BEAM_ROW_SPLITS where bw and a cluster of
    MAX_SPLITS blocks leave room, else 1; each row's panels are copied by
    one block), each block's rows staged ``rows`` at a time.  ``cols`` is a
    multiple of 16, the most, up to BEAM_COLS, whose panels of all the
    block's rows fit a block; where even 16 columns do not fit, ``cols`` is
    16 and ``rows`` the most rows that do."""
    splits = decode_splits(S)
    width = split_width(S, splits)
    rs = max(1, min(bw, BEAM_ROW_SPLITS, MAX_SPLITS // splits))
    qn, rows = min(bw, BEAM_ROWS), -(-bw // rs)
    cols = min(BEAM_COLS, _pad16(width))

    def fits():
        return beam_smem_bytes(qn, rows, D, cols, itemsize,
                               splits * rs) <= KERNEL_SMEM
    while cols > 16 and not fits():
        cols -= 16
    while not fits():           # one row of 16 columns always fits
        rows -= 1
    return dict(splits=splits, width=width, cols=cols,
                rounds=-(-width // cols), rs=rs, rows=rows)


# the paged kernel (csrc/paged_decode_attention.cu): a warp takes 32 tokens
# a round, a block at most PAGED_WARPS warps and PAGED_HEADS query heads (a
# lane scores its token for each of them, so more heads a block lengthen the
# chain while the blocks of one KV head read its panels from L2); a table of
# more tokens than one block's round is split over a cluster of at most
# MAX_SPLITS blocks; the C entry takes no more warps or heads than these
PAGED_WARPS = 4
PAGED_HEADS = 2


@functools.lru_cache(maxsize=None)
def paged_plan(max_blocks: int, T: int, rep: int) -> dict:
    """The paged kernel's plan over a table of ``max_blocks`` blocks of T
    tokens and rep query heads a KV head, which the wrapper passes to the
    kernel: a cluster of ``splits`` blocks (from the static table width,
    never the lengths), each a slice of ``width`` tokens (a multiple of 32;
    the slices cover the table, the last one not empty), ``warps`` warps
    (a power of 2) walking it in ``rounds`` rounds of 32 tokens a warp, and
    ``heads`` query heads a block (the power of 2 at or above rep, at most
    PAGED_HEADS: one at rep 1, so no query lane is padded)."""
    tokens = max_blocks * T
    per_block = PAGED_WARPS * _WARP
    splits = max(1, min(-(-tokens // per_block), MAX_SPLITS))
    width = (-(-tokens // splits) + _WARP - 1) // _WARP * _WARP
    splits = -(-tokens // width)
    warps = min(PAGED_WARPS, _pow2_at_least(-(-width // _WARP)))
    return dict(splits=splits, width=width, warps=warps,
                rounds=-(-width // (_WARP * warps)),
                heads=min(PAGED_HEADS, _pow2_at_least(rep)))


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check_beam_args(fresh_kv, proj) -> None:
    """The beam mode's contract, as the JAX dispatch asserts it
    (``pallas_decode_attention.py:835-838``)."""
    if fresh_kv is None:
        raise ValueError("beam decode is deferred-write only (fresh K/V "
                         "required)")
    if proj is not None:
        raise ValueError("the out-projection fusion is batch-1 only; beam "
                         "decode returns the context")


def _check_gqa_args(fresh_kv, proj) -> None:
    """The grouped mode's contract, as the JAX dispatch asserts it
    (``pallas_decode_attention.py:849-851``)."""
    if fresh_kv is None:
        raise ValueError("grouped decode is deferred-write only (fresh K/V "
                         "required)")
    if proj is not None:
        raise ValueError("the out-projection fusion is equal-heads only")


def plain_gqa_decode_attention(full_cache, layer_idx: int, q, seq_len,
                               scale: float, kv_quant_orig_scale=None,
                               fresh_kv: Optional[Tuple] = None,
                               start_index=None) -> torch.Tensor:
    """The plain PyTorch version of the grouped mode of
    :func:`fused_decode_attention`: the grouped ``cached_decode_attention``
    over layer ``layer_idx`` of the stacked cache."""
    return cached_decode_attention(
        q, layer_kv_views(full_cache, layer_idx), seq_len, scale=scale,
        kv_quant_orig_scale=kv_quant_orig_scale, start_index=start_index,
        fresh_kv=fresh_kv)


def plain_beam_decode_attention(full_cache, layer_idx: int, q, seq_len,
                                scale: float, kv_quant_orig_scale=None,
                                fresh_kv: Optional[Tuple] = None,
                                start_index=None, *,
                                beam_indirection) -> torch.Tensor:
    """The plain PyTorch version of the beam entry of
    :func:`fused_decode_attention`: ``beam_indirect_decode_attention`` over
    layer ``layer_idx`` of the stacked cache."""
    return beam_indirect_decode_attention(
        q, layer_kv_views(full_cache, layer_idx), seq_len, beam_indirection,
        scale=scale, kv_quant_orig_scale=kv_quant_orig_scale,
        start_index=start_index, fresh_kv=fresh_kv)


def plain_decode_attention(full_cache, layer_idx: int, q, seq_len,
                           scale: float, kv_quant_orig_scale=None,
                           fresh_kv: Optional[Tuple] = None,
                           start_index=None,
                           proj: Optional[Tuple] = None,
                           beam_indirection=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_decode_attention`."""
    if beam_indirection is not None:
        _check_beam_args(fresh_kv, proj)
        return plain_beam_decode_attention(
            full_cache, layer_idx, q, seq_len, scale, kv_quant_orig_scale,
            fresh_kv, start_index, beam_indirection=beam_indirection)
    if full_cache.shape[1] != q.shape[0]:
        raise NotImplementedError("group-shared caches are not ported")
    if q.shape[1] != full_cache.shape[3]:
        _check_gqa_args(fresh_kv, proj)
        return plain_gqa_decode_attention(
            full_cache, layer_idx, q, seq_len, scale, kv_quant_orig_scale,
            fresh_kv, start_index)
    ctx = cached_decode_attention(
        q, layer_kv_views(full_cache, layer_idx), seq_len, scale=scale,
        kv_quant_orig_scale=kv_quant_orig_scale, start_index=start_index,
        fresh_kv=fresh_kv)
    if proj is None:
        return ctx
    w, w_scale, bias = proj
    if w.dim() == 3:
        w = w[layer_idx]
    b, h, _, d = ctx.shape
    out = weight_only_quant_matmul(ctx.reshape(b, h * d), w, w_scale)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The terms of x along ``dim`` added one after the other from 0, as a
    loop adds them."""
    acc = torch.zeros_like(x.select(dim, 0))
    for t in x.unbind(dim):
        acc = acc + t
    return acc


def _warp_sum(x: torch.Tensor) -> torch.Tensor:
    """x [..., 32] -> [...]: what lane 0 holds after the kernel's butterfly
    (shuffle xor 16, 8, 4, 2, 1: lane i adds lane i + o)."""
    o = _WARP // 2
    while o:
        x = x[..., :o] + x[..., o:2 * o]
        o //= 2
    return x[..., 0]


def plain_split_decode_attention(full_cache, layer_idx: int, q, seq_len,
                                 scale: float, kv_quant_orig_scale=None,
                                 fresh_kv: Optional[Tuple] = None,
                                 start_index=None, *,
                                 splits: int) -> torch.Tensor:
    """Kernel 1 without beams, step by step, in fp32: the sequence cut into
    ``splits`` slices of :func:`split_width` columns (one block of the
    cluster each).  Scores with q pre-scaled by scale * kscale, each summed
    over four interleaved d-groups (d = g, g + 4, ...) in order; the max
    over the whole row; p = exp(s - max), summed in fp32 and rounded to the
    activation dtype (bf16 for bf16 q) for P·V; per slice, the denominator
    and the context summed as the block's threads, warps and lanes add
    them; the slices added in rank order; then the fresh column.  Every
    product and sum is rounded where the kernel rounds it, so on the card
    the kernel equals this function bit for bit.  q [B, H, 1, D] (bf16 or
    fp32) over a cache [L, B, 2, H, D, S] (bf16, int8 or fp32), no beams,
    no grouped heads; returns [B, H, 1, D] in q's dtype."""
    _, B, _, H, D, S = full_cache.shape
    f32, dev = torch.float32, q.device
    kscale = (torch.ones((), dtype=f32, device=dev)
              if kv_quant_orig_scale is None else
              torch.as_tensor(kv_quant_orig_scale, dtype=f32,
                              device=dev).reshape(()))
    qs = q[:, :, 0].to(f32) * (torch.tensor(scale, dtype=f32, device=dev)
                               * kscale)                      # [B, H, D]
    k, v = (full_cache[layer_idx, :, i].to(f32) for i in (0, 1))

    def dot(keys):                      # [B, H, D, N] -> [B, H, N]
        groups = []
        for g in range(4):
            acc = torch.zeros(B, H, keys.shape[-1], dtype=f32, device=dev)
            for d in range(g, D, 4):
                acc = acc + qs[:, :, d, None] * keys[:, :, d]
            groups.append(acc)
        return ((groups[0] + groups[1]) + groups[2]) + groups[3]

    with_fresh = fresh_kv is not None
    pos = torch.arange(S, device=dev)
    cache_len = torch.clamp(torch.as_tensor(seq_len, device=dev).reshape(B)
                            - int(with_fresh), max=S)
    valid = pos < cache_len[:, None]
    if start_index is not None:
        valid = valid & (pos >= torch.as_tensor(start_index,
                                                device=dev).reshape(B, 1))
    valid = valid[:, None, :]                                 # [B, 1, S]
    s = torch.where(valid, dot(k), torch.full((), NEG, device=dev))
    m = s.amax(-1)                                            # [B, H]
    p = torch.where(valid, torch.exp(s - m[..., None]),
                    torch.zeros((), device=dev))
    cdt = q.dtype if q.dtype in (torch.float32, torch.bfloat16) \
        else torch.bfloat16
    p_r = p.to(cdt).to(f32)
    pv = torch.where(p_r[:, :, None] != 0, p_r[:, :, None] * v,
                     torch.zeros((), device=dev))             # [B, H, D, S]
    W = split_width(S, splits)
    Wp = -(-W // _THREADS) * _THREADS   # whole rounds of 256 columns

    def slices(x):                      # [..., S] -> [splits, ..., Wp]
        x = torch.nn.functional.pad(x, (0, splits * W - S))
        x = x.reshape(*x.shape[:-1], splits, W).movedim(-2, 0)
        return torch.nn.functional.pad(x, (0, Wp - W))

    # the denominator: thread t adds columns t, t + 256, ...; the lanes of
    # a warp by the butterfly; the warps in order; the slices in rank order
    per_thread = _in_order(slices(p).unflatten(-1, (-1, _THREADS)), -2)
    per_warp = _warp_sum(per_thread.unflatten(-1, (-1, _WARP)))
    lt = _in_order(_in_order(per_warp, -1), 0)                # [B, H]
    # P·V: lane j adds columns 4j..4j+3, then 128 further, ...; the lanes by
    # the butterfly; the slices in rank order
    x = slices(pv).unflatten(-1, (-1, _WARP, 4)).transpose(-1, -2)
    per_lane = _in_order(x.flatten(-3, -2), -2)       # [splits, B, H, D, 32]
    acc = _in_order(_warp_sum(per_lane), 0)                   # [B, H, D]
    if with_fresh:
        fk, fv = (t[..., 0].to(f32) for t in fresh_kv)        # [B, H, D]
        s_f = dot(fk[..., None])[..., 0]                      # [B, H]
        m_fin = torch.maximum(m, s_f)
        alpha, p_f = torch.exp(m - m_fin), torch.exp(s_f - m_fin)
        lt = lt * alpha + p_f
        acc = acc * alpha[..., None] + p_f[..., None] * fv
    inv = torch.where(lt > 0, kscale / lt, torch.zeros((), device=dev))
    return (acc * inv[..., None]).to(q.dtype)[:, :, None]


def fused_decode_attention(full_cache, layer_idx: int, q, seq_len,
                           scale: float, kv_quant_orig_scale=None,
                           fresh_kv: Optional[Tuple] = None,
                           start_index=None,
                           proj: Optional[Tuple] = None,
                           tail_kv: Optional[Tuple] = None,
                           beam_indirection=None) -> torch.Tensor:
    """One-token attention against layer ``layer_idx`` of the stacked cache.

    full_cache [L, B, 2, H, D, S] bf16 or int8 (seq-minor); q [B, H, 1, D];
    seq_len [B] integer tensor on q's device: valid length INCLUDING the
    current token.  ``kv_quant_orig_scale``: per-tensor int8 dequant scale (a 0-d
    or [1] fp32 tensor, read on the device).  ``fresh_kv`` (k, v)
    [B, H, D, 1] in cache dtype: the current token's K/V, not in the cache
    yet.  ``start_index`` [B]: keys below it are masked.  ``proj`` (weight
    int8 [L, H*D, N] or [H*D, N], scale [N] fp32, bias [N] or None): the
    out-projection, giving [B, N]; otherwise the result is the context
    [B, H, 1, D].

    ``beam_indirection`` [groups, beams, s_ind] integer tensor, groups *
    beams = B: beam search.  Each (query beam, position) reads the cache
    row of its group that the table names (rows of one group are
    consecutive; row ``g * beams`` speaks for the group's length and
    start); fresh K/V is required and is each row's own; no ``proj``.  A
    table narrower than S is padded.

    MQA/GQA: q [B, Hq, 1, D] over a cache of H = Hq / rep KV heads (query
    head h reads KV head h // rep).  Fresh K/V [B, H, D, 1] is required and
    there is no ``proj``, as in the JAX dispatch (:844-855); any S.  The
    K-step ``tail_kv`` mode of the JAX function is not ported and raises."""
    if tail_kv is not None:
        raise NotImplementedError("the decode tail is not ported yet")
    grouped = beam_indirection is None and q.shape[1] != full_cache.shape[3]
    if beam_indirection is not None:
        _check_beam_args(fresh_kv, proj)
    elif grouped:
        _check_gqa_args(fresh_kv, proj)
    if not q.is_cuda:
        return plain_decode_attention(full_cache, layer_idx, q, seq_len,
                                      scale, kv_quant_orig_scale, fresh_kv,
                                      start_index, proj, beam_indirection)
    L, b_kv, two, H, D, S = full_cache.shape
    B, Hq = q.shape[0], q.shape[1]
    if q.shape != (B, Hq, 1, D) or Hq % H or (Hq != H and not grouped):
        raise NotImplementedError(
            f"q {tuple(q.shape)} vs cache heads {H}: multi-token decode and "
            "beams over MQA/GQA caches are not ported")
    if b_kv != B:
        raise NotImplementedError("group-shared caches are not ported")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"decode kernel takes bf16 q, got {q.dtype}")
    if full_cache.dtype.is_floating_point and full_cache.dtype.itemsize == 1:
        raise NotImplementedError("fp8 KV caches are not ported yet")
    if full_cache.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"decode kernel cache dtype {full_cache.dtype}")
    if not full_cache.is_contiguous() or (S % 4 and not grouped):
        raise ValueError("decode kernel needs a contiguous cache with S a "
                         "multiple of 4")
    dev = q.device
    # every tensor the kernel reads is held in a local until the launch is
    # enqueued: a temporary freed earlier could hand its memory to the next
    # allocation here, whose fill runs on the stream before the kernel
    q = q.contiguous()

    def as_rows(x, what):
        if not torch.is_tensor(x) or x.shape != (B,) or x.device != dev:
            raise TypeError(f"{what} must be a [{B}] tensor on {dev}")
        return x.to(torch.int32).contiguous()

    seq_t = as_rows(seq_len, "seq_len")
    start_t = None if start_index is None else as_rows(start_index,
                                                       "start_index")
    ks_t = None
    if kv_quant_orig_scale is not None:
        ks_t = torch.as_tensor(kv_quant_orig_scale, dtype=torch.float32,
                               device=dev).reshape(-1)
        if ks_t.numel() != 1:
            raise ValueError("kv_quant_orig_scale must be one value")
    fk = fv = None
    if fresh_kv is not None:
        fk, fv = (t.contiguous() for t in fresh_kv)
        if fk.dtype != full_cache.dtype or fk.shape != (B, H, D, 1):
            raise ValueError("fresh K/V must be [B,H,D,1] in cache dtype")
    is_int8 = full_cache.dtype == torch.int8
    ctx = torch.empty((B, Hq * D), dtype=torch.bfloat16, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    if grouped:
        splits = gqa_splits(S)
        _build.check(_build.load("gqa_decode_attention").gqa_decode_attention(
            _ptr(q), _ptr(full_cache), int(is_int8), int(layer_idx), B, H,
            Hq // H, D, S, splits, gqa_slice_width(S, splits), _ptr(seq_t),
            _ptr(start_t), _ptr(ks_t), float(scale), _ptr(fk), _ptr(fv),
            _ptr(ctx), stream), "gqa_decode_attention")
        launches["gqa_decode_attention"] += 1
        return ctx.view(B, Hq, 1, D)
    lib = _build.load("decode_attention")
    if beam_indirection is not None:
        ind = beam_indirection
        if (not torch.is_tensor(ind) or ind.dim() != 3 or ind.device != dev
                or ind.shape[0] * ind.shape[1] != B or ind.shape[2] > S):
            raise ValueError(f"beam_indirection must be a [groups, beams, "
                             f"<= {S}] tensor on {dev} with groups * beams "
                             f"= {B}")
        bw = ind.shape[1]
        plan = beam_plan(S, bw, D, full_cache.element_size())
        ind = ind.to(torch.int32)
        if ind.shape[2] < S:
            ind = torch.nn.functional.pad(ind, (0, S - ind.shape[2]))
        ind = ind.contiguous()
        if ind.data_ptr() % 16:          # the kernel copies 16 bytes at once
            ind = ind.clone()
        _build.check(lib.beam_decode_attention(
            _ptr(q), _ptr(full_cache), int(is_int8), int(layer_idx), B, H,
            D, S, plan["splits"], plan["width"], plan["cols"],
            plan["rounds"], plan["rs"], plan["rows"], _ptr(seq_t), _ptr(start_t),
            _ptr(ks_t), float(scale), _ptr(fk), _ptr(fv), _ptr(ind), bw,
            _ptr(ctx), stream), "beam_decode_attention")
        launches["beam_decode_attention"] += 1
        return ctx.view(B, H, 1, D)
    _build.check(lib.decode_attention(
        _ptr(q), _ptr(full_cache), int(is_int8),
        int(layer_idx), B, H, D, S, decode_splits(S), _ptr(seq_t),
        _ptr(start_t), _ptr(ks_t),
        float(scale), _ptr(fk), _ptr(fv), _ptr(ctx), stream),
        "decode_attention")
    launches["decode_attention_int8" if is_int8 else
             "decode_attention_bf16"] += 1
    if proj is None:
        return ctx.view(B, H, 1, D)
    return out_proj_gemv(ctx, layer_idx, *proj)


# the out-projection GEMV (csrc/decode_attention.cu): GEMV_COLS output
# columns a block of 128 threads (GEMV_ROW_LANES lanes of rows for each 16
# columns), a cluster of at most GEMV_MAX_CLUSTER blocks along K, up to 8
# rows of x a block (GEMV_BATCH)
GEMV_COLS = 64
GEMV_ROW_LANES = 32
GEMV_MAX_CLUSTER = 8
GEMV_BATCH = (1, 2, 4, 8)


@functools.lru_cache(maxsize=None)
def gemv_plan(B: int, K: int, N: int, sms: int) -> dict:
    """The GEMV's plan for x [B, K] @ W [K, N]: ``batch`` rows of x a block
    (the least of GEMV_BATCH that holds min(B, 8)), ceil(N / GEMV_COLS)
    column blocks for each ceil(B / batch) batch tiles, and along K a
    cluster of ``cluster`` blocks of ``rows`` consecutive rows each
    (cluster * rows >= K > (cluster - 1) * rows): the most blocks that fit
    one wave of ``sms`` multiprocessors, at most GEMV_MAX_CLUSTER, and no
    more than K / GEMV_ROW_LANES ranks (a row for every lane).  At the
    scanned path's call ([1,1280] x [1280,1280] on 132 SMs): 20 x 6 = 120
    blocks of 214 rows.  The C entry refuses any other plan."""
    batch = next(b for b in GEMV_BATCH if b >= min(B, GEMV_BATCH[-1]))
    blocks = -(-N // GEMV_COLS) * -(-B // batch)
    cluster = max(1, min(GEMV_MAX_CLUSTER, sms // blocks,
                         -(-K // GEMV_ROW_LANES)))
    return dict(cluster=cluster, rows=-(-K // cluster), batch=batch)


def out_proj_gemv(x: torch.Tensor, layer_idx: int, weight: torch.Tensor,
                  scale: torch.Tensor, bias: Optional[torch.Tensor]
                  ) -> torch.Tensor:
    """x [B, K] bf16 @ int8 weight [L, K, N] (layer ``layer_idx``) or
    [K, N], times scale [N], plus bias [N] -> [B, N] bf16, on the card, with
    :func:`gemv_plan`."""
    if weight.dtype != torch.int8:
        raise NotImplementedError("the float out-projection epilogue is "
                                  "not ported; run the dense layer instead")
    w = weight if weight.dim() == 3 else weight[None]
    if w.dim() != 3:
        raise ValueError(f"proj weight {tuple(weight.shape)}")
    layer = layer_idx if weight.dim() == 3 else 0
    B, K = x.shape
    N = w.shape[2]
    if w.shape[1] != K or N % 4 or not w.is_contiguous():
        raise ValueError(f"proj weight {tuple(w.shape)} for x {tuple(x.shape)}"
                         " (contiguous, N a multiple of 4)")
    if x.dtype != torch.bfloat16 or scale.dtype != torch.float32:
        raise TypeError("GEMV takes bf16 x and fp32 scale")
    if bias is not None and bias.dtype != torch.bfloat16:
        raise TypeError("GEMV takes a bf16 bias")
    # operands held in locals until the launch is enqueued (see above)
    x = x.contiguous()
    scale = scale.contiguous()
    bias = None if bias is None else bias.contiguous()
    out = torch.empty((B, N), dtype=torch.bfloat16, device=x.device)
    plan = gemv_plan(B, K, N, _sm_count(x.device.index or 0))
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _build.load("decode_attention")
    _build.check(lib.out_proj_gemv(
        _ptr(x), _ptr(w), layer, _ptr(scale), _ptr(bias), _ptr(out), B, K, N,
        plan["cluster"], plan["rows"], plan["batch"], stream),
        "out_proj_gemv")
    launches["out_proj_gemv"] += 1
    return out


def plain_paged_decode_attention(full_pool, layer_idx: int, q, block_table,
                                 seq_len, scale: float,
                                 kv_quant_orig_scale=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_paged_decode_attention`:
    ``paged_decode_attention`` (the JAX XLA formulation) on layer
    ``layer_idx`` of the stacked pool."""
    return paged_decode_attention(q, full_pool[layer_idx], block_table,
                                  seq_len, scale=scale,
                                  kv_quant_orig_scale=kv_quant_orig_scale)


def _check_paged_args(full_pool, layer_idx: int, q, block_table, seq_len,
                      kv_quant_orig_scale):
    """The paged entries' input checks on the card (both take the same
    pool, table and lengths); returns the fp32 dequant scale or None."""
    L, N, two, Hkv, T, D = full_pool.shape
    B, H = q.shape[0], q.shape[1]
    if q.dim() != 4 or q.shape[3] != D or H % Hkv:
        raise NotImplementedError(
            f"q {tuple(q.shape)} over {Hkv} KV heads of {D}: H must be a "
            "multiple of Hkv")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"paged decode kernel takes bf16 q, got {q.dtype}")
    if full_pool.dtype not in (torch.bfloat16, torch.int8):
        raise TypeError(f"paged decode kernel pool dtype {full_pool.dtype}")
    if (not full_pool.is_contiguous() or full_pool.data_ptr() % 16
            or D % 16 or D > 128 or two != 2):
        raise ValueError("paged decode kernel needs a contiguous, 16-byte "
                         "aligned [L, N, 2, Hkv, T, D] pool with D a multiple "
                         "of 16 up to 128")
    if not 0 <= layer_idx < L:
        raise IndexError(f"layer {layer_idx} of a {L}-layer pool")
    dev = q.device
    if (not torch.is_tensor(block_table) or block_table.dim() != 2
            or block_table.shape[0] != B or block_table.device != dev
            or block_table.dtype.is_floating_point):
        raise TypeError(f"block_table must be a [{B}, max_blocks] integer "
                        f"tensor on {dev}")
    if (not torch.is_tensor(seq_len) or seq_len.shape != (B,)
            or seq_len.device != dev):
        raise TypeError(f"seq_len must be a [{B}] tensor on {dev}")
    if kv_quant_orig_scale is not None:
        ks_t = torch.as_tensor(kv_quant_orig_scale, dtype=torch.float32,
                               device=dev).reshape(-1)
        if ks_t.numel() != 1:
            raise ValueError("kv_quant_orig_scale must be one value")
        return ks_t
    if full_pool.dtype == torch.int8:
        raise ValueError("an int8 pool needs kv_quant_orig_scale")
    return None


def fused_paged_decode_attention(full_pool, layer_idx: int, q, block_table,
                                 seq_len, scale: float,
                                 kv_quant_orig_scale=None) -> torch.Tensor:
    """One-token attention off layer ``layer_idx`` of the stacked block pool.

    full_pool [L, N, 2, Hkv, T, D] bf16 or int8 (token-major); q
    [B, H, 1, D]; block_table [B, max_blocks] integer, -1 padded; seq_len
    [B] integer: the valid length INCLUDING the current token, whose K/V is
    already in the pool.  MQA/GQA: H = rep * Hkv, query head h reads KV head
    h // rep.  ``kv_quant_orig_scale``: the int8 pool's per-tensor dequant
    scale (a 0-d or [1] fp32 tensor).  Returns [B, H, 1, D].  The kernel
    takes any batch (the JAX layer's batch gate came from a TPU
    measurement).  A row with seq_len 0 gives zeros on the card (the plain
    version's context of a fully masked row is of no use either).  fp8
    pools raise."""
    if full_pool.dtype.is_floating_point and full_pool.dtype.itemsize == 1:
        raise NotImplementedError("fp8 KV pools are not ported yet")
    if not q.is_cuda:
        return plain_paged_decode_attention(full_pool, layer_idx, q,
                                            block_table, seq_len, scale,
                                            kv_quant_orig_scale)
    L, N, two, Hkv, T, D = full_pool.shape
    B, H = q.shape[0], q.shape[1]
    if q.shape != (B, H, 1, D):
        raise NotImplementedError(
            f"q {tuple(q.shape)}: the single-token entry takes one query "
            "token a row (the window entry takes more)")
    ks_t = _check_paged_args(full_pool, layer_idx, q, block_table, seq_len,
                             kv_quant_orig_scale)
    dev = q.device
    is_int8 = full_pool.dtype == torch.int8
    # operands held in locals until the launch is enqueued (see above)
    q = q.contiguous()
    table_t = block_table.to(torch.int32).contiguous()
    seq_t = seq_len.to(torch.int32).contiguous()
    out = torch.empty((B, H, 1, D), dtype=torch.bfloat16, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    MB = table_t.shape[1]
    plan = paged_plan(MB, T, H // Hkv)
    _build.check(_build.load("paged_decode_attention").paged_decode_attention(
        _ptr(q), _ptr(full_pool), int(is_int8), int(layer_idx), N, Hkv,
        H // Hkv, T, D, B, MB, _ptr(table_t), _ptr(seq_t), _ptr(ks_t),
        float(scale), plan["splits"], plan["width"], plan["warps"],
        plan["rounds"], plan["heads"], _ptr(out), stream),
        "paged_decode_attention")
    launches["paged_decode_attention"] += 1
    return out


def plain_paged_window_attention(full_pool, layer_idx: int, q, block_table,
                                 seq_len, causal_offset, scale: float,
                                 kv_quant_orig_scale=None) -> torch.Tensor:
    """The plain PyTorch version of :func:`fused_paged_window_attention`:
    ``paged_decode_attention`` with ``causal_offset`` (the JAX XLA
    formulation) on layer ``layer_idx`` of the stacked pool."""
    return paged_decode_attention(q, full_pool[layer_idx], block_table,
                                  seq_len, scale=scale,
                                  kv_quant_orig_scale=kv_quant_orig_scale,
                                  causal_offset=causal_offset)


def fused_paged_window_attention(full_pool, layer_idx: int, q, block_table,
                                 seq_len, causal_offset, scale: float,
                                 kv_quant_orig_scale=None) -> torch.Tensor:
    """W query tokens a row off layer ``layer_idx`` of the stacked block
    pool (mixed context+generation admission).

    full_pool [L, N, 2, Hkv, T, D] bf16 or int8; q [B, H, W, D];
    block_table [B, max_blocks] integer, -1 padded; seq_len [B]: the valid
    length INCLUDING the window's tokens, whose K/V is already in the pool;
    causal_offset [B]: query token i of row b attends keys <= causal_offset
    [b] + i.  MQA/GQA and the int8 scale as the single-token entry takes
    them.  Returns [B, H, W, D].  One launch of the window entry of
    ``csrc/paged_decode_attention.cu`` (any W, any table width); a row
    with no valid key gives zeros on the card (the plain version's is of
    no use either).  fp8 pools raise."""
    if full_pool.dtype.is_floating_point and full_pool.dtype.itemsize == 1:
        raise NotImplementedError("fp8 KV pools are not ported yet")
    if not q.is_cuda:
        return plain_paged_window_attention(full_pool, layer_idx, q,
                                            block_table, seq_len,
                                            causal_offset, scale,
                                            kv_quant_orig_scale)
    L, N, two, Hkv, T, D = full_pool.shape
    ks_t = _check_paged_args(full_pool, layer_idx, q, block_table, seq_len,
                             kv_quant_orig_scale)
    B, H, W = q.shape[0], q.shape[1], q.shape[2]
    dev = q.device
    if (not torch.is_tensor(causal_offset) or causal_offset.shape != (B,)
            or causal_offset.device != dev):
        raise TypeError(f"causal_offset must be a [{B}] tensor on {dev}")
    # operands held in locals until the launch is enqueued (see above)
    q = q.contiguous()
    table_t = block_table.to(torch.int32).contiguous()
    seq_t = seq_len.to(torch.int32).contiguous()
    off_t = causal_offset.to(torch.int32).contiguous()
    out = torch.empty((B, H, W, D), dtype=torch.bfloat16, device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    _build.check(_build.load("paged_decode_attention").paged_window_attention(
        _ptr(q), _ptr(full_pool), int(full_pool.dtype == torch.int8),
        int(layer_idx), N, Hkv, H // Hkv, T, D, B, table_t.shape[1], W,
        _ptr(table_t), _ptr(seq_t), _ptr(off_t), _ptr(ks_t), float(scale),
        _ptr(out), stream), "paged_window_attention")
    launches["paged_window_attention"] += 1
    return out
