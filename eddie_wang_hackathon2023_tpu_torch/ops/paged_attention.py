"""Block-paged KV-cache attention in plain PyTorch (the JAX package's
``ops/paged_attention.py``, the modes of paged serving without beams).

One preallocated pool tensor holds the KV blocks; a sequence reaches its
blocks through its row of the block table (int32 indices into the pool, -1
where it has none), which :mod:`..runtime.kv_cache_manager` builds.

Pool layout: ``[N + 1, 2, Hkv, T, D]`` or stacked
``[L, N + 1, 2, Hkv, T, D]`` (T tokens per block, the sink below last).  It is TOKEN-MAJOR: D is contiguous, and a block's
``[T, D]`` panel of one head is one contiguous piece of memory (the dense
stacked cache of :mod:`.attention` is seq-minor ``[.., D, S]``).

The writes update the pool in place (the JAX functions return a new pool)
and return it.  A write whose table slot is -1 (or whose position lies
past the table) is dropped, as JAX's scatter with ``mode="drop"`` drops it.
A torch index of -1 would instead wrap onto block N-1, which belongs to
another sequence, so the pool a write takes holds one block more than
the tables may name: :func:`new_block_pool` of N blocks is N + 1 blocks,
and block N is a sink that takes the dropped writes (:func:`token_slots`)
and is never read.  That keeps the writes one scatter each, with no host
synchronisation (a boolean selection of the written rows would wait for
the device).

Mixed context+generation admission writes a W-token window a row at any
offset (:func:`paged_append_window`) and reads it with per-row
``causal_offset`` (:func:`paged_decode_attention` with Lq = W).  Not
ported here: the ``beam_indirection`` mode of the attention, which raises.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .attention import NEG, _mm_f32, quantize_cache_values


@dataclasses.dataclass(frozen=True)
class TokenSlots:
    """Where R tokens land in a pool of N blocks of T tokens and its sink
    block N, found once for all layers of a step (the tables and positions
    are the same in every layer): each token's block and offset.  A token
    whose table slot is -1, or whose position lies outside the table or
    the pool, lands in the sink."""
    blk: torch.Tensor        # [R] long, in [0, N]
    off: torch.Tensor        # [R] long, in [0, T)


def token_slots(block_table, pos, num_blocks: int,
                tokens_per_block: int) -> TokenSlots:
    """The :class:`TokenSlots` of tokens at positions pos [B, P] through
    block_table [B, max_blocks] (rows flattened b-major) into a pool of
    ``num_blocks`` blocks and the sink."""
    t = tokens_per_block
    table = block_table.to(dtype=torch.long)
    mb = table.shape[1]
    pos = pos.to(device=table.device, dtype=torch.long)
    in_table = (pos >= 0) & (pos < mb * t)
    blk = torch.gather(table, 1, torch.where(in_table, pos // t, 0))
    valid = in_table & (blk >= 0) & (blk < num_blocks)
    return TokenSlots(torch.where(valid, blk, num_blocks).reshape(-1),
                      (pos % t).reshape(-1))


def put_tokens(pool_l: torch.Tensor, slots: TokenSlots,
               rows: torch.Tensor) -> None:
    """``pool_l[blk, :, :, off] = rows``, in place.  pool_l
    [N + 1, 2, H, T, D]; rows [R, 2, H, D] in the pool's dtype."""
    pool_l[slots.blk, :, :, slots.off] = rows


@dataclasses.dataclass(frozen=True)
class PagedKV:
    """One attention call's paged cache: the stacked pool
    [L, N + 1, 2, Hkv, T, D], the batch's block tables [B, max_blocks] (int32,
    -1 padded) and the layer index; for a one-token step, the write slots
    of its tokens, found once for all layers."""
    pool: torch.Tensor
    block_table: torch.Tensor
    layer_idx: int
    slots: Optional[TokenSlots] = None


@dataclasses.dataclass(frozen=True)
class PagedCacheState:
    """The serving runtime's cache argument in paged mode (in place of the
    dense stacked cache): the pool and the current block tables."""
    pool: torch.Tensor           # [L, N + 1, 2, Hkv, T, D]
    block_table: torch.Tensor    # [B, max_blocks] int32


def new_block_pool(num_blocks: int, num_kv_heads: int, tokens_per_block: int,
                   head_dim: int, dtype=torch.bfloat16,
                   num_layers: Optional[int] = None,
                   device=None) -> torch.Tensor:
    """A zeroed pool [(L,) N + 1, 2, Hkv, T, D]: ``num_blocks`` blocks for
    the tables and the sink of the dropped writes."""
    shape = (num_blocks + 1, 2, num_kv_heads, tokens_per_block, head_dim)
    if num_layers is not None:
        shape = (num_layers,) + shape
    return torch.zeros(shape, dtype=dtype, device=device)


def paged_append_kv(pool, k_new, v_new, block_table, write_pos,
                    kv_orig_quant_scale=None, layer_idx=None,
                    slots: Optional[TokenSlots] = None) -> torch.Tensor:
    """Write one new token's K/V per sequence into the pool, in place.

    pool        [N + 1, 2, H, T, D] (or [L, N + 1, 2, H, T, D] with
                ``layer_idx``): N blocks and the sink, as
                :func:`new_block_pool` makes it
    k_new/v_new [B, H, 1, D]  (decode step)
    block_table [B, max_blocks] int32
    write_pos   [B] integer tensor (or an int): the token position this
                write lands at.  An int8 pool quantises with
                ``kv_orig_quant_scale`` and round-half-away.
    ``slots``: the :class:`TokenSlots` of these tables and positions, when
    the caller has found them already."""
    pool_l = pool if layer_idx is None else pool[layer_idx]
    kv = torch.stack([k_new[:, :, 0], v_new[:, :, 0]], dim=1)   # [B,2,H,D]
    kv = quantize_cache_values(kv, pool.dtype, kv_orig_quant_scale)
    if slots is None:
        pos = torch.as_tensor(write_pos, device=pool.device).reshape(-1)
        slots = token_slots(block_table.to(pool.device),
                            pos.expand(kv.shape[0])[:, None],
                            pool_l.shape[0] - 1, pool_l.shape[3])
    put_tokens(pool_l, slots, kv)
    return pool


def paged_append_window(pool, k_new, v_new, block_table, write_pos,
                        kv_orig_quant_scale=None, layer_idx=None,
                        slots: Optional[TokenSlots] = None) -> torch.Tensor:
    """Write a W-token window's K/V per row into the pool at positions
    write_pos .. write_pos + W - 1, in place (mixed context+generation
    admission: a prompt chunk or a decode row's pending token and its pad
    lanes; no block alignment assumed).

    k_new/v_new [B, H, W, D]; block_table [B, max_blocks]; write_pos [B];
    the pool as :func:`paged_append_kv` takes it.  Lanes whose table slot
    is -1 or that lie past the table go to the sink, as JAX's scatter drops
    them; pad lanes that land in a row's own blocks write K/V past its
    length, which its later tokens overwrite before anything reads them.
    ``slots``: the :class:`TokenSlots` of these tables and positions, when
    the caller has found them already."""
    b, h, w, d = k_new.shape
    pool_l = pool if layer_idx is None else pool[layer_idx]
    kv = torch.stack([k_new, v_new], dim=1).permute(0, 3, 1, 2, 4)
    kv = quantize_cache_values(kv, pool.dtype, kv_orig_quant_scale)
    if slots is None:
        pos = torch.as_tensor(write_pos, device=pool.device).reshape(-1, 1)
        pos = pos.long() + torch.arange(w, device=pool.device)[None, :]
        slots = token_slots(block_table.to(pool.device), pos,
                            pool_l.shape[0] - 1, pool_l.shape[3])
    put_tokens(pool_l, slots, kv.reshape(b * w, 2, h, d))
    return pool


def paged_prefill(pool, k, v, block_table, kv_orig_quant_scale=None,
                  layer_idx=None) -> torch.Tensor:
    """Write a whole prompt's K/V into the pool at positions 0..P-1, in
    place (context phase).  k/v [B, H, P, D]; block_table [B, max_blocks];
    the pool as :func:`paged_append_kv` takes it.  Tokens past a row's
    allocation (the right padding beyond the true prompt) are dropped."""
    b, h, p, d = k.shape
    pool_l = pool if layer_idx is None else pool[layer_idx]
    kv = torch.stack([k, v], dim=1).permute(0, 3, 1, 2, 4)  # [B,P,2,H,D]
    kv = quantize_cache_values(kv, pool.dtype, kv_orig_quant_scale)
    pos = torch.arange(p, device=pool.device)[None, :].expand(b, p)
    slots = token_slots(block_table.to(pool.device), pos,
                        pool_l.shape[0] - 1, pool_l.shape[3])
    put_tokens(pool_l, slots, kv.reshape(b * p, 2, h, d))
    return pool


def paged_decode_attention(q, pool, block_table, seq_len,
                           scale: Optional[float] = None,
                           kv_quant_orig_scale=None,
                           causal_offset=None,
                           beam_indirection=None) -> torch.Tensor:
    """q [B, H, Lq, D] against the block pool [N, 2, Hkv, T, D] through
    block_table [B, max_blocks]; seq_len [B] counts the current tokens,
    which are already in the pool.  Returns [B, H, Lq, D].

    Lq == 1 is the generation phase.  Lq > 1 needs ``causal_offset`` [B]
    (the mixed context+generation window): query row i of row b attends
    keys < seq_len[b] and <= causal_offset[b] + i.

    The JAX XLA formulation: every table slot's block is gathered (a -1
    slot reads block 0, masked), masked positions at -1e30, fp32 scores and
    softmax, probabilities cast to the value dtype before P·V, fp32
    accumulation (a row with no valid key averages every gathered key, as
    there; its output is of no use).  An int8 pool is dequantised to q's
    dtype with ``kv_quant_orig_scale``.  MQA/GQA: query head h reads KV
    head h // (H / Hkv).  ``beam_indirection`` (paged beams) raises."""
    if beam_indirection is not None:
        raise NotImplementedError("paged beams are not ported")
    b, h, lq, d = q.shape
    if lq != 1 and causal_offset is None:
        raise ValueError("multi-token paged queries need per-row causal "
                         "offsets")
    n, _, hk, t, _ = pool.shape
    if h % hk:
        raise ValueError(f"{h} query heads over {hk} KV heads")
    if pool.dtype.is_floating_point and pool.dtype.itemsize == 1:
        raise NotImplementedError("fp8 KV pools are not ported yet")
    max_blocks = block_table.shape[1]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    table = block_table.to(device=pool.device, dtype=torch.long).clamp(min=0)
    blocks = pool[table]                     # [B, max_blocks, 2, Hkv, T, D]
    k, v = (blocks[:, :, i].transpose(1, 2).reshape(b, hk, max_blocks * t, d)
            for i in (0, 1))
    if pool.dtype == torch.int8:
        if kv_quant_orig_scale is None:
            raise ValueError("an int8 pool needs kv_quant_orig_scale")
        k = (k.float() * kv_quant_orig_scale).to(q.dtype)
        v = (v.float() * kv_quant_orig_scale).to(q.dtype)
    else:
        k, v = k.to(q.dtype), v.to(q.dtype)
    if hk != h:
        k, v = (x.repeat_interleave(h // hk, dim=1) for x in (k, v))
    scores = _mm_f32("bhqd,bhkd->bhqk", q, k) * scale
    kpos = torch.arange(max_blocks * t, device=q.device)[None, None, None, :]
    seq = torch.as_tensor(seq_len, device=q.device).reshape(-1, 1, 1, 1)
    valid = kpos < seq
    if lq > 1:
        qpos = torch.arange(lq, device=q.device)[None, None, :, None]
        off = torch.as_tensor(causal_offset, device=q.device)
        valid = valid & (kpos <= qpos + off.reshape(-1, 1, 1, 1))
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    probs = torch.softmax(scores, dim=-1)
    ctx = _mm_f32("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return ctx.to(q.dtype)
