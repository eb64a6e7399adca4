"""Attention formulations in plain PyTorch (the subset of the JAX
package's ``ops/attention.py`` on the Whisper and decoder-only paths).

These are the plain versions: the CPU runs them, and the CUDA kernels in
:mod:`.decode_attention` and :mod:`.flash_attention` are held against them
on the card.  Numerics follow the JAX package: fp32 scores and softmax,
probabilities cast to the value dtype before the PV product, fp32
accumulation.

Cache layout (as in the JAX package): the stacked decoder cache is
``[L, B, 2, H, D, S]``, SEQ-MINOR.  Unlike JAX, the port updates it in
place (``write_fresh_kv``, ``append_kv_stacked``) instead of returning a
new buffer.  Both take one write column for all rows or a [B] tensor of
per-row columns (continuous batching), written by one indexed store on
the device (:func:`put_columns`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..functional import round_half_away

NEG = -1e30


def _mm_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with fp32 accumulation and output (``preferred_element_type=
    float32``): the operands are upcast, which is exact for bf16/int8."""
    return torch.einsum(eq, a.float(), b.float())


# the fp8 (e4m3) cache's element type and its largest finite value
FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0
# the cache kinds the kernels take (their C entries' ``kind`` argument)
CACHE_KINDS = {torch.bfloat16: 0, torch.int8: 1, FP8: 2}


def is_quantized_cache(dtype: torch.dtype) -> bool:
    """An int8 or fp8 (e4m3) cache: written through
    ``kv_orig_quant_scale``, read through ``kv_quant_orig_scale``."""
    return dtype in (torch.int8, FP8)


def cache_kind(dtype: torch.dtype) -> int:
    """The kernels' cache kind: 0 bf16, 1 int8, 2 e4m3."""
    if dtype not in CACHE_KINDS:
        raise TypeError(f"cache dtype {dtype}: bf16, int8 or float8_e4m3fn")
    return CACHE_KINDS[dtype]


def quantize_cache_values(kv: torch.Tensor, cache_dtype: torch.dtype,
                          kv_orig_quant_scale=None) -> torch.Tensor:
    """Cast fresh K/V values into the cache dtype: int8 with
    round-half-away and clip to [-128, 127]; e4m3 by the saturating cast
    (values past +-448 give +-448, as Hopper's ``cvt.rn.satfinite`` and
    the JAX package's ``quantize_fp8``; the JAX cache cast itself gives NaN
    there); float dtypes pass through."""
    if cache_dtype == torch.int8:
        assert kv_orig_quant_scale is not None
        scaled = kv.float() * kv_orig_quant_scale
        return torch.clamp(round_half_away(scaled), -128, 127).to(torch.int8)
    if cache_dtype == FP8:
        assert kv_orig_quant_scale is not None
        scaled = kv.float() * kv_orig_quant_scale
        return torch.clamp(scaled, -FP8_MAX, FP8_MAX).to(FP8)
    return kv.to(cache_dtype)


def dequantize_cache_values(x: torch.Tensor, kv_quant_orig_scale,
                            out_dtype: torch.dtype) -> torch.Tensor:
    """Inverse of :func:`quantize_cache_values` for int8 and e4m3
    caches."""
    if is_quantized_cache(x.dtype):
        assert kv_quant_orig_scale is not None
        return (x.float() * kv_quant_orig_scale).to(out_dtype)
    return x.to(out_dtype)


def masked_values(v: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """v with its masked positions set to 0 where v is an e4m3 cache's
    read: an e4m3 byte may be NaN, and a masked probability of 0 times NaN
    would poison P.V (int8 and float caches hold finite values, and pass
    through)."""
    return torch.where(valid, v, torch.zeros((), dtype=v.dtype,
                                             device=v.device))


def length_mask_bias(lengths: torch.Tensor, max_len: int,
                     dtype=torch.float32) -> torch.Tensor:
    """Additive bias [B, 1, 1, max_len]: 0 below the length, -inf after."""
    pos = torch.arange(max_len, device=lengths.device)[None, None, None, :]
    bias = torch.zeros((lengths.shape[0], 1, 1, max_len), dtype=dtype,
                       device=lengths.device)
    return bias.masked_fill(pos >= lengths[:, None, None, None],
                            float("-inf"))


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q [B,H,Lq,D], k/v [B,H,Lk,D] -> [B,H,Lq,D]: fp32 scores and
    softmax, probabilities cast to the value dtype, fp32 accumulation."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = _mm_f32("bhqd,bhkd->bhqk", q, k) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    ctx = _mm_f32("bhqk,bhkd->bhqd", probs.to(v.dtype), v)
    return ctx.to(q.dtype)


def put_columns(cache: torch.Tensor, new: torch.Tensor,
                write_index: torch.Tensor) -> None:
    """``cache[b, ..., write_index[b] + j] = new[b, ..., j]``, in place, as
    one indexed store with no host synchronisation: cache [B, ..., S] (a
    view is fine), new [B, ..., n] in the cache's dtype, write_index [B].

    A negative start counts from the end (S + write_index), as the JAX
    package's per-row ``dynamic_update_slice`` takes it: a slot that is not
    live rides a step at column -1 and writes column S - 1, which no
    sequence reaches (the scheduler ends one at S - 1 tokens).  One token
    (n == 1) lands at its column clamped into [0, S - 1], where JAX puts
    it.  A window (n > 1) writes only its lanes that fall in [0, S): JAX's
    clamp would shift the whole window back onto real columns.  The lanes past
    the end are sent to the nearest column inside with the value that
    column gets anyway (its own lane's, or what it held), so every store
    to one column carries one value and the order of the stores does not
    matter.  An e4m3 cache is written through its bytes (uint8 views:
    torch gathers no float8 values)."""
    if cache.dtype == FP8:
        put_columns(cache.view(torch.uint8), new.view(torch.uint8),
                    write_index)
        return
    b, s, n = cache.shape[0], cache.shape[-1], new.shape[-1]
    dev = cache.device
    wi = write_index.to(device=dev, dtype=torch.long).reshape(b, 1)
    wi = torch.where(wi < 0, wi + s, wi)
    lane = torch.arange(n, device=dev)[None, :]
    cols = torch.clamp(wi + lane, 0, s - 1)                   # [B, n]
    if n > 1:
        src = cols - wi                 # the lane whose column this is
        fits = (src >= 0) & (src < n)
        mid = (1,) * (new.dim() - 2)

        def spread(idx, like):
            return idx.reshape(b, *mid, n).expand(*like.shape[:-1], n)
        vals = torch.gather(new, -1, spread(src.clamp(0, n - 1), new))
        old = torch.gather(cache, -1, spread(cols, cache))
        new = torch.where(spread(fits, new), vals, old)
    rows = torch.arange(b, device=dev)[:, None].expand(b, n)
    # two advanced indices around the ellipsis: the value is [B, n, ...]
    cache[rows, ..., cols] = new.movedim(-1, 1)


def append_kv_stacked(full_cache: torch.Tensor, k_new: torch.Tensor,
                      v_new: torch.Tensor, layer_idx: int, write_index,
                      kv_orig_quant_scale=None) -> torch.Tensor:
    """Write one layer's K/V [B,H,L_new,D] into the stacked seq-minor
    cache [L,B,2,H,D,S] at (layer_idx, ..., write_index), in place;
    ``write_index`` an int, or a [B] tensor of per-row columns
    (:func:`put_columns`)."""
    kv = torch.stack([k_new, v_new], dim=1).transpose(3, 4)  # [B,2,H,D,L]
    kv = quantize_cache_values(kv, full_cache.dtype, kv_orig_quant_scale)
    if torch.is_tensor(write_index):
        put_columns(full_cache[layer_idx], kv, write_index)
        return full_cache
    n = kv.shape[-1]
    full_cache[layer_idx, ..., write_index:write_index + n] = kv
    return full_cache


def cast_kv_for_cache(k: torch.Tensor, v: torch.Tensor,
                      cache_dtype: torch.dtype, kv_orig_quant_scale=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cast fresh K/V [B,H,L,D] as a cache write would, transposed to the
    cache's seq-minor layout [B,H,D,L]."""
    k = k.transpose(2, 3)
    v = v.transpose(2, 3)
    return (quantize_cache_values(k, cache_dtype, kv_orig_quant_scale),
            quantize_cache_values(v, cache_dtype, kv_orig_quant_scale))


def write_fresh_kv(full_cache: torch.Tensor, kv_new: torch.Tensor,
                   write_index) -> torch.Tensor:
    """One store of every layer's fresh K/V [L,B,2,H,D,L_new] (already in
    cache dtype) at column ``write_index``, in place: an int, or a [B]
    tensor of per-row columns (:func:`put_columns`)."""
    if torch.is_tensor(write_index):
        put_columns(full_cache.transpose(0, 1), kv_new.transpose(0, 1),
                    write_index)
        return full_cache
    n = kv_new.shape[-1]
    full_cache[..., write_index:write_index + n] = kv_new
    return full_cache


def layer_kv_views(full_cache: torch.Tensor, layer_idx: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One layer's K and V [B,H,D,S] as views of the stacked cache."""
    return full_cache[layer_idx, :, 0], full_cache[layer_idx, :, 1]


def cached_decode_attention(q: torch.Tensor, cache, seq_len,
                            scale: Optional[float] = None,
                            kv_quant_orig_scale=None,
                            causal_offset=None,
                            start_index=None,
                            fresh_kv: Optional[Tuple] = None,
                            group: int = 1, bias=None) -> torch.Tensor:
    """Masked attention of q [B,H,Lq,D] against a seq-minor cache
    [B,2,Hkv,D,S] (or its (k, v) views), attending to positions < seq_len.

    ``seq_len`` [B] (or an int) is the valid length INCLUDING the current
    tokens.  ``fresh_kv`` (k, v) [B,Hkv,D,Lq] in cache dtype carries the
    current tokens when their cache write is deferred: the cache then holds
    ``seq_len - Lq`` valid columns.  ``start_index`` masks keys below it.
    ``causal_offset`` (Lq > 1, a prefill written into the cache): query row
    i attends keys <= causal_offset + i; None: no causal mask (the
    bidirectional prefill of GLM).  ``bias`` [1, H, 1, S] fp32 (ALiBi) is
    added to the scaled scores before the mask; it takes no deferred write
    (``fresh_kv``) and no GQA, as in the JAX package.  int8 and e4m3
    caches are dequantised with the per-tensor ``kv_quant_orig_scale``; an
    e4m3 cache's masked columns are left out of P.V
    (:func:`masked_values`).

    MQA/GQA (the JAX package's ``ops/attention.py:264-317``): a cache with
    fewer KV heads than q is read without repeating its heads.  One KV head
    rides the einsums' size-1 broadcast; 1 < Hkv < H folds the query head
    groups onto the q-length axis (``group`` is the recursion's marker), so
    masks index positions by ``row % true_lq``.  (The JAX version's tail
    mode is not ported.)"""
    b, h, lq, d = q.shape
    k, v = cache if isinstance(cache, tuple) else (cache[:, 0], cache[:, 1])
    hkv = k.shape[1]
    if bias is not None and (fresh_kv is not None or hkv not in (h, 1)):
        raise ValueError("a per-head bias (ALiBi) takes no deferred write "
                         "and no GQA cache")
    if group == 1 and hkv not in (h, 1):
        g = h // hkv
        if g * hkv != h:
            raise ValueError(f"{h} query heads over {hkv} KV heads")
        out = cached_decode_attention(
            q.reshape(b, hkv, g * lq, d), (k, v), seq_len, scale=scale,
            kv_quant_orig_scale=kv_quant_orig_scale,
            causal_offset=causal_offset, start_index=start_index,
            fresh_kv=fresh_kv, group=g)
        return out.reshape(b, h, lq, d)
    lq_t = lq // group          # true token count (== lq unless grouped)
    s_max = k.shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    fp8 = k.dtype == FP8
    if is_quantized_cache(k.dtype):
        k = dequantize_cache_values(k, kv_quant_orig_scale, q.dtype)
        v = dequantize_cache_values(v, kv_quant_orig_scale, q.dtype)
    scores = _mm_f32("bhqd,bhds->bhqs", q, k) * scale
    if bias is not None:                    # ALiBi [1, H, 1, S]
        scores = scores + bias.float()
    kpos = torch.arange(s_max, device=q.device)[None, None, None, :]
    cache_len = torch.as_tensor(seq_len, dtype=torch.int32, device=q.device)
    cache_len = cache_len.reshape(-1, 1, 1, 1)
    if fresh_kv is not None:
        cache_len = cache_len - lq_t        # current tokens not in cache yet
    valid = kpos < cache_len
    if start_index is not None:
        start = torch.as_tensor(start_index, dtype=torch.int32,
                                device=q.device).reshape(-1, 1, 1, 1)
        valid = valid & (kpos >= start)
    if fp8:                                 # [B, 1, 1, S] over [B, H, D, S]
        v = masked_values(v, valid)
    qpos = torch.arange(lq, device=q.device)[None, None, :, None] % lq_t
    if lq_t > 1 and causal_offset is not None:
        # causal within the appended block; grouped rows share a token
        offset = torch.as_tensor(causal_offset, dtype=torch.int32,
                                 device=q.device).reshape(-1, 1, 1, 1)
        valid = valid & (kpos <= qpos + offset)
    # finite mask value: a fully-masked row (a left-pad query position)
    # yields finite probabilities, not NaN, which would poison the cache
    # the next layer writes
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    if fresh_kv is not None:
        k_f = dequantize_cache_values(fresh_kv[0], kv_quant_orig_scale,
                                      q.dtype)
        v_f = dequantize_cache_values(fresh_kv[1], kv_quant_orig_scale,
                                      q.dtype)
        s_f = _mm_f32("bhqd,bhds->bhqs", q, k_f) * scale
        if lq_t > 1:
            # causal among the fresh tokens themselves
            fpos = torch.arange(lq_t, device=q.device)[None, None, None, :]
            s_f = torch.where(fpos <= qpos, s_f, torch.full_like(s_f, NEG))
        probs = torch.softmax(torch.cat([scores, s_f], dim=-1), dim=-1)
        p_c, p_f = probs[..., :s_max], probs[..., s_max:]
        ctx = (_mm_f32("bhqs,bhds->bhqd", p_c.to(v.dtype), v)
               + _mm_f32("bhqs,bhds->bhqd", p_f.to(v_f.dtype), v_f))
        return ctx.to(q.dtype)
    probs = torch.softmax(scores, dim=-1)
    ctx = _mm_f32("bhqs,bhds->bhqd", probs.to(v.dtype), v)
    return ctx.to(q.dtype)


def beam_indirect_decode_attention(q: torch.Tensor, cache, seq_len,
                                   indirection: torch.Tensor,
                                   scale: Optional[float] = None,
                                   kv_quant_orig_scale=None,
                                   start_index=None,
                                   fresh_kv: Optional[Tuple] = None,
                                   bias=None) -> torch.Tensor:
    """One-token attention through a beam cache-indirection table, without
    a reordered copy of the cache (the JAX package's
    ``beam_indirect_decode_attention``, ``ops/attention.py:396``).

    q [B, H, 1, D] with B = groups * beams, grouped by group; ``cache``
    (k, v) [B, H, D, S] physical seq-minor views (or [B, 2, H, D, S]);
    ``indirection`` [groups, beams, s_ind] maps each (query beam, position)
    to the beam row of its group whose K/V wrote that position; a table
    narrower than S is padded (positions past it are masked by seq_len).
    Every (query beam, source beam) score is computed, the non-selected
    ones are zeroed per position, and V is summed per source beam with the
    masked probabilities: the selected terms equal those of a gathered
    cache exactly; only the order of the fp32 P·V sum differs.
    ``fresh_kv`` (k, v) [B, H, D, 1] is the current token's, each row's
    own (no indirection).  ``bias`` [1, H, 1, S] fp32 (ALiBi, over the
    absolute column) is added to the scaled scores; with it the current
    token is read from the cache (its column written, the table pointing
    at the row's own), not from ``fresh_kv``.  int8 and e4m3 caches are
    dequantised."""
    b, h, lq, d = q.shape
    if lq != 1:
        raise ValueError("beam-indirect attention is a one-token decode op")
    k, v = cache if isinstance(cache, tuple) else (cache[:, 0], cache[:, 1])
    if k.shape[1] != h:
        # nor run by the JAX package: its XLA formulation reshapes such a
        # cache with the query head count and raises TypeError
        raise NotImplementedError(
            "beams over MQA/GQA caches are not ported (the JAX package's "
            "beam_indirect_decode_attention reshapes such a cache with the "
            "query head count and raises TypeError)")
    s_max = k.shape[3]
    bg, bw, s_ind = indirection.shape
    if bg * bw != b:
        raise ValueError(f"indirection {tuple(indirection.shape)} for {b} "
                         "query rows")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    fp8 = k.dtype == FP8
    if is_quantized_cache(k.dtype):
        k = dequantize_cache_values(k, kv_quant_orig_scale, q.dtype)
        v = dequantize_cache_values(v, kv_quant_orig_scale, q.dtype)
    ind = indirection
    if s_ind < s_max:
        ind = torch.nn.functional.pad(ind, (0, s_max - s_ind))
    k5 = k.reshape(bg, bw, h, d, s_max)
    v5 = v.reshape(bg, bw, h, d, s_max)
    q4 = q[:, :, 0, :].reshape(bg, bw, h, d)
    # every (query beam, source beam) score: [g, qb, kb, H, S]
    s_all = _mm_f32("gqhd,gkhds->gqkhs", q4, k5) * scale
    sel = (ind[:, :, None, :] == torch.arange(
        bw, dtype=ind.dtype, device=ind.device)[None, None, :, None])
    scores = torch.where(sel[:, :, :, None, :], s_all, 0.0).sum(2)
    scores = scores.reshape(b, h, 1, s_max)
    if bias is not None:
        if fresh_kv is not None:
            raise ValueError("a bias (ALiBi) takes no deferred write")
        scores = scores + bias.float()
    kpos = torch.arange(s_max, device=q.device)[None, None, None, :]
    cache_len = torch.as_tensor(seq_len, dtype=torch.int32,
                                device=q.device).reshape(-1, 1, 1, 1)
    if fresh_kv is not None:
        cache_len = cache_len - 1          # current token not in cache yet
    valid = kpos < cache_len
    if start_index is not None:
        start = torch.as_tensor(start_index, dtype=torch.int32,
                                device=q.device).reshape(-1, 1, 1, 1)
        valid = valid & (kpos >= start)
    scores = torch.where(valid, scores, torch.full_like(scores, NEG))
    if fp8:              # every row's columns past the group's length
        v5 = masked_values(v5, valid.expand(b, 1, 1, s_max).reshape(
            bg, bw, 1, 1, s_max))

    def pv(p):                              # p [B, H, 1, S] -> [B, H, 1, D]
        p_m = torch.where(sel[:, :, :, None, :],
                          p.reshape(bg, bw, 1, h, s_max), 0.0)
        return _mm_f32("gqkhs,gkhds->gqhd", p_m.to(v.dtype),
                       v5).reshape(b, h, 1, d)

    if fresh_kv is not None:
        k_f = dequantize_cache_values(fresh_kv[0], kv_quant_orig_scale,
                                      q.dtype)
        v_f = dequantize_cache_values(fresh_kv[1], kv_quant_orig_scale,
                                      q.dtype)
        s_f = _mm_f32("bhqd,bhds->bhqs", q, k_f) * scale
        probs = torch.softmax(torch.cat([scores, s_f], dim=-1), dim=-1)
        p_c, p_f = probs[..., :s_max], probs[..., s_max:]
        ctx = pv(p_c) + _mm_f32("bhqs,bhds->bhqd", p_f.to(v_f.dtype), v_f)
        return ctx.to(q.dtype)
    return pv(torch.softmax(scores, dim=-1)).to(q.dtype)
