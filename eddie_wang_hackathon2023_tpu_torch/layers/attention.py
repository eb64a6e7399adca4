"""Self/cross attention layer (the Whisper and decoder-only parts of the
JAX package's ``layers/attention.py``).

Modes, as in the JAX package:
* encoder self-attention with the pad-once ``valid_len`` contract, through
  :func:`..ops.flash_attention.flash_mha` (the flash kernel, or a user
  kernel installed by ``set_custom_mha``);
* decoder self-attention over the stacked seq-minor cache
  ``[L, B, 2, Hkv, D, S]``: prefill (``past_key_value = (cache, layer)``,
  written in place; into an empty cache without ``attention_start``, causal
  attention over the fresh K/V through ``flash_mha``; with
  ``attention_start``, left-padded prompts attend over the cache
  causally), and single-token decode with the fresh K/V
  write deferred to the caller (``(cache, layer, "defer")``), optionally
  read through a beam cache-indirection table (``beam_indirection``);
  MQA/GQA (``num_kv_heads``) keeps Hkv heads in the cache;
* cross-attention over the stacked cross cache (``cross_key_value =
  (cache, layer)`` or ``((cache, scales), layer)`` for int8 with per-layer
  scales);
* decoder self-attention over the block-paged pool (``past_key_value`` a
  :class:`..ops.paged_attention.PagedKV`, paged serving): a single-token
  step writes its K/V through the block table at each row's
  ``cache_write_index`` and reads the pool through the paged decode kernel
  (:func:`..ops.decode_attention.fused_paged_decode_attention`); a prompt
  (write index 0) is stored with ``paged_prefill`` and attends causally
  over its fresh K/V, with no length mask (prompts are right-padded); a
  mixed window (several tokens a row at the per-row positions
  ``cache_write_index`` [B], mixed context+generation admission) is stored
  with ``paged_append_window`` and reads the pool through the paged
  kernel's window entry (:func:`..ops.decode_attention.
  fused_paged_window_attention`) with the window's offsets as the causal
  offsets; a single-token step with ``beam_indirection`` (paged beam
  search) reads each position through the chain of the beam that wrote it,
  through the kernel's beam entry (:func:`..ops.decode_attention.
  fused_paged_beam_attention`).  Over the stacked cache a [B]
  ``cache_write_index`` writes each
  row at its own column: one token through the deferred write as above, a
  window (as the paged one) into the cache and then over it with the
  per-row causal offsets, in plain PyTorch as the JAX layer runs it in
  XLA.
With ``use_int8_kv_cache`` (the ``kv8`` recipe) the self cache is int8,
with ``use_fp8_kv_cache`` e4m3 (the saturating cast), either with the
per-tensor scales ``kv_orig_quant_scale`` (every write: the
prefill's and the fresh K/V of a decode step) and ``kv_quant_orig_scale``
(every read, the fresh column's too, as a write-then-read would give it);
a prefill then attends over the quantised cache it has just written, as
the JAX layer does (its flash fast path is off under a quantised cache,
``layers/attention.py:669-697``).  An int8 or e4m3 paged pool is quantised
and read with the same scales (the JAX layer's :471-473, :496-535; the
JAX pool writes and reads e4m3 unscaled, a fault of the reference, which
this port does not copy).
Single-token decode over the stacked cache goes through the decode kernel
(:func:`..ops.decode_attention.fused_decode_attention`; its grouped mode
when the cache has fewer heads), with the int8 out-projection fused when
the dense layer is weight-only int8 (not int4) at batch 1 with equal heads
(never with beams).
Rotary positions (``rotary_embedding_dim`` > 0, the JAX layer's
``PositionEmbeddingType.rope``, :427-435): q and k are rotated in every
self-attention mode before the cache write, by the ``rotary`` (cos, sin)
pair of the tokens' positions that the caller makes once a step
(:func:`..functional.rope_angles`), GPT-NeoX halves or GPT-J interleaved
pairs (``neox_rotary_style``) over the first ``rotary_embedding_dim``
channels.  ChatGLM's two-dimensional rotary (``glm_2d_rope``, the JAX
layer's :436-452, ``rotary_embedding_dim`` = head_dim // 2): the low half
of each head rotated GPT-NeoX style by the angles of the position row 0,
the high half by those of row 1 (``rotary`` a pair of (cos, sin) pairs).
ALiBi (``alibi``, Bloom): an additive per-head bias over the absolute
cache column, [1, H, 1, S] (the caller's ``alibi_bias``, made once a
step); its prompt never takes flash and attends over
the cache it has just written (the JAX layer's :683-698), and its
single-token step writes its own column and then attends with the bias
(the JAX layer asserts the deferred write away, :574), through a beam
table where there is one.  A non-causal layer (``causal=False`` on the
self-attention, ChatGLM's bidirectional prompt) prefills over the cache
with no causal mask; keys are still masked by the length and the start.
``apply_query_key_layer_scaling``: the scale is 1 / (sqrt(head_dim) *
num_layers), as the JAX layer's ``norm_factor`` (:227-233).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from ..functional import apply_rope, causal_bias
from ..ops.attention import (FP8, append_kv_stacked,
                             beam_indirect_decode_attention,
                             cached_decode_attention, cast_kv_for_cache,
                             layer_kv_views, multihead_attention)
from ..ops.decode_attention import (fused_decode_attention,
                                    fused_paged_beam_attention,
                                    fused_paged_decode_attention,
                                    fused_paged_window_attention)
from ..ops.flash_attention import MIN_FLASH_LEN, flash_mha
from ..ops.paged_attention import (PagedKV, paged_append_kv,
                                   paged_append_window, paged_prefill)
from ..quantization.layers import (WeightOnlyQuantLinear,
                                   WeightOnlyQuantQKVLinear,
                                   WeightOnlyQuantRowLinear)
from ..quantization.mode import QuantMode
from ..quantization.smoothquant_layers import (SmoothQuantLinear,
                                               SmoothQuantQKVLinear,
                                               SmoothQuantRowLinear)
from ..quantization.surgery import int4_group
from .linear import ColumnLinear, RowLinear, frozen

@functools.lru_cache(maxsize=None)
def _full_lengths(batch: int, length: int, device: torch.device
                  ) -> torch.Tensor:
    """[batch] int32 of ``length``: the valid length of a full cross
    cache, made once per shape instead of once per layer and step."""
    return torch.full((batch,), length, dtype=torch.int32, device=device)


class QKVLinear(nn.Module):
    """Fused QKV projection with the head-major weight [3, H, hd, hidden]
    (``convert._fuse_qkv``) and bias [3, H, hd].  With fewer KV heads
    (MQA/GQA, the JAX package's ``layers/attention.py:135-149``) q and kv
    are stored apart: ``weight`` [H, hd, hidden] + ``kv_weight``
    [2, Hkv, hd, hidden], ``bias`` [H, hd] + ``kv_bias`` [2, Hkv, hd].
    Returns q [B, L, H, hd], k and v [B, L, Hkv, hd]."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 bias: bool = True, dtype=torch.float32,
                 num_kv_heads: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_kv_heads or num_heads
        self.head_dim = head_dim
        hk = self.num_kv_heads
        # the separate-KV layout (a tensor-parallel shard may hold as many
        # KV heads as query heads and keep it)
        self.separate_kv = hk != num_heads
        if hk == num_heads:
            self.weight = frozen((3, num_heads, head_dim, hidden_size), dtype)
            self.bias = (frozen((3, num_heads, head_dim), dtype) if bias
                         else None)
        else:
            self.weight = frozen((num_heads, head_dim, hidden_size), dtype)
            self.kv_weight = frozen((2, hk, head_dim, hidden_size), dtype)
            self.bias = frozen((num_heads, head_dim), dtype) if bias else None
            self.kv_bias = frozen((2, hk, head_dim), dtype) if bias else None

    def forward(self, x: torch.Tensor):
        b, l, hidden = x.shape
        h, hk, d = self.num_heads, self.num_kv_heads, self.head_dim
        if not self.separate_kv:
            w = self.weight.reshape(3 * h * d, hidden)
            qkv = torch.matmul(x, w.t()).reshape(b, l, 3, h, d)
            if self.bias is not None:
                qkv = qkv + self.bias.to(qkv.dtype)
            return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        q = torch.matmul(x, self.weight.reshape(h * d, hidden).t())
        kv = torch.matmul(x, self.kv_weight.reshape(2 * hk * d, hidden).t())
        q, kv = q.reshape(b, l, h, d), kv.reshape(b, l, 2, hk, d)
        if self.bias is not None:
            q = q + self.bias.to(q.dtype)
            kv = kv + self.kv_bias.to(kv.dtype)
        return q, kv[:, :, 0], kv[:, :, 1]


def linear_classes(quant_mode: QuantMode, dtype):
    """(qkv, column, row) linear classes for a quantisation mode.  The int4
    classes take their group size from their own in-features (the first
    argument of each), as the JAX package's surgery gives it
    (``quantization/surgery.py:46-55``)."""
    if quant_mode.is_int8_weight_only():
        return (WeightOnlyQuantQKVLinear, WeightOnlyQuantLinear,
                WeightOnlyQuantRowLinear)
    if quant_mode.is_int4_weight_only():
        def woq4(cls):
            return lambda in_features, *a, **kw: cls(
                in_features, *a, **kw, bits=4,
                group_size=int4_group(quant_mode, in_features))
        return (woq4(WeightOnlyQuantQKVLinear), woq4(WeightOnlyQuantLinear),
                woq4(WeightOnlyQuantRowLinear))
    if quant_mode.has_act_and_weight_quant():
        def sq(cls, out_dtype=dtype):
            return lambda *a, **kw: cls(*a, **{**kw, "dtype": out_dtype},
                                        quant_mode=quant_mode)
        # the QKV projection is built with dtype None (fp32 q/k/v and bias),
        # as the JAX package's surgery builds it (surgery.py:152-155)
        return (sq(SmoothQuantQKVLinear, None), sq(SmoothQuantLinear),
                sq(SmoothQuantRowLinear))
    # the KV-cache flags choose no linear class
    if quant_mode & (QuantMode.INT8_WEIGHTS | QuantMode.INT4_WEIGHTS
                     | QuantMode.ACTIVATIONS):
        raise NotImplementedError(f"quant mode {quant_mode!r} is not ported")
    return QKVLinear, ColumnLinear, RowLinear


class Attention(nn.Module):
    """Under tensor parallelism (``parallel.sharding.shard_attention``)
    the layer runs its rank's ``num_attention_heads`` query heads (from
    ``head_offset``) and the KV heads they read, its QKV projection
    column-parallel on those heads and ``dense`` row-parallel; its caches
    hold the rank's KV heads.
    ``num_kv_heads`` < ``num_attention_heads``: MQA/GQA self-attention
    (the separate-KV QKV layout, a cache of ``num_kv_heads`` heads, the
    grouped mode of the decode kernel); the query heads of one KV head are
    consecutive.  ``flash_prefill_rows``: the fewest query rows of a causal
    prefill into an empty stacked cache that take kernel 2's causal mode on
    the card (``MIN_FLASH_LEN``, the JAX package's threshold, unless the
    model asks for fewer)."""

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 cross_attention: bool = False, causal: bool = False,
                 bias: bool = True, dtype=torch.float32,
                 quant_mode: QuantMode = QuantMode(0),
                 num_kv_heads: Optional[int] = None,
                 use_int8_kv_cache: bool = False,
                 use_fp8_kv_cache: bool = False,
                 rotary_embedding_dim: int = 0,
                 neox_rotary_style: bool = True,
                 glm_2d_rope: bool = False, alibi: bool = False,
                 num_layers: int = 1,
                 apply_query_key_layer_scaling: bool = False,
                 flash_prefill_rows: int = MIN_FLASH_LEN):
        super().__init__()
        self.tp = None
        self.head_offset = 0
        self.flash_prefill_rows = flash_prefill_rows
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.num_attention_kv_heads = num_kv_heads or num_attention_heads
        self.attention_head_size = hidden_size // num_attention_heads
        self.cross_attention = cross_attention
        self.causal = causal
        self.dtype = dtype
        self.use_int8_kv_cache = use_int8_kv_cache
        self.use_fp8_kv_cache = use_fp8_kv_cache
        if use_int8_kv_cache and use_fp8_kv_cache:
            raise ValueError("an int8 or an fp8 KV cache, not both")
        self.rotary_embedding_dim = rotary_embedding_dim
        self.neox_rotary_style = neox_rotary_style
        self.glm_2d_rope = glm_2d_rope
        if glm_2d_rope:
            self.rotary_embedding_dim = self.attention_head_size // 2
        self.alibi = alibi
        # the JAX layer's norm_factor: sqrt(head_dim), times the layers
        # under query-key layer scaling
        self.norm_factor = math.sqrt(self.attention_head_size) * (
            num_layers if apply_query_key_layer_scaling else 1)
        # the int8 or e4m3 self cache's per-tensor scales (the JAX layer's
        # [1] fp32 parameters, scale_y_quant_orig semantics): quantise,
        # dequantise
        if self.quantized_kv_cache:
            self.kv_orig_quant_scale = frozen((1,), torch.float32)
            self.kv_quant_orig_scale = frozen((1,), torch.float32)
        else:
            self.kv_orig_quant_scale = self.kv_quant_orig_scale = None
        qkv_cls, col_cls, row_cls = linear_classes(quant_mode, dtype)
        grouped = self.num_attention_kv_heads != num_attention_heads
        if grouped and (cross_attention
                        or quant_mode.has_act_and_weight_quant()):
            raise NotImplementedError("MQA/GQA is ported for float and "
                                      "weight-only self-attention only")
        if cross_attention:
            self.q_linear = col_cls(hidden_size, hidden_size, bias=bias,
                                    dtype=dtype)
            self.qkv = None
        else:
            kw = dict(num_kv_heads=num_kv_heads) if grouped else {}
            self.qkv = qkv_cls(hidden_size, num_attention_heads,
                               self.attention_head_size, bias=bias,
                               dtype=dtype, **kw)
            self.q_linear = None
        self.dense = row_cls(hidden_size, hidden_size, bias=bias, dtype=dtype)

    @property
    def quantized_kv_cache(self) -> bool:
        return self.use_int8_kv_cache or self.use_fp8_kv_cache

    @property
    def kv_cache_dtype(self) -> torch.dtype:
        """The self cache's element type: int8, e4m3 or the layer's."""
        return (torch.int8 if self.use_int8_kv_cache
                else FP8 if self.use_fp8_kv_cache else self.dtype)

    @property
    def scale(self) -> float:
        return 1.0 / self.norm_factor

    def _split_heads(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_attention_heads,
                         self.attention_head_size).transpose(1, 2)

    @staticmethod
    def _merge_heads(x):
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def new_kv_cache(self, batch: int, max_len: int,
                     device=None) -> torch.Tensor:
        """A zeroed self cache [B, 2, Hkv, head_dim, S] (seq-minor), in
        :attr:`kv_cache_dtype`."""
        return torch.zeros((batch, 2, self.num_attention_kv_heads,
                            self.attention_head_size, max_len),
                           dtype=self.kv_cache_dtype, device=device)

    def _decode_proj_operands(self, batch: int):
        """(weight, scale, bias) of an int8 weight-only dense layer for the
        fused out-projection at batch 1 with equal heads; None otherwise
        (an int4 dense layer runs on its own, and so does a
        tensor-parallel one, which the epilogue would neither reduce nor
        give its bias once, as in the JAX package's ``_woq8_unsharded``,
        ``layers/attention.py:95-99``)."""
        d = self.dense
        if (batch != 1 or not isinstance(d, WeightOnlyQuantLinear)
                or d.bits != 8 or d.tp is not None
                or self.num_attention_kv_heads != self.num_attention_heads):
            return None
        return d.qweight, d.per_channel_scale, d.bias

    def _decode(self, cache, layer_idx, q, seq_len, kv_quant_orig_scale=None,
                fresh_kv=None, beam_indirection=None, start_index=None):
        """Single-token attention + out-projection -> [B, 1, N]."""
        b = q.shape[0]
        proj = (None if beam_indirection is not None
                else self._decode_proj_operands(b))
        res = fused_decode_attention(cache, layer_idx, q, seq_len,
                                     self.scale,
                                     kv_quant_orig_scale=kv_quant_orig_scale,
                                     fresh_kv=fresh_kv, start_index=start_index,
                                     proj=proj,
                                     beam_indirection=beam_indirection)
        if proj is not None:
            return res[:, None, :]
        return self.dense(self._merge_heads(res))

    def _flash(self, q, k, v, valid_len: Optional[int] = None):
        """Context attention through :func:`..ops.flash_attention.flash_mha`
        (the kernel, its plain version or an installed user kernel), q, k,
        v [B, H, L, D], then the out-projection.  The result is written as
        [B, L, H, D], so merging the heads is a free reshape."""
        b, _, l, d = q.shape
        ctx = torch.empty((b, l, self.num_attention_heads, d),
                          dtype=q.dtype, device=q.device)
        flash_mha(q, k, v, causal=self.causal, scale=self.scale,
                  kv_valid_len=valid_len, out=ctx.transpose(1, 2),
                  min_causal_rows=self.flash_prefill_rows)
        return self.dense(ctx.reshape(b, l, self.num_attention_heads * d))

    def _paged(self, q, k, v, pk: PagedKV, sequence_length, write_index,
               beam_indirection=None):
        """Self-attention over the block pool (the JAX layer's paged
        branch, ``layers/attention.py:474-551``): q [B, H, L, D], k/v
        [B, Hkv, L, D]; an int8 or e4m3 pool quantises every write with
        ``kv_orig_quant_scale`` and every kernel reads it with
        ``kv_quant_orig_scale``.  ``beam_indirection`` [groups, beams, S]
        (a single-token step): each position read through the chain of the
        beam that wrote it (the beam entry).  Returns (the attention
        output [B, L, N], the pool, updated in place)."""
        if not self.causal or self.alibi or self.glm_2d_rope:
            raise NotImplementedError("paged attention is causal, with "
                                      "learned or rotary positions")
        kv_oq, kv_qo = self.kv_orig_quant_scale, self.kv_quant_orig_scale
        l = q.shape[2]
        if beam_indirection is not None and l != 1:
            raise ValueError("paged beams are single-token steps")
        if l == 1:
            # generation: the token's K/V first (through the row's own
            # table), then the pool through the kernel, which reads the
            # token from the pool
            paged_append_kv(pk.pool, k, v, pk.block_table, write_index,
                            kv_orig_quant_scale=kv_oq,
                            layer_idx=pk.layer_idx, slots=pk.slots)
            if beam_indirection is not None:
                ctx = fused_paged_beam_attention(
                    pk.pool, pk.layer_idx, q, pk.block_table,
                    sequence_length, beam_indirection, self.scale,
                    kv_quant_orig_scale=kv_qo)
            else:
                ctx = fused_paged_decode_attention(
                    pk.pool, pk.layer_idx, q, pk.block_table,
                    sequence_length, self.scale, kv_quant_orig_scale=kv_qo)
        elif torch.is_tensor(write_index) and write_index.dim() >= 1:
            # a mixed window: W tokens a row at its own offset, written
            # first, then read causally from that offset
            paged_append_window(pk.pool, k, v, pk.block_table, write_index,
                                kv_orig_quant_scale=kv_oq,
                                layer_idx=pk.layer_idx, slots=pk.slots)
            ctx = fused_paged_window_attention(
                pk.pool, pk.layer_idx, q, pk.block_table, sequence_length,
                write_index, self.scale, kv_quant_orig_scale=kv_qo)
        elif write_index != 0:
            raise ValueError("a paged prompt is written from position 0")
        else:
            paged_prefill(pk.pool, k, v, pk.block_table,
                          kv_orig_quant_scale=kv_oq, layer_idx=pk.layer_idx)
            rep = self.num_attention_heads // self.num_attention_kv_heads
            if rep > 1:
                k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
            ctx = multihead_attention(
                q, k, v, bias=causal_bias(l, l, device=q.device),
                scale=self.scale)
        return self.dense(self._merge_heads(ctx)), pk.pool

    def forward(self, hidden_states: torch.Tensor, past_key_value=None,
                sequence_length=None, cross_key_value=None,
                cache_write_index: Optional[int] = None,
                valid_len: Optional[int] = None, use_cache: bool = False,
                beam_indirection=None, attention_start=None, rotary=None,
                alibi_bias=None):
        """``beam_indirection`` [groups, beams, S] (single-token decode of
        the self-attention only): each query row reads the cache positions
        through the table, as the JAX layer does (``layers/attention.py``
        :576-614); cross-attention ignores it (its cache rows are the
        repeated audio, the same for every beam).  ``attention_start`` [B]
        (left-padded prompts, self-attention over the stacked cache): keys
        below it are masked; a prefill given it attends over the cache it
        has just written, causally from ``cache_write_index``, as the JAX
        layer does when its flash fast path is off (:683-698).  ``rotary``
        (cos, sin) [B, L, rotary_embedding_dim // 2]: the tokens' rotary
        angles, needed when the layer has a rotary dim (GLM: ((cos, sin)
        of the position row 0, (cos, sin) of row 1)).  ``alibi_bias``
        [1, H, 1, S] (ALiBi over the stacked cache): the bias over the
        cache's columns (:func:`..functional.generate_alibi_biases`)."""
        b, l, _ = hidden_states.shape

        if self.cross_attention:
            (full, layer_idx) = cross_key_value
            scales = None
            if isinstance(full, tuple):
                full, scales = full
            cross_scale = None if scales is None else scales[layer_idx]
            query = self._split_heads(self.q_linear(hidden_states))
            s_full = full.shape[-1]
            if l == 1:
                out = self._decode(full, layer_idx, query,
                                   _full_lengths(b, s_full, query.device),
                                   kv_quant_orig_scale=cross_scale)
            else:
                ctx = cached_decode_attention(
                    query, layer_kv_views(full, layer_idx), s_full,
                    scale=self.scale, kv_quant_orig_scale=cross_scale)
                out = self.dense(self._merge_heads(ctx))
            return (out, past_key_value) if use_cache else out

        q, k, v = self.qkv(hidden_states)          # [B, L, H, D]
        if self.rotary_embedding_dim:
            if rotary is None:
                raise ValueError("a rotary layer needs the tokens' rotary "
                                 "angles")
            if self.glm_2d_rope:
                half = self.rotary_embedding_dim

                def rot2d(x):
                    return torch.cat([apply_rope(x[..., :half], *rotary[0]),
                                      apply_rope(x[..., half:], *rotary[1])],
                                     dim=-1)
                q, k = rot2d(q), rot2d(k)
            else:
                q = apply_rope(q, *rotary, self.neox_rotary_style)
                k = apply_rope(k, *rotary, self.neox_rotary_style)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))

        if isinstance(past_key_value, PagedKV):
            out, pool = self._paged(q, k, v, past_key_value, sequence_length,
                                    cache_write_index, beam_indirection)
            return (out, pool) if use_cache else out

        if isinstance(past_key_value, tuple) and len(past_key_value) == 3:
            # deferred-write decode: the cache is read as it is, the current
            # token comes in as the fresh operand, the caller stores it
            full, layer_idx, _ = past_key_value
            if l != 1:
                raise ValueError("deferred-write decode is single-token")
            if self.alibi:
                raise ValueError("an ALiBi step writes its own column: no "
                                 "deferred write")
            k_st, v_st = cast_kv_for_cache(k, v, full.dtype,
                                           self.kv_orig_quant_scale)
            out = self._decode(full, layer_idx, q, sequence_length,
                               kv_quant_orig_scale=self.kv_quant_orig_scale,
                               fresh_kv=(k_st, v_st),
                               beam_indirection=beam_indirection,
                               start_index=attention_start)
            return (out, (k_st, v_st)) if use_cache else out

        if past_key_value is not None:
            # prefill (or an ALiBi model's single-token step): write the
            # tokens' K/V into the stacked cache
            full, layer_idx = past_key_value
            append_kv_stacked(full, k, v, layer_idx, cache_write_index,
                              self.kv_orig_quant_scale)
            if self.alibi and alibi_bias is None:
                raise ValueError("an ALiBi layer needs the bias over the "
                                 "cache's columns")
            if beam_indirection is not None:
                # an ALiBi beam step: its column is written, the table
                # points at the row's own for it
                if l != 1 or not self.alibi:
                    raise ValueError("a beam table without the deferred "
                                     "write is for ALiBi steps")
                ctx = beam_indirect_decode_attention(
                    q, layer_kv_views(full, layer_idx), sequence_length,
                    beam_indirection, scale=self.scale,
                    kv_quant_orig_scale=self.kv_quant_orig_scale,
                    start_index=attention_start, bias=alibi_bias)
                out = self.dense(self._merge_heads(ctx))
            elif (attention_start is not None or self.quantized_kv_cache
                    or self.alibi or not self.causal or l == 1
                    or torch.is_tensor(cache_write_index)):
                # left-padded prompts, a quantised cache, ALiBi, a
                # bidirectional prompt, one token or a window at per-row
                # columns: attend over the cache just written
                # (dequantised), keys below the start masked, causal from
                # the write index unless bidirectional
                ctx = cached_decode_attention(
                    q, layer_kv_views(full, layer_idx), sequence_length,
                    scale=self.scale,
                    kv_quant_orig_scale=self.kv_quant_orig_scale,
                    causal_offset=cache_write_index if self.causal else None,
                    start_index=attention_start, bias=alibi_bias)
                out = self.dense(self._merge_heads(ctx))
            else:
                # the cache was empty before: causal context attention over
                # the fresh K/V through flash_mha, as the JAX layer's
                # empty-cache fast path (:660-682)
                if cache_write_index != 0:
                    raise NotImplementedError(
                        "a prefill after earlier tokens needs "
                        "attention_start")
                rep = self.num_attention_heads // self.num_attention_kv_heads
                if rep > 1:
                    k, v = (t.repeat_interleave(rep, dim=1) for t in (k, v))
                out = self._flash(q, k, v)
            return (out, full) if use_cache else out

        # one-shot (encoder) attention: flash_mha where the JAX layer calls
        # it (:715-740), the pad-once call always, others of MIN_FLASH_LEN
        # rows or more on the card
        if valid_len is not None or (l >= MIN_FLASH_LEN and q.is_cuda):
            out = self._flash(q, k, v, valid_len)
        else:
            bias = (causal_bias(l, l, device=q.device) if self.causal
                    else None)
            ctx = multihead_attention(q, k, v, bias=bias, scale=self.scale)
            out = self.dense(self._merge_heads(ctx))
        return (out, None) if use_cache else out
