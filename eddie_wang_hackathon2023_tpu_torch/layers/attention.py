"""Self/cross attention layer (the Whisper part of the JAX package's
``layers/attention.py``).

Modes, as in the JAX package:
* encoder self-attention with the pad-once ``valid_len`` contract, through
  the flash kernel (:func:`..ops.flash_attention.flash_mha`);
* decoder self-attention over the stacked seq-minor cache
  ``[L, B, 2, H, D, S]``: prefill from an empty cache (``past_key_value =
  (cache, layer)``, written in place), and single-token decode with the
  fresh K/V write deferred to the caller (``(cache, layer, "defer")``),
  optionally read through a beam cache-indirection table
  (``beam_indirection``);
* cross-attention over the stacked cross cache (``cross_key_value =
  (cache, layer)`` or ``((cache, scales), layer)`` for int8 with per-layer
  scales).
Single-token decode goes through the decode kernel
(:func:`..ops.decode_attention.fused_decode_attention`), with the int8
out-projection fused when the dense layer is weight-only int8 at batch 1
(never with beams).
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch import nn

from ..functional import causal_bias
from ..ops.attention import (append_kv_stacked, cached_decode_attention,
                             cast_kv_for_cache, layer_kv_views,
                             multihead_attention)
from ..ops.decode_attention import fused_decode_attention
from ..ops.flash_attention import flash_mha
from ..quantization.layers import (WeightOnlyQuantLinear,
                                   WeightOnlyQuantQKVLinear,
                                   WeightOnlyQuantRowLinear)
from ..quantization.mode import QuantMode
from ..quantization.smoothquant_layers import (SmoothQuantLinear,
                                               SmoothQuantQKVLinear,
                                               SmoothQuantRowLinear)
from .linear import ColumnLinear, RowLinear, frozen

_MIN_FLASH_LEN = 128


@functools.lru_cache(maxsize=None)
def _full_lengths(batch: int, length: int, device: torch.device
                  ) -> torch.Tensor:
    """[batch] int32 of ``length``: the valid length of a full cross
    cache, made once per shape instead of once per layer and step."""
    return torch.full((batch,), length, dtype=torch.int32, device=device)


class QKVLinear(nn.Module):
    """Fused QKV projection with the head-major weight [3, H, hd, hidden]
    (``convert._fuse_qkv``) and bias [3, H, hd]."""

    def __init__(self, hidden_size: int, num_heads: int, head_dim: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.num_kv_heads = num_heads
        self.head_dim = head_dim
        self.weight = frozen((3, num_heads, head_dim, hidden_size), dtype)
        self.bias = frozen((3, num_heads, head_dim), dtype) if bias else None

    def forward(self, x: torch.Tensor):
        b, l, hidden = x.shape
        h, d = self.num_heads, self.head_dim
        w = self.weight.reshape(3 * h * d, hidden)
        qkv = torch.matmul(x, w.t()).reshape(b, l, 3, h, d)
        if self.bias is not None:
            qkv = qkv + self.bias.to(qkv.dtype)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


def linear_classes(quant_mode: QuantMode, dtype):
    """(qkv, column, row) linear classes for a quantisation mode."""
    if quant_mode.is_int8_weight_only():
        return (WeightOnlyQuantQKVLinear, WeightOnlyQuantLinear,
                WeightOnlyQuantRowLinear)
    if quant_mode.has_act_and_weight_quant():
        def sq(cls, out_dtype=dtype):
            return lambda *a, **kw: cls(*a, **{**kw, "dtype": out_dtype},
                                        quant_mode=quant_mode)
        # the QKV projection is built with dtype None (fp32 q/k/v and bias),
        # as the JAX package's surgery builds it (surgery.py:152-155)
        return (sq(SmoothQuantQKVLinear, None), sq(SmoothQuantLinear),
                sq(SmoothQuantRowLinear))
    if quant_mode.is_weight_only() or quant_mode.has_any_quant():
        raise NotImplementedError(f"quant mode {quant_mode!r} is not ported")
    return QKVLinear, ColumnLinear, RowLinear


class Attention(nn.Module):

    def __init__(self, hidden_size: int, num_attention_heads: int,
                 cross_attention: bool = False, causal: bool = False,
                 bias: bool = True, dtype=torch.float32,
                 quant_mode: QuantMode = QuantMode(0)):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_attention_heads = num_attention_heads
        self.attention_head_size = hidden_size // num_attention_heads
        self.cross_attention = cross_attention
        self.causal = causal
        self.dtype = dtype
        qkv_cls, col_cls, row_cls = linear_classes(quant_mode, dtype)
        if cross_attention:
            self.q_linear = col_cls(hidden_size, hidden_size, bias=bias,
                                    dtype=dtype)
            self.qkv = None
        else:
            self.qkv = qkv_cls(hidden_size, num_attention_heads,
                               self.attention_head_size, bias=bias,
                               dtype=dtype)
            self.q_linear = None
        self.dense = row_cls(hidden_size, hidden_size, bias=bias, dtype=dtype)

    @property
    def scale(self) -> float:
        return 1.0 / math.sqrt(self.attention_head_size)

    def _split_heads(self, x):
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_attention_heads,
                         self.attention_head_size).transpose(1, 2)

    @staticmethod
    def _merge_heads(x):
        b, h, l, d = x.shape
        return x.transpose(1, 2).reshape(b, l, h * d)

    def _decode_proj_operands(self, batch: int):
        """(weight, scale, bias) of an int8 weight-only dense layer for the
        fused out-projection at batch 1; None otherwise."""
        d = self.dense
        if batch != 1 or not isinstance(d, WeightOnlyQuantLinear):
            return None
        return d.qweight, d.per_channel_scale, d.bias

    def _decode(self, cache, layer_idx, q, seq_len, kv_quant_orig_scale=None,
                fresh_kv=None, beam_indirection=None):
        """Single-token attention + out-projection -> [B, 1, N]."""
        b = q.shape[0]
        proj = (None if beam_indirection is not None
                else self._decode_proj_operands(b))
        res = fused_decode_attention(cache, layer_idx, q, seq_len,
                                     self.scale,
                                     kv_quant_orig_scale=kv_quant_orig_scale,
                                     fresh_kv=fresh_kv, proj=proj,
                                     beam_indirection=beam_indirection)
        if proj is not None:
            return res[:, None, :]
        return self.dense(self._merge_heads(res))

    def forward(self, hidden_states: torch.Tensor, past_key_value=None,
                sequence_length=None, cross_key_value=None,
                cache_write_index: Optional[int] = None,
                valid_len: Optional[int] = None, use_cache: bool = False,
                beam_indirection=None):
        """``beam_indirection`` [groups, beams, S] (single-token decode of
        the self-attention only): each query row reads the cache positions
        through the table, as the JAX layer does (``layers/attention.py``
        :576-614); cross-attention ignores it (its cache rows are the
        repeated audio, the same for every beam)."""
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
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))

        if isinstance(past_key_value, tuple) and len(past_key_value) == 3:
            # deferred-write decode: the cache is read as it is, the current
            # token comes in as the fresh operand, the caller stores it
            full, layer_idx, _ = past_key_value
            if l != 1:
                raise ValueError("deferred-write decode is single-token")
            k_st, v_st = cast_kv_for_cache(k, v, full.dtype)
            out = self._decode(full, layer_idx, q, sequence_length,
                               fresh_kv=(k_st, v_st),
                               beam_indirection=beam_indirection)
            return (out, (k_st, v_st)) if use_cache else out

        if past_key_value is not None:
            # prefill: write the prompt's K/V into the stacked cache, then
            # attend over the fresh K/V (the cache was empty before)
            full, layer_idx = past_key_value
            if cache_write_index != 0 or l == 1 or not self.causal:
                raise NotImplementedError(
                    "only a causal prefill from an empty cache is ported")
            append_kv_stacked(full, k, v, layer_idx, 0)
            ctx = multihead_attention(
                q, k, v, bias=causal_bias(l, l, device=q.device),
                scale=self.scale)
            out = self.dense(self._merge_heads(ctx))
            return (out, full) if use_cache else out

        # one-shot (encoder) attention
        if valid_len is not None or (l >= _MIN_FLASH_LEN and q.is_cuda
                                     and not self.causal):
            # the kernel writes [B, L, H, D] directly, so merging the heads
            # for the out-projection is a free reshape
            ctx = torch.empty((b, l, self.num_attention_heads,
                               self.attention_head_size), dtype=q.dtype,
                              device=q.device)
            flash_mha(q, k, v, causal=self.causal, scale=self.scale,
                      kv_valid_len=valid_len, out=ctx.transpose(1, 2))
            out = self.dense(ctx.reshape(b, l, self.hidden_size))
        else:
            bias = (causal_bias(l, l, device=q.device) if self.causal
                    else None)
            ctx = multihead_attention(q, k, v, bias=bias, scale=self.scale)
            out = self.dense(self._merge_heads(ctx))
        return (out, None) if use_cache else out
