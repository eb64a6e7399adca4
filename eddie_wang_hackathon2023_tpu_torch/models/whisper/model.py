"""Whisper encoder, cross-KV precompute and decoder (the JAX package's
``models/whisper/model.py``).

The JAX package scans one block over weights stacked [n_layer, ...]; the
port keeps one module per layer and loops over them in Python.  Layouts at
the public functions are the JAX package's: the decoder self cache and the
cross cache are stacked SEQ-MINOR, [n_layer, B, 2, H, head_dim, S].
Single-token decode steps take one of the JAX package's two paths: the
scanned path (``model.py:394-447``), with the fresh K/V of every layer
stored after the layer loop, or, given the packed weight image at batch 1,
the whole-step megakernel (``model.py:359-393``, ``ops/decoder_layer.py``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..._utils import str_dtype_to_torch
from ...functional import gelu, matmul_fp32, round_half_away
from ...layers import Attention, Conv1d, Embedding, LayerNorm
from ...layers.attention import linear_classes
from ...layers.linear import frozen
from ...ops.attention import write_fresh_kv
from ...quantization.mode import QuantMode
from .config import WhisperConfig

# the linear layers of one block, as stacked state-dict paths (the
# quantisation surgery of quantization/surgery.py walks these)
ENCODER_LINEARS = ("blocks.attn.qkv", "blocks.attn.dense", "blocks.mlp1",
                   "blocks.mlp2")
DECODER_LINEARS = ENCODER_LINEARS + ("blocks.cross_attn.q_linear",
                                     "blocks.cross_attn.dense")


class ResidualAttentionBlock(nn.Module):
    """Pre-LN self-attention (+ cross-attention) + 4x GELU MLP."""

    def __init__(self, n_state: int, n_head: int, dtype,
                 cross_attention: bool = False,
                 quant_mode: QuantMode = QuantMode(0),
                 causal: bool = False):
        super().__init__()
        self.attn_ln = LayerNorm(n_state, dtype=dtype)
        self.attn = Attention(n_state, n_head, causal=causal, dtype=dtype,
                              quant_mode=quant_mode,
                              use_int8_kv_cache=quant_mode.has_int8_kv_cache(),
                              use_fp8_kv_cache=quant_mode.has_fp8_kv_cache())
        self.cross_attention = cross_attention
        if cross_attention:
            self.cross_attn_ln = LayerNorm(n_state, dtype=dtype)
            self.cross_attn = Attention(n_state, n_head, cross_attention=True,
                                        dtype=dtype, quant_mode=quant_mode)
        col = linear_classes(quant_mode, dtype)[1]
        self.mlp_ln = LayerNorm(n_state, dtype=dtype)
        self.mlp1 = col(n_state, 4 * n_state, bias=True, dtype=dtype)
        self.mlp2 = col(4 * n_state, n_state, bias=True, dtype=dtype)

    def forward(self, x, kv_cache=None, cross_kv=None, write_index=None,
                sequence_length=None, valid_len=None,
                use_cache: bool = False, beam_indirection=None):
        attn_out = self.attn(self.attn_ln(x), past_key_value=kv_cache,
                             sequence_length=sequence_length,
                             cache_write_index=write_index,
                             valid_len=valid_len, use_cache=use_cache,
                             beam_indirection=beam_indirection)
        if use_cache:
            attn_out, kv_cache = attn_out
        x = x + attn_out
        if self.cross_attention:
            x = x + self.cross_attn(self.cross_attn_ln(x),
                                    cross_key_value=cross_kv)
        x = x + self.mlp2(gelu(self.mlp1(self.mlp_ln(x))))
        if use_cache:
            return x, kv_cache
        return x


class WhisperEncoder(nn.Module):
    """Conv1d+GELU -> Conv1d(stride 2)+GELU -> + positions -> blocks ->
    LN.  mel [B, n_mels, 2*n_audio_ctx] -> [B, n_audio_ctx, d]."""

    def __init__(self, config: WhisperConfig,
                 quant_mode: QuantMode = QuantMode(0)):
        super().__init__()
        c = config
        self.config = c
        dtype = str_dtype_to_torch(c.dtype)
        self.conv1 = Conv1d(c.n_mels, c.n_audio_state, 3, padding=1,
                            dtype=dtype)
        self.conv2 = Conv1d(c.n_audio_state, c.n_audio_state, 3, stride=2,
                            padding=1, dtype=dtype)
        self.positional_embedding = frozen((c.n_audio_ctx, c.n_audio_state),
                                           dtype)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(c.n_audio_state, c.n_audio_head, dtype,
                                   quant_mode=quant_mode)
            for _ in range(c.n_audio_layer))
        self.ln_post = LayerNorm(c.n_audio_state, dtype=dtype)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = gelu(self.conv1(mel))
        x = gelu(self.conv2(x))
        x = x.transpose(1, 2)                      # [B, n_audio_ctx, d]
        x = x + self.positional_embedding.to(x.dtype)
        # pad once to the flash block multiple (1500 -> 1536) and carry the
        # padded rows through every block; attention masks them by valid_len
        valid = x.shape[1]
        pad = (-valid) % 128 if valid >= 128 else 0
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
        vl = valid if pad else None
        for block in self.blocks:
            x = block(x, valid_len=vl)
        if pad:
            x = x[:, :valid]
        return self.ln_post(x)


class CrossAttnKV(nn.Module):
    """Every decoder layer's cross-attention K/V from the encoder output,
    once per utterance.  ``kv_weight`` [L, 2, d, d] holds the K and V
    projections of all layers fused ([out, in] each), ``v_bias`` [L, d]
    (K has no bias).  With ``int8_output`` the result is quantised per
    layer with the calibrated ``kv_scale`` [L] (the JAX package's
    ``static_scale=True``; its runtime-amax variant is not ported)."""

    def __init__(self, config: WhisperConfig, int8_output: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.int8_output = int8_output
        dtype = str_dtype_to_torch(c.dtype)
        d = c.n_text_state
        self.kv_weight = frozen((c.n_text_layer, 2, d, d), dtype)
        self.v_bias = frozen((c.n_text_layer, d), dtype)
        self.kv_scale = (frozen((c.n_text_layer,), torch.float32)
                         if int8_output else None)

    def forward(self, xa: torch.Tensor):
        """xa [B, S, d] -> [L, B, 2, H, head_dim, S] (seq-minor), plus the
        [L] fp32 dequant scales when int8."""
        c = self.config
        b, s, d = xa.shape
        n_layer = self.kv_weight.shape[0]
        h, hd = c.n_text_head, c.head_dim
        if b == 1:
            # one stacked GEMM whose natural output is the seq-minor layout:
            # out[L*2*d, S] = W[L*2*d, d] @ xa^T
            kv = torch.matmul(self.kv_weight.reshape(n_layer * 2 * d, d),
                              xa[0].t()).reshape(n_layer, 1, 2, d, s)
        else:
            kv = torch.einsum("bsi,ltoi->lbtos", xa, self.kv_weight)
        bias = F.pad(self.v_bias[:, None, :], (0, 0, 1, 0))  # zero K bias
        kv = kv + bias[:, None, :, :, None].to(kv.dtype)
        if not self.int8_output:
            return kv.reshape(n_layer, b, 2, h, hd, s)
        scale = self.kv_scale.float()
        q = torch.clamp(round_half_away(kv.float() / scale[:, None, None,
                                                           None, None]),
                        -127, 127)
        return q.to(torch.int8).reshape(n_layer, b, 2, h, hd, s), scale


class WhisperDecoder(nn.Module):
    """Token embedding + positions -> causal blocks over the stacked cache
    + cross-attention -> LN -> tied-embedding logits (int8 lm_head with
    ``quantize_lm_head``)."""

    def __init__(self, config: WhisperConfig,
                 quant_mode: QuantMode = QuantMode(0),
                 quantize_lm_head: bool = False):
        super().__init__()
        c = config
        self.config = c
        self.dtype = str_dtype_to_torch(c.dtype)
        self.token_embedding = Embedding(c.padded_vocab, c.n_text_state,
                                         dtype=self.dtype)
        self.quantize_lm_head = quantize_lm_head
        if quantize_lm_head:
            self.lm_head_qweight = frozen((c.padded_vocab, c.n_text_state),
                                          torch.int8)
            self.lm_head_scale = frozen((c.padded_vocab,), torch.float32)
        self.positional_embedding = frozen((c.n_text_ctx, c.n_text_state),
                                           self.dtype)
        self.blocks = nn.ModuleList(
            ResidualAttentionBlock(c.n_text_state, c.n_text_head, self.dtype,
                                   cross_attention=True,
                                   quant_mode=quant_mode, causal=True)
            for _ in range(c.n_text_layer))
        self.ln = LayerNorm(c.n_text_state, dtype=self.dtype)

    def new_kv_cache(self, batch: int, max_len: Optional[int] = None
                     ) -> torch.Tensor:
        """Zeroed stacked cache [n_layer, B, 2, H, head_dim, S], int8
        under ``kv8``, e4m3 under an fp8 KV cache (the JAX package's
        ``model.py:283-288``)."""
        c = self.config
        return torch.zeros(
            (c.n_text_layer, batch, 2, c.n_text_head, c.head_dim,
             max_len or c.n_text_ctx),
            dtype=self.blocks[0].attn.kv_cache_dtype,
            device=self.positional_embedding.device)

    def megakernel_eligible(self, device=None) -> bool:
        """Structure check for the whole-step megakernel
        (``ops/decoder_layer.py``), the JAX package's ``model.py:291-322``:
        lane-divisible widths and every block uniformly weight-only (int8
        per output channel, or int4 per channel or in groups that divide
        d/2: :func:`..ops.decoder_layer.woq_block_eligible`) or uniformly
        float (the fused equal-heads QKV and plain linears: bf16 panels
        with unit scales).  On a CUDA ``device`` (default: the weights'
        device) also the types the kernel takes: bf16 activations (the self
        cache is bf16, int8 under ``kv8`` or e4m3 under an fp8 KV cache;
        the cross cache, made in the same dtype or int8, follows) and heads
        of 64."""
        from ...layers.attention import QKVLinear
        from ...layers.linear import Linear, RowLinear
        from ...ops.decoder_layer import HEAD_DIM, woq_block_eligible
        from ...quantization.layers import WeightOnlyQuantQKVLinear
        c = self.config
        b = self.blocks[0]
        if device is None:
            device = self.positional_embedding.device
        if torch.device(device).type == "cuda" and (
                self.dtype != torch.bfloat16 or c.head_dim != HEAD_DIM):
            return False
        if c.n_text_state % 128 or 128 % c.head_dim:
            return False
        if b.mlp1.out_features % c.n_text_state:
            return False
        qkv = b.attn.qkv
        mods = [b.attn.dense, b.cross_attn.q_linear, b.cross_attn.dense,
                b.mlp1, b.mlp2]
        if isinstance(qkv, WeightOnlyQuantQKVLinear):
            return woq_block_eligible(qkv, mods, c.n_text_state)
        return (isinstance(qkv, QKVLinear)
                and qkv.num_kv_heads == qkv.num_heads
                and all(type(m) in (Linear, RowLinear) for m in mods))

    def megakernel_blobs(self):
        """The megakernel's weight image, packed from this decoder's own
        blocks (stacked into the JAX state layout first) on their device:
        a second copy of the decoder's weights (int8, int4 with its group
        scales, or float), and on a card a third, the kernel's
        item-contiguous tiles."""
        from ...ops.decoder_layer import megakernel_tiles, pack_decoder_blobs
        c = self.config
        per_layer = [blk.state_dict() for blk in self.blocks]
        state = {k: torch.stack([sd[k] for sd in per_layer])
                 for k in per_layer[0]}
        blobs = pack_decoder_blobs(
            state, n_layer=c.n_text_layer, hidden=c.n_text_state,
            n_head=c.n_text_head, head_dim=c.head_dim,
            ffn=self.blocks[0].mlp1.out_features, with_cross=True)
        return megakernel_tiles(blobs) if blobs.wblob.is_cuda else blobs

    def forward(self, tokens: torch.Tensor, kv_cache: torch.Tensor,
                cross_kv, write_index: int, sequence_length,
                megakernel_blobs=None, beam_indirection=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens [B, T]; kv_cache [L,B,2,H,D,S] (updated in place);
        cross_kv [L,B,2,H,D,S_audio] or (int8 cache, scales [L]);
        write_index: the cache column of tokens[:, 0]; sequence_length: the
        valid length including these tokens (int or [B] tensor; a
        single-token step makes an int a [B] tensor once for all layers).
        ``megakernel_blobs`` (:meth:`megakernel_blobs`): a single-token
        step at batch 1 runs every layer in one megakernel launch, as the
        JAX package's gate (``model.py:359-393``) does.
        ``beam_indirection`` [groups, beams, S] (single-token steps): the
        self-attention reads the cache through this beam table; such a step
        never takes the megakernel (``model.py:363``).
        Returns (logits [B, T, n_vocab] fp32, kv_cache)."""
        c = self.config
        t = tokens.shape[1]
        x = self.token_embedding(tokens)
        pos = self.positional_embedding[write_index:write_index + t]
        x = x + pos.to(x.dtype)
        if (megakernel_blobs is not None and t == 1 and tokens.shape[0] == 1
                and beam_indirection is None
                and self.megakernel_eligible(x.device)):
            from ...ops.decoder_layer import fused_decoder_stack
            cross, cscales = (cross_kv if isinstance(cross_kv, tuple)
                              else (cross_kv, None))
            # a fill, not a host-to-device copy, which would wait for the
            # stream
            seq1 = (torch.full((1,), sequence_length, dtype=torch.int32,
                               device=x.device)
                    if isinstance(sequence_length, int)
                    else sequence_length.reshape(-1)[:1])
            hid, fresh = fused_decoder_stack(
                x[:, 0, :], megakernel_blobs, kv_cache, seq1,
                self.blocks[0].attn.scale, cross_cache=cross,
                cross_scale=cscales, head_dim=c.head_dim)
            # [L, 2, H, D] -> [L, 1, 2, H, D, 1]
            write_fresh_kv(kv_cache, fresh[:, None, ..., None], write_index)
            return self._logits(self.ln(hid[:, None, :])), kv_cache
        if t == 1:
            if isinstance(sequence_length, int):
                sequence_length = torch.full((tokens.shape[0],),
                                             sequence_length,
                                             dtype=torch.int32,
                                             device=x.device)
            fresh = []
            for li, block in enumerate(self.blocks):
                x, (k_new, v_new) = block(
                    x, kv_cache=(kv_cache, li, "defer"),
                    cross_kv=(cross_kv, li), write_index=write_index,
                    sequence_length=sequence_length, use_cache=True,
                    beam_indirection=beam_indirection)
                fresh.append(torch.stack([k_new, v_new], dim=1))
            write_fresh_kv(kv_cache, torch.stack(fresh), write_index)
        else:
            for li, block in enumerate(self.blocks):
                x, kv_cache = block(
                    x, kv_cache=(kv_cache, li), cross_kv=(cross_kv, li),
                    write_index=write_index,
                    sequence_length=sequence_length, use_cache=True)
        x = self.ln(x)
        return self._logits(x), kv_cache

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, accumulated in fp32 as with
        ``preferred_element_type=float32``; the int8 lm_head is cast to the
        activation dtype and scaled per vocab row on the accumulator."""
        c = self.config
        if self.quantize_lm_head:
            logits = matmul_fp32(x, self.lm_head_qweight.to(x.dtype).t())
            logits = logits * self.lm_head_scale[None, None, :]
        else:
            logits = matmul_fp32(x, self.token_embedding.weight.t())
        if c.padded_vocab != c.n_vocab:
            logits = logits[..., :c.n_vocab]
        return logits


def quantize_lm_head_state(dec_state):
    """Add the int8 lm-head tensors to a decoder state dict: symmetric
    per-vocab-row quantisation of the tied embedding (``np.round``, half
    to even, as in the JAX package)."""
    w = np.asarray(dec_state["token_embedding.weight"], np.float32)
    amax = np.abs(w).max(axis=1)
    scale = np.maximum(amax, 1e-8) / 127.0
    q = np.clip(np.round(w / scale[:, None]), -127, 127).astype(np.int8)
    out = dict(dec_state)
    out["lm_head_qweight"] = q
    out["lm_head_scale"] = scale.astype(np.float32)
    return out
