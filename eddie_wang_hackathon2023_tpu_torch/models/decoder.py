"""Generic decoder-only transformer LM (the JAX package's
``models/decoder.py``), for the families this port runs so far: learned
positions, LayerNorm, a plain MLP, the sequential pre-LN residual, tied
word embeddings, and MQA/GQA attention (SantaCoder / StarCoder class).

Forward contract (used by :mod:`..runtime.generation` and
:mod:`..runtime.batch_manager`)::

    logits, kv_cache = model(tokens, kv_cache, write_index,
                             sequence_length, attention_start)

with either the stacked seq-minor KV cache ``[L, B, 2, Hkv, head_dim, S]``
and one ``write_index`` for all rows, or (paged serving) a
:class:`..ops.paged_attention.PagedCacheState`: the block pool
``[L, N + 1, 2, Hkv, T, head_dim]`` (``new_paged_pool``) with the block
tables, and either a prompt written from position 0 or one token per row
at the per-row positions ``write_index`` [B].  The port updates the cache
or the pool in place.  The JAX package scans one block over weights
stacked [n_layer, ...]; the port keeps one module per layer and loops over
them in Python.  A single-token step over the stacked cache stores every
layer's fresh K/V once, after the loop (``models/decoder.py:458-460``);
its self-attention goes through the decode kernel (the grouped mode when
the cache has fewer heads than the query); over the pool, each layer
writes its token through the table and reads the pool through the paged
decode kernel.  With an int8 KV cache (``QuantMode.set_int8_kv_cache``,
the per-layer scales in the state as ``attention.kv_orig_quant_scale`` and
``kv_quant_orig_scale``) the stacked cache is int8, every write quantises
and the grouped kernel reads it with the scale; an int8 pool raises.
RoPE, ALiBi and GLM positions, RMSNorm, the gated MLP, the
parallel and deepnorm residuals, untied or biased LM heads, per-row write
positions on the stacked cache, mixed prompt/decode windows on the pool,
the K-step tail and the megakernel are not ported and raise
``NotImplementedError``.  Beam search passes a ``beam_indirection``
[groups, beams, S] table to the single-token step, which every layer's
self-attention reads the cache through (the beam entry of the decode
kernel); over an MQA/GQA cache it raises, as the JAX package cannot run
it either.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .._utils import pad_vocab_size, str_dtype_to_torch
from ..functional import matmul_fp32
from ..layers import MLP, Attention, Embedding, LayerNorm
from ..ops.attention import write_fresh_kv
from ..ops.paged_attention import (PagedCacheState, PagedKV,
                                   new_block_pool, token_slots)
from ..quantization.mode import QuantMode

# the linear layers of one block, as stacked state-dict paths (the
# quantisation surgery of quantization/surgery.py walks these)
DECODER_LINEARS = ("blocks.attention.qkv", "blocks.attention.dense",
                   "blocks.mlp.fc", "blocks.mlp.proj")


@dataclasses.dataclass
class DecoderConfig:
    """The JAX package's ``DecoderConfig`` (``models/decoder.py:32-85``),
    field for field."""
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: Optional[int] = None          # != num_heads => MQA/GQA
    ffn_hidden_size: Optional[int] = None       # default 4*hidden
    max_position_embeddings: int = 2048
    position_embedding: str = "learned"         # learned | rope | alibi | glm_rope | none
    position_offset: int = 0                    # OPT's +2 quirk
    rotary_pct: float = 1.0
    rotary_base: float = 10000.0
    neox_rotary_style: bool = True
    norm: str = "layernorm"                     # layernorm | rmsnorm
    norm_eps: float = 1e-5
    hidden_act: str = "gelu"
    gated_mlp: bool = False
    attn_bias: bool = True
    mlp_bias: bool = True
    parallel_attn: bool = False
    deepnorm_alpha: Optional[float] = None
    bidirectional_context: bool = False
    embedding_norm: bool = False
    final_norm: bool = True
    tie_word_embeddings: bool = True
    lm_head_bias: bool = False
    apply_query_key_layer_scaling: bool = False
    dtype: str = "bfloat16"
    quant_mode: QuantMode = QuantMode(0)
    vocab_pad_multiple: int = 1

    def __post_init__(self):
        if self.num_kv_heads is None:
            self.num_kv_heads = self.num_heads
        if self.ffn_hidden_size is None:
            self.ffn_hidden_size = 4 * self.hidden_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def padded_vocab(self) -> int:
        return pad_vocab_size(self.vocab_size, self.vocab_pad_multiple)


def _check_ported(c: DecoderConfig) -> None:
    """Raise for the configuration options this port does not run yet."""
    unported = {
        f"position_embedding={c.position_embedding!r}":
            c.position_embedding not in ("learned", "none"),
        f"norm={c.norm!r}": c.norm != "layernorm",
        "gated_mlp": c.gated_mlp,
        "parallel_attn": c.parallel_attn,
        "deepnorm_alpha": c.deepnorm_alpha is not None,
        "bidirectional_context": c.bidirectional_context,
        "embedding_norm": c.embedding_norm,
        "untied word embeddings": not c.tie_word_embeddings,
        "lm_head_bias": c.lm_head_bias,
        "apply_query_key_layer_scaling": c.apply_query_key_layer_scaling,
        "a quantised KV cache": c.quant_mode.has_fp8_kv_cache(),
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"decoder options not ported: {bad}")


def _check_beam_forward(tokens, kv_cache) -> None:
    """Beams read the stacked cache through the indirection table, one
    token a step (an MQA/GQA cache is refused by the attention op)."""
    if isinstance(kv_cache, PagedCacheState) or tokens.shape[1] != 1:
        raise NotImplementedError("beam_indirection is ported for the "
                                  "single-token step over the stacked cache")


class DecoderBlock(nn.Module):
    """Pre-LN causal self-attention, then the pre-LN MLP, each added to the
    residual."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        c = config
        dtype = str_dtype_to_torch(c.dtype)
        self.input_layernorm = LayerNorm(c.hidden_size, eps=c.norm_eps,
                                         dtype=dtype)
        self.attention = Attention(c.hidden_size, c.num_heads, causal=True,
                                   bias=c.attn_bias, dtype=dtype,
                                   quant_mode=c.quant_mode,
                                   num_kv_heads=c.num_kv_heads,
                                   use_int8_kv_cache=(
                                       c.quant_mode.has_int8_kv_cache()))
        self.post_layernorm = LayerNorm(c.hidden_size, eps=c.norm_eps,
                                        dtype=dtype)
        self.mlp = MLP(c.hidden_size, c.ffn_hidden_size, c.hidden_act,
                       bias=c.mlp_bias, dtype=dtype, quant_mode=c.quant_mode)

    def forward(self, x, kv_cache, write_index, sequence_length,
                attention_start=None, beam_indirection=None):
        attn_out, new_cache = self.attention(
            self.input_layernorm(x), past_key_value=kv_cache,
            sequence_length=sequence_length, cache_write_index=write_index,
            attention_start=attention_start, use_cache=True,
            beam_indirection=beam_indirection)
        x = x + attn_out
        x = x + self.mlp(self.post_layernorm(x))
        return x, new_cache


class DecoderLMHead(nn.Module):
    """Embedding (+ learned positions) -> blocks -> final LN -> tied LM
    head, fp32 logits."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        _check_ported(config)
        c = config
        self.config = c
        self.dtype = str_dtype_to_torch(c.dtype)
        self.vocab_embedding = Embedding(c.padded_vocab, c.hidden_size,
                                         dtype=self.dtype)
        if c.position_embedding == "learned":
            self.position_embedding = Embedding(
                c.max_position_embeddings + c.position_offset, c.hidden_size,
                dtype=self.dtype)
        self.blocks = nn.ModuleList(DecoderBlock(c)
                                    for _ in range(c.num_layers))
        if c.final_norm:
            self.ln_f = LayerNorm(c.hidden_size, eps=c.norm_eps,
                                  dtype=self.dtype)

    def new_kv_cache(self, batch: int, max_len: Optional[int] = None
                     ) -> torch.Tensor:
        """Zeroed stacked cache [n_layer, B, 2, Hkv, head_dim, S] (int8
        with an int8 KV cache in the config's quant mode)."""
        c = self.config
        per_layer = self.blocks[0].attention.new_kv_cache(
            batch, max_len or c.max_position_embeddings, device="meta")
        return torch.zeros((c.num_layers,) + per_layer.shape,
                           dtype=per_layer.dtype,
                           device=self.vocab_embedding.weight.device)

    def new_paged_pool(self, num_blocks: int, tokens_per_block: int
                       ) -> torch.Tensor:
        """Zeroed stacked block pool [n_layer, N + 1, 2, Hkv, T, head_dim]
        for paged serving (N blocks and the sink of the dropped writes,
        :func:`..ops.paged_attention.new_block_pool`), in the model's dtype,
        on its device.  An int8 pool is not ported."""
        c = self.config
        if c.quant_mode.has_int8_kv_cache():
            raise NotImplementedError("int8 paged pools are not ported")
        return new_block_pool(num_blocks, c.num_kv_heads, tokens_per_block,
                              c.head_dim, dtype=self.dtype,
                              num_layers=c.num_layers,
                              device=self.vocab_embedding.weight.device)

    def forward(self, tokens: torch.Tensor, kv_cache, write_index,
                sequence_length, attention_start=None,
                beam_indirection=None, kv_tail=None, megakernel_blobs=None
                ) -> Tuple[torch.Tensor, object]:
        """tokens [B, T] (left-padded prompts use ``attention_start`` [B]);
        ``write_index``: the cache column of tokens[:, 0], one for all rows,
        or over the paged pool a [B] tensor of per-row positions (one token
        per row); ``sequence_length``: the valid length including these
        tokens (an int or a [B] tensor; a single-token step makes an int a
        [B] tensor once for all layers); ``beam_indirection``
        [groups, beams, S] int32 (beam search, a single-token step over the
        stacked cache, rows grouped by group): the physical cache row of
        each (beam, position).  Returns (logits [B, T, vocab] fp32,
        kv_cache)."""
        if kv_tail is not None or megakernel_blobs is not None:
            raise NotImplementedError("the K-step tail and the megakernel "
                                      "are not ported for the decoder-only "
                                      "path")
        if beam_indirection is not None:
            _check_beam_forward(tokens, kv_cache)
        if isinstance(kv_cache, PagedCacheState):
            return self._paged_forward(tokens, kv_cache, write_index,
                                       sequence_length, attention_start)
        if not torch.is_tensor(kv_cache) or not isinstance(write_index, int):
            raise NotImplementedError("per-row write positions are ported "
                                      "for the paged pool only")
        c = self.config
        b, t = tokens.shape
        x = self.vocab_embedding(tokens)
        if c.position_embedding == "learned":
            pos = write_index + torch.arange(t, device=x.device)[None, :]
            if attention_start is not None:
                pos = torch.clamp(pos - attention_start[:, None].long(), min=0)
            x = x + self.position_embedding(pos.expand(b, t)
                                            + c.position_offset)
        if t == 1:
            if isinstance(sequence_length, int):
                # a fill, not a host-to-device copy, which would wait for
                # the stream
                sequence_length = torch.full((b,), sequence_length,
                                             dtype=torch.int32,
                                             device=x.device)
            fresh = []
            for li, block in enumerate(self.blocks):
                x, (k_new, v_new) = block(x, (kv_cache, li, "defer"),
                                          write_index, sequence_length,
                                          attention_start, beam_indirection)
                fresh.append(torch.stack([k_new, v_new], dim=1))
            write_fresh_kv(kv_cache, torch.stack(fresh), write_index)
        else:
            for li, block in enumerate(self.blocks):
                x, kv_cache = block(x, (kv_cache, li), write_index,
                                    sequence_length, attention_start)
        if c.final_norm:
            x = self.ln_f(x)
        return self._logits(x), kv_cache

    def _paged_forward(self, tokens, state: PagedCacheState, write_index,
                       sequence_length, attention_start):
        """The paged serving path (the JAX model's ``models/decoder.py``
        :339-360): positions per row from ``write_index``, each layer given
        ``PagedKV(pool, table, layer)`` and, for a one-token step, the write
        slots of the rows' tokens, found once.  A slot that is not live still
        rides the step at length 0, so its position is -1, which is clamped
        here (the JAX gather wraps or clamps it); its output is discarded by
        the caller."""
        if attention_start is not None:
            raise NotImplementedError("left-padded prompts (attention_start) "
                                      "are not ported for the paged pool")
        c = self.config
        b, t = tokens.shape
        x = self.vocab_embedding(tokens)
        if c.position_embedding == "learned":
            base = (write_index[:, None].long()
                    if torch.is_tensor(write_index) else write_index)
            pos = base + torch.arange(t, device=x.device)[None, :]
            pos = pos.clamp(0, c.max_position_embeddings - 1)
            x = x + self.position_embedding(pos.expand(b, t)
                                            + c.position_offset)
        pool, table = state.pool, state.block_table
        slots = None
        if t == 1:
            # where each row's token lands: the same in every layer
            pos = torch.as_tensor(write_index, device=x.device).reshape(-1)
            slots = token_slots(table, pos.expand(b)[:, None],
                                pool.shape[1] - 1, pool.shape[4])
        for li, block in enumerate(self.blocks):
            x, pool = block(x, PagedKV(pool, table, li, slots), write_index,
                            sequence_length)
        if c.final_norm:
            x = self.ln_f(x)
        return self._logits(x), PagedCacheState(pool, table)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied logits accumulated and returned in fp32
        (``preferred_element_type=float32``), sliced to the vocab."""
        c = self.config
        logits = matmul_fp32(x, self.vocab_embedding.weight.t())
        if c.padded_vocab != c.vocab_size:
            logits = logits[..., :c.vocab_size]
        return logits
