"""Generic decoder-only transformer LM (the JAX package's
``models/decoder.py``), for every family it runs: learned, rotary, ALiBi,
GLM two-dimensional rotary or no positions (RoPE: GPT-NeoX halves or GPT-J
interleaved pairs, a partial rotary dim), LayerNorm or RMSNorm (and a norm
after the embedding), the plain or gated MLP, the sequential, parallel or
deepnorm residual, a causal or bidirectional prompt, query-key layer
scaling, a tied or separate LM head (with a bias), and MQA/GQA attention:
GPT-2, OPT, LLaMA (GQA too), GPT-J, GPT-NeoX, Bloom, ChatGLM-6B and
SantaCoder / StarCoder (``models/families.py``).

Forward contract (used by :mod:`..runtime.generation` and
:mod:`..runtime.batch_manager`)::

    logits, kv_cache = model(tokens, kv_cache, write_index,
                             sequence_length, attention_start)

with either the stacked seq-minor KV cache ``[L, B, 2, Hkv, head_dim, S]``
and one ``write_index`` for all rows or (serving's dense slot cache) a
[B] tensor of per-row columns, or (paged serving) a
:class:`..ops.paged_attention.PagedCacheState`: the block pool
``[L, N + 1, 2, Hkv, T, head_dim]`` (``new_paged_pool``) with the block
tables, and either a prompt written from position 0 or tokens at the
per-row positions ``write_index`` [B] (one a row, or a window of several,
mixed context+generation admission).  The port updates the cache or the
pool in place.  The JAX package scans one block over weights
stacked [n_layer, ...]; the port keeps one module per layer and loops over
them in Python.  A token's position is its cache column less its row's
``attention_start``, floored at 0 (the JAX model's :303-313); learned
positions embed it, rotary ones rotate q and k by it in every layer (the
angles made once a call).  A single-token step over the stacked cache
stores every layer's fresh K/V once, after the loop
(``models/decoder.py:458-460``); its self-attention goes through the
decode kernel (the grouped mode when the cache has fewer heads than the
query); over the pool, each layer writes its token through the table and
reads the pool through the paged decode kernel.  With an int8 KV cache
(``QuantMode.set_int8_kv_cache``, the per-layer scales in the state as
``attention.kv_orig_quant_scale`` and ``kv_quant_orig_scale``) the
stacked cache (or the pool) is int8, every write quantises and the decode
kernels read it with the scale.  A causal prompt into an empty
stacked cache takes kernel 2's causal mode on the card at any length
(heads of 64; the JAX package keeps prompts under 128 tokens in XLA), so
that serving's admission prefill runs on it.  At batch 1 a single-token step
given ``megakernel_blobs`` (:meth:`DecoderLMHead.megakernel_blobs`) runs
every layer in one launch of the whole-step megakernel
(``ops/decoder_layer.py``), as the JAX model's :367-412 does: the final
norm and the logits after it, then the fresh K/V written at
``write_index``; an MQA/GQA model (heads of 128) through the kernel's
grouped mode.  ALiBi (Bloom): the bias [1, H, 1, S] over the absolute
cache column made once a call, every prompt attending over the cache it
has written, and a single-token step writing each layer's column before
attending (no deferred write, no decode kernel: the JAX model runs it
through XLA, ``models/decoder.py:460-472``).  GLM (ChatGLM-6B): the
positions [B, 2, T], ``pos0 = min(p, plen - 2)`` and ``pos1 = max(p -
plen + 2, 0)`` with ``plen`` the true prompt lengths (``context_lengths``,
which :attr:`DecoderLMHead.needs_context_lengths` asks the session for),
the deepnorm residual ``x = ln(x) alpha + attn; y = ln2(x); x = y alpha +
mlp(y)`` and the bidirectional prompt.  An fp8 (e4m3) KV cache is the
int8 cache's twin: the same per-layer scales around the saturating cast.
The K-step tail is not ported and raises ``NotImplementedError``; the
megakernel is
not taken for per-row columns (the JAX model's gate, :365).
Beam search passes a ``beam_indirection`` [groups, beams, S] table to the
single-token step, which every layer's self-attention reads the cache
through (the beam entry of the decode kernel; an ALiBi step through the
plain beam attention with the bias, after writing its column) or the pool
through (the paged kernel's beam entry, each beam row appending into its
own chain); over an MQA/GQA cache or pool it raises, as the JAX package
cannot run it either.  (The
JAX model's ALiBi step drops the table, so its Bloom beams read their own
rows' history; the port reads through it, as the JAX gather mode does.)
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from .._utils import pad_vocab_size, str_dtype_to_torch
from ..functional import (ACT2FN, alibi_slopes, generate_alibi_biases,
                          matmul_fp32, rope_angles)
from ..layers import (MLP, Attention, Embedding, GatedMLP, LayerNorm,
                      Linear, QKVLinear, RmsNorm, RowLinear)
from ..ops.attention import write_fresh_kv
from ..parallel import collectives
from ..ops.paged_attention import (PagedCacheState, PagedKV,
                                   new_block_pool, token_slots)
from ..quantization.mode import QuantMode

# the linear layers of one block, as stacked state-dict paths (the
# quantisation surgery of quantization/surgery.py walks these)
DECODER_LINEARS = ("blocks.attention.qkv", "blocks.attention.dense",
                   "blocks.mlp.fc", "blocks.mlp.gate", "blocks.mlp.proj")


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
            c.position_embedding not in ("learned", "none", "rope", "alibi",
                                         "glm_rope"),
        f"norm={c.norm!r}": c.norm not in ("layernorm", "rmsnorm"),
        f"hidden_act={c.hidden_act!r}": c.hidden_act not in ACT2FN,
    }
    bad = [name for name, on in unported.items() if on]
    if bad:
        raise NotImplementedError(f"decoder options not ported: {bad}")


def _make_norm(c: DecoderConfig, dtype):
    if c.norm == "rmsnorm":
        return RmsNorm(c.hidden_size, eps=c.norm_eps, dtype=dtype)
    return LayerNorm(c.hidden_size, eps=c.norm_eps, dtype=dtype)


def rotary_dim(c: DecoderConfig) -> int:
    """The rotated channels of a head (0 without RoPE), as the JAX
    attention layer sizes them (``int(head_dim * rotary_pct)``)."""
    if c.position_embedding != "rope":
        return 0
    return int(c.head_dim * c.rotary_pct)


def glm_positions(positions: torch.Tensor, context_lengths: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ChatGLM-6B's two position rows of the tokens at ``positions``
    [B, T] (their place in the true, unpadded sequence) for prompts of the
    true lengths ``context_lengths`` [B] (the JAX model's :313-326): the
    prompt's last token, [sop], repeats [gMASK]'s position plen - 2 with
    block position 1, and generated token s keeps plen - 2 with block
    position s + 2."""
    plen = context_lengths.reshape(-1, 1).to(positions.device).long()
    return (torch.minimum(positions, plen - 2),
            torch.clamp(positions - plen + 2, min=0))


class DecoderBlock(nn.Module):
    """Pre-norm self-attention and MLP: sequential (each added to the
    residual, the MLP after ``post_layernorm``), with ``parallel_attn``
    (GPT-J, GPT-NeoX) both reading the input norm and added together,
    ``x + attn + mlp``, or with ``deepnorm_alpha`` (ChatGLM-6B) the
    residual taken from the norms, ``x = ln(x) alpha + attn; y = ln2(x);
    x = y alpha + mlp(y)`` (the JAX block's :142-147).  The attention is
    causal unless the prompt is bidirectional."""

    def __init__(self, config: DecoderConfig):
        super().__init__()
        c = config
        self.parallel = c.parallel_attn
        self.deepnorm_alpha = c.deepnorm_alpha
        dtype = str_dtype_to_torch(c.dtype)
        self.input_layernorm = _make_norm(c, dtype)
        self.attention = Attention(
            c.hidden_size, c.num_heads, causal=not c.bidirectional_context,
            bias=c.attn_bias, dtype=dtype, quant_mode=c.quant_mode,
            num_kv_heads=c.num_kv_heads,
            use_int8_kv_cache=c.quant_mode.has_int8_kv_cache(),
            use_fp8_kv_cache=c.quant_mode.has_fp8_kv_cache(),
            rotary_embedding_dim=rotary_dim(c),
            neox_rotary_style=c.neox_rotary_style,
            glm_2d_rope=c.position_embedding == "glm_rope",
            alibi=c.position_embedding == "alibi",
            num_layers=c.num_layers,
            apply_query_key_layer_scaling=c.apply_query_key_layer_scaling,
            flash_prefill_rows=1)
        if not c.parallel_attn or c.deepnorm_alpha is not None:
            self.post_layernorm = _make_norm(c, dtype)
        mlp = GatedMLP if c.gated_mlp else MLP
        self.mlp = mlp(c.hidden_size, c.ffn_hidden_size, c.hidden_act,
                       bias=c.mlp_bias, dtype=dtype, quant_mode=c.quant_mode)

    def forward(self, x, kv_cache, write_index, sequence_length,
                attention_start=None, beam_indirection=None, rotary=None,
                alibi_bias=None):
        normed = self.input_layernorm(x)
        attn_out, new_cache = self.attention(
            normed, past_key_value=kv_cache,
            sequence_length=sequence_length, cache_write_index=write_index,
            attention_start=attention_start, use_cache=True,
            beam_indirection=beam_indirection, rotary=rotary,
            alibi_bias=alibi_bias)
        if self.deepnorm_alpha is not None:
            alpha = self.deepnorm_alpha
            x = normed * alpha + attn_out
            normed2 = self.post_layernorm(x)
            return normed2 * alpha + self.mlp(normed2), new_cache
        if self.parallel:
            return x + attn_out + self.mlp(normed), new_cache
        x = x + attn_out
        x = x + self.mlp(self.post_layernorm(x))
        return x, new_cache


class DecoderLMHead(nn.Module):
    """Embedding (+ learned positions) -> blocks -> final norm -> tied or
    separate LM head, fp32 logits."""

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
        if c.embedding_norm:
            self.ln_embed = _make_norm(c, self.dtype)
        self.blocks = nn.ModuleList(DecoderBlock(c)
                                    for _ in range(c.num_layers))
        if c.final_norm:
            self.ln_f = _make_norm(c, self.dtype)
        if not c.tie_word_embeddings:
            self.lm_head = Linear(c.hidden_size, c.padded_vocab,
                                  bias=c.lm_head_bias, dtype=self.dtype)

    def tp_shard(self, tp) -> None:
        """``parallel.sharding.parallelize``'s hook: a separate LM head is
        column-parallel over the vocab, its rows gathered (where the tp
        size divides the vocab)."""
        from ..parallel.sharding import shard_linear
        if not self.config.tie_word_embeddings \
                and self.config.padded_vocab % tp.size == 0:
            shard_linear(self.lm_head, tp, "col", gather_output=True)

    def new_kv_cache(self, batch: int, max_len: Optional[int] = None
                     ) -> torch.Tensor:
        """Zeroed stacked cache [n_layer, B, 2, Hkv, head_dim, S] (int8
        or e4m3 with an int8 or fp8 KV cache in the config's quant
        mode)."""
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
        :func:`..ops.paged_attention.new_block_pool`), in the dtype of the
        model's KV cache (int8 or e4m3 with an int8 or fp8 KV cache), on
        its device."""
        c = self.config
        return new_block_pool(num_blocks,
                              self.blocks[0].attention.num_attention_kv_heads,
                              tokens_per_block,
                              c.head_dim,
                              dtype=self.blocks[0].attention.kv_cache_dtype,
                              num_layers=c.num_layers,
                              device=self.vocab_embedding.weight.device)

    @property
    def needs_context_lengths(self) -> bool:
        """GLM's positions depend on the true prompt lengths, which the
        session passes to every call (the JAX model's :196-201)."""
        return self.config.position_embedding == "glm_rope"

    def megakernel_eligible(self) -> bool:
        """Structure check for the whole-step megakernel
        (``ops/decoder_layer.py``), the JAX model's :203-266: learned, no or
        rotary positions (an even rotary dim; not ALiBi or GLM), no deepnorm
        residual and no bidirectional prompt, LayerNorm or RMSNorm, the
        kernel's activations, lane-divisible widths up to d 2048, MQA/GQA
        only at head dim 128 with the query heads a multiple of the KV
        heads (the grouped mode), and every block uniformly int8
        weight-only per output channel or uniformly float.  With the
        weights on a card also the types and shapes the kernel takes
        (:func:`..ops.decoder_layer.kernel_takes`: bf16 activations, heads
        of 64 or 128)."""
        from ..ops.decoder_layer import kernel_takes, woq_block_eligible
        from ..parallel.sharding import tp_active
        from ..quantization.layers import WeightOnlyQuantQKVLinear
        c = self.config
        if tp_active(self):
            # the JAX package's params_cross_device_sharded gate
            return False
        if c.position_embedding not in ("learned", "none", "rope"):
            return False
        if rotary_dim(c) % 2:
            return False
        if c.deepnorm_alpha is not None or c.bidirectional_context:
            return False
        if c.hidden_act not in ("gelu", "relu", "gelu_exact", "silu"):
            return False
        if c.num_kv_heads != c.num_heads and (
                c.head_dim != 128 or c.num_heads % c.num_kv_heads):
            return False
        if c.hidden_size % 128 or 128 % c.head_dim or c.hidden_size > 2048:
            return False
        nf = -(-c.ffn_hidden_size // c.hidden_size)
        if self.vocab_embedding.weight.is_cuda and not kernel_takes(
                self.dtype, c.hidden_size, nf, c.head_dim):
            return False
        b = self.blocks[0]
        qkv = b.attention.qkv
        mods = [b.attention.dense, b.mlp.fc, b.mlp.proj]
        if c.gated_mlp:
            mods.append(b.mlp.gate)
        if isinstance(qkv, WeightOnlyQuantQKVLinear):
            # int4 stays layer by layer, as in the JAX package (its device
            # A/B lost on decoder-only stacks, JAX models/decoder.py:248)
            return woq_block_eligible(qkv, mods, c.hidden_size,
                                      allow_int4=False)
        return isinstance(qkv, QKVLinear) and all(
            type(m) in (Linear, RowLinear) for m in mods)

    def megakernel_blobs(self):
        """The megakernel's weight image, packed from this model's own
        blocks (each block's state in the JAX layout) on their device (the
        JAX model's :268-283, the MLP reading the input norm under
        ``parallel_attn``), one layer at a time.  On the CPU the blobs hold
        the K-major panels (``wblob``) the plain version reads.  On a card
        each layer's panels are cut into the kernel's tiles at once and
        dropped: ``tiles`` is the one copy of the weights besides the
        model's, and ``wblob`` a meta tensor that keeps their type and
        shape (the kernel reads nothing else of it), and so is ``kvblob``
        (the grouped mode's K and V columns)."""
        from ..ops.decoder_layer import (DECODER_KEYS, MegakernelBlobs,
                                         megakernel_tiles, pack_decoder_blobs)
        c = self.config
        keys = dict(DECODER_KEYS)
        if c.parallel_attn:
            keys["ln"] = ("input_layernorm",)
        layers, tiles, grid = [], None, None
        for li, blk in enumerate(self.blocks):
            state = {k: v[None] for k, v in blk.state_dict().items()}
            b = pack_decoder_blobs(
                state, n_layer=1, hidden=c.hidden_size, n_head=c.num_heads,
                head_dim=c.head_dim, ffn=c.ffn_hidden_size, with_cross=False,
                gated=c.gated_mlp, n_kv_head=c.num_kv_heads, keys=keys)
            if b.wblob.is_cuda:
                tb = megakernel_tiles(b)
                t, grid = tb.tiles, tb.tiles_grid
                if tiles is None:
                    tiles = torch.empty((c.num_layers, t.shape[1]),
                                        dtype=t.dtype, device=t.device)
                tiles[li] = t[0]
                b = b._replace(wblob=b.wblob.to("meta"), kvblob=(
                    None if b.kvblob is None else b.kvblob.to("meta")))
            layers.append(b)
        blobs = MegakernelBlobs(*(
            torch.cat(f) if torch.is_tensor(f[0]) else f[0]
            for f in zip(*layers)))
        return blobs._replace(tiles=tiles, tiles_grid=grid)

    def _embed(self, tokens, positions, context_lengths=None):
        """Token embeddings (+ learned positions at ``positions`` [B, T],
        then the embedding norm) and, with RoPE, the (cos, sin) of the
        positions for every layer; with GLM's positions (which need the
        true prompt lengths ``context_lengths`` [B]) the (cos, sin) of each
        of the two position rows over half a head."""
        c = self.config
        x = self.vocab_embedding(tokens)
        if c.position_embedding == "learned":
            pos = positions.clamp(0, c.max_position_embeddings - 1)
            x = x + self.position_embedding(pos + c.position_offset)
        if c.embedding_norm:
            x = self.ln_embed(x)
        rotary = None
        if c.position_embedding == "glm_rope":
            if context_lengths is None:
                raise ValueError("GLM positions need context_lengths (the "
                                 "true prompt lengths [B])")
            half = c.head_dim // 2
            rotary = tuple(rope_angles(p, half, c.rotary_base)
                           for p in glm_positions(positions,
                                                  context_lengths))
        elif rotary_dim(c):
            rotary = rope_angles(positions, rotary_dim(c), c.rotary_base)
        return x, rotary

    def forward(self, tokens: torch.Tensor, kv_cache, write_index,
                sequence_length, attention_start=None,
                beam_indirection=None, kv_tail=None, megakernel_blobs=None,
                context_lengths=None) -> Tuple[torch.Tensor, object]:
        """tokens [B, T] (left-padded prompts use ``attention_start`` [B]);
        ``write_index``: the cache column of tokens[:, 0], one for all rows,
        or a [B] tensor of per-row positions (over the stacked cache or the
        paged pool; a prompt over the pool starts at 0); ``sequence_length``:
        the valid length including these
        tokens (an int or a [B] tensor; a single-token step makes an int a
        [B] tensor once for all layers); ``beam_indirection``
        [groups, beams, S] int32 (beam search, a single-token step over the
        stacked cache, rows grouped by group): the physical cache row of
        each (beam, position); ``megakernel_blobs``: a single-token step at
        batch 1 over the stacked cache, without beams, runs through the
        megakernel with them (:class:`..runtime.GenerationSession` packs
        them for an eligible model and passes them where the kernel takes
        the cache); ``context_lengths`` [B]: the true prompt lengths
        (GLM positions only).  Returns (logits [B, T, vocab] fp32,
        kv_cache)."""
        if kv_tail is not None:
            raise NotImplementedError("the K-step tail is not ported")
        if beam_indirection is not None and tokens.shape[1] != 1:
            # beams read the cache or the pool through the table one token
            # a step (an MQA/GQA one is refused by the attention op)
            raise NotImplementedError("beam_indirection is ported for the "
                                      "single-token step")
        if isinstance(kv_cache, PagedCacheState):
            return self._paged_forward(tokens, kv_cache, write_index,
                                       sequence_length, attention_start,
                                       beam_indirection)
        per_row = torch.is_tensor(write_index)
        if not torch.is_tensor(kv_cache) or not (
                per_row or isinstance(write_index, int)):
            raise TypeError("the stacked cache takes an int or a [B] tensor "
                            "write_index")
        c = self.config
        b, t = tokens.shape
        dev = tokens.device
        if (megakernel_blobs is not None and t == 1 and b == 1
                and beam_indirection is None and not per_row):
            return self._megakernel_step(tokens, kv_cache, write_index,
                                         sequence_length, attention_start,
                                         megakernel_blobs)
        base = write_index.reshape(-1, 1).long() if per_row else write_index
        pos = base + torch.arange(t, device=dev)[None, :]
        if attention_start is not None:
            pos = torch.clamp(pos - attention_start[:, None].long(), min=0)
        x, rotary = self._embed(tokens, pos.expand(b, t), context_lengths)
        alibi = None
        if c.position_embedding == "alibi":
            # the bias over the cache's columns, once for every layer
            # (under tensor parallelism the slopes of the rank's heads)
            attn = self.blocks[0].attention
            slopes = alibi_slopes(c.num_heads, dev)[
                :, attn.head_offset:
                attn.head_offset + attn.num_attention_heads]
            alibi = generate_alibi_biases(slopes, kv_cache.shape[-1])
        if t == 1 and alibi is not None:
            # an ALiBi step: each layer writes its column, then attends
            # with the bias (through the beam table where there is one)
            if isinstance(sequence_length, int):
                sequence_length = torch.full((b,), sequence_length,
                                             dtype=torch.int32, device=dev)
            for li, block in enumerate(self.blocks):
                x, kv_cache = block(x, (kv_cache, li), write_index,
                                    sequence_length, attention_start,
                                    beam_indirection, alibi_bias=alibi)
        elif t == 1:
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
                                          attention_start, beam_indirection,
                                          rotary)
                fresh.append(torch.stack([k_new, v_new], dim=1))
            write_fresh_kv(kv_cache, torch.stack(fresh), write_index)
        else:
            for li, block in enumerate(self.blocks):
                x, kv_cache = block(x, (kv_cache, li), write_index,
                                    sequence_length, attention_start,
                                    rotary=rotary, alibi_bias=alibi)
        if c.final_norm:
            x = self.ln_f(x)
        return self._logits(x), kv_cache

    def _megakernel_step(self, tokens, kv_cache, write_index,
                         sequence_length, attention_start, blobs):
        """One token at batch 1 through the megakernel (the JAX model's
        :367-412): the embedded token (its learned position at
        ``write_index`` less the start), every layer in one launch, the
        RoPE angles made inside it from ``write_index`` and the start
        held on the device, then the final norm and the logits here, and
        the fresh K/V written at ``write_index``."""
        from ..ops.decoder_layer import Rotary, fused_decoder_stack
        c = self.config
        x = self.vocab_embedding(tokens)
        if c.position_embedding == "learned":
            pos = write_index + torch.zeros((1, 1), dtype=torch.long,
                                            device=x.device)
            if attention_start is not None:
                pos = torch.clamp(pos - attention_start[:, None].long(), min=0)
            x = x + self.position_embedding(pos + c.position_offset)
        if c.embedding_norm:
            x = self.ln_embed(x)
        # a fill, not a host-to-device copy, which would wait for the stream
        seq1 = (torch.full((1,), sequence_length, dtype=torch.int32,
                           device=x.device)
                if isinstance(sequence_length, int)
                else sequence_length.reshape(-1)[:1])
        rope = (Rotary(write_index, rotary_dim(c), c.rotary_base,
                       c.neox_rotary_style) if rotary_dim(c) else None)
        attn = self.blocks[0].attention
        hid, fresh = fused_decoder_stack(
            x[:, 0, :], blobs, kv_cache, seq1, attn.scale,
            start_index=attention_start, head_dim=c.head_dim,
            eps=c.norm_eps, act=c.hidden_act, norm=c.norm,
            gated=c.gated_mlp, parallel=c.parallel_attn, rope=rope)
        hid = hid[:, None, :]
        if c.final_norm:
            hid = self.ln_f(hid)
        # [L, 2, H, D] -> [L, 1, 2, H, D, 1]
        write_fresh_kv(kv_cache, fresh[:, None, ..., None], write_index)
        return self._logits(hid), kv_cache

    def _paged_forward(self, tokens, state: PagedCacheState, write_index,
                       sequence_length, attention_start, beam_indirection):
        """The paged serving path (the JAX model's ``models/decoder.py``
        :339-360): positions per row from ``write_index``, each layer given
        ``PagedKV(pool, table, layer)`` and, for tokens at per-row positions
        (one a row, or a mixed window), their write slots, found once.  A
        slot that is not live still rides the step at length 0, so its
        position is -1, which the learned embedding clamps (the JAX gather
        wraps or clamps it); its output is discarded by the caller.
        ``attention_start`` [B] (left-padded prompts) moves the positions
        only, to max(column - start, 0) (the JAX model's :308-310): the
        JAX paged branch masks no key below the start, and neither does
        this one.  ``beam_indirection`` [groups, beams, S]: a single-token
        beam step, each layer reading the pool through it.  ALiBi and GLM
        positions raise (the JAX paged branch reads no ALiBi bias, and
        its GLM admission asserts a causal mask)."""
        if self.config.position_embedding in ("alibi", "glm_rope"):
            raise NotImplementedError("ALiBi and GLM positions are not "
                                      "ported for the paged pool")
        c = self.config
        b, t = tokens.shape
        dev = tokens.device
        base = (write_index[:, None].long()
                if torch.is_tensor(write_index) else write_index)
        col = base + torch.arange(t, device=dev)[None, :]
        pos = col
        if attention_start is not None:
            pos = torch.clamp(col - attention_start.to(dev)[:, None].long(),
                              min=0)
        x, rotary = self._embed(tokens, pos.expand(b, t))
        pool, table = state.pool, state.block_table
        slots = None
        if t == 1 or torch.is_tensor(write_index):
            # where each row's tokens land: the same in every layer
            slots = token_slots(table, col.expand(b, t), pool.shape[1] - 1,
                                pool.shape[4])
        for li, block in enumerate(self.blocks):
            x, pool = block(x, PagedKV(pool, table, li, slots), write_index,
                            sequence_length,
                            beam_indirection=beam_indirection,
                            rotary=rotary)
        if c.final_norm:
            x = self.ln_f(x)
        return self._logits(x), PagedCacheState(pool, table)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 logits, sliced to the vocab: tied ones accumulated and
        returned in fp32 (``preferred_element_type=float32``), a separate
        LM head in the activation dtype (with its bias) then cast, as the
        JAX model's :546-557 computes them."""
        c = self.config
        if c.tie_word_embeddings:
            logits = matmul_fp32(x, self.vocab_embedding.weight.t())
            if logits.shape[-1] != c.padded_vocab:
                # vocab-parallel: every rank's rows, in rank order
                logits = collectives.all_gather(logits, self.mapping.tp)
        else:
            logits = self.lm_head(x).float()
        if c.padded_vocab != c.vocab_size:
            logits = logits[..., :c.vocab_size]
        return logits
