"""Model families as config constructors plus HF weight mappers (the JAX
package's ``models/families.py``), for every family it has: GPT-2, LLaMA
(GQA too), OPT, Bloom (ALiBi, the embedding norm), GPT-J, GPT-NeoX,
ChatGLM-6B (GLM positions, the deepnorm residual, the bidirectional
prompt; THUDM's layout, no HF class) and SantaCoder / StarCoder (HF
``gpt_bigcode``, multi-query or not).

Each ``*_config`` builds a :class:`~.decoder.DecoderConfig` from an HF
config object (read by attribute); each ``from_hf_*`` maps an HF state
dict (tensors or arrays) to numpy arrays in the JAX package's stacked
layout (QKV fused head-major [3, H, hd, hidden], or q [H, hd, hidden] and
kv [2, Hkv, hd, hidden] with fewer KV heads), equal to the JAX mapper's
key for key.  No module here imports ``transformers``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .decoder import DecoderConfig


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _stack(per_layer) -> Dict[str, np.ndarray]:
    return {f"blocks.{k}": np.stack([d[k] for d in per_layer], axis=0)
            for k in per_layer[0]}


def _fuse_qkv_headmajor(wq, wk, wv, n_head: int) -> np.ndarray:
    d = wq.shape[1]
    hd = wq.shape[0] // n_head
    return np.stack([w.reshape(n_head, hd, d) for w in (wq, wk, wv)], axis=0)


def _fuse_qkv_bias(bq, bk, bv, n_head: int) -> np.ndarray:
    hd = bq.shape[0] // n_head
    return np.stack([b.reshape(n_head, hd) for b in (bq, bk, bv)], axis=0)


# -- GPT-2 -------------------------------------------------------------------

def gpt2_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        max_position_embeddings=hf_cfg.n_positions,
        position_embedding="learned", hidden_act="gelu",
        norm_eps=hf_cfg.layer_norm_epsilon, dtype=dtype, **kw)


def from_hf_gpt2(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """GPT-2's Conv1D weights are stored [in, out]: transposed to [out,
    in]."""
    def g(k):
        return _np(hf_sd[k if k in hf_sd else "transformer." + k])
    h = config.num_heads
    per_layer = []
    for i in range(config.num_layers):
        p = f"h.{i}." if f"h.{i}.ln_1.weight" in hf_sd else f"transformer.h.{i}."

        def gg(k):
            return _np(hf_sd[p + k])
        wq, wk, wv = np.split(gg("attn.c_attn.weight").T, 3, axis=0)
        bq, bk, bv = np.split(gg("attn.c_attn.bias"), 3, axis=0)
        per_layer.append({
            "input_layernorm.weight": gg("ln_1.weight"),
            "input_layernorm.bias": gg("ln_1.bias"),
            "attention.qkv.weight": _fuse_qkv_headmajor(wq, wk, wv, h),
            "attention.qkv.bias": _fuse_qkv_bias(bq, bk, bv, h),
            "attention.dense.weight": gg("attn.c_proj.weight").T,
            "attention.dense.bias": gg("attn.c_proj.bias"),
            "post_layernorm.weight": gg("ln_2.weight"),
            "post_layernorm.bias": gg("ln_2.bias"),
            "mlp.fc.weight": gg("mlp.c_fc.weight").T,
            "mlp.fc.bias": gg("mlp.c_fc.bias"),
            "mlp.proj.weight": gg("mlp.c_proj.weight").T,
            "mlp.proj.bias": gg("mlp.c_proj.bias"),
        })
    state = {
        "vocab_embedding.weight": g("wte.weight"),
        "position_embedding.weight": g("wpe.weight"),
        "ln_f.weight": g("ln_f.weight"),
        "ln_f.bias": g("ln_f.bias"),
    }
    state.update(_stack(per_layer))
    return state


# -- LLaMA -------------------------------------------------------------------

def llama_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        num_kv_heads=getattr(hf_cfg, "num_key_value_heads", None),
        ffn_hidden_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        position_embedding="rope",
        rotary_base=getattr(hf_cfg, "rope_theta", 10000.0),
        norm="rmsnorm", norm_eps=hf_cfg.rms_norm_eps,
        hidden_act="silu", gated_mlp=True, attn_bias=False, mlp_bias=False,
        tie_word_embeddings=getattr(hf_cfg, "tie_word_embeddings", False),
        dtype=dtype, **kw)


def from_hf_llama(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """The gated MLP computes act(fc(x)) * gate(x): fc <- ``gate_proj``,
    gate <- ``up_proj``.  GQA takes the separate-KV layout."""
    pre = "model." if "model.embed_tokens.weight" in hf_sd else ""

    def g(k):
        return _np(hf_sd[pre + k])
    h = config.num_heads
    hkv, hd = config.num_kv_heads, config.head_dim
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}layers.{i}.{k}"])
        if hkv == h:
            qkv = {"attention.qkv.weight": _fuse_qkv_headmajor(
                gg("self_attn.q_proj.weight"), gg("self_attn.k_proj.weight"),
                gg("self_attn.v_proj.weight"), h)}
        else:
            qkv = {
                "attention.qkv.weight":
                    gg("self_attn.q_proj.weight").reshape(h, hd, -1),
                "attention.qkv.kv_weight": np.stack([
                    gg("self_attn.k_proj.weight").reshape(hkv, hd, -1),
                    gg("self_attn.v_proj.weight").reshape(hkv, hd, -1)],
                    axis=0),
            }
        per_layer.append({
            "input_layernorm.weight": gg("input_layernorm.weight"),
            **qkv,
            "attention.dense.weight": gg("self_attn.o_proj.weight"),
            "post_layernorm.weight": gg("post_attention_layernorm.weight"),
            "mlp.fc.weight": gg("mlp.gate_proj.weight"),
            "mlp.gate.weight": gg("mlp.up_proj.weight"),
            "mlp.proj.weight": gg("mlp.down_proj.weight"),
        })
    state = {
        "vocab_embedding.weight": g("embed_tokens.weight"),
        "ln_f.weight": g("norm.weight"),
    }
    if not config.tie_word_embeddings:
        state["lm_head.weight"] = _np(hf_sd["lm_head.weight"])
    state.update(_stack(per_layer))
    return state


# -- OPT ---------------------------------------------------------------------

def opt_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """Learned positions offset by 2 (OPT's quirk)."""
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        ffn_hidden_size=hf_cfg.ffn_dim,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        position_embedding="learned", position_offset=2,
        hidden_act="relu" if hf_cfg.activation_function == "relu" else
        hf_cfg.activation_function,
        dtype=dtype, **kw)


def from_hf_opt(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    pre = ("model.decoder." if "model.decoder.embed_tokens.weight" in hf_sd
           else "decoder.")

    def g(k):
        return _np(hf_sd[pre + k])
    h = config.num_heads
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}layers.{i}.{k}"])
        per_layer.append({
            "input_layernorm.weight": gg("self_attn_layer_norm.weight"),
            "input_layernorm.bias": gg("self_attn_layer_norm.bias"),
            "attention.qkv.weight": _fuse_qkv_headmajor(
                gg("self_attn.q_proj.weight"), gg("self_attn.k_proj.weight"),
                gg("self_attn.v_proj.weight"), h),
            "attention.qkv.bias": _fuse_qkv_bias(
                gg("self_attn.q_proj.bias"), gg("self_attn.k_proj.bias"),
                gg("self_attn.v_proj.bias"), h),
            "attention.dense.weight": gg("self_attn.out_proj.weight"),
            "attention.dense.bias": gg("self_attn.out_proj.bias"),
            "post_layernorm.weight": gg("final_layer_norm.weight"),
            "post_layernorm.bias": gg("final_layer_norm.bias"),
            "mlp.fc.weight": gg("fc1.weight"),
            "mlp.fc.bias": gg("fc1.bias"),
            "mlp.proj.weight": gg("fc2.weight"),
            "mlp.proj.bias": gg("fc2.bias"),
        })
    state = {
        "vocab_embedding.weight": g("embed_tokens.weight"),
        "position_embedding.weight": g("embed_positions.weight"),
        "ln_f.weight": g("final_layer_norm.weight"),
        "ln_f.bias": g("final_layer_norm.bias"),
    }
    state.update(_stack(per_layer))
    return state


# -- Bloom -------------------------------------------------------------------

def bloom_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """ALiBi positions, a LayerNorm after the embedding, tied embeddings."""
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        max_position_embeddings=2048,
        position_embedding="alibi", embedding_norm=True,
        norm_eps=hf_cfg.layer_norm_epsilon, hidden_act="gelu",
        dtype=dtype, **kw)


def _per_head_qkv(w, b, h: int, hd: int, hidden: int):
    """A QKV packed per head, [H, 3, hd, hidden] rows (Bloom, GPT-NeoX,
    ChatGLM-6B, gpt_bigcode without multi-query) -> [3, H, hd, hidden] and
    its bias [3, H, hd]."""
    return (w.reshape(h, 3, hd, hidden).transpose(1, 0, 2, 3),
            b.reshape(h, 3, hd).transpose(1, 0, 2))


def from_hf_bloom(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """Bloom fuses q, k and v per head."""
    pre = ("transformer." if "transformer.word_embeddings.weight" in hf_sd
           else "")

    def g(k):
        return _np(hf_sd[pre + k])
    h, hd = config.num_heads, config.head_dim
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}h.{i}.{k}"])
        wqkv, bqkv = _per_head_qkv(
            gg("self_attention.query_key_value.weight"),
            gg("self_attention.query_key_value.bias"), h, hd,
            config.hidden_size)
        per_layer.append({
            "input_layernorm.weight": gg("input_layernorm.weight"),
            "input_layernorm.bias": gg("input_layernorm.bias"),
            "attention.qkv.weight": wqkv,
            "attention.qkv.bias": bqkv,
            "attention.dense.weight": gg("self_attention.dense.weight"),
            "attention.dense.bias": gg("self_attention.dense.bias"),
            "post_layernorm.weight": gg("post_attention_layernorm.weight"),
            "post_layernorm.bias": gg("post_attention_layernorm.bias"),
            "mlp.fc.weight": gg("mlp.dense_h_to_4h.weight"),
            "mlp.fc.bias": gg("mlp.dense_h_to_4h.bias"),
            "mlp.proj.weight": gg("mlp.dense_4h_to_h.weight"),
            "mlp.proj.bias": gg("mlp.dense_4h_to_h.bias"),
        })
    state = {
        "vocab_embedding.weight": g("word_embeddings.weight"),
        "ln_embed.weight": g("word_embeddings_layernorm.weight"),
        "ln_embed.bias": g("word_embeddings_layernorm.bias"),
        "ln_f.weight": g("ln_f.weight"),
        "ln_f.bias": g("ln_f.bias"),
    }
    state.update(_stack(per_layer))
    return state


# -- GPT-J -------------------------------------------------------------------

def gptj_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """Interleaved partial RoPE, the parallel residual, a biased separate
    LM head."""
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        max_position_embeddings=hf_cfg.n_positions,
        position_embedding="rope",
        rotary_pct=hf_cfg.rotary_dim / (hf_cfg.n_embd // hf_cfg.n_head),
        neox_rotary_style=False, parallel_attn=True,
        hidden_act="gelu", attn_bias=False, mlp_bias=True,
        tie_word_embeddings=False, lm_head_bias=True,
        norm_eps=hf_cfg.layer_norm_epsilon, dtype=dtype, **kw)


def from_hf_gptj(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    pre = "transformer." if "transformer.wte.weight" in hf_sd else ""

    def g(k):
        return _np(hf_sd[pre + k])
    h = config.num_heads
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}h.{i}.{k}"])
        per_layer.append({
            "input_layernorm.weight": gg("ln_1.weight"),
            "input_layernorm.bias": gg("ln_1.bias"),
            "attention.qkv.weight": _fuse_qkv_headmajor(
                gg("attn.q_proj.weight"), gg("attn.k_proj.weight"),
                gg("attn.v_proj.weight"), h),
            "attention.dense.weight": gg("attn.out_proj.weight"),
            "mlp.fc.weight": gg("mlp.fc_in.weight"),
            "mlp.fc.bias": gg("mlp.fc_in.bias"),
            "mlp.proj.weight": gg("mlp.fc_out.weight"),
            "mlp.proj.bias": gg("mlp.fc_out.bias"),
        })
    state = {
        "vocab_embedding.weight": g("wte.weight"),
        "ln_f.weight": g("ln_f.weight"),
        "ln_f.bias": g("ln_f.bias"),
        "lm_head.weight": _np(hf_sd["lm_head.weight"]),
        "lm_head.bias": _np(hf_sd["lm_head.bias"]),
    }
    state.update(_stack(per_layer))
    return state


# -- GPT-NeoX ----------------------------------------------------------------

def gptneox_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """Partial NeoX-style RoPE, the parallel residual (unless the config
    turns it off), a separate LM head."""
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=hf_cfg.num_hidden_layers,
        num_heads=hf_cfg.num_attention_heads,
        ffn_hidden_size=hf_cfg.intermediate_size,
        max_position_embeddings=hf_cfg.max_position_embeddings,
        position_embedding="rope", rotary_pct=hf_cfg.rotary_pct,
        neox_rotary_style=True,
        parallel_attn=getattr(hf_cfg, "use_parallel_residual", True),
        hidden_act="gelu", tie_word_embeddings=False,
        norm_eps=hf_cfg.layer_norm_eps, dtype=dtype, **kw)


def from_hf_gptneox(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """NeoX fuses q, k and v per head: [H, 3, hd, hidden] -> [3, H, hd,
    hidden]."""
    pre = "gpt_neox." if "gpt_neox.embed_in.weight" in hf_sd else ""

    def g(k):
        return _np(hf_sd[pre + k])
    h, hd = config.num_heads, config.head_dim
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}layers.{i}.{k}"])
        wqkv, bqkv = _per_head_qkv(gg("attention.query_key_value.weight"),
                                   gg("attention.query_key_value.bias"), h,
                                   hd, config.hidden_size)
        d = {
            "input_layernorm.weight": gg("input_layernorm.weight"),
            "input_layernorm.bias": gg("input_layernorm.bias"),
            "attention.qkv.weight": wqkv,
            "attention.qkv.bias": bqkv,
            "attention.dense.weight": gg("attention.dense.weight"),
            "attention.dense.bias": gg("attention.dense.bias"),
            "mlp.fc.weight": gg("mlp.dense_h_to_4h.weight"),
            "mlp.fc.bias": gg("mlp.dense_h_to_4h.bias"),
            "mlp.proj.weight": gg("mlp.dense_4h_to_h.weight"),
            "mlp.proj.bias": gg("mlp.dense_4h_to_h.bias"),
        }
        if not config.parallel_attn:
            d["post_layernorm.weight"] = gg("post_attention_layernorm.weight")
            d["post_layernorm.bias"] = gg("post_attention_layernorm.bias")
        per_layer.append(d)
    state = {
        "vocab_embedding.weight": g("embed_in.weight"),
        "ln_f.weight": g("final_layer_norm.weight"),
        "ln_f.bias": g("final_layer_norm.bias"),
        "lm_head.weight": _np(hf_sd["embed_out.weight"]),
    }
    state.update(_stack(per_layer))
    return state


# -- ChatGLM-6B --------------------------------------------------------------

def chatglm6b_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """THUDM/chatglm-6b: GLM's two-dimensional rotary over half a head per
    position row, the deepnorm residual with alpha (2 num_layers) ** 0.5,
    the bidirectional prompt, erf GELU, a separate LM head (the config
    read by attribute: ``num_layers``, ``inner_hidden_size``,
    ``max_sequence_length``, ``layernorm_epsilon``)."""
    n_layer = getattr(hf_cfg, "num_layers",
                      getattr(hf_cfg, "num_hidden_layers", None))
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.hidden_size,
        num_layers=n_layer, num_heads=hf_cfg.num_attention_heads,
        ffn_hidden_size=getattr(hf_cfg, "inner_hidden_size",
                                4 * hf_cfg.hidden_size),
        max_position_embeddings=getattr(hf_cfg, "max_sequence_length",
                                        2048),
        position_embedding="glm_rope", deepnorm_alpha=(2 * n_layer) ** 0.5,
        bidirectional_context=True, hidden_act="gelu_exact",
        tie_word_embeddings=False,
        norm_eps=getattr(hf_cfg, "layernorm_epsilon", 1e-5),
        dtype=dtype, **kw)


def from_hf_chatglm6b(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """THUDM's layout: ``query_key_value`` packed per head, [H, 3, hd]
    rows."""
    pre = ("transformer." if "transformer.word_embeddings.weight" in hf_sd
           else "")

    def g(k):
        return _np(hf_sd[pre + k])
    h, hd = config.num_heads, config.head_dim
    per_layer = []
    for i in range(config.num_layers):
        def gg(k):
            return _np(hf_sd[f"{pre}layers.{i}.{k}"])
        wqkv, bqkv = _per_head_qkv(gg("attention.query_key_value.weight"),
                                   gg("attention.query_key_value.bias"), h,
                                   hd, config.hidden_size)
        per_layer.append({
            "input_layernorm.weight": gg("input_layernorm.weight"),
            "input_layernorm.bias": gg("input_layernorm.bias"),
            "attention.qkv.weight": wqkv,
            "attention.qkv.bias": bqkv,
            "attention.dense.weight": gg("attention.dense.weight"),
            "attention.dense.bias": gg("attention.dense.bias"),
            "post_layernorm.weight": gg("post_attention_layernorm.weight"),
            "post_layernorm.bias": gg("post_attention_layernorm.bias"),
            "mlp.fc.weight": gg("mlp.dense_h_to_4h.weight"),
            "mlp.fc.bias": gg("mlp.dense_h_to_4h.bias"),
            "mlp.proj.weight": gg("mlp.dense_4h_to_h.weight"),
            "mlp.proj.bias": gg("mlp.dense_4h_to_h.bias"),
        })
    state = {
        "vocab_embedding.weight": g("word_embeddings.weight"),
        "ln_f.weight": g("final_layernorm.weight"),
        "ln_f.bias": g("final_layernorm.bias"),
        "lm_head.weight": _np(hf_sd["lm_head.weight"]),
    }
    state.update(_stack(per_layer))
    return state


# -- SantaCoder / StarCoder (gpt_bigcode) --------------------------------------

def santacoder_config(hf_cfg, dtype: str = "bfloat16", **kw) -> DecoderConfig:
    """GPT-2 topology with multi-query attention (HF ``gpt_bigcode``, which
    covers SantaCoder and StarCoder)."""
    return DecoderConfig(
        vocab_size=hf_cfg.vocab_size, hidden_size=hf_cfg.n_embd,
        num_layers=hf_cfg.n_layer, num_heads=hf_cfg.n_head,
        num_kv_heads=1 if getattr(hf_cfg, "multi_query", True) else None,
        max_position_embeddings=hf_cfg.n_positions,
        position_embedding="learned", hidden_act="gelu",
        norm_eps=hf_cfg.layer_norm_epsilon, dtype=dtype, **kw)


def from_hf_santacoder(hf_sd, config: DecoderConfig) -> Dict[str, np.ndarray]:
    """HF GPTBigCode state dict -> the JAX package's ``DecoderLMHead``
    layout (numpy, stacked).  Plain nn.Linear weights ([out, in], no GPT-2
    Conv1D transpose).  Multi-query: c_attn rows are [H*D query | D key | D
    value], the separate-KV layout.  Without multi-query HF packs q, k and
    v per head, [H, 3, D] rows (``GPTBigCodeAttention`` views c_attn's
    output as [.., H, 3 D]), the fused layout; the JAX mapper's [q | k | v]
    split does not follow HF there, so this one is held against HF."""

    def g(k):
        return _np(hf_sd[k if k in hf_sd else "transformer." + k])
    h, hd = config.num_heads, config.head_dim
    per_layer = []
    for i in range(config.num_layers):
        p = f"h.{i}." if f"h.{i}.ln_1.weight" in hf_sd else f"transformer.h.{i}."

        def gg(k):
            return _np(hf_sd[p + k])
        w = gg("attn.c_attn.weight")
        bb = gg("attn.c_attn.bias")
        d = {
            "input_layernorm.weight": gg("ln_1.weight"),
            "input_layernorm.bias": gg("ln_1.bias"),
            "attention.dense.weight": gg("attn.c_proj.weight"),
            "attention.dense.bias": gg("attn.c_proj.bias"),
            "post_layernorm.weight": gg("ln_2.weight"),
            "post_layernorm.bias": gg("ln_2.bias"),
            "mlp.fc.weight": gg("mlp.c_fc.weight"),
            "mlp.fc.bias": gg("mlp.c_fc.bias"),
            "mlp.proj.weight": gg("mlp.c_proj.weight"),
            "mlp.proj.bias": gg("mlp.c_proj.bias"),
        }
        if config.num_kv_heads == h:
            d["attention.qkv.weight"], d["attention.qkv.bias"] = \
                _per_head_qkv(w, bb, h, hd, config.hidden_size)
        else:
            # the separate-KV layout: q [H, hd, dm] + kv [2, 1, hd, dm]
            d["attention.qkv.weight"] = w[:h * hd].reshape(h, hd, -1)
            d["attention.qkv.kv_weight"] = w[h * hd:].reshape(2, 1, hd, -1)
            d["attention.qkv.bias"] = bb[:h * hd].reshape(h, hd)
            d["attention.qkv.kv_bias"] = bb[h * hd:].reshape(2, 1, hd)
        per_layer.append(d)
    state = {
        "vocab_embedding.weight": g("wte.weight"),
        "position_embedding.weight": g("wpe.weight"),
        "ln_f.weight": g("ln_f.weight"),
        "ln_f.bias": g("ln_f.bias"),
    }
    state.update(_stack(per_layer))
    return state


FAMILIES = {
    "gpt2": (gpt2_config, from_hf_gpt2),
    "santacoder": (santacoder_config, from_hf_santacoder),
    "gpt_bigcode": (santacoder_config, from_hf_santacoder),
    "starcoder": (santacoder_config, from_hf_santacoder),
    "llama": (llama_config, from_hf_llama),
    "opt": (opt_config, from_hf_opt),
    "bloom": (bloom_config, from_hf_bloom),
    "chatglm6b": (chatglm6b_config, from_hf_chatglm6b),
    "gptj": (gptj_config, from_hf_gptj),
    "gptneox": (gptneox_config, from_hf_gptneox),
}


def pad_vocab_state(state: Dict[str, np.ndarray], config: DecoderConfig
                    ) -> Dict[str, np.ndarray]:
    """The vocab rows of the embedding, the LM head and its bias zero-padded
    to ``config.padded_vocab`` (the logits are sliced back in the model)."""
    pad = config.padded_vocab - config.vocab_size
    if not pad:
        return state
    state = dict(state)
    for key in ("vocab_embedding.weight", "lm_head.weight", "lm_head.bias"):
        w = state.get(key)
        if w is not None and w.shape[0] == config.vocab_size:
            state[key] = np.concatenate(
                [w, np.zeros((pad,) + w.shape[1:], w.dtype)], axis=0)
    return state


def build_from_hf(family: str, hf_model, dtype: str = "float32",
                  device=None, mapping=None, **kw):
    """(the port's ``DecoderLMHead`` with the weights of ``hf_model``, its
    ``DecoderConfig``): any object with the HF ``config`` attribute and
    ``state_dict()`` (a transformers model, not imported here), mapped by
    the family's mapper and quantised for ``kw``'s ``quant_mode``.  Runs on
    the CUDA card unless ``device`` says otherwise; ``mapping``: this
    rank's tensor-parallel shard."""
    from .decoder_convert import from_jax_state, quantize_state
    if family not in FAMILIES:
        raise NotImplementedError(f"family {family!r} is not ported")
    cfg_fn, map_fn = FAMILIES[family]
    config = cfg_fn(hf_model.config, dtype=dtype, **kw)
    state = pad_vocab_state(map_fn(hf_model.state_dict(), config), config)
    return from_jax_state(quantize_state(state, config), config,
                          device=device, mapping=mapping), config
