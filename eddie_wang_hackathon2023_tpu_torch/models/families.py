"""Model families as config constructors plus HF weight mappers (the JAX
package's ``models/families.py``), for the family this port runs:
SantaCoder / StarCoder (HF ``gpt_bigcode``, multi-query).  The others
wait."""
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
    """HF GPTBigCode state dict (multi-query) -> the JAX package's
    ``DecoderLMHead`` layout (numpy, stacked).  Plain nn.Linear weights
    ([out, in], no GPT-2 Conv1D transpose); c_attn rows are [H*D query | D
    key | D value].  Without multi-query HF interleaves q, k and v per head,
    which the JAX mapper's [q | k | v] split does not follow: not ported."""
    if config.num_kv_heads != 1:
        raise NotImplementedError("gpt_bigcode without multi_query is not "
                                  "ported")

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
