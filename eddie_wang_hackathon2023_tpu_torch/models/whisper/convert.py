"""Whisper checkpoint conversion and recipe assembly.

* ``encoder_state_dict`` / ``decoder_state_dict`` / ``cross_kv_state_dict``
  and ``hf_to_openai_state_dict``: copies of the JAX package's numpy
  converters, giving state dicts in the JAX package's layout (per-layer
  tensors stacked [n_layer, ...], head-major fused QKV with a zero K bias).
* ``quantize_states``: the bench recipe (``woq8+ckv8+lmq8+sqenc``, and
  ``woq4`` and ``kv8``) applied to such state dicts with the port's own
  quantisers.
* ``from_jax_state``: state dicts in that layout (float, or already
  quantised by either package's surgery) -> the port's modules, on a
  device.  Both packages then compute with identical int8 (or int4)
  weights and scales.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..._utils import resolve_device
from ...functional import sinusoids
from ...quantization.mode import QuantMode
from ...quantization.surgery import (smooth_quantize_state_dict,
                                     weight_only_quantize_state)
from .._state import unstack_blocks
from .config import WhisperConfig
from .model import (DECODER_LINEARS, ENCODER_LINEARS, CrossAttnKV,
                    WhisperDecoder, WhisperEncoder, quantize_lm_head_state)

BENCH_RECIPE = "woq8+ckv8+lmq8+sqenc"


class Recipe(NamedTuple):
    """A "+"-joined recipe string as bench.py reads it: ``woq8`` int8
    weight-only decoder (and encoder, unless ``sqenc``), ``woq4`` the same
    with int4 weights (groups of INT4_GROUP_SIZE rows where the
    in-features allow; it wins over ``woq8``), ``sqenc`` SmoothQuant W8A8
    encoder (per token, per channel), ``kv8`` int8 decoder self-KV cache
    with calibrated per-layer scales, ``ckv8`` static int8 cross-KV,
    ``lmq8`` int8 lm_head."""
    encoder: QuantMode
    decoder: QuantMode
    lm_head: bool
    ckv8: bool

    @staticmethod
    def parse(recipe: str) -> "Recipe":
        parts = set(p for p in recipe.split("+") if p and p not in
                    ("none", "bf16"))
        unknown = parts - {"woq8", "woq4", "kv8", "ckv8", "lmq8", "sqenc"}
        if unknown:
            raise NotImplementedError(f"recipe parts {sorted(unknown)} are "
                                      "not ported")
        weights = (QuantMode.use_weight_only(use_int4_weights="woq4" in parts)
                   if parts & {"woq8", "woq4"} else QuantMode(0))
        # the self-KV cache is the decoder's; the encoder keeps none
        dec = (weights.set_int8_kv_cache() if "kv8" in parts else weights)
        enc = (QuantMode.use_smooth_quant(per_token=True, per_channel=True)
               if "sqenc" in parts else weights)
        return Recipe(enc, dec, "lmq8" in parts, "ckv8" in parts)


def _np(t):
    if hasattr(t, "detach"):
        t = t.detach().cpu().float().numpy()
    return np.asarray(t, dtype=np.float32)


def _fuse_qkv(wq, wk, wv, bq, bv, n_head: int):
    d = wq.shape[1]
    hd = wq.shape[0] // n_head
    w = np.stack([wq.reshape(n_head, hd, d), wk.reshape(n_head, hd, d),
                  wv.reshape(n_head, hd, d)], axis=0)
    b = np.stack([bq.reshape(n_head, hd),
                  np.zeros_like(bq).reshape(n_head, hd),  # zero K bias
                  bv.reshape(n_head, hd)], axis=0)
    return w, b


def _block_state(sd, prefix: str, n_head: int, cross: bool):
    def g(k):
        return _np(sd[prefix + k])
    w, b = _fuse_qkv(g("attn.query.weight"), g("attn.key.weight"),
                     g("attn.value.weight"), g("attn.query.bias"),
                     g("attn.value.bias"), n_head)
    out = {
        "attn_ln.weight": g("attn_ln.weight"),
        "attn_ln.bias": g("attn_ln.bias"),
        "attn.qkv.weight": w,
        "attn.qkv.bias": b,
        "attn.dense.weight": g("attn.out.weight"),
        "attn.dense.bias": g("attn.out.bias"),
        "mlp_ln.weight": g("mlp_ln.weight"),
        "mlp_ln.bias": g("mlp_ln.bias"),
        "mlp1.weight": g("mlp.0.weight"),
        "mlp1.bias": g("mlp.0.bias"),
        "mlp2.weight": g("mlp.2.weight"),
        "mlp2.bias": g("mlp.2.bias"),
    }
    if cross:
        out.update({
            "cross_attn_ln.weight": g("cross_attn_ln.weight"),
            "cross_attn_ln.bias": g("cross_attn_ln.bias"),
            "cross_attn.q_linear.weight": g("cross_attn.query.weight"),
            "cross_attn.q_linear.bias": g("cross_attn.query.bias"),
            "cross_attn.dense.weight": g("cross_attn.out.weight"),
            "cross_attn.dense.bias": g("cross_attn.out.bias"),
        })
    return out


def _stack_blocks(per_layer):
    keys = per_layer[0].keys()
    return {k: np.stack([bl[k] for bl in per_layer], axis=0) for k in keys}


def encoder_state_dict(sd, config: WhisperConfig) -> Dict[str, np.ndarray]:
    c = config
    if "encoder.positional_embedding" in sd:
        pos = _np(sd["encoder.positional_embedding"])
    else:
        pos = sinusoids(c.n_audio_ctx, c.n_audio_state)
    blocks = _stack_blocks([
        _block_state(sd, f"encoder.blocks.{i}.", c.n_audio_head, cross=False)
        for i in range(c.n_audio_layer)])
    state = {
        "conv1.weight": _np(sd["encoder.conv1.weight"]),
        "conv1.bias": _np(sd["encoder.conv1.bias"]),
        "conv2.weight": _np(sd["encoder.conv2.weight"]),
        "conv2.bias": _np(sd["encoder.conv2.bias"]),
        "positional_embedding": pos,
        "ln_post.weight": _np(sd["encoder.ln_post.weight"]),
        "ln_post.bias": _np(sd["encoder.ln_post.bias"]),
    }
    state.update({f"blocks.{k}": v for k, v in blocks.items()})
    return state


def decoder_state_dict(sd, config: WhisperConfig,
                       int8_kv_scales=None) -> Dict[str, np.ndarray]:
    """``int8_kv_scales``: optional [n_layer] per-layer dequantise steps
    of the int8 self cache (``calibrate_int8_kv``: amax / 127), or the
    e4m3 self cache's scales (``quantization.fp8_layers.
    fp8_scales_from_amax`` of the same amax), stored as ``1 / t`` and ``t``
    under the attention's ``kv_orig_quant_scale`` and
    ``kv_quant_orig_scale``, [n_layer, 1] each."""
    c = config
    blocks = _stack_blocks([
        _block_state(sd, f"decoder.blocks.{i}.", c.n_text_head, cross=True)
        for i in range(c.n_text_layer)])
    emb = _np(sd["decoder.token_embedding.weight"])
    if c.padded_vocab != emb.shape[0]:
        emb = np.concatenate(
            [emb, np.zeros((c.padded_vocab - emb.shape[0], emb.shape[1]),
                           emb.dtype)], axis=0)
    state = {
        "token_embedding.weight": emb,
        "positional_embedding": _np(sd["decoder.positional_embedding"]),
        "ln.weight": _np(sd["decoder.ln.weight"]),
        "ln.bias": _np(sd["decoder.ln.bias"]),
    }
    state.update({f"blocks.{k}": v for k, v in blocks.items()})
    if int8_kv_scales is not None:
        t = np.asarray(int8_kv_scales, np.float32).reshape(c.n_text_layer, 1)
        state["blocks.attn.kv_orig_quant_scale"] = 1.0 / t
        state["blocks.attn.kv_quant_orig_scale"] = t
    return state


def cross_kv_state_dict(sd, config: WhisperConfig) -> Dict[str, np.ndarray]:
    c = config
    per_layer = []
    for i in range(c.n_text_layer):
        p = f"decoder.blocks.{i}.cross_attn."
        per_layer.append({
            "k_linear.weight": _np(sd[p + "key.weight"]),
            "v_linear.weight": _np(sd[p + "value.weight"]),
            "v_linear.bias": _np(sd[p + "value.bias"]),
        })
    return {f"blocks.{k}": v for k, v in _stack_blocks(per_layer).items()}


_HF_BLOCK_MAP = {
    "self_attn.q_proj": "attn.query",
    "self_attn.k_proj": "attn.key",
    "self_attn.v_proj": "attn.value",
    "self_attn.out_proj": "attn.out",
    "self_attn_layer_norm": "attn_ln",
    "encoder_attn.q_proj": "cross_attn.query",
    "encoder_attn.k_proj": "cross_attn.key",
    "encoder_attn.v_proj": "cross_attn.value",
    "encoder_attn.out_proj": "cross_attn.out",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "fc1": "mlp.0",
    "fc2": "mlp.2",
    "final_layer_norm": "mlp_ln",
}


def hf_to_openai_state_dict(hf_sd) -> Dict[str, np.ndarray]:
    """Map a transformers Whisper state dict to OpenAI naming."""
    out = {}
    for k, v in hf_sd.items():
        k = k.replace("model.", "", 1) if k.startswith("model.") else k
        if k == "proj_out.weight":
            continue  # tied to decoder.embed_tokens
        nk = None
        if k.startswith("encoder.conv") or k.startswith("encoder.layer_norm"):
            nk = k.replace("encoder.layer_norm", "encoder.ln_post")
        elif k == "encoder.embed_positions.weight":
            nk = "encoder.positional_embedding"
        elif k == "decoder.embed_positions.weight":
            nk = "decoder.positional_embedding"
        elif k == "decoder.embed_tokens.weight":
            nk = "decoder.token_embedding.weight"
        elif k.startswith("decoder.layer_norm"):
            nk = k.replace("decoder.layer_norm", "decoder.ln")
        elif ".layers." in k:
            side, rest = k.split(".layers.", 1)
            idx, sub = rest.split(".", 1)
            for hf_name, oa_name in _HF_BLOCK_MAP.items():
                if sub.startswith(hf_name + "."):
                    suffix = sub[len(hf_name) + 1:]
                    nk = f"{side}.blocks.{idx}.{oa_name}.{suffix}"
                    break
        else:
            nk = k
        if nk is not None:
            out[nk] = _np(v)
    return out


def quantize_states(enc_sd, dec_sd, ckv_sd, recipe: str = BENCH_RECIPE,
                    ckv_scales: Optional[np.ndarray] = None
                    ) -> Tuple[dict, dict, dict]:
    """Float state dicts (JAX layout) -> the recipe's quantised ones, as
    the JAX package's examples/whisper/wer_matrix.py builds them.  ``ckv8``
    needs the calibrated per-layer ``ckv_scales``
    (quantization.calibration.calibrate_cross_kv_scales); ``kv8`` needs the
    self-KV scales in ``dec_sd``, put there by
    ``decoder_state_dict(int8_kv_scales=)`` (from
    quantization.calibration.calibrate_int8_kv), and passes them through."""
    r = Recipe.parse(recipe)
    if (r.decoder.has_int8_kv_cache()
            and "blocks.attn.kv_orig_quant_scale" not in dec_sd):
        raise ValueError("kv8 needs calibrated self-KV scales: "
                         "decoder_state_dict(int8_kv_scales=)")
    enc_sd, dec_sd, ckv_sd = dict(enc_sd), dict(dec_sd), dict(ckv_sd)
    if r.decoder.is_weight_only():
        dec_sd = weight_only_quantize_state(dec_sd, DECODER_LINEARS,
                                            r.decoder)
    if r.encoder.is_weight_only():
        enc_sd = weight_only_quantize_state(enc_sd, ENCODER_LINEARS,
                                            r.encoder)
    elif r.encoder.has_act_and_weight_quant():
        enc_sd = smooth_quantize_state_dict(enc_sd, ENCODER_LINEARS,
                                            r.encoder)
    if r.lm_head:
        dec_sd = quantize_lm_head_state(dec_sd)
    if r.ckv8:
        if ckv_scales is None:
            raise ValueError("ckv8 needs calibrated cross-KV scales")
        ckv_sd["kv_scale"] = np.asarray(ckv_scales, np.float32)
    return enc_sd, dec_sd, ckv_sd


def from_jax_state(enc_state, dec_state, ckv_state, config: WhisperConfig,
                   recipe: str = "", device=None
                   ) -> Tuple[WhisperEncoder, WhisperDecoder, CrossAttnKV]:
    """Build the port's (encoder, decoder, cross-KV) modules from state
    dicts in the JAX package's layout, quantised for ``recipe`` (by
    :func:`quantize_states` or by the JAX package's surgery).  Runs on the
    CUDA card unless ``device`` says otherwise."""
    device = resolve_device(device)
    r = Recipe.parse(recipe)
    with torch.device(device):
        enc = WhisperEncoder(config, r.encoder)
        dec = WhisperDecoder(config, r.decoder, quantize_lm_head=r.lm_head)
    enc.load_state_dict(unstack_blocks(enc_state))
    dec.load_state_dict(unstack_blocks(dec_state))
    ckv = cross_kv_from_jax_state(ckv_state, config, recipe, device)
    return enc.eval(), dec.eval(), ckv


def cross_kv_from_jax_state(ckv_state, config: WhisperConfig,
                            recipe: str = "", device=None) -> CrossAttnKV:
    """The cross-KV module alone (see :func:`from_jax_state`); with
    ``ckv8`` the state holds the calibrated ``kv_scale``."""
    device = resolve_device(device)
    r = Recipe.parse(recipe)
    with torch.device(device):
        ckv = CrossAttnKV(config, int8_output=r.ckv8)
    ckv_t = {
        "kv_weight": torch.from_numpy(np.stack(
            [np.asarray(ckv_state["blocks.k_linear.weight"], np.float32),
             np.asarray(ckv_state["blocks.v_linear.weight"], np.float32)],
            axis=1)),
        "v_bias": torch.from_numpy(
            np.asarray(ckv_state["blocks.v_linear.bias"], np.float32)),
    }
    if r.ckv8:
        ckv_t["kv_scale"] = torch.from_numpy(
            np.asarray(ckv_state["kv_scale"], np.float32))
    ckv.load_state_dict(ckv_t)
    return ckv.eval()
