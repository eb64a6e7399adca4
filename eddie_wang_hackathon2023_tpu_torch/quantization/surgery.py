"""Offline quantisation of numpy state dicts (the state-dict half of the
JAX package's ``quantization/surgery.py``).

The JAX package swaps modules and transforms the state dict in one step;
the port's modules are built for a recipe directly
(``models/whisper/convert.py``), so here only the state transform
remains.  It walks the given linear paths of a stacked state dict
(``"blocks.attn.qkv"`` -> ``"blocks.attn.qkv.weight"`` [L, ...]).  The
arithmetic is the JAX package's numpy code, unchanged, so the outputs are
bit-equal.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np

from ..ops.quant_matmul import quantize_weights_int8
from .mode import QuantMode


def _flatten_qkv(path: str, w: np.ndarray, kv=None) -> np.ndarray:
    """A fused head-major QKV weight [*lead, 3, H, hd, in] becomes
    [*lead, 3*H*hd, in]; a separate-KV one (MQA/GQA: q [*lead, H, hd, in]
    and ``kv`` [*lead, 2, Hkv, hd, in]) becomes the q rows then the k and v
    rows, [*lead, (H + 2*Hkv)*hd, in] (the JAX package's
    ``surgery.py:291-301``); other weights [*lead, out, in] pass through."""
    if not path.endswith("qkv"):
        return w
    if kv is not None:
        lead = w.shape[:w.ndim - 3]
        in_f = w.shape[-1]
        return np.concatenate([w.reshape(lead + (-1, in_f)),
                               np.asarray(kv, np.float32).reshape(
                                   lead + (-1, in_f))], axis=-2)
    lead_ndim = w.ndim - 4
    three, h, hd, in_f = w.shape[lead_ndim:]
    return w.reshape(w.shape[:lead_ndim] + (three * h * hd, in_f))


def _quantize_stacked(w: np.ndarray, lead_ndim: int):
    """w [*lead, out, in] -> (q [*lead, in, out] int8, scales [*lead, out])."""
    lead = w.shape[:lead_ndim]
    out_f, in_f = w.shape[lead_ndim], w.shape[lead_ndim + 1]
    flat = w.reshape(-1, out_f, in_f)
    qs, ss = zip(*(quantize_weights_int8(np.ascontiguousarray(m.T))
                   for m in flat))
    q = np.stack(qs, 0).reshape(lead + qs[0].shape)
    s = np.stack(ss, 0).reshape(lead + ss[0].shape)
    return q, s


def weight_only_quantize_state(state: Dict[str, np.ndarray],
                               paths: Iterable[str],
                               quant_mode: QuantMode
                               ) -> Dict[str, np.ndarray]:
    """int8 weight-only: every ``<path>.weight`` becomes ``<path>.qweight``
    [*lead, in, out] int8 + ``<path>.per_channel_scale`` [*lead, out] (a
    separate-KV QKV's ``kv_weight`` joins its columns; ``kv_bias`` stays)."""
    if not quant_mode.is_int8_weight_only():
        raise NotImplementedError(f"{quant_mode!r}: only int8 weight-only "
                                  "is ported")
    out = dict(state)
    for path in paths:
        key = f"{path}.weight"
        if key not in out:
            continue
        w = _flatten_qkv(path, np.asarray(out.pop(key), np.float32),
                         out.pop(f"{path}.kv_weight", None))
        q, s = _quantize_stacked(w, w.ndim - 2)
        out[f"{path}.qweight"] = q
        out[f"{path}.per_channel_scale"] = s
    return out


def _sq_quantize_stacked(w: np.ndarray, lead_ndim: int, per_channel: bool):
    """w [*lead, out, in] -> (q [*lead, in, out] int8, step [*lead, out|1])."""
    lead = w.shape[:lead_ndim]
    out_f, in_f = w.shape[lead_ndim], w.shape[lead_ndim + 1]
    flat = w.reshape(-1, out_f, in_f)
    qs, ss = [], []
    for m in flat:
        wt = np.ascontiguousarray(m.T.astype(np.float32))     # [in, out]
        axis = 0 if per_channel else None
        amax = np.max(np.abs(wt), axis=axis, keepdims=False)
        step = np.maximum(amax, 1e-8) / 127.0
        q = np.clip(np.round(wt / step), -127, 127).astype(np.int8)
        qs.append(q)
        ss.append(np.atleast_1d(step).astype(np.float32))
    q = np.stack(qs, 0).reshape(lead + qs[0].shape)
    s = np.stack(ss, 0).reshape(lead + ss[0].shape)
    return q, s


def smooth_quantize_state_dict(state: Dict[str, np.ndarray],
                               paths: Iterable[str],
                               quant_mode: QuantMode
                               ) -> Dict[str, np.ndarray]:
    """SmoothQuant W8A8 weights: every ``<path>.weight`` becomes int8
    ``<path>.qweight`` + step ``<path>.per_channel_scale`` (and a unit
    ``<path>.act_scale`` for static activation scaling).  The JAX
    function's optional smoothing by calibrated activation ranges is not
    ported: the Whisper recipe runs without it."""
    if not quant_mode.has_act_and_weight_quant():
        raise ValueError(f"{quant_mode!r} is not a SmoothQuant mode")
    per_channel = quant_mode.has_per_channel_scaling()
    out = dict(state)
    for path in paths:
        key = f"{path}.weight"
        if key not in out:
            continue
        w = _flatten_qkv(path, np.asarray(out.pop(key), np.float32))
        q, s = _sq_quantize_stacked(w, w.ndim - 2, per_channel)
        out[f"{path}.qweight"] = q
        out[f"{path}.per_channel_scale"] = s
        if not quant_mode.has_per_token_dynamic_scaling():
            out.setdefault(f"{path}.act_scale", np.ones((1,), np.float32))
    return out
