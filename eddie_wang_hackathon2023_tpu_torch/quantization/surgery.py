"""Offline quantisation of numpy state dicts (the state-dict half of the
JAX package's ``quantization/surgery.py``).

The JAX package swaps modules and transforms the state dict in one step;
the port's modules are built for a recipe directly
(``models/whisper/convert.py``), so here only the state transform
remains.  It walks the given linear paths of a stacked state dict
(``"blocks.attn.qkv"`` -> ``"blocks.attn.qkv.weight"`` [L, ...]).  The
arithmetic is the JAX package's numpy code, unchanged, so the outputs are
bit-equal.  The int4 group size is the JAX package's default,
:data:`..ops.quant_matmul.INT4_GROUP_SIZE` (its plugin knob is not ported).
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np

from ..ops.quant_matmul import (INT4_GROUP_SIZE, quantize_weights_int4,
                                quantize_weights_int8)
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


def _quantize_stacked(w: np.ndarray, lead_ndim: int, bits: int = 8,
                      group_size: int = 0):
    """w [*lead, out, in] -> (q [*lead, in(, /2), out] int8,
    scales [*lead, out] or [*lead, in/G, out] when grouped)."""
    lead = w.shape[:lead_ndim]
    out_f, in_f = w.shape[lead_ndim], w.shape[lead_ndim + 1]
    flat = w.reshape(-1, out_f, in_f)
    if bits == 8:
        qfn = quantize_weights_int8
    else:
        def qfn(m):
            return quantize_weights_int4(m, group_size=group_size or None)
    qs, ss = zip(*(qfn(np.ascontiguousarray(m.T)) for m in flat))
    q = np.stack(qs, 0).reshape(lead + qs[0].shape)
    s = np.stack(ss, 0).reshape(lead + ss[0].shape)
    return q, s


def int4_group(quant_mode: QuantMode, in_features: int) -> int:
    """The int4 group size of a linear with ``in_features`` (the JAX
    package's ``_int4_group``): INT4_GROUP_SIZE where it divides the
    in-features, else 0 (per-channel scales, as tiny models fall back);
    0 for every mode but int4 weight-only."""
    if not quant_mode.is_int4_weight_only():
        return 0
    return INT4_GROUP_SIZE if in_features % INT4_GROUP_SIZE == 0 else 0


def weight_only_quantize_state(state: Dict[str, np.ndarray],
                               paths: Iterable[str],
                               quant_mode: QuantMode
                               ) -> Dict[str, np.ndarray]:
    """int8 or int4 weight-only: every ``<path>.weight`` becomes
    ``<path>.qweight`` (int8 [*lead, in, out]; int4 packed [*lead, in/2,
    out]) + ``<path>.per_channel_scale`` ([*lead, out]; int4 with groups
    [*lead, in/G, out], G from the path's own in-features) (a separate-KV
    QKV's ``kv_weight`` joins its columns; ``kv_bias`` stays)."""
    if not quant_mode.is_weight_only():
        raise ValueError(f"{quant_mode!r} is not a weight-only mode")
    bits = 4 if quant_mode.is_int4_weight_only() else 8
    out = dict(state)
    for path in paths:
        key = f"{path}.weight"
        if key not in out:
            continue
        w = _flatten_qkv(path, np.asarray(out.pop(key), np.float32),
                         out.pop(f"{path}.kv_weight", None))
        q, s = _quantize_stacked(w, w.ndim - 2, bits,
                                 int4_group(quant_mode, w.shape[-1]))
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


def _smooth_stacked(w: np.ndarray, act, lw, lb, alpha: float):
    """The smoothing of :func:`smooth_quantize_state_dict` for one linear:
    ``w`` [*lead, out, in], its activations' amax ``act`` ([in], shared by
    the layers, or [*lead, in]), its LayerNorm's weight and bias (or None)
    -> (w, lw, lb) smoothed, per layer when stacked (a scale a layer, as
    a linear of its own would get)."""
    from .smoothquant_layers import smooth_gemm
    lead_ndim = w.ndim - 2
    act = np.asarray(act, np.float32)
    if lead_ndim == 0:
        _, sm = smooth_gemm(w, act, lw, lb, alpha=alpha)
        return (sm["gemm_weight"], sm.get("layernorm_weight"),
                sm.get("layernorm_bias"))
    wf = w.reshape((-1,) + w.shape[lead_ndim:])
    n = wf.shape[0]
    actf = (np.broadcast_to(act, (n, wf.shape[-1])) if act.ndim <= 1
            else act.reshape(n, wf.shape[-1]))
    lwf = None if lw is None else np.asarray(lw, np.float32).reshape(n, -1)
    lbf = None if lb is None else np.asarray(lb, np.float32).reshape(n, -1)
    rows, lws, lbs = [], [], []
    for i in range(n):
        _, sm = smooth_gemm(wf[i], actf[i],
                            None if lwf is None else lwf[i],
                            None if lbf is None else lbf[i], alpha=alpha)
        rows.append(sm["gemm_weight"])
        if lwf is not None:
            lws.append(sm["layernorm_weight"])
        if lbf is not None:
            lbs.append(sm["layernorm_bias"])
    w = np.stack(rows, 0).reshape(w.shape)
    lw = None if lwf is None else np.stack(lws, 0).reshape(np.shape(lw))
    lb = None if lbf is None else np.stack(lbs, 0).reshape(np.shape(lb))
    return w, lw, lb


def smooth_quantize_state_dict(state: Dict[str, np.ndarray],
                               paths: Iterable[str],
                               quant_mode: QuantMode,
                               act_scales: Optional[Dict[str, np.ndarray]]
                               = None,
                               ln_paths: Optional[Dict[str, str]] = None,
                               alpha: float = 0.5
                               ) -> Dict[str, np.ndarray]:
    """SmoothQuant W8A8 weights: every ``<path>.weight`` becomes int8
    ``<path>.qweight`` + step ``<path>.per_channel_scale`` (and a unit
    ``<path>.act_scale`` for static activation scaling).

    ``act_scales`` ({path: per-in-channel activation amax}, from
    calibration): the alpha smoothing (``smooth_gemm``) is folded into the
    path's weight before quantisation and, where ``ln_paths`` maps the path
    to its preceding LayerNorm, the inverse scaling into that LayerNorm's
    weight and bias, so the network computes the same function; stacked
    [L, out, in] weights get a scale a layer.  Paths are taken in order,
    as the JAX package walks its modules (``surgery.py:196-277``)."""
    if not quant_mode.has_act_and_weight_quant():
        raise ValueError(f"{quant_mode!r} is not a SmoothQuant mode")
    per_channel = quant_mode.has_per_channel_scaling()
    out = dict(state)
    for path in paths:
        key = f"{path}.weight"
        if key not in out:
            continue
        w = _flatten_qkv(path, np.asarray(out.pop(key), np.float32))
        if act_scales is not None and path in act_scales:
            ln = (ln_paths or {}).get(path)
            lw = out.get(f"{ln}.weight") if ln else None
            lb = out.get(f"{ln}.bias") if ln else None
            w, lw, lb = _smooth_stacked(w, act_scales[path], lw, lb, alpha)
            if lw is not None:
                out[f"{ln}.weight"] = lw
            if lb is not None:
                out[f"{ln}.bias"] = lb
        q, s = _sq_quantize_stacked(w, w.ndim - 2, per_channel)
        out[f"{path}.qweight"] = q
        out[f"{path}.per_channel_scale"] = s
        if not quant_mode.has_per_token_dynamic_scaling():
            out.setdefault(f"{path}.act_scale", np.ones((1,), np.float32))
    return out
