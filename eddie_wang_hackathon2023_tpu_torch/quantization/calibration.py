"""Calibration of the static int8 scales (the JAX package's
``quantization/calibration.py``): the decoder's self-KV cache
(``kv_abs_max``, ``calibrate_int8_kv``) and the cross-KV
(``calibrate_cross_kv_scales``)."""
from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from .._utils import resolve_device


def kv_abs_max(decoder, tokens: torch.Tensor, cross_kv,
               lengths: torch.Tensor) -> np.ndarray:
    """Per-layer amax(|K|, |V|) [n_layer] over the valid positions of a
    teacher-forced prefill of ``tokens`` [B, T] through ``decoder`` (a
    float self cache: the decoder of the recipe without ``kv8``), on the
    device of its weights; ``lengths`` [B] the valid lengths."""
    t = tokens.shape[1]
    with torch.inference_mode():
        cache = decoder.new_kv_cache(tokens.shape[0], max_len=t)
        _, cache = decoder(tokens, cache, cross_kv, 0, lengths)
        # cache [L, B, 2, H, D, T] (seq-minor); positions >= length masked
        pos = torch.arange(t, device=cache.device)
        valid = (pos[None, :] < lengths[:, None])[None, :, None, None, None]
        abskv = torch.where(valid, cache.float().abs(), 0.0)
        return abskv.amax(dim=(1, 2, 3, 4, 5)).cpu().numpy()


def calibrate_int8_kv(pipeline, mels: List[np.ndarray],
                      batch_size: int = 1) -> np.ndarray:
    """Greedy-decode the calibration clips ``mels`` ([n_mels, frames]
    each) with ``pipeline`` (a :class:`..models.whisper.pipeline.
    WhisperPipeline` whose decoder keeps a float self cache), then run a
    teacher-forced prefill over each batch's tokens and take the per-layer
    amax of the cached K and V: returns amax / 127 [n_text_layer] fp32, the
    per-layer dequantise step that
    ``decoder_state_dict(int8_kv_scales=)`` expects.  Runs on the
    pipeline's device."""
    pipe = pipeline
    dev = pipe.device
    amax = np.zeros((pipe.config.n_text_layer,), np.float32)
    for i in range(0, len(mels), batch_size):
        mel = np.stack(mels[i:i + batch_size])
        xa = pipe.get_audio_features(mel)
        cross = pipe.precompute_cross_kv(xa)
        tokens, lengths, _, _ = pipe.main_loop(xa, cross)
        t = int(lengths.max())
        layer_amax = kv_abs_max(
            pipe.decoder,
            torch.as_tensor(tokens[:, :t], dtype=torch.long, device=dev),
            cross, torch.as_tensor(lengths, dtype=torch.int32, device=dev))
        amax = np.maximum(amax, layer_amax)
    return amax / 127.0


def calibrate_cross_kv_scales(ckv_state: Dict[str, np.ndarray],
                              xas: Iterable, device=None) -> np.ndarray:
    """Per-layer cross-KV quant scales [n_text_layer] fp32 for
    ``CrossAttnKV(int8_output=True)``: the max over the calibration
    utterances' encoder outputs ``xas`` ([B, S, d] each) of the per-layer
    amax/127.  ``ckv_state`` is the JAX-layout cross-KV state dict
    (``blocks.k_linear.weight`` [L, d, d], ...).  The projections are fp32
    GEMMs, so the scales agree with the JAX function to fp32 rounding of
    the sums, not bit for bit."""
    device = resolve_device(device)

    def t(name):
        return torch.as_tensor(np.asarray(ckv_state[name], np.float32),
                               device=device)

    wk = t("blocks.k_linear.weight")
    wv = t("blocks.v_linear.weight")
    bv = t("blocks.v_linear.bias")
    amax = torch.zeros((wk.shape[0],), dtype=torch.float32, device=device)
    with torch.inference_mode():
        for xa in xas:
            if not isinstance(xa, torch.Tensor):
                xa = torch.from_numpy(np.array(xa, np.float32))
            xa = xa.to(device).float()
            k = torch.einsum("bsi,loi->lbos", xa, wk)
            v = torch.einsum("bsi,loi->lbos", xa, wv) + bv[:, None, :, None]
            kv = torch.stack([k, v], dim=2)
            amax = torch.maximum(amax, kv.abs().amax(dim=(1, 2, 3, 4)))
    amax = amax.cpu().numpy()
    return (np.maximum(amax, 1e-6) / 127.0).astype(np.float32)
