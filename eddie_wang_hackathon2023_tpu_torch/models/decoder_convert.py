"""Decoder-only weights carried over from the JAX package's layout.

``quantize_state``: a float state dict of the JAX ``DecoderLMHead``
(``state_dict()``, per-layer tensors stacked [n_layer, ...]) quantised for
the config's recipe with the port's own quantiser, bit-equal to the JAX
package's ``quantize_state_dict``.  ``from_jax_state``: such a state dict,
float or already quantised (by either package) -> the port's
:class:`~.decoder.DecoderLMHead` on a device.  The families' keys carry
over as they are: the gated MLP's ``mlp.gate``, a separate ``lm_head``
(and its bias), RMSNorm weights without a bias.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .._utils import resolve_device
from ..quantization.surgery import weight_only_quantize_state
from ._state import unstack_blocks
from .decoder import DECODER_LINEARS, DecoderConfig, DecoderLMHead


def quantize_state(state: Dict[str, np.ndarray], config: DecoderConfig
                   ) -> Dict[str, np.ndarray]:
    """The float state dict quantised for ``config.quant_mode`` (int8 or
    int4 weight-only, int4 in groups of 128 rows where a linear's
    in-features allow, else per channel; without weight quantisation it is
    returned as it is).  An int8 or e4m3 KV cache's scales
    (``blocks.attention.kv_orig_quant_scale`` / ``kv_quant_orig_scale``)
    pass through."""
    if not config.quant_mode.is_weight_only():
        return dict(state)
    return weight_only_quantize_state(state, DECODER_LINEARS,
                                      config.quant_mode)


def from_jax_state(state: Dict[str, np.ndarray], config: DecoderConfig,
                   device=None, mapping=None) -> DecoderLMHead:
    """The port's model for ``config``, loaded from ``state`` (the JAX
    layout, already quantised for ``config.quant_mode``).  Runs on the CUDA
    card unless ``device`` says otherwise.  ``mapping`` (a
    :class:`..parallel.Mapping`): this rank's tensor-parallel shard
    (``parallel.parallelize``), loaded with its shard of ``state``
    (``parallel.shard_state``)."""
    from ..parallel.sharding import parallelize, shard_state
    device = resolve_device(device)
    with torch.device(device):
        model = DecoderLMHead(config)
    if mapping is not None:
        parallelize(model, mapping)
        state = shard_state(state, model)
    model.load_state_dict(unstack_blocks(state))
    return model.eval()
