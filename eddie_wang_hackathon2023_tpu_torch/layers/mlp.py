"""MLP blocks (the JAX package's ``layers/mlp.py``: ``MLP`` and
``GatedMLP``).  Under tensor parallelism (``parallel.sharding.shard_mlp``,
where the tp size divides the ffn width) ``fc`` and the gate are
column-parallel and ``proj`` row-parallel: one all-reduce a block."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import ACT2FN
from ..quantization.mode import QuantMode
from .attention import linear_classes


class MLP(nn.Module):
    """fc, then ``ACT2FN[hidden_act]``, then proj; the linears are the
    quantisation mode's (int8 or int4 weight-only, or float)."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 hidden_act: str = "gelu", bias: bool = True,
                 dtype=torch.float32, quant_mode: QuantMode = QuantMode(0)):
        super().__init__()
        if hidden_act not in ACT2FN:
            raise NotImplementedError(f"activation {hidden_act!r} is not "
                                      "ported")
        _, col, row = linear_classes(quant_mode, dtype)
        self.fc = col(hidden_size, ffn_hidden_size, bias=bias, dtype=dtype)
        self.proj = row(ffn_hidden_size, hidden_size, bias=bias, dtype=dtype)
        self.hidden_act = hidden_act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(ACT2FN[self.hidden_act](self.fc(x)))


class GatedMLP(MLP):
    """LLaMA's MLP: ``proj(act(fc(x)) * gate(x))``, the activation on fc
    only."""

    def __init__(self, hidden_size: int, ffn_hidden_size: int,
                 hidden_act: str = "silu", bias: bool = False,
                 dtype=torch.float32, quant_mode: QuantMode = QuantMode(0)):
        super().__init__(hidden_size, ffn_hidden_size, hidden_act, bias,
                         dtype, quant_mode)
        _, col, _ = linear_classes(quant_mode, dtype)
        self.gate = col(hidden_size, ffn_hidden_size, bias=bias, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        act = ACT2FN[self.hidden_act](self.fc(x))
        return self.proj(act * self.gate(x))
