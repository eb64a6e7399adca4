"""Linear layers (the JAX package's ``layers/linear.py``).  The weight
keeps the torch layout [out, in].

Tensor parallelism (``parallel.sharding.shard_linear`` sets ``tp``,
``tp_mode`` and ``gather_output``; a layer that is not sharded has
``tp`` None and is the plain function): a column-parallel layer holds its
rank's out-features and, with ``gather_output``, joins every rank's
outputs; a row-parallel one holds its rank's in-features, sums the
partial products over the group in fp32 (``all_reduce``), rounds once to
the activation dtype and adds the replicated bias after the reduction, as
the JAX package's ``RowLinear`` (``linear.py:60-73``).  ``TP_DIMS`` names
the dim each parameter splits on in either mode (the JAX pspecs)."""
from __future__ import annotations

import torch
from torch import nn

from ..functional import matmul_fp32
from ..parallel import collectives


def frozen(shape, dtype) -> nn.Parameter:
    """An uninitialised inference-only parameter (filled by
    ``load_state_dict``)."""
    return nn.Parameter(torch.empty(shape, dtype=dtype), requires_grad=False)


class TensorParallel:
    """The tensor-parallel state of a linear layer (none by default)."""
    tp = None
    tp_mode = None
    gather_output = False

    @property
    def row_parallel(self) -> bool:
        return self.tp is not None and self.tp_mode == "row"

    def tp_finish(self, out: torch.Tensor, dtype) -> torch.Tensor:
        """The partial product ``out`` (fp32 on a row-parallel layer) ->
        reduced over the group (row), in ``dtype``, the bias added, then
        gathered (column with ``gather_output``)."""
        if self.row_parallel:
            out = collectives.all_reduce(out, self.tp)
        out = out.to(dtype)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        if self.tp is not None and self.tp_mode == "col" \
                and self.gather_output:
            out = collectives.all_gather(out, self.tp)
        return out


class Linear(TensorParallel, nn.Module):
    """y = x W^T + b; the bias is added after the product, in its dtype."""
    TP_DIMS = {"col": {"weight": 0, "bias": 0}, "row": {"weight": 1}}

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype=torch.float32):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight = frozen((out_features, in_features), dtype)
        self.bias = frozen((out_features,), dtype) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.row_parallel:
            out = matmul_fp32(x, self.weight.t())
        else:
            out = torch.matmul(x, self.weight.t())
        return self.tp_finish(out, x.dtype)


ColumnLinear = Linear


class RowLinear(Linear):
    """Same function as :class:`Linear` unsharded; the attention's
    ``dense`` and an MLP's projection, split on their in-features under
    tensor parallelism."""
