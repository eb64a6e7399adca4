"""Layers of the Whisper and decoder-only paths."""
from .activation import Gelu
from .attention import Attention, QKVLinear
from .conv import Conv1d
from .embedding import Embedding
from .linear import ColumnLinear, Linear, RowLinear
from .mlp import MLP, GatedMLP
from .normalization import LayerNorm, RmsNorm

__all__ = ["Attention", "ColumnLinear", "Conv1d", "Embedding", "GatedMLP",
           "Gelu", "LayerNorm", "Linear", "MLP", "QKVLinear", "RmsNorm",
           "RowLinear"]
