"""Quantisation recipes of the Whisper and decoder-only paths: int8 and
int4 weight-only, SmoothQuant W8A8, static int8 cross-KV."""
from .mode import QuantMode

__all__ = ["QuantMode"]
