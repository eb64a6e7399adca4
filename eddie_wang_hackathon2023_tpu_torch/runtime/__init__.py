"""Decoding runtime: the beam-search step and its cache-indirection table."""
from .sampling import (beam_search_step, finalize_beams, gather_beams,
                       update_indirection)

__all__ = ["beam_search_step", "finalize_beams", "gather_beams",
           "update_indirection"]
