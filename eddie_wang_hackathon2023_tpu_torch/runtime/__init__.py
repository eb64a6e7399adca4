"""Decoding runtime: greedy generation for decoder-only LMs, the greedy
decoding step, and the beam-search step with its cache-indirection
table."""
from .generation import (PROMPT_BUCKETS, GenerationSession, ModelConfig,
                         bucket_length)
from .sampling import (SamplingConfig, beam_search_step, dynamic_decode,
                       finalize_beams, gather_beams, update_indirection)

__all__ = ["GenerationSession", "ModelConfig", "PROMPT_BUCKETS",
           "SamplingConfig", "beam_search_step", "bucket_length",
           "dynamic_decode", "finalize_beams", "gather_beams",
           "update_indirection"]
