"""Decoding runtime: greedy generation for decoder-only LMs, paged
continuous-batching serving with its KV block manager, the greedy decoding
step, and the beam-search step with its cache-indirection table."""
from .batch_manager import (ContinuousBatchingManager, InferenceRequest,
                            Response)
from .generation import (PROMPT_BUCKETS, GenerationSession, ModelConfig,
                         bucket_length)
from .kv_cache_manager import KVCacheManager
from .sampling import (SamplingConfig, beam_search_step, dynamic_decode,
                       finalize_beams, gather_beams, update_indirection)

__all__ = ["ContinuousBatchingManager", "GenerationSession",
           "InferenceRequest", "KVCacheManager", "ModelConfig",
           "PROMPT_BUCKETS", "Response", "SamplingConfig",
           "beam_search_step", "bucket_length", "dynamic_decode",
           "finalize_beams", "gather_beams", "update_indirection"]
