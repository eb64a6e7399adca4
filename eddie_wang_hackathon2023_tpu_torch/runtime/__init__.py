"""Decoding runtime: greedy, sampled and beam-search generation for
decoder-only LMs, paged continuous-batching serving (greedy) with its KV
block manager, the decoding step with its logit filters, and the
beam-search step with its cache-indirection table."""
from .batch_manager import (ContinuousBatchingManager, InferenceRequest,
                            Response)
from .generation import (PROMPT_BUCKETS, GenerationSession, ModelConfig,
                         bucket_length)
from .kv_cache_manager import KVCacheManager
from .sampling import (DecodeParams, SamplingConfig, beam_search_step,
                       dynamic_decode, finalize_beams, gather_beams,
                       sample_step, update_indirection)

__all__ = ["ContinuousBatchingManager", "DecodeParams", "GenerationSession",
           "InferenceRequest", "KVCacheManager", "ModelConfig",
           "PROMPT_BUCKETS", "Response", "SamplingConfig",
           "beam_search_step", "bucket_length", "dynamic_decode",
           "finalize_beams", "gather_beams", "sample_step",
           "update_indirection"]
