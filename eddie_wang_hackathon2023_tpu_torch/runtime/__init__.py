"""Decoding runtime: greedy, sampled and beam-search generation for
decoder-only LMs, continuous-batching serving (greedy and sampled, over a
dense slot cache or a block-paged pool, with mixed admission) with its KV
block manager and scheduler, the decoding step with its logit filters, and
the beam-search step with its cache-indirection table."""
from .batch_manager import (ContinuousBatchingManager, InferenceRequest,
                            Response)
from .generation import (PROMPT_BUCKETS, GenerationSession, ModelConfig,
                         bucket_length)
from .kv_cache_manager import (Block, BlocksManager, GenerationSequence,
                               KVCacheManager)
from .sampling import (DecodeParams, SamplingConfig, beam_search_step,
                       dynamic_decode, finalize_beams, gather_beams,
                       sample_step, update_indirection)

__all__ = ["Block", "BlocksManager", "ContinuousBatchingManager",
           "DecodeParams", "GenerationSequence", "GenerationSession",
           "InferenceRequest", "KVCacheManager", "ModelConfig",
           "PROMPT_BUCKETS", "Response", "SamplingConfig",
           "beam_search_step", "bucket_length", "dynamic_decode",
           "finalize_beams", "gather_beams", "sample_step",
           "update_indirection"]
