"""Tensor, data and sequence parallelism with ``torch.distributed`` (the
JAX package's ``parallel/``): the rank layout and groups
(:mod:`.mapping`), the collectives the sharded layers call
(:mod:`.collectives`), the per-block sharding of a model and its state
(:mod:`.sharding`) and the multi-rank dry run (:mod:`.dryrun`)."""
from .collectives import Group
from .mapping import (DP_AXIS, PP_AXIS, TP_AXIS, Mapping, init_distributed,
                      spawn_ranks, start_ranks)
from .sharding import parallelize, shard_state

__all__ = ["DP_AXIS", "Group", "Mapping", "PP_AXIS", "TP_AXIS",
           "init_distributed", "parallelize", "shard_state", "spawn_ranks",
           "start_ranks"]
