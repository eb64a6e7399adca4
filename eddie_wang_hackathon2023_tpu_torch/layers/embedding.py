"""Token embedding (the JAX package's ``layers/embedding.py``).

Vocab-parallel (``parallel.sharding.shard_embedding``): the rank holds
rows ``[vocab_start, vocab_start + rows)`` of the table, looks up each
token's row where it holds it and zeros elsewhere, and the ranks sum the
result (``all_reduce``): exact, since one rank adds a non-zero row."""
from __future__ import annotations

import torch
from torch import nn

from ..parallel import collectives
from .linear import frozen


class Embedding(nn.Module):
    tp = None
    vocab_start = 0

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 dtype=torch.float32):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embedding_dim = embedding_dim
        self.weight = frozen((num_embeddings, embedding_dim), dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.weight[tokens]
        local = tokens - self.vocab_start
        mine = (local >= 0) & (local < self.weight.shape[0])
        rows = self.weight[torch.where(mine, local, 0)]
        rows = rows * mine[..., None].to(rows.dtype)
        return collectives.all_reduce(rows, self.tp)
