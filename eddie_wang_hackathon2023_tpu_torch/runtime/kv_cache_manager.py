"""Paged KV-cache bookkeeping (the JAX package's
``runtime/kv_cache_manager.py:22-201``, kept as the port's own copy).

A pool of fixed-size KV blocks with reference counting (beams share context
blocks copy-on-write style), per-sequence block lists, and the
per-sequence block-index arrays that the paged attention reads
(:mod:`..ops.paged_attention`): int32 indices into one preallocated pool
tensor, -1 where a sequence has no block.  Host-side Python and numpy.
Allocation order is the JAX package's: a block is popped from the front of
the free list and appended to its back when freed, so both managers hand
out the same block tables for the same trace.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np


class Block:
    """One fixed-size cache block with a reference count."""

    def __init__(self, block_idx: int):
        self.idx = block_idx
        self.ref_count = 0

    def add_link(self) -> None:
        self.ref_count += 1

    def remove_link(self) -> None:
        self.ref_count -= 1

    def has_link(self) -> bool:
        return self.ref_count > 0

    def is_shared(self) -> bool:
        return self.ref_count > 1


class GenerationSequence:

    def __init__(self, seq_idx: int, batch_idx: int):
        self.seq_idx = seq_idx
        self.batch_idx = batch_idx

    def get_batch_idx(self) -> int:
        return self.batch_idx

    def get_seq_idx(self) -> int:
        return self.seq_idx

    def __eq__(self, other):
        return (isinstance(other, GenerationSequence)
                and self.seq_idx == other.seq_idx
                and self.batch_idx == other.batch_idx)

    def __hash__(self):
        return self.seq_idx


class BlocksManager:
    """Pool allocator with beam-width-aware per-sequence block lists."""

    def __init__(self, num_blocks: int, block_size: int, beam_width: int = 1):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.beam_width = beam_width
        self.free_blocks: List[Block] = [Block(i) for i in range(num_blocks)]
        # seq -> [beam][block list]
        self.allocated_blocks: Dict[GenerationSequence, List[List[Block]]] = {}

    def has_free_block(self) -> bool:
        return len(self.free_blocks) > 0

    def allocate(self, owner: GenerationSequence,
                 share_across_beam: bool = False) -> None:
        """Append one block per beam (or one shared block) to the owner."""
        if owner not in self.allocated_blocks:
            self.allocated_blocks[owner] = [[] for _ in range(self.beam_width)]
        block = None
        for bi in range(self.beam_width):
            if not share_across_beam or block is None:
                if not self.has_free_block():
                    raise RuntimeError("KV cache block pool exhausted")
                block = self.free_blocks.pop(0)
            block.add_link()
            self.allocated_blocks[owner][bi].append(block)

    def replace_shared_block(self, owner: GenerationSequence,
                             block_idx: int) -> None:
        """Copy-on-write: give each beam a private block for position
        ``block_idx`` if it is shared."""
        blocks = self.allocated_blocks[owner]
        if not blocks[0][block_idx].is_shared():
            return
        for bi in range(self.beam_width):
            shared = blocks[bi][block_idx]
            if shared.has_link():
                shared.remove_link()
                if not shared.has_link():
                    self.free_blocks.append(shared)
            if not self.has_free_block():
                raise RuntimeError("KV cache block pool exhausted")
            fresh = self.free_blocks.pop(0)
            fresh.add_link()
            blocks[bi][block_idx] = fresh

    def free(self, owner: GenerationSequence) -> None:
        for beam_blocks in self.allocated_blocks.pop(owner, []):
            for block in beam_blocks:
                block.remove_link()
                if not block.has_link():
                    self.free_blocks.append(block)

    def get_number_blocks(self, owner: GenerationSequence) -> int:
        return len(self.allocated_blocks[owner][0])

    def get_block_index_array(self, owners: List[GenerationSequence],
                              max_blocks: Optional[int] = None) -> np.ndarray:
        """[num_seqs, beam, max_blocks] int32 block indices, -1 padded."""
        if max_blocks is None:
            max_blocks = max((self.get_number_blocks(o) for o in owners),
                             default=0)
        out = np.full((len(owners), self.beam_width, max_blocks), -1,
                      np.int32)
        for si, owner in enumerate(owners):
            for bi, beam_blocks in enumerate(self.allocated_blocks[owner]):
                for li, block in enumerate(beam_blocks):
                    out[si, bi, li] = block.idx
        return out


class KVCacheManager:
    """Per-step block lifecycle across a batch of sequences
    (add_sequence / step / stop)."""

    def __init__(self,
                 num_layers: int,
                 num_blocks: int,
                 tokens_per_block: int,
                 max_blocks_per_seq: int,
                 beam_width: int = 1):
        self.num_layers = num_layers
        self.tokens_per_block = tokens_per_block
        self.max_blocks_per_seq = max_blocks_per_seq
        self.beam_width = beam_width
        self.blocks_manager = BlocksManager(num_blocks, tokens_per_block,
                                            beam_width)
        self.lens: List[int] = []
        self.sequences: List[GenerationSequence] = []

    def add_sequence(self, sequence: GenerationSequence,
                     context_len: int) -> None:
        self.lens.append(context_len)
        self.sequences.append(sequence)
        t = self.tokens_per_block
        context_blocks = max(1, -(-context_len // t))
        # full context blocks are shared across beams (they hold the prompt
        # and are never written again); a partial last block is private per
        # beam from the start, since every beam writes its generated tokens
        # into it
        partial = (context_len % t != 0) or context_len == 0
        full = context_blocks - (1 if partial else 0)
        for _ in range(full):
            self.blocks_manager.allocate(sequence,
                                         share_across_beam=self.beam_width > 1)
        if partial:
            self.blocks_manager.allocate(sequence, share_across_beam=False)

    def step(self, finished: List[bool]) -> None:
        """Advance every live sequence by one token; allocate a fresh block
        on block-boundary crossings; un-share the last context block for
        beam search."""
        for i, seq in enumerate(self.sequences):
            if finished[i]:
                continue
            cur = self.lens[i]
            if cur % self.tokens_per_block == 0:
                self.blocks_manager.allocate(seq, share_across_beam=False)
            elif self.beam_width > 1:
                last = self.blocks_manager.get_number_blocks(seq) - 1
                self.blocks_manager.replace_shared_block(seq, last)
            self.lens[i] += 1

    def stop(self, sequence: GenerationSequence) -> None:
        self.blocks_manager.free(sequence)
        idx = self.sequences.index(sequence)
        del self.sequences[idx]
        del self.lens[idx]

    def get_block_index_arrays(self) -> np.ndarray:
        return self.blocks_manager.get_block_index_array(
            self.sequences, self.max_blocks_per_seq)
