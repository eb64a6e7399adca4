"""Continuous (in-flight) batching over the block-paged KV pool (the greedy,
paged, prefill-admission subset of the JAX package's
``runtime/batch_manager.py``).

Requests enter and leave the running batch between decode steps, without
draining it.  A fixed set of B slots shares one preallocated block pool
``[n_layer, N + 1, 2, Hkv, T, D]`` (N blocks and the sink of the dropped
writes); each slot's sequence reaches its blocks
through its row of the block tables that the KV-cache manager
(:mod:`.kv_cache_manager`) builds.  Admission runs a prefill of the
right-padded prompt (padded to the manager's own length buckets) that
writes the prompt's K/V into the slot's blocks and gives its first token;
every scheduler tick then runs ONE decode step over all slots, with
per-slot lengths: each live slot's pending token is written at position
``length - 1`` and attends over ``length`` positions.  A slot that is not
live rides the step at length 0 with an empty table row: its write is
dropped, its attention gives zeros and its token is replaced by
``pad_id`` (the JAX manager sends its stale length, which changes no live
row).  The callbacks
follow the JAX package's (``get_inference_requests(n)`` returns up to n new
requests, ``send_response(Response)`` receives results).

The tick's block tables, lengths and pending tokens go to the device in
one copy, and the tick fetches its tokens once: that is its one
wait on the device.  The loop runs on the card unless ``device='cpu'``.

What is ported: greedy requests (temperature 0, or top_k <= 1 with
top_p <= 0) with neutral penalties and no bad or stop words, per-request
``end_id`` and ``max_new_tokens``, streaming responses.  Since every row
is greedy, the JAX manager's penalty counts and bad-word ban tail are
identities and are left out.  What raises ``NotImplementedError``: the
dense slot cache (``paged=False``), mixed context+generation admission,
beams (``max_beam_width > 1``), ``steps_per_tick > 1``, sampling,
penalties, bad and stop words, and the native C++ scheduler.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._utils import resolve_device
from ..ops.paged_attention import PagedCacheState
from .kv_cache_manager import GenerationSequence, KVCacheManager
from .sampling import SamplingConfig, check_greedy_config


@dataclasses.dataclass
class InferenceRequest:
    """A request: its prompt, its token budget, its end id (None: the
    manager's), whether to stream, and its sampling (None: the manager's)."""
    request_id: int
    input_ids: np.ndarray           # [prompt_len] int32
    max_new_tokens: int = 64
    end_id: Optional[int] = None
    streaming: bool = False
    sampling: Optional[SamplingConfig] = None


@dataclasses.dataclass
class Response:
    request_id: int
    output_ids: List[int]
    finished: bool


def _bucket(n: int, sizes=(32, 64, 128, 256, 512, 1024, 2048)) -> int:
    """The manager's prompt buckets (not ``generation.PROMPT_BUCKETS``)."""
    for s in sizes:
        if n <= s:
            return s
    return sizes[-1]


FINISHED, STREAM = 1, 2     # push_token flag bits


class _PyScheduler:
    """Slot admission and per-slot accounting (the JAX package's Python
    scheduler; its native C++ twin is not ported)."""

    def __init__(self, max_slots: int, max_seq_len: int, end_id: int):
        self.max_slots = max_slots
        self.max_seq_len = max_seq_len
        self.default_end_id = end_id
        self.pending: List[tuple] = []
        self.active = np.zeros((max_slots,), bool)
        self.lengths = np.zeros((max_slots,), np.int32)
        self.budget = np.zeros((max_slots,), np.int32)
        self.last_token = np.zeros((max_slots,), np.int32)
        self.end_id = np.full((max_slots,), end_id, np.int32)
        self.streaming = np.zeros((max_slots,), bool)

    def add_request(self, request_id: int, max_new_tokens: int,
                    end_id: int = -1, streaming: bool = False) -> None:
        self.pending.append((request_id, max_new_tokens,
                             self.default_end_id if end_id < 0 else end_id,
                             streaming))

    def next_admission(self):
        if not self.pending:
            return -1, -1
        for s in range(self.max_slots):
            if not self.active[s]:
                rid, max_new, eid, stream = self.pending.pop(0)
                self.active[s] = True
                self.lengths[s] = 0
                self.budget[s] = max_new
                self.end_id[s] = eid
                self.streaming[s] = stream
                return s, rid
        return -1, -1

    def on_admitted(self, slot: int, prompt_len: int) -> None:
        self.lengths[slot] = prompt_len

    def push_token(self, slot: int, tok: int) -> int:
        self.budget[slot] -= 1
        self.last_token[slot] = tok
        self.lengths[slot] += 1
        done = (tok == self.end_id[slot] or self.budget[slot] <= 0
                or self.lengths[slot] >= self.max_seq_len - 1)
        if done:
            self.active[slot] = False
            return FINISHED
        return STREAM if self.streaming[slot] else 0

    @property
    def num_pending(self) -> int:
        return len(self.pending)

    @property
    def num_active(self) -> int:
        return int(self.active.sum())

    def state(self):
        return (self.active.copy(), self.lengths.copy(),
                self.last_token.copy())


def make_scheduler(max_slots: int, max_seq_len: int, end_id: int,
                   native: Optional[bool] = None):
    """The Python scheduler; ``native=True`` (the JAX package's C++
    scheduler) raises."""
    if native:
        raise NotImplementedError("the native C++ scheduler is not ported")
    return _PyScheduler(max_slots, max_seq_len, end_id)


def _check_sampling(sc: SamplingConfig) -> None:
    if sc.num_beams != 1:
        raise NotImplementedError("beams in serving are not ported")
    check_greedy_config(sc)


class ContinuousBatchingManager:
    """In-flight batching of greedy requests over B slots and a block-paged
    KV pool, on ``device`` (None: the CUDA card, which must hold the
    model's weights; ``'cpu'`` runs on the CPU)."""

    def __init__(self,
                 model,
                 sampling_config: SamplingConfig,
                 max_batch_size: int = 8,
                 max_seq_len: int = 2048,
                 get_inference_requests: Optional[
                     Callable[[int], List[InferenceRequest]]] = None,
                 send_response: Optional[Callable[[Response], None]] = None,
                 native_scheduler: Optional[bool] = None,
                 steps_per_tick: int = 1,
                 paged: bool = False,
                 tokens_per_block: int = 32,
                 num_blocks: Optional[int] = None,
                 mixed_admission: bool = False,
                 max_beam_width: int = 1,
                 device=None):
        if not paged:
            raise NotImplementedError("the dense slot cache is not ported; "
                                      "pass paged=True")
        if mixed_admission:
            raise NotImplementedError("mixed context+generation admission "
                                      "is not ported")
        if max_beam_width > 1:
            raise NotImplementedError("beams in serving are not ported")
        if steps_per_tick != 1:
            raise NotImplementedError("steps_per_tick > 1 is not ported")
        _check_sampling(sampling_config)
        dev = resolve_device(device)
        weights = model.vocab_embedding.weight.device
        if weights.type != dev.type or dev.index not in (None, weights.index):
            raise ValueError(f"the model's weights are on {weights}, not on "
                             f"{dev}")
        self.device = weights
        self.model = model
        self.sc = sampling_config
        self.B = max_batch_size
        self.S = max_seq_len
        self.get_inference_requests = get_inference_requests or (lambda n: [])
        self.send_response = send_response or (lambda r: None)
        self.tokens_per_block = tokens_per_block
        self.max_blocks_per_seq = -(-self.S // tokens_per_block)
        self.num_blocks = num_blocks or self.B * self.max_blocks_per_seq
        self.pool = model.new_paged_pool(self.num_blocks, tokens_per_block)
        self.kvman = KVCacheManager(
            num_layers=self.pool.shape[0], num_blocks=self.num_blocks,
            tokens_per_block=tokens_per_block,
            max_blocks_per_seq=self.max_blocks_per_seq)
        self._kv_seqs: Dict[int, GenerationSequence] = {}   # slot -> seq
        self._seq_counter = 0
        self.pad_id = int(_scalar(self.sc.pad_id))
        self.sched = make_scheduler(self.B, self.S,
                                    int(_scalar(self.sc.end_id)),
                                    native_scheduler)
        self._requests: Dict[int, InferenceRequest] = {}   # queued, by id
        self.slot_request: Dict[int, InferenceRequest] = {}
        self.slot_output: Dict[int, List[int]] = {}
        self.decode_ticks = 0

    # -- paged bookkeeping -------------------------------------------------

    def _block_tables(self) -> np.ndarray:
        """[B, max_blocks] int32 tables, one row per slot, -1 padded (a slot
        with no sequence: all -1)."""
        arr = np.full((self.B, self.max_blocks_per_seq), -1, np.int32)
        if self.kvman.sequences:
            idx = self.kvman.get_block_index_arrays()   # [n, 1, max]
            for i, seq in enumerate(self.kvman.sequences):
                arr[seq.batch_idx] = idx[i, 0]
        return arr

    # -- admission, ticks ---------------------------------------------------

    @torch.inference_mode()
    def _admit(self, req: InferenceRequest, slot: int) -> None:
        """Prefill the right-padded prompt into the slot's blocks; its
        logits at the last prompt position give the first token."""
        _check_sampling(req.sampling or self.sc)
        prompt = np.asarray(req.input_ids, np.int32).reshape(-1)
        p = prompt.shape[0]
        if not 0 < p < self.S:
            raise ValueError(f"a prompt of {p} tokens for max_seq_len "
                             f"{self.S}")
        bucket = _bucket(p)
        seq = GenerationSequence(self._seq_counter, slot)
        self._seq_counter += 1
        self.kvman.add_sequence(seq, p)
        self._kv_seqs[slot] = seq
        # cover the pending token's position p (a new block if p % T == 0)
        self.kvman.step([s.batch_idx != slot for s in self.kvman.sequences])
        host = np.full((bucket + self.max_blocks_per_seq,), self.pad_id,
                       np.int32)
        host[:p] = prompt
        host[bucket:] = self._block_tables()[slot]
        dev = torch.from_numpy(host).to(self.device)     # one copy
        tokens = dev[:bucket].long()[None]
        table = dev[bucket:][None]
        length = torch.full((1,), p, dtype=torch.int32, device=self.device)
        logits, state = self.model(tokens, PagedCacheState(self.pool, table),
                                   0, length)
        self.pool = state.pool
        tok = int(torch.argmax(logits[0, p - 1]))
        self.sched.on_admitted(slot, p)
        self.slot_request[slot] = req
        self.slot_output[slot] = []
        self._push_token(slot, tok)

    @torch.inference_mode()
    def _dispatch_tick(self, active, lengths, last_tokens) -> torch.Tensor:
        """One decode step over all slots: the pending tokens [B] are written
        at ``lengths - 1`` and attend over ``lengths`` (0 where a slot is not
        live).  Returns the next tokens [B] on the device (``pad_id`` where
        a slot is not live); nothing is fetched here."""
        # extend block coverage for the position this tick writes
        self.kvman.step([False] * len(self.kvman.sequences))
        b, mb = self.B, self.max_blocks_per_seq
        host = np.concatenate([self._block_tables().reshape(-1),
                               np.where(active, lengths, 0).astype(np.int32),
                               last_tokens.astype(np.int32)])
        dev = torch.from_numpy(host).to(self.device)     # one copy
        table = dev[:b * mb].view(b, mb)
        lens = dev[b * mb:b * mb + b]
        tokens = dev[b * mb + b:].long()[:, None]
        self.decode_ticks += 1
        logits, state = self.model(tokens, PagedCacheState(self.pool, table),
                                   lens - 1, lens)
        self.pool = state.pool
        nt = torch.argmax(logits[:, -1], dim=-1)
        return torch.where(lens > 0, nt, self.pad_id)

    def _consume_tick(self, tokens_dev, active) -> None:
        """Fetch one tick's tokens and account them to the slots that were
        live at dispatch."""
        next_np = tokens_dev.cpu().numpy()
        for slot in np.flatnonzero(active):
            self._push_token(int(slot), int(next_np[slot]))

    # -- token push / responses -------------------------------------------

    def _push_token(self, slot: int, tok: int) -> int:
        """Account one generated token; the scheduler decides whether the
        slot is done (end id, budget, length) or streams."""
        req = self.slot_request[slot]
        self.slot_output[slot].append(tok)
        flags = self.sched.push_token(slot, tok)
        if flags & FINISHED:
            if slot in self._kv_seqs:
                self.kvman.stop(self._kv_seqs.pop(slot))
            self.send_response(Response(req.request_id,
                                        list(self.slot_output[slot]),
                                        finished=True))
            del self.slot_request[slot]
        elif flags & STREAM:
            self.send_response(Response(req.request_id, [tok],
                                        finished=False))
        return flags

    def step(self) -> int:
        """One scheduler tick: admit new requests into free slots, then one
        decode step across the slots.  Returns the number of live slots."""
        free = self.B - self.sched.num_active
        if free > 0:
            for req in self.get_inference_requests(free):
                eid = req.end_id if req.end_id is not None \
                    else int(_scalar(self.sc.end_id))
                self._requests[req.request_id] = req
                self.sched.add_request(req.request_id, req.max_new_tokens,
                                       eid, req.streaming)
        while True:
            slot, rid = self.sched.next_admission()
            if slot < 0:
                break
            self._admit(self._requests.pop(rid), slot)
        active, lengths, last_tokens = self.sched.state()
        if not active.any():
            return 0
        next_tok = self._dispatch_tick(active, lengths, last_tokens)
        self._consume_tick(next_tok, active)
        return self.sched.num_active

    def run(self, max_ticks: int = 1_000_000) -> None:
        """Drive until the queues drain (two empty polls in a row)."""
        idle = 0
        for _ in range(max_ticks):
            n = self.step()
            if n == 0:
                idle += 1
                if idle >= 2:
                    break
            else:
                idle = 0


def _scalar(x):
    """Serving configs must be scalar per request; reject [B] arrays."""
    if np.ndim(x):
        raise ValueError("ContinuousBatchingManager takes scalar "
                         "SamplingConfig fields (per-request variation "
                         "comes from InferenceRequest.sampling)")
    return x if isinstance(x, (int, float)) else float(x)
