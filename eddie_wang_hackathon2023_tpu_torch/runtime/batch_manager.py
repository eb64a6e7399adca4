"""Continuous (in-flight) batching (the JAX package's
``runtime/batch_manager.py`` without its beam serving).

Requests enter and leave the running batch between decode steps, without
draining it.  A fixed set of B slots shares one preallocated KV cache:
the dense slot cache ``[n_layer, B, 2, Hkv, D, S]`` (``paged=False``, the
default; slot b is row b), or (``paged=True``) a block pool
``[n_layer, N + 1, 2, Hkv, T, D]`` (N blocks and the sink of the dropped
writes) that each slot's sequence reaches through its row of the block
tables that the KV-cache manager (:mod:`.kv_cache_manager`) builds.

Admission runs a prefill of the right-padded prompt (padded to the
manager's own length buckets) that writes the prompt's K/V into the slot
(the dense slot's row of the cache, taken as a view and written in place,
or its blocks) and gives its first token; every scheduler tick then runs
``steps_per_tick`` decode steps over all slots in one dispatch, with
per-slot lengths: each live slot's pending token is written at position
``length - 1`` and attends over ``length`` positions.  The pending tokens,
lengths, penalty counts and ban tail stay on the device between the steps,
and the tick fetches its ``[B, steps_per_tick]`` tokens once: that is its
one wait on the device.  A slot that is not live rides the step at length
0: its write is discarded (dropped through an empty table row, or a column
of its own dense row that its next prompt overwrites) and its token is
replaced by ``pad_id``.  With ``mixed_admission`` a prompt is fed in
``chunk_width``-token chunks through the same tick that decodes the other
slots (:meth:`ContinuousBatchingManager._mixed_tick`): every row carries a
window, a decode row its pending token, a prompt row its next chunk.

Sampling is per request: each slot carries its request's temperature,
top-k (clamped to ``max_top_k``), top-p, penalties, min-length, end id
and bad words (its own and the manager's) as rows of device tensors read
by :func:`.sampling.dynamic_decode`; the penalty counts ``[B, V]`` and the
ban tail ``[B, max_bad_word_len]`` live on the device.  Stop words are
matched on the host when a token is pushed, and the stop word stays in the
output.  The noise of every sampled draw comes from
:meth:`ContinuousBatchingManager._gumbel`, which names the draw (the JAX
manager's keys cannot be reproduced): by default a ``torch.Generator`` on
the model's device seeded by ``random_seed``; tests give it the JAX
manager's noise for the same draw.

The scheduler is the native C++ one (``native/batch_runtime.cc``, built by
``g++`` at first use) when it builds, else the Python one, which behaves
the same.  The callbacks follow the JAX package's
(``get_inference_requests(n)`` returns up to n new requests,
``send_response(Response)`` receives results).  The loop runs on the card
unless ``device='cpu'``.  Beams (``max_beam_width > 1``, a request's
``num_beams > 1``) raise ``NotImplementedError``, and so do an int8 pool
and left-padded prompts on the pool (``attention_start``), which the
model refuses.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._utils import resolve_device
from ..ops.paged_attention import PagedCacheState
from .kv_cache_manager import GenerationSequence, KVCacheManager
from .sampling import (DecodeParams, SamplingConfig, dynamic_decode,
                       gumbel_noise)


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


FINISHED, STREAM = 1, 2     # push_token flag bits (the native library's too)


class _PyScheduler:
    """Slot admission and per-slot accounting in Python, the API and the
    semantics of the native ``NativeScheduler``."""

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
    """The native C++ scheduler when its library builds (``native=None``)
    or when asked for (``native=True``, which raises if it cannot build);
    the Python one otherwise."""
    from ..native import batch_runtime
    if native is None:
        native = batch_runtime.available()
    if native:
        return batch_runtime.NativeScheduler(max_slots, max_seq_len, end_id)
    return _PyScheduler(max_slots, max_seq_len, end_id)


def _check_sampling(sc: SamplingConfig) -> None:
    if sc.num_beams != 1:
        raise NotImplementedError("beams in serving are not ported")


def _ends_with(seq: List[int], word) -> bool:
    n = len(word)
    return n > 0 and len(seq) >= n and \
        [int(x) for x in seq[-n:]] == [int(x) for x in word]


class ContinuousBatchingManager:
    """In-flight batching of greedy and sampled requests over B slots and a
    dense slot cache or a block-paged KV pool, on ``device`` (None: the
    CUDA card, which must hold the model's weights; ``'cpu'`` runs on the
    CPU)."""

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
                 max_top_k: int = 64,
                 max_bad_words: int = 4,
                 max_bad_word_len: int = 4,
                 mixed_admission: bool = False,
                 chunk_width: int = 16,
                 max_beam_width: int = 1,
                 device=None):
        if max_beam_width > 1:
            raise NotImplementedError("beams in serving are not ported")
        _check_sampling(sampling_config)
        if mixed_admission and getattr(model.config, "bidirectional_context",
                                       False):
            raise ValueError("mixed admission needs causal prompt attention")
        dev = resolve_device(device)
        weights = model.vocab_embedding.weight.device
        if weights.type != dev.type or dev.index not in (None, weights.index):
            raise ValueError(f"the model's weights are on {weights}, not on "
                             f"{dev}")
        self.device = weights
        self.model = model
        self.sc = sc = sampling_config
        self.B = max_batch_size
        self.S = max_seq_len
        # model steps a tick: more amortise the host round trip, at the
        # cost of up to steps_per_tick - 1 wasted steps after a slot ends
        self.steps_per_tick = max(1, steps_per_tick)
        self.get_inference_requests = get_inference_requests or (lambda n: [])
        self.send_response = send_response or (lambda r: None)
        self.paged = paged
        self.tokens_per_block = tokens_per_block
        self.max_blocks_per_seq = -(-self.S // tokens_per_block)
        self.max_top_k = max_top_k
        if paged:
            self.num_blocks = num_blocks or self.B * self.max_blocks_per_seq
            self.pool = model.new_paged_pool(self.num_blocks,
                                             tokens_per_block)
            self.kvman = KVCacheManager(
                num_layers=self.pool.shape[0], num_blocks=self.num_blocks,
                tokens_per_block=tokens_per_block,
                max_blocks_per_seq=self.max_blocks_per_seq)
            self._kv_seqs: Dict[int, GenerationSequence] = {}   # slot -> seq
            self._seq_counter = 0
            self.cache = None
        else:
            # S rounded up to 4 columns, which kernel 1 reads at once; no
            # sequence reaches the extra columns
            self.cache = model.new_kv_cache(self.B, -(-self.S // 4) * 4)
        self.pad_id = int(_scalar(sc.pad_id))
        self.sched = make_scheduler(self.B, self.S, int(_scalar(sc.end_id)),
                                    native_scheduler)
        self._requests: Dict[int, InferenceRequest] = {}   # queued, by id
        self.slot_request: Dict[int, InferenceRequest] = {}
        self.slot_output: Dict[int, List[int]] = {}
        # true prompt lengths: GLM's positions need them at every step
        self._needs_ctx = getattr(model, "needs_context_lengths", False)
        self._ctx_lens = np.zeros((self.B,), np.int32)

        # per-slot sampling, host mirrors of the device rows
        self._vocab = v = model.config.vocab_size
        self._temp = np.full((self.B,), _scalar(sc.temperature), np.float32)
        self._topk = np.full((self.B,), min(_scalar(sc.top_k), max_top_k),
                             np.int32)
        self._topp = np.full((self.B,), _scalar(sc.top_p), np.float32)
        self._rep = np.full((self.B,), _scalar(sc.repetition_penalty),
                            np.float32)
        self._pres = np.full((self.B,), _scalar(sc.presence_penalty),
                             np.float32)
        self._minlen = np.full((self.B,), _scalar(sc.min_length), np.int32)
        self._end_ids = np.full((self.B,), _scalar(sc.end_id), np.int32)
        self._seeds = np.zeros((self.B,), np.int64)
        self.NW, self.MW = max_bad_words, max_bad_word_len
        self._bad_words = np.zeros((self.B, self.NW, self.MW), np.int32)
        self._bad_lens = np.zeros((self.B, self.NW), np.int32)
        self._stop_words: Dict[int, List[List[int]]] = {}
        self._dp: Optional[DecodeParams] = None     # rows on the device
        # the ban tail holds the last max_bad_word_len tokens
        self._tail_len = max(self.MW, 1)
        self._counts = torch.zeros((self.B, v), dtype=torch.int32,
                                   device=self.device)
        self._tail = torch.full((self.B, self._tail_len), -1,
                                dtype=torch.int32, device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(_scalar(sc.random_seed)))
        self._tick = 0

        self.mixed_admission = mixed_admission
        self.chunk_width = max(2, chunk_width)
        self._prefill_prompt: Dict[int, np.ndarray] = {}
        self._prefill_progress: Dict[int, int] = {}
        # what ran: admission prefills, decode ticks and their model steps,
        # mixed ticks
        self.prefills = self.decode_ticks = self.decode_steps = 0
        self.mixed_ticks = 0

    # -- sampling state ------------------------------------------------------

    def _gumbel(self, shape, where) -> torch.Tensor:
        """The Gumbel noise [shape] fp32 of one draw on the device.
        ``where`` names it: ``("admit", slot, seed, tick)`` for an
        admission, ``("tick", tick, step)`` for a step of a decode tick,
        ``("mixed", tick)`` for a mixed tick.  This draws from the
        manager's generator and reads ``where`` not at all; tests replace
        it to give the JAX manager's noise of the same draw."""
        return gumbel_noise(shape, self._generator, self.device)

    def _set_slot_sampling(self, slot: int, req: InferenceRequest) -> None:
        sc = req.sampling or self.sc
        _check_sampling(sc)
        self._temp[slot] = _scalar(sc.temperature)
        self._topk[slot] = min(_scalar(sc.top_k), self.max_top_k)
        self._topp[slot] = _scalar(sc.top_p)
        self._rep[slot] = _scalar(sc.repetition_penalty)
        self._pres[slot] = _scalar(sc.presence_penalty)
        self._minlen[slot] = _scalar(sc.min_length)
        self._end_ids[slot] = (req.end_id if req.end_id is not None
                               else _scalar(sc.end_id))
        self._seeds[slot] = _scalar(sc.random_seed)
        self._bad_words[slot] = 0
        self._bad_lens[slot] = 0
        words = list(sc.bad_words_list or [])
        if req.sampling is not None and self.sc.bad_words_list:
            # the manager's bans apply on top of a request's own
            words += [w for w in self.sc.bad_words_list if w not in words]
        for i, w in enumerate(words[:self.NW]):
            w = list(w)[:self.MW]
            self._bad_words[slot, i, :len(w)] = w
            self._bad_lens[slot, i] = len(w)
        self._stop_words[slot] = [list(w)
                                  for w in (sc.stop_words_list or [])]
        self._dp = None

    def _decode_params(self) -> DecodeParams:
        """Every slot's sampling as [B] rows on the device, copied once
        after a change (two copies: the float and the integer fields).
        ``greedy`` when every row is, which skips the noise."""
        if self._dp is None:
            b, d = self.B, self.device
            f = torch.from_numpy(np.stack([self._temp, self._topp, self._rep,
                                           self._pres])).to(d)
            i = torch.from_numpy(np.concatenate([
                self._topk, self._minlen, self._end_ids,
                self._bad_lens.reshape(-1),
                self._bad_words.reshape(-1)])).to(d)
            nw = b * self.NW
            greedy = bool(np.all((self._temp <= 0.0) | (
                (self._topk <= 1) & (self._topp <= 0.0))))
            self._dp = DecodeParams(
                temperature=f[0], top_p=f[1], repetition_penalty=f[2],
                presence_penalty=f[3], top_k=i[:b], min_length=i[b:2 * b],
                end_id=i[2 * b:3 * b],
                bad_word_lens=i[3 * b:3 * b + nw].view(b, self.NW),
                bad_words=i[3 * b + nw:].view(b, self.NW, self.MW),
                max_top_k=self.max_top_k, greedy=greedy)
        return self._dp

    @staticmethod
    def _rows(dp: DecodeParams, rows: slice) -> DecodeParams:
        """The rows ``rows`` of ``dp`` (views; greedy when they all are)."""
        out = {f.name: getattr(dp, f.name)[rows]
               for f in dataclasses.fields(dp)
               if torch.is_tensor(getattr(dp, f.name))}
        return dataclasses.replace(dp, **out)

    def _sample(self, logits, dp: DecodeParams, where, counts, gen_lens,
                tail) -> torch.Tensor:
        """One :func:`.sampling.dynamic_decode` over fp32 logits [R, V]
        with the rows' counts, generated lengths and ban tail; [R] int64
        tokens."""
        noise = None if dp.greedy else self._gumbel(tuple(logits.shape),
                                                    where)
        tok, _ = dynamic_decode(logits.float(), noise, dp,
                                token_counts=counts, cur_lengths=gen_lens,
                                tokens=tail, cur=self._tail_len)
        return tok

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

    def _add_sequence(self, slot: int, prompt_len: int) -> None:
        seq = GenerationSequence(self._seq_counter, slot)
        self._seq_counter += 1
        self.kvman.add_sequence(seq, prompt_len)
        self._kv_seqs[slot] = seq

    def _to_device(self, *parts) -> List[torch.Tensor]:
        """Host int32 arrays -> device tensors of their shapes, in one
        copy."""
        flat = [np.asarray(p, np.int32).reshape(-1) for p in parts]
        dev = torch.from_numpy(np.concatenate(flat)).to(self.device)
        out, at = [], 0
        for p, f in zip(parts, flat):
            out.append(dev[at:at + f.size].view(np.shape(p)))
            at += f.size
        return out

    def _extra(self, ctx_lens) -> dict:
        return dict(context_lengths=ctx_lens) if self._needs_ctx else {}

    # -- admission, ticks ---------------------------------------------------

    @torch.inference_mode()
    def _admit(self, req: InferenceRequest, slot: int) -> None:
        """Prefill the right-padded prompt into the slot; its logits at the
        last prompt position give the first token.  The slot's counts and
        ban tail are seeded from the prompt.  With mixed admission the
        prompt waits for the mixed ticks instead."""
        prompt = np.asarray(req.input_ids, np.int32).reshape(-1)
        p = prompt.shape[0]
        if not 0 < p < self.S:
            raise ValueError(f"a prompt of {p} tokens for max_seq_len "
                             f"{self.S}")
        self._set_slot_sampling(slot, req)
        self.sched.on_admitted(slot, p)
        self._ctx_lens[slot] = p
        self.slot_request[slot] = req
        self.slot_output[slot] = []
        if self.mixed_admission:
            # the prompt's blocks allocated now; its chunks land at any
            # offset in them
            if self.paged:
                self._add_sequence(slot, p)
            self._prefill_prompt[slot] = prompt
            self._prefill_progress[slot] = 0
            return
        bucket = _bucket(p)
        if self.paged:
            self._add_sequence(slot, p)
            # cover the pending token's position p (a new block if p % T
            # == 0)
            self.kvman.step([s.batch_idx != slot
                             for s in self.kvman.sequences])
            table_row = self._block_tables()[slot]
        else:
            bucket = min(bucket, self.cache.shape[-1])
            table_row = np.zeros((0,), np.int32)
        host = np.full((bucket,), self.pad_id, np.int32)
        host[:p] = prompt
        tl = self._tail_len
        pos = p - tl + np.arange(tl)
        tail_row = np.where(pos >= 0, prompt[np.clip(pos, 0, p - 1)], -1)
        tokens, table, length, tail_row = self._to_device(
            host[None], table_row[None], [p], tail_row[None])
        extra = self._extra(length)
        if self.paged:
            logits, state = self.model(tokens.long(),
                                       PagedCacheState(self.pool, table), 0,
                                       length, **extra)
            self.pool = state.pool
        else:
            # the slot's row of the cache, a view written in place
            logits, _ = self.model(tokens.long(),
                                   self.cache[:, slot:slot + 1], 0, length,
                                   **extra)
        self.prefills += 1
        counts = torch.zeros((1, self._vocab), dtype=torch.int32,
                             device=self.device)
        counts.scatter_add_(1, tokens[:, :p].long(),
                            torch.ones_like(tokens[:, :p]))
        nt = self._sample(logits[:, p - 1], self._rows(
            self._decode_params(), slice(slot, slot + 1)),
            ("admit", slot, int(self._seeds[slot]), self._tick), counts,
            torch.zeros_like(length), tail_row)
        counts.scatter_add_(1, nt[:, None], torch.ones_like(counts[:, :1]))
        self._counts[slot] = counts[0]
        self._tail[slot] = torch.cat([tail_row[0, 1:], nt.to(torch.int32)])
        self._push_token(slot, int(nt[0]))

    def _model_cache(self, table):
        return (PagedCacheState(self.pool, table) if self.paged
                else self.cache)

    def _keep_cache(self, state) -> None:
        if self.paged:
            self.pool = state.pool

    @torch.inference_mode()
    def _dispatch_tick(self, active, lengths, last_tokens) -> torch.Tensor:
        """``steps_per_tick`` decode steps over all slots: the pending
        tokens [B] are written at ``lengths - 1`` and attend over
        ``lengths`` (0 where a slot is not live), then each step samples
        the next tokens from the rows' counts, generated lengths and ban
        tail, which it updates.  Returns the tokens [B, steps_per_tick] on
        the device (``pad_id`` where a slot is not live); nothing is
        fetched here."""
        if self.paged:
            # cover every position this tick writes
            for _ in range(self.steps_per_tick):
                self.kvman.step([False] * len(self.kvman.sequences))
            table_np = self._block_tables()
        else:
            table_np = np.zeros((self.B, 0), np.int32)
        lens_np = np.where(active, lengths, 0)
        table, lens, toks, glens, act, ctx = self._to_device(
            table_np, lens_np, last_tokens, lens_np - self._ctx_lens,
            active, self._ctx_lens)
        self._tick += 1
        self.decode_ticks += 1
        dp = self._decode_params()
        live = act.bool()
        extra = self._extra(ctx)
        toks = toks.long()
        out = []
        for k in range(self.steps_per_tick):
            logits, state = self.model(toks[:, None], self._model_cache(table),
                                       lens - 1, lens, **extra)
            self._keep_cache(state)
            self.decode_steps += 1
            nt = self._sample(logits[:, -1], dp, ("tick", self._tick, k),
                              self._counts, glens, self._tail)
            toks = torch.where(live, nt, self.pad_id)
            # (a row that is not live adds 0, at its sampled token: pad_id
            # may lie past the vocabulary)
            self._counts.scatter_add_(1, nt[:, None],
                                      act[:, None].to(torch.int32))
            self._tail = torch.cat(
                [self._tail[:, 1:], toks[:, None].to(torch.int32)], 1)
            out.append(toks)
            lens, glens = lens + 1, glens + 1
        return torch.stack(out, 1)

    def _consume_tick(self, tokens_dev, active, rids) -> None:
        """Fetch one tick's tokens [B, steps_per_tick] and account them to
        the slots that were live at dispatch.  ``rids`` snapshots (slot,
        request) at dispatch: a slot finished and admitted again since
        receives none of the stale tokens."""
        rid_of = dict(rids)
        next_np = tokens_dev.cpu().numpy()
        live = list(active)
        for k in range(next_np.shape[1]):
            for slot in range(self.B):
                if not live[slot]:
                    continue
                if self.slot_request.get(slot) is not rid_of.get(slot):
                    live[slot] = False              # admitted again since
                    continue
                if self._push_token(slot, int(next_np[slot, k])) & FINISHED:
                    live[slot] = False

    @torch.inference_mode()
    def _mixed_tick(self) -> int:
        """One mixed context+generation tick (the JAX manager's
        ``_mixed_tick``, :690): every row a window of ``chunk_width``
        tokens at ``write_pos``, ``valid`` of them real.  A decode row
        carries its pending token at lane 0; a row in its context phase the
        next chunk of its prompt.  The pad lanes write K/V past the row's
        length, which its later tokens overwrite before anything reads it
        (the dense cache keeps only the lanes inside it).  Rows that finish
        their prompt, and the decode rows, sample one token."""
        active, lengths, last_tokens = self.sched.state()
        if not active.any():
            return 0
        B, W = self.B, self.chunk_width
        window = np.zeros((B, W), np.int32)
        write_pos = np.zeros((B,), np.int32)
        valid = np.zeros((B,), np.int32)
        is_prefill = np.zeros((B,), bool)
        sample_mask = np.zeros((B,), bool)
        reset_mask = np.zeros((B,), bool)
        gen_lens = np.zeros((B,), np.int32)
        chunk_of: Dict[int, int] = {}
        for slot in range(B):
            if slot in self._prefill_progress:
                off = self._prefill_progress[slot]
                prompt = self._prefill_prompt[slot]
                k = min(W, len(prompt) - off)
                window[slot, :k] = prompt[off:off + k]
                write_pos[slot] = off
                valid[slot] = k
                is_prefill[slot] = True
                sample_mask[slot] = off + k == len(prompt)
                reset_mask[slot] = off == 0
                chunk_of[slot] = k
            elif active[slot]:
                window[slot, 0] = last_tokens[slot]
                write_pos[slot] = lengths[slot] - 1
                valid[slot] = 1
                sample_mask[slot] = True
                gen_lens[slot] = lengths[slot] - self._ctx_lens[slot]
        if self.paged:
            # coverage one position ahead of the pending token: decode rows
            # and rows finishing their prompt advance, rows mid-prompt hold
            # (their prompt's blocks were allocated at admission)
            self.kvman.step([s.batch_idx in self._prefill_progress
                             and not sample_mask[s.batch_idx]
                             for s in self.kvman.sequences])
            table_np = self._block_tables()
        else:
            table_np = np.zeros((B, 0), np.int32)
        (table, window_d, wpos, valid_d, pre, smask, reset, glens, act,
         ctx) = self._to_device(table_np, window, write_pos, valid,
                                is_prefill, sample_mask, reset_mask,
                                gen_lens, active, self._ctx_lens)
        self._tick += 1
        self.mixed_ticks += 1
        counts = torch.where(reset.bool()[:, None], 0, self._counts)
        tail = torch.where(reset.bool()[:, None], -1, self._tail)
        logits, state = self.model(window_d.long(), self._model_cache(table),
                                   wpos, wpos + valid_d, **self._extra(ctx))
        self._keep_cache(state)
        real = torch.arange(W, device=self.device)[None, :] < valid_d[:, None]
        # context rows count their prompt's tokens; a decode row's pending
        # token was counted when it was sampled
        counts.scatter_add_(1, window_d.long(),
                            (real & pre.bool()[:, None]).to(torch.int32))
        # the ban tail takes a context row's real tokens
        stream = torch.cat([tail, window_d], 1)
        tl = self._tail_len
        start = torch.where(pre.bool(), valid_d, 0)
        tail = torch.gather(stream, 1, start[:, None].long() + torch.arange(
            tl, device=self.device)[None, :])
        last_at = torch.clamp(valid_d - 1, 0, W - 1).long()
        last = logits[torch.arange(B, device=self.device), last_at]
        nt = self._sample(last, self._decode_params(), ("mixed", self._tick),
                          counts, glens, tail)
        emit = smask.bool() & act.bool()
        counts.scatter_add_(1, nt[:, None], emit[:, None].to(torch.int32))
        nt = torch.where(emit, nt, self.pad_id)
        self._counts = counts
        self._tail = torch.where(
            emit[:, None], torch.cat([tail[:, 1:], nt[:, None].to(
                torch.int32)], 1), tail)
        nt_np = nt.cpu().numpy()
        for slot in range(B):
            if slot in self._prefill_progress:
                if sample_mask[slot]:
                    del self._prefill_progress[slot]
                    del self._prefill_prompt[slot]
                    self._push_token(slot, int(nt_np[slot]))
                else:
                    self._prefill_progress[slot] += chunk_of[slot]
            elif active[slot]:
                self._push_token(slot, int(nt_np[slot]))
        return self.sched.num_active

    # -- token push / responses -------------------------------------------

    def _push_token(self, slot: int, tok: int) -> int:
        """Account one generated token; the scheduler decides whether the
        slot is done (end id, budget, length) or streams.  A request's stop
        words are matched here, on its prompt and output: a match ends the
        slot as its end id would, with the stop word kept in the output."""
        req = self.slot_request[slot]
        self.slot_output[slot].append(tok)
        stops = self._stop_words.get(slot)
        seq = (list(np.asarray(req.input_ids).reshape(-1))
               + self.slot_output[slot]) if stops else []
        if stops and any(_ends_with(seq, w) for w in stops):
            flags = self.sched.push_token(slot, int(self._end_ids[slot]))
            flags |= FINISHED
        else:
            flags = self.sched.push_token(slot, tok)
        if flags & FINISHED:
            if self.paged and slot in self._kv_seqs:
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
        tick across the slots (a mixed one while a prompt is being fed).
        Returns the number of live slots."""
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
        if self.mixed_admission and self._prefill_progress:
            return self._mixed_tick()
        active, lengths, last_tokens = self.sched.state()
        if not active.any():
            return 0
        next_tok = self._dispatch_tick(active, lengths, last_tokens)
        self._consume_tick(next_tok, active, list(self.slot_request.items()))
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
