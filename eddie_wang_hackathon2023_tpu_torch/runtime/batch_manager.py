"""Continuous (in-flight) batching (the JAX package's
``runtime/batch_manager.py``).

Requests enter and leave the running batch between decode steps, without
draining it.  A fixed set of B slots shares one preallocated KV cache:
the dense slot cache ``[n_layer, B * W, 2, Hkv, D, S]`` (``paged=False``,
the default; slot b owns rows b * W .. b * W + W - 1, W =
``max_beam_width``), or (``paged=True``) a block pool
``[n_layer, N + 1, 2, Hkv, T, D]`` (N blocks and the sink of the dropped
writes) that each slot's sequence reaches through its rows of the block
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

Beams (``max_beam_width`` W > 1, the JAX manager's :171-212 and
:333-1212): each request decodes with its own width (``num_beams`` <= W;
greedy and sampled requests are width 1 and run on the slot's first row).
The cache never reorders: a [B, W, S] cache-indirection table carries each
beam's ancestry into the attention read, as the offline session's does.
A beam admission prefills the prompt into the slot's first row only (the
table maps every prompt position to it) and expands the top W first
continuations; each beam tick runs ``steps_per_tick`` steps over all
B * W rows (filters per row, ``log_softmax``, ``beam_search_step``; width-1
rows through ``dynamic_decode``), reorders the counts and tails by parent,
matches the stop words in the step (a stopped beam freezes at once) and
advances the table; the host keeps each beam's history and finishes a slot
when all its beams are done, answering with the best by the GNMT length
penalty.  Over the pool every beam row appends into its own private block
chain: full prompt blocks are shared read-only, the partial one is copied
into each sibling beam's private block after the prefill.  Under mixed
admission a beam request's prompt is fed into the slot's first row by the
mixed window (:meth:`ContinuousBatchingManager._beam_feed_tick`) while
the other slots keep decoding; the other rows' window writes park at
their next pending position (the dense cache has ``chunk_width`` columns
of slack) or, over the pool, in the sink.  At handoff the pending token is
the prompt's last, whose rewrite at p - 1 reproduces the beam prefill's
expansion.  MQA/GQA models cannot take beams (the attention raises, as
the JAX package's does).

Sampling is per request: each slot carries its request's temperature,
top-k (clamped to ``max_top_k``), top-p, penalties, min-length, end id
and bad words (its own and the manager's) as rows of device tensors read
by :func:`.sampling.dynamic_decode`; the penalty counts ``[B * W, V]`` and
the ban tail ``[B * W, max_bad_word_len]`` live on the device.  Stop words
are matched on the host when a token is pushed, and the stop word stays
in the output.  The noise of every sampled draw comes from
:meth:`ContinuousBatchingManager._gumbel`, which names the draw (the JAX
manager's keys cannot be reproduced): by default a ``torch.Generator`` on
the model's device seeded by ``random_seed``; tests give it the JAX
manager's noise for the same draw.

The scheduler is the native C++ one (``native/batch_runtime.cc``, built by
``g++`` at first use) when it builds, else the Python one, which behaves
the same.  The callbacks follow the JAX package's
(``get_inference_requests(n)`` returns up to n new requests,
``send_response(Response)`` receives results).  The loop runs on the card
unless ``device='cpu'``.  A request that wants more beams than
``max_beam_width`` raises ``ValueError`` (the JAX manager ignores its
``num_beams`` when ``max_beam_width`` is 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from .._utils import resolve_device
from ..ops.paged_attention import PagedCacheState
from .kv_cache_manager import GenerationSequence, KVCacheManager
from .sampling import (DecodeParams, SamplingConfig, beam_search_step,
                       dynamic_decode, filtered_logits, gumbel_noise,
                       match_stop_words, update_indirection)


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


def _ends_with(seq: List[int], word) -> bool:
    n = len(word)
    return n > 0 and len(seq) >= n and \
        [int(x) for x in seq[-n:]] == [int(x) for x in word]


class ContinuousBatchingManager:
    """In-flight batching of greedy, sampled and beam requests over B slots
    and a dense slot cache or a block-paged KV pool, on ``device`` (None:
    the CUDA card, which must hold the model's weights; ``'cpu'`` runs on
    the CPU)."""

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
        # the slot cache holds W rows a slot; each request decodes with its
        # own width <= W (greedy and sampled requests: 1)
        self.W = W = max(1, max_beam_width)
        if max(1, sampling_config.num_beams) > W:
            raise ValueError(f"num_beams {sampling_config.num_beams} for a "
                             f"manager of max_beam_width {W}")
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
            self.num_blocks = num_blocks or (self.B * W
                                             * self.max_blocks_per_seq)
            self.pool = model.new_paged_pool(self.num_blocks,
                                             tokens_per_block)
            self.kvman = KVCacheManager(
                num_layers=self.pool.shape[0], num_blocks=self.num_blocks,
                tokens_per_block=tokens_per_block,
                max_blocks_per_seq=self.max_blocks_per_seq, beam_width=W)
            self._kv_seqs: Dict[int, GenerationSequence] = {}   # slot -> seq
            self._seq_counter = 0
            self.cache = None
            self.S_cache = self.S
        else:
            # beams x mixed admission: the rows that are not fed park their
            # window writes at their next pending position, so chunk_width
            # columns of slack keep them inside the cache.  S rounded up to
            # 4 columns, which kernel 1 and its beam entry read at once; no
            # sequence reaches the extra columns
            slack = max(2, chunk_width) if mixed_admission and W > 1 else 0
            self.S_cache = -(-(self.S + slack) // 4) * 4
            self.cache = model.new_kv_cache(self.B * W, self.S_cache)
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
        # fixed-shape stop tables, which the beam step matches in the step
        # (the host lists above stay authoritative elsewhere)
        self._stopw = np.zeros((self.B, self.NW, self.MW), np.int32)
        self._stopl = np.zeros((self.B, self.NW), np.int32)
        self._dp: Optional[DecodeParams] = None     # rows on the device
        self._dp_rows = None                        # (dp, its B * W rows)
        # the ban tail holds the last max_bad_word_len tokens (a whole stop
        # word, which the beam step matches against it)
        self._tail_len = max(self.MW, 1)
        rows = self.B * W                           # one a cache row
        self._counts = torch.zeros((rows, v), dtype=torch.int32,
                                   device=self.device)
        self._tail = torch.full((rows, self._tail_len), -1,
                                dtype=torch.int32, device=self.device)
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(int(_scalar(sc.random_seed)))
        self._tick = 0
        if W > 1:
            # beam state: the indirection on the device (its width the
            # cache's columns); host mirrors of the small per-(slot, beam)
            # arrays, which every tick fetches anyway
            self._ind = torch.zeros((self.B, W, self.S_cache),
                                    dtype=torch.int32, device=self.device)
            self._pending = np.zeros((self.B, W), np.int32)
            self._cum = np.full((self.B, W), -1e9, np.float32)
            self._fins = np.ones((self.B, W), bool)
            self._beam_w = np.ones((self.B,), np.int32)
            self._is_sampled = np.ones((self.B,), bool)
            self._beam_hist: Dict[int, List[List[int]]] = {}

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
        admission (a beam manager's width-1 admission too), ``("tick",
        tick, step)`` for a step of a decode tick or a beam tick,
        ``("mixed", tick)`` for a mixed tick.  This draws from the
        manager's generator and reads ``where`` not at all; tests replace
        it to give the JAX manager's noise of the same draw."""
        return gumbel_noise(shape, self._generator, self.device)

    def _set_slot_sampling(self, slot: int, req: InferenceRequest) -> None:
        sc = req.sampling or self.sc
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
        self._stopw[slot] = 0
        self._stopl[slot] = 0
        for i, w in enumerate((sc.stop_words_list or [])[:self.NW]):
            w = list(w)[:self.MW]
            self._stopw[slot, i, :len(w)] = w
            self._stopl[slot, i] = len(w)
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

    def _decode_params_rows(self) -> DecodeParams:
        """:meth:`_decode_params` with each slot's row repeated over its W
        cache rows (the JAX manager's :336-345)."""
        dp = self._decode_params()
        if self._dp_rows is None or self._dp_rows[0] is not dp:
            self._dp_rows = (dp, dp.repeat_rows(self.W))
        return self._dp_rows[1]

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
        """[B * W, max_blocks] int32 tables, -1 padded, the rows grouped by
        slot (row b * W + j: beam j's own chain; the shared prompt blocks
        appear in every beam's row; a slot with no sequence: all -1)."""
        W = self.W
        arr = np.full((self.B * W, self.max_blocks_per_seq), -1, np.int32)
        if self.kvman.sequences:
            idx = self.kvman.get_block_index_arrays()   # [n, W, max]
            for i, seq in enumerate(self.kvman.sequences):
                arr[seq.batch_idx * W:(seq.batch_idx + 1) * W] = idx[i]
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
        sc = req.sampling or self.sc
        w = max(1, int(sc.num_beams))
        if w > self.W:
            raise ValueError(f"request {req.request_id} wants {w} beams; "
                             f"the manager's max_beam_width is {self.W}")
        if self.W > 1:
            # beam stop words are matched in the step against the device
            # tail, which holds max_bad_word_len tokens (the JAX manager's
            # :800-811)
            if (w > 1 and sc.stop_words_list and self.steps_per_tick > 1
                    and any(len(x) > self.MW for x in sc.stop_words_list)):
                raise ValueError(
                    f"beam stop words longer than max_bad_word_len "
                    f"({self.MW}) need steps_per_tick=1 or a larger word "
                    f"buffer")
            self._admit_beam(req, slot, prompt, w)
            return
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

    def _mixed_window(self, table_np, window, write_pos, valid, is_prefill,
                      sample_mask, reset_mask, gen_lens, active, ctx_lens,
                      dp: DecodeParams) -> Optional[torch.Tensor]:
        """One call of the model over the rows' windows (the JAX manager's
        ``_mixed_step_impl``, :635-688), in the current tick: every row's
        ``window`` [R, chunk] at ``write_pos``, ``valid`` of its lanes
        real.  The rows in ``reset_mask`` start new counts and tails;
        context rows (``is_prefill``) count their real tokens and take them
        into their tails.  The rows in ``sample_mask`` that are ``active``
        sample one token from their last real lane, which their counts and
        tails take; the others' tokens are ``pad_id``.  Returns the tokens
        [R] on the device, or None when no row samples (no draw then)."""
        (table, window_d, wpos, valid_d, pre, smask, reset, glens, act,
         ctx) = self._to_device(table_np, window, write_pos, valid,
                                is_prefill, sample_mask, reset_mask,
                                gen_lens, active, ctx_lens)
        r, w = window.shape
        counts = torch.where(reset.bool()[:, None], 0, self._counts)
        tail = torch.where(reset.bool()[:, None], -1, self._tail)
        logits, state = self.model(window_d.long(), self._model_cache(table),
                                   wpos, wpos + valid_d, **self._extra(ctx))
        self._keep_cache(state)
        real = torch.arange(w, device=self.device)[None, :] < valid_d[:, None]
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
        if not np.any(sample_mask):
            self._counts, self._tail = counts, tail
            return None
        last_at = torch.clamp(valid_d - 1, 0, w - 1).long()
        last = logits[torch.arange(r, device=self.device), last_at]
        nt = self._sample(last, dp, ("mixed", self._tick), counts, glens,
                          tail)
        emit = smask.bool() & act.bool()
        counts.scatter_add_(1, nt[:, None], emit[:, None].to(torch.int32))
        nt = torch.where(emit, nt, self.pad_id)
        self._counts = counts
        self._tail = torch.where(
            emit[:, None], torch.cat([tail[:, 1:], nt[:, None].to(
                torch.int32)], 1), tail)
        return nt

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
        self._tick += 1
        self.mixed_ticks += 1
        nt = self._mixed_window(table_np, window, write_pos, valid,
                                is_prefill, sample_mask, reset_mask,
                                gen_lens, active, self._ctx_lens,
                                self._decode_params())
        nt_np = None if nt is None else nt.cpu().numpy()
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

    # -- beams (the JAX manager's :333-553, :876-1212) ------------------------

    @torch.inference_mode()
    def _admit_beam(self, req: InferenceRequest, slot: int, prompt, w: int
                    ) -> None:
        """Admission into a beam manager (the JAX manager's
        ``_admit_beam``, :876-981, and ``_beam_prefill_impl``, :361-448):
        the prompt's K/V into the slot's first row only (over the pool,
        through beam 0's table, the partial prompt block then copied into
        each sibling beam's private block).  A beam request (w > 1)
        expands the top w first continuations of its filtered
        log-probabilities; a width-1 request samples on the first row.
        Each live row's counts are the prompt's plus its own first token,
        its tail the prompt's; the indirection maps every prompt position
        to the first row and position p to the row itself.  With mixed
        admission the prompt waits for the feed ticks instead."""
        W, V, tl = self.W, self._vocab, self._tail_len
        p = prompt.shape[0]
        self._set_slot_sampling(slot, req)
        self._beam_w[slot] = w
        self._is_sampled[slot] = w == 1
        self.sched.on_admitted(slot, p)
        self._ctx_lens[slot] = p
        self.slot_request[slot] = req
        self.slot_output[slot] = []
        if self.mixed_admission:
            # the feed ticks stream the prompt into the slot's first row;
            # out of the done-checks until the handoff
            self._beam_hist[slot] = [[] for _ in range(W)]
            self._fins[slot] = True
            self._cum[slot] = -1e9
            self._prefill_prompt[slot] = prompt
            self._prefill_progress[slot] = 0
            if self.paged:
                self._add_sequence(slot, p)
            return
        row0 = slot * W
        bucket = _bucket(p)
        copy = None
        if self.paged:
            self._add_sequence(slot, p)
            # cover the pending tokens' position p (a new block a beam if
            # p % T == 0)
            self.kvman.step([s.batch_idx != slot
                             for s in self.kvman.sequences])
            tables = self._block_tables()
            table_row = tables[row0]
            t = self.tokens_per_block
            if p % t:
                b = (p - 1) // t
                copy = (int(tables[row0, b]),
                        tables[row0 + 1:row0 + W, b].astype(np.int64))
        else:
            bucket = min(bucket, self.S_cache)
            table_row = np.zeros((0,), np.int32)
        host = np.full((bucket,), self.pad_id, np.int32)
        host[:p] = prompt
        pos = p - tl + np.arange(tl)
        tail_row = np.where(pos >= 0, prompt[np.clip(pos, 0, p - 1)], -1)
        live_row = np.arange(W) < w
        tokens, table, length, tail_row, live_d = self._to_device(
            host[None], table_row[None], [p], tail_row, live_row)
        extra = self._extra(length)
        if self.paged:
            logits, state = self.model(tokens.long(),
                                       PagedCacheState(self.pool, table), 0,
                                       length, **extra)
            self.pool = state.pool
            if copy is not None:
                src, dst = copy
                self.pool[:, torch.from_numpy(dst).to(self.device)] = \
                    self.pool[:, src:src + 1]
        else:
            logits, _ = self.model(tokens.long(),
                                   self.cache[:, row0:row0 + 1], 0, length,
                                   **extra)
        self.prefills += 1
        prompt_counts = torch.zeros((1, V), dtype=torch.int32,
                                    device=self.device)
        prompt_counts.scatter_add_(1, tokens[:, :p].long(),
                                   torch.ones_like(tokens[:, :p]))
        last = logits[:, p - 1].float()
        dp = self._rows(self._decode_params(), slice(slot, slot + 1))
        zero = torch.zeros_like(length)
        live = live_d.bool()
        if w > 1:
            lg = filtered_logits(last, dp, prompt_counts, zero,
                                 tail_row[None], tl)
            # all but beam 0 start at -1e9, so that the first expansion
            # picks distinct continuations
            lp = torch.log_softmax(lg[0], -1).expand(1, W, V)
            cum0 = torch.full((1, W), -1e9, device=self.device)
            cum0[0, 0] = 0.0
            _, tok, cum, fin = beam_search_step(
                lp, cum0, torch.zeros((1, W), dtype=torch.bool,
                                      device=self.device), W, dp.end_id)
            pending, cum, fin = tok[0], cum[0], fin[0]
        else:
            nt = self._sample(last, dp, ("admit", slot,
                                         int(self._seeds[slot]), self._tick),
                              prompt_counts, zero, tail_row[None])
            pending = torch.full((W,), self.pad_id, dtype=torch.long,
                                 device=self.device)
            pending[0] = nt[0]
            cum = torch.full((W,), -1e9, device=self.device)
            cum[0] = 0.0
            fin = torch.ones((W,), dtype=torch.bool, device=self.device)
            fin[0] = nt[0] == dp.end_id[0]
        cum = torch.where(live, cum, -1e9)
        fin = torch.where(live, fin, True)
        # every live row: the prompt's counts plus its own first token
        counts = prompt_counts.expand(W, V).clone()
        counts.scatter_add_(1, pending.clamp(0, V - 1)[:, None],
                            live[:, None].to(torch.int32))
        self._counts[row0:row0 + W] = counts
        self._tail[row0:row0 + W] = torch.cat(
            [tail_row[1:].expand(W, tl - 1),
             pending[:, None].to(torch.int32)], 1)
        # the prompt's positions read the first row; position p, where
        # the pending tokens land, each row its own
        spos = torch.arange(self.S_cache, device=self.device)[None, :]
        self._ind[slot] = torch.where(
            spos == p, torch.arange(W, dtype=torch.int32,
                                    device=self.device)[:, None], 0)
        host_out = torch.cat([pending.float(), cum, fin.float()]).cpu()
        pend_np = host_out[:W].numpy().astype(np.int64)
        self._pending[slot] = pend_np
        self._cum[slot] = host_out[W:2 * W].numpy()
        self._fins[slot] = host_out[2 * W:].numpy() > 0
        self._beam_hist[slot] = [[int(pend_np[j])] if live_row[j] else []
                                 for j in range(W)]
        self._account_beam_tick(slot)

    def _account_beam_tick(self, slot: int, fins_row=None,
                           cums_row=None) -> None:
        """One scheduler push a tick for a beam slot, for its budget and
        length (the JAX manager's :983-1001): the slot is done when all
        its live beams are, not when a token is its end id."""
        fins_row = self._fins[slot] if fins_row is None else fins_row
        cums_row = self._cum[slot] if cums_row is None else cums_row
        done = bool(np.all(fins_row | ~(np.arange(self.W)
                                        < self._beam_w[slot])))
        end = int(self._end_ids[slot])
        probe = end if done else (end + 1) % max(self._vocab, 2)
        flags = self.sched.push_token(slot, probe)
        if (flags & FINISHED) or done:
            if not flags & FINISHED:
                # every beam finished inside the budget: release the slot
                while not self.sched.push_token(slot, end) & FINISHED:
                    pass
            self._finalize_beam_slot(slot, cums_row)

    def _finalize_beam_slot(self, slot: int, cums_row) -> None:
        """Send the best live beam, by cum / ((5 + length) / 6) ** the
        request's length penalty, its tokens up to its first end id (the
        JAX manager's :1003-1026, the offline ``finalize_beams``)."""
        req = self.slot_request[slot]
        lp = float((req.sampling or self.sc).length_penalty)
        end = int(self._end_ids[slot])
        prompt_len = int(self._ctx_lens[slot])
        best_score, best_tokens = -np.inf, []
        for j in range(int(self._beam_w[slot])):
            toks = self._beam_hist[slot][j]
            glen = toks.index(end) if end in toks else len(toks)
            penalty = max(((5.0 + prompt_len + glen) / 6.0) ** lp, 1e-9)
            score = float(cums_row[j]) / penalty
            if score > best_score:
                best_score, best_tokens = score, toks[:glen]
        self.send_response(Response(req.request_id, list(best_tokens),
                                    finished=True))
        if self.paged and slot in self._kv_seqs:
            self.kvman.stop(self._kv_seqs.pop(slot))
        del self.slot_request[slot]
        del self._beam_hist[slot]

    @torch.inference_mode()
    def _beam_feed_tick(self) -> None:
        """Beams under mixed admission (the JAX manager's
        ``_beam_feed_tick``, :1027-1095): every prompt being fed advances
        one chunk into its slot's first row through the mixed window over
        all B * W rows, while nothing samples.  The other rows have no
        valid lane; their window writes park at their slot's next pending
        position (dense: overwritten before anything reads it, inside the
        slack columns) or, over the pool, go to the sink through tables
        set to -1 (their rows alias the slot's shared prompt blocks).  A
        prompt fed to its end is handed off to the beam tick."""
        rows, W, Wc = self.B * self.W, self.W, self.chunk_width
        active, lengths, _ = self.sched.state()
        window = np.zeros((rows, Wc), np.int32)
        write_pos = np.zeros((rows,), np.int32)
        valid = np.zeros((rows,), np.int32)
        is_prefill = np.zeros((rows,), bool)
        reset_mask = np.zeros((rows,), bool)
        done_slots = []
        for slot in range(self.B):
            r0 = slot * W
            if slot in self._prefill_progress:
                off = self._prefill_progress[slot]
                prompt = self._prefill_prompt[slot]
                k = min(Wc, len(prompt) - off)
                window[r0, :k] = prompt[off:off + k]
                write_pos[r0] = off
                valid[r0] = k
                is_prefill[r0] = True
                reset_mask[r0] = off == 0
                self._prefill_progress[slot] = off + k
                if off + k == len(prompt):
                    done_slots.append(slot)
            elif active[slot]:
                write_pos[r0:r0 + W] = lengths[slot]
        if self.paged:
            tables = self._block_tables()
            fed = np.zeros((rows,), bool)
            for slot in list(self._prefill_progress) + done_slots:
                fed[slot * W] = True
            tables[~fed] = -1
        else:
            tables = np.zeros((rows, 0), np.int32)
        self._tick += 1
        self.mixed_ticks += 1
        none = np.zeros((rows,), bool)
        self._mixed_window(tables, window, write_pos, valid, is_prefill,
                           none, reset_mask, np.zeros((rows,), np.int32),
                           none, np.repeat(self._ctx_lens, W), None)
        for slot in done_slots:
            self._beam_handoff(slot)

    def _beam_handoff(self, slot: int) -> None:
        """The fed slot joins the beam tick (the JAX manager's
        :1097-1130): its first row's counts and tail to every row, its
        indirection zeroed (every prompt position read from the first
        row), its pending tokens the prompt's last, whose rewrite at p - 1
        gives the prompt's last logits, so that the tick's expansion from
        cum = [0, -1e9, ...] is the beam prefill's."""
        del self._prefill_progress[slot]
        prompt = self._prefill_prompt.pop(slot)
        r0, W = slot * self.W, self.W
        self._counts[r0:r0 + W] = self._counts[r0]
        self._tail[r0:r0 + W] = self._tail[r0]
        self._ind[slot] = 0
        self._pending[slot] = int(prompt[-1])
        self._cum[slot] = -1e9
        self._cum[slot, 0] = 0.0
        self._fins[slot] = False

    @torch.inference_mode()
    def _beam_tick(self) -> int:
        """One tick of a beam manager (the JAX manager's ``_beam_tick``,
        :1131-1209, and ``_beam_step_impl``, :450-553): ``steps_per_tick``
        steps over all B * W rows, each row's pending token written at
        ``length - 1`` and the cache read through the indirection; per row
        the filters, then ``log_softmax`` and ``beam_search_step`` (width-1
        rows: ``dynamic_decode``); dead beams stay dead, finished sampled
        rows emit the end id, slots that are not live keep their state;
        the counts and tails follow the parents, the stop words freeze a
        beam in the step, and the indirection advances.  The host then
        extends each beam's history by its parent's, matches the stop
        words on it exactly, and accounts the slot once a step."""
        active, lengths, _ = self.sched.state()
        if self._prefill_progress:
            active = active.copy()          # slots being fed do not decode
            for slot in self._prefill_progress:
                active[slot] = False
        if not active.any():
            return self.sched.num_active if self._prefill_progress else 0
        self._tick += 1
        self.decode_ticks += 1
        B, W, V, tl = self.B, self.W, self._vocab, self._tail_len
        rows = B * W
        live = np.arange(W)[None, :] < self._beam_w[:, None]
        if self.paged:
            # every live chain covers the positions this tick writes (a
            # private block a beam at a block's edge)
            for _ in range(self.steps_per_tick):
                self.kvman.step([False] * len(self.kvman.sequences))
            table_np = self._block_tables()
        else:
            table_np = np.zeros((rows, 0), np.int32)
        # a slot that is not live (or is being fed) rides at length 0, as
        # in the greedy tick
        lens_np = np.where(active, lengths, 0)
        (table, pending, lens, glens, act, live_d, sam, end_slot, fins, ctx,
         stopw, stopl) = self._to_device(
            table_np, self._pending, lens_np, lens_np - self._ctx_lens,
            active, live, self._is_sampled, self._end_ids, self._fins,
            np.repeat(self._ctx_lens, W), self._stopw, self._stopl)
        cum = torch.from_numpy(self._cum).to(self.device)
        pending, fins, end_slot = pending.long(), fins.bool(), end_slot.long()
        act, live_d, sam = act.bool(), live_d.bool(), sam.bool()[:, None]
        dp = self._decode_params_rows()
        extra = self._extra(ctx)
        eye = torch.arange(W, device=self.device)[None, :].expand(B, W)
        keep = ~act[:, None]
        sampled = bool(np.any(self._is_sampled & active))
        stops = bool(np.any(self._stopl[active]))
        if stops:
            stopw = stopw.repeat_interleave(W, 0)
            stopl = stopl.repeat_interleave(W, 0)
        base = torch.arange(B, device=self.device)[:, None] * W
        counts, tail, ind = self._counts, self._tail, self._ind
        steps, scores = [], []        # each step's (parent, token, fin), cum
        for k in range(self.steps_per_tick):
            lens_r = lens.repeat_interleave(W)
            logits, state = self.model(pending.reshape(rows, 1),
                                       self._model_cache(table), lens_r - 1,
                                       lens_r, beam_indirection=ind, **extra)
            self._keep_cache(state)
            self.decode_steps += 1
            lg = logits[:, -1].float()
            glens_r = glens.repeat_interleave(W)
            lg_f = filtered_logits(lg, dp, counts, glens_r, tail, tl)
            logprobs = torch.log_softmax(lg_f, -1).reshape(B, W, V)
            parent, tok, new_cum, fin = beam_search_step(
                logprobs, cum, fins, W, end_slot)
            if sampled:
                # width-1 rows: dynamic_decode on their own rows
                nt = self._sample(lg, dp, ("tick", self._tick, k), counts,
                                  glens_r, tail).reshape(B, W)
                parent = torch.where(sam, eye, parent)
                tok = torch.where(sam, nt, tok)
                fin = torch.where(sam, fins | (tok == end_slot[:, None]),
                                  fin)
                new_cum = torch.where(sam, cum, new_cum)
                tok = torch.where(sam & fins, end_slot[:, None], tok)
            # dead beams stay dead; slots that are not live keep their state
            new_cum = torch.where(live_d, new_cum, -1e9)
            fin = torch.where(live_d, fin, True)
            parent = torch.where(keep, eye, parent)
            tok = torch.where(keep, pending, tok)
            new_cum = torch.where(keep, cum, new_cum)
            fin = torch.where(keep, fins, fin)
            # the rows' counts and tails follow their parents
            parent_rows = (base + parent).reshape(rows)
            counts, tail = counts[parent_rows], tail[parent_rows]
            grow = live_d & act[:, None] & ~fin
            counts.scatter_add_(1, tok.reshape(rows, 1).clamp(0, V - 1),
                                grow.reshape(rows, 1).to(torch.int32))
            tail = torch.cat([tail[:, 1:],
                              tok.reshape(rows, 1).to(torch.int32)], 1)
            if stops:
                # a beam whose tail now ends with a stop word of its slot
                # freezes at once: the next step keeps it with its score
                hit = match_stop_words(tail, tl - 1, stopw,
                                       stopl).reshape(B, W)
                fin = fin | (hit & act[:, None] & live_d)
            # the next pending tokens land at ``lens``, each in its own row
            ind = update_indirection(ind, parent,
                                     torch.where(act, lens, -1))
            adv = act.to(lens.dtype)
            steps.append(torch.stack([parent, tok, fin.long()]))
            scores.append(new_cum)
            pending, cum, fins = tok, new_cum, fin
            lens, glens = lens + adv, glens + adv
        self._counts, self._tail, self._ind = counts, tail, ind
        n = self.steps_per_tick
        ints = torch.stack(steps).cpu().numpy()            # [n, 3, B, W]
        cums = torch.stack(scores).cpu().numpy()           # [n, B, W]
        parents, toks, fin_k = ints[:, 0], ints[:, 1], ints[:, 2] > 0
        self._pending = toks[n - 1].astype(np.int32)
        self._cum = cums[n - 1].astype(np.float32)
        self._fins = fin_k[n - 1].copy()
        live_slots = list(active)
        stop_force = np.zeros((B, W), bool)
        for k in range(n):
            for slot in range(B):
                if not live_slots[slot]:
                    continue
                hist = self._beam_hist[slot]
                par, tk = parents[k, slot], toks[k, slot]
                hist = [hist[int(par[j])] + [int(tk[j])] for j in range(W)]
                self._beam_hist[slot] = hist
                # stop words on the history, exactly, whatever their length
                # (the device learns it at the next tick's upload)
                words = self._stop_words.get(slot)
                if words:
                    prompt = list(np.asarray(
                        self.slot_request[slot].input_ids).reshape(-1))
                    for j in range(int(self._beam_w[slot])):
                        if any(_ends_with(prompt + hist[j], x)
                               for x in words):
                            stop_force[slot, j] = True
                self._account_beam_tick(slot, fin_k[k, slot]
                                        | stop_force[slot], cums[k, slot])
                if slot not in self.slot_request:   # finished this step
                    live_slots[slot] = False
        if stop_force.any():
            self._fins = self._fins | stop_force
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
        if self.W > 1:
            if self.mixed_admission and self._prefill_progress:
                self._beam_feed_tick()
            return self._beam_tick()
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
