"""Autoregressive generation for decoder-only LMs (the JAX package's
``runtime/generation.py``): greedy, sampled (temperature, top-k, top-p,
repetition and presence penalties, min-length, bad and stop words) and
beam search.

The JAX package runs prefill and the decode steps as one jitted
``lax.while_loop``; here the loop runs on the host, one model call a token,
with every per-step tensor made on the device (no host-to-device copy waits
for the stream).  Prompt lengths are bucketed (unless ``bucket_prompts`` is
off) and left-padded; the ``attention_start`` of each row masks its pad.
Semantics as in the JAX ``GenerationSession._decode_impl`` (:106-306):

* sampling: ``dynamic_decode`` on the rows, with the prompt's tokens and
  every generated token of a row not finished counted for the penalties; a
  finished row emits ``end_id``; a stop word finishes its row;
* beams: after the prefill at batch B every row is repeated ``beam``
  times (cache, logits, start), beam 0 alone starts live, and each step
  filters the logits (penalties, min-length, bad words), ranks
  cum + log_softmax with ``beam_search_step`` and reorders tokens and
  counts by parent.  The cache stays put and the ``[B, beam, S]``
  indirection table follows the parents (``use_cache_indirection``, the
  beam entry of the decode kernel reads through it), or the cache itself
  is gathered by parent every step;
* a row's length ends at its first ``end_id``.

The JAX loop runs the model once more after the last token and drops its
logits; this loop does not (the same tokens, lengths and log-probabilities).
Sampled rows draw argmax(logits / T + Gumbel noise) with the noise from
:meth:`GenerationSession._gumbel`, a ``torch.Generator`` on the model's
device seeded by ``decode(seed=)``; the port cannot reproduce
``jax.random``'s streams.  The cache's S is the prompt bucket plus the new
tokens rounded up to a multiple of 4 (the beam entry and kernel 1 take no
other); the extra columns are never valid.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from .sampling import (DecodeParams, SamplingConfig, beam_search_step,
                       dynamic_decode, filtered_logits, finalize_beams,
                       gather_beams, gumbel_noise, match_stop_words,
                       update_indirection, uses_min_length, uses_penalties)

PROMPT_BUCKETS = (8, 16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                  1024, 1536, 2048)


def bucket_length(n: int, buckets=PROMPT_BUCKETS) -> int:
    for s in buckets:
        if n <= s:
            return s
    return n


@dataclasses.dataclass
class ModelConfig:
    """The JAX package's ``ModelConfig``."""
    vocab_size: int
    num_layers: int
    num_heads: int
    hidden_size: int
    max_seq_len: int = 2048
    num_kv_heads: Optional[int] = None


class GenerationSession:
    """Drives a model with the ``DecoderLMHead`` forward contract on the
    device its weights live on.  ``use_cache_indirection`` (beams): read
    the cache through the ``[B, beam, S]`` table (the default), or gather
    the whole cache by parent every step (kernel 1 then serves the step;
    a cross-check at small shapes, refused where its copies would not
    fit the card)."""

    def __init__(self, model_config: ModelConfig, model,
                 sampling_config: Optional[SamplingConfig] = None,
                 bucket_prompts: bool = True,
                 use_cache_indirection: bool = True):
        self.model_config = model_config
        self.model = model
        self.sampling_config = sampling_config or SamplingConfig()
        self.bucket_prompts = bucket_prompts
        self.use_cache_indirection = use_cache_indirection
        self.decode_steps = 0
        self._rng: Optional[torch.Generator] = None

    def _gumbel(self, shape) -> torch.Tensor:
        """Gumbel noise [shape] fp32 from the session's generator (seeded
        by :meth:`decode`), one draw for each sampled step."""
        return gumbel_noise(shape, self._rng, self._rng.device)

    def _check_gather_memory(self, b: int, beam: int, total: int) -> None:
        """The JAX guard (:328-362): gathering the cache by parent holds
        about three copies of it live."""
        mc = self.model_config
        nkv = mc.num_kv_heads or mc.num_heads
        cache_bytes = (mc.num_layers * b * beam * 2 * nkv * total
                       * (mc.hidden_size // mc.num_heads) * 2)
        live = 3 * cache_bytes
        dev = self.model.vocab_embedding.weight.device
        if dev.type == "cuda":
            free, _ = torch.cuda.mem_get_info(dev)
            if live > 0.9 * free:
                raise MemoryError(
                    f"physical-gather beam decode needs ~{live / 1e9:.1f} GB "
                    f"live cache (> {free / 1e9:.1f} GB free on the card); "
                    "use use_cache_indirection=True (the default)")
        if live > 4e9:
            warnings.warn(f"physical-gather beam decode will hold "
                          f"~{live / 1e9:.1f} GB of cache copies live per "
                          "step; prefer use_cache_indirection=True")

    def decode(self, input_ids: np.ndarray, input_lengths: np.ndarray,
               sampling_config: Optional[SamplingConfig] = None,
               max_new_tokens: int = 32, seed: int = 0):
        """input_ids [B, L] LEFT-padded (pad with anything; each row's
        ``attention_start`` masks it); input_lengths [B] the true prompt
        lengths.  ``seed`` (or the config's ``random_seed`` when 0) seeds
        the sampling noise.  Returns numpy (output_ids [B, beam, L +
        max_new_tokens], seq_lengths [B, beam], cum_log_probs [B, beam]),
        the bucket padding sliced back off."""
        if sampling_config is not None:
            self.sampling_config = sampling_config
        sc = self.sampling_config
        beam = sc.num_beams
        b, in_len = input_ids.shape
        mc = self.model_config
        if beam > 1 and (mc.num_kv_heads or mc.num_heads) != mc.num_heads:
            # refused before the prefill; the model refuses such a step too
            raise NotImplementedError("beams over an MQA/GQA cache are not "
                                      "ported (nor run by the JAX package)")
        if beam > 1 and not self.use_cache_indirection:
            self._check_gather_memory(b, beam, in_len + max_new_tokens)
        prompt_len = bucket_length(in_len) if self.bucket_prompts else in_len
        pad = prompt_len - in_len
        if pad:
            input_ids = np.concatenate(
                [np.full((b, pad), sc.pad_id, input_ids.dtype), input_ids],
                axis=1)
        dev = self.model.vocab_embedding.weight.device
        self._rng = torch.Generator(device=dev)
        self._rng.manual_seed(seed or sc.random_seed)
        with torch.inference_mode():
            tokens, lens, cum = self._decode(
                np.asarray(input_ids), np.asarray(input_lengths), prompt_len,
                max_new_tokens, sc, beam)
        total = prompt_len + max_new_tokens
        tokens = tokens.cpu().numpy().astype(np.int32).reshape(
            b, beam, total)[:, :, pad:]
        lens = lens.cpu().numpy().astype(np.int32).reshape(b, beam) - pad
        return tokens, lens, cum.cpu().numpy().reshape(b, beam)

    def best_sequences(self, tokens, seq_lens, cum):
        """The best beam of each row by the length penalty (the ranker):
        (tokens [B, T], seq_lens [B]) numpy."""
        best_tokens, best = finalize_beams(
            torch.as_tensor(tokens), torch.as_tensor(cum),
            torch.as_tensor(seq_lens), self.sampling_config.length_penalty)
        best = best.numpy()
        b = tokens.shape[0]
        return (best_tokens.numpy(),
                np.asarray(seq_lens)[np.arange(b), best])

    def _decode(self, input_ids, input_lengths, prompt_len: int,
                max_new_tokens: int, sc: SamplingConfig, beam: int):
        model = self.model
        dev = model.vocab_embedding.weight.device
        b = input_ids.shape[0]
        bb = b * beam
        total = prompt_len + max_new_tokens
        v = self.model_config.vocab_size
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
        start = (prompt_len - torch.as_tensor(
            input_lengths, dtype=torch.int32, device=dev)).to(torch.int32)
        dp = DecodeParams.from_config(sc, b, device=dev)
        end_ids = np.broadcast_to(np.asarray(sc.end_id, np.int64), (b,))
        # a row finishes by emitting an end id in the vocab or on a stop
        # word; where neither can happen the loop need not ask the device
        # whether all rows did
        can_finish = bool(np.any((end_ids >= 0) & (end_ids < v))
                          or sc.stop_words_list)
        s_cache = -(-total // 4) * 4

        cache = model.new_kv_cache(b, s_cache)
        seq0 = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
        logits_all, cache = model(ids, cache, 0, seq0, attention_start=start)
        logits = logits_all[:, -1]
        del logits_all
        if beam > 1:
            cache = cache.repeat_interleave(beam, dim=1)
            logits = logits.repeat_interleave(beam, dim=0)
            start = start.repeat_interleave(beam, dim=0)
            ids = ids.repeat_interleave(beam, dim=0)
            dp = dp.repeat_rows(beam)
        end_id = dp.end_id.long()
        tokens = torch.full((bb, total), sc.pad_id, dtype=torch.long,
                            device=dev)
        tokens[:, :prompt_len] = ids
        counts = None
        if uses_penalties(sc):
            # the prompt's live tokens, counted once for the penalties
            live = (torch.arange(prompt_len, device=dev)[None, :]
                    >= start[:, None]).to(torch.int32)
            counts = torch.zeros((bb, v), dtype=torch.int32, device=dev)
            counts.scatter_add_(1, ids, live)
        min_len = uses_min_length(sc)
        words = dp.bad_words is not None
        finished = torch.zeros((bb,), dtype=torch.bool, device=dev)
        use_ind = beam > 1 and self.use_cache_indirection
        ind = None
        if beam > 1:
            cum = torch.zeros((b, beam), dtype=torch.float32, device=dev)
            cum[:, 1:] = -1e9
            if use_ind:
                # after the prefill every beam holds its own copy of the
                # prompt
                ind = torch.arange(beam, dtype=torch.int32,
                                   device=dev)[None, :, None].expand(
                    b, beam, s_cache).contiguous()
        else:
            cum = torch.zeros((bb,), dtype=torch.float32, device=dev)

        self.decode_steps = 0
        for cur in range(prompt_len, total):
            gen_len = cur - prompt_len
            if beam > 1:
                lg = filtered_logits(logits, dp, counts,
                                     gen_len if min_len else None,
                                     tokens if words else None, cur)
                logprobs = torch.log_softmax(lg.reshape(b, beam, v), dim=-1)
                parent, tok, cum, fin = beam_search_step(
                    logprobs, cum, finished.reshape(b, beam), beam,
                    sc.end_id, sc.length_penalty, cur_len=gen_len)
                tokens = gather_beams(tokens.reshape(b, beam, -1),
                                      parent).reshape(bb, -1)
                if counts is not None:
                    counts = gather_beams(counts.reshape(b, beam, v),
                                          parent).reshape(bb, v)
                if not use_ind:
                    rows = (parent + beam * torch.arange(
                        b, device=dev)[:, None]).reshape(bb)
                    cache = cache.index_select(1, rows)
                tok = tok.reshape(bb)
                finished = fin.reshape(bb)
            else:
                noise = None if dp.greedy else self._gumbel((bb, v))
                tok, lp = dynamic_decode(
                    logits, noise, dp, token_counts=counts,
                    cur_lengths=gen_len if min_len else None,
                    tokens=tokens if words else None, cur=cur)
                cum = cum + torch.where(finished, 0.0, lp)
                tok = torch.where(finished, end_id, tok)
                finished = finished | (tok == end_id)
            tokens[:, cur] = tok
            if dp.stop_words is not None:
                finished = finished | match_stop_words(
                    tokens, cur, dp.stop_words, dp.stop_word_lens)
            if counts is not None:
                # a finished row adds nothing (its end id may lie outside
                # the vocab, as one_hot's zero row in the JAX loop)
                counts.scatter_add_(1, torch.where(finished, 0, tok)[:, None],
                                    (~finished).to(torch.int32)[:, None])
            if cur + 1 == total or (can_finish and bool(finished.all())):
                break
            if use_ind:
                ind = update_indirection(ind, parent, cur)
            seq = torch.full((bb,), cur + 1, dtype=torch.int32, device=dev)
            step_logits, cache = model(tok[:, None], cache, cur, seq,
                                       attention_start=start,
                                       beam_indirection=ind)
            logits = step_logits[:, -1]
            self.decode_steps += 1
        # a row's length ends at its first end id after the prompt
        is_end = tokens[:, prompt_len:] == end_id[:, None]
        first_end = torch.argmax(is_end.to(torch.int32), dim=-1)
        gen_lens = torch.where(is_end.any(-1), first_end, max_new_tokens)
        return tokens, prompt_len + gen_lens, cum

