"""Autoregressive generation for decoder-only LMs (the JAX package's
``runtime/generation.py``), greedy.

The JAX package runs prefill and the decode steps as one jitted
``lax.while_loop``; here the loop runs on the host, one model call a token,
with every per-step tensor made on the device (no host-to-device copy waits
for the stream).  Prompt lengths are bucketed and left-padded; the
``attention_start`` of each row masks its pad.  Semantics as in the JAX
``GenerationSession._decode_impl`` (:106-306) for ``num_beams == 1``: a
finished row emits ``end_id``; the sequence length of a row ends at its
first ``end_id``.  The JAX loop runs the model once more after the last
token and drops its logits; this loop does not (the same tokens, lengths
and log-probabilities).  Beams raise.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .sampling import SamplingConfig, check_greedy_config, dynamic_decode

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
    device its weights live on."""

    def __init__(self, model_config: ModelConfig, model,
                 sampling_config: Optional[SamplingConfig] = None):
        self.model_config = model_config
        self.model = model
        self.sampling_config = sampling_config or SamplingConfig()
        self.decode_steps = 0

    def decode(self, input_ids: np.ndarray, input_lengths: np.ndarray,
               sampling_config: Optional[SamplingConfig] = None,
               max_new_tokens: int = 32):
        """input_ids [B, L] LEFT-padded (pad with anything; each row's
        ``attention_start`` masks it); input_lengths [B] the true prompt
        lengths.  Returns numpy (output_ids [B, 1, L + max_new_tokens],
        seq_lengths [B, 1], cum_log_probs [B, 1]), the bucket padding
        sliced back off."""
        if sampling_config is not None:
            self.sampling_config = sampling_config
        sc = self.sampling_config
        if sc.num_beams != 1:
            raise NotImplementedError("beam search is not ported for the "
                                      "decoder-only path")
        check_greedy_config(sc)
        b, in_len = input_ids.shape
        prompt_len = bucket_length(in_len)
        pad = prompt_len - in_len
        if pad:
            input_ids = np.concatenate(
                [np.full((b, pad), sc.pad_id, input_ids.dtype), input_ids],
                axis=1)
        with torch.inference_mode():
            tokens, lens, cum = self._decode(
                np.asarray(input_ids), np.asarray(input_lengths), prompt_len,
                max_new_tokens, sc)
        tokens = tokens.cpu().numpy().astype(np.int32)[:, None, pad:]
        lens = lens.cpu().numpy().astype(np.int32)[:, None] - pad
        return tokens, lens, cum.cpu().numpy()[:, None]

    def _decode(self, input_ids, input_lengths, prompt_len: int,
                max_new_tokens: int, sc: SamplingConfig):
        model = self.model
        dev = model.vocab_embedding.weight.device
        b = input_ids.shape[0]
        total = prompt_len + max_new_tokens
        v = self.model_config.vocab_size
        ids = torch.as_tensor(input_ids, dtype=torch.long, device=dev)
        start = (prompt_len - torch.as_tensor(
            input_lengths, dtype=torch.int32, device=dev)).to(torch.int32)
        end_ids = np.broadcast_to(np.asarray(sc.end_id, np.int64), (b,)).copy()
        end_id = torch.as_tensor(end_ids, device=dev)
        # an end id outside the vocab never comes out of the argmax: no row
        # can finish, and the loop need not ask the device whether all did
        can_finish = bool(np.any((end_ids >= 0) & (end_ids < v)))

        cache = model.new_kv_cache(b, total)
        seq0 = torch.full((b,), prompt_len, dtype=torch.int32, device=dev)
        logits_all, cache = model(ids, cache, 0, seq0, attention_start=start)
        logits = logits_all[:, -1]
        tokens = torch.full((b, total), sc.pad_id, dtype=torch.long,
                            device=dev)
        tokens[:, :prompt_len] = ids
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        cum = torch.zeros((b,), dtype=torch.float32, device=dev)
        self.decode_steps = 0
        for cur in range(prompt_len, total):
            tok, lp = dynamic_decode(logits, sc)
            cum = cum + torch.where(finished, 0.0, lp)
            tok = torch.where(finished, end_id, tok)
            finished = finished | (tok == end_id)
            tokens[:, cur] = tok
            if cur + 1 == total or (can_finish and bool(finished.all())):
                break
            seq = torch.full((b,), cur + 1, dtype=torch.int32, device=dev)
            step_logits, cache = model(tok[:, None], cache, cur, seq,
                                       attention_start=start)
            logits = step_logits[:, -1]
            self.decode_steps += 1
        # a row's length ends at its first end id after the prompt
        is_end = tokens[:, prompt_len:] == end_id[:, None]
        first_end = torch.argmax(is_end.to(torch.int32), dim=-1)
        gen_lens = torch.where(is_end.any(-1), first_end, max_new_tokens)
        return tokens, prompt_len + gen_lens, cum
