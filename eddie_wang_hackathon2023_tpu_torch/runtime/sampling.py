"""Decoding steps (the JAX package's ``runtime/sampling.py``): the greedy
branch of ``dynamic_decode`` (:330-366) with its ``SamplingConfig``
(:34-70), and beam search (``beam_search_step`` :380, ``gather_beams``
:422, ``update_indirection`` :437, ``finalize_beams`` :456).

Beams advance together: every tensor is ``[B, beam, ...]`` with B the
number of groups (one per audio).  The KV cache is never reordered; the
``[B, beam, S]`` indirection table maps each (beam, position) to the
physical cache row that wrote it, and the decode attention reads through
it.  Ties between equal scores go to the lower flat index first, the rule
of ``jax.lax.top_k`` (``torch.topk`` promises no order among ties).
Top-k/top-p sampling, penalties at other than their neutral values, and
bad and stop words are not ported yet: they raise.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

NEG_INF = float("-inf")

Scalar = Union[int, float]
PerRequest = Union[Scalar, Sequence[Scalar], np.ndarray]


@dataclasses.dataclass
class SamplingConfig:
    """The JAX package's ``SamplingConfig``, field for field: each knob a
    scalar or one value per row."""
    end_id: int = 50256
    pad_id: int = 50256
    num_beams: int = 1
    temperature: PerRequest = 1.0
    top_k: PerRequest = 1
    top_p: PerRequest = 0.0
    length_penalty: float = 1.0
    repetition_penalty: PerRequest = 1.0
    presence_penalty: PerRequest = 0.0
    min_length: PerRequest = 0
    random_seed: int = 0
    bad_words_list: Optional[List[List[int]]] = None
    stop_words_list: Optional[List[List[int]]] = None


def all_greedy(sc: SamplingConfig) -> bool:
    """True when every row is greedy: temperature 0, or top_k <= 1 with
    top_p <= 0 (the JAX package's ``_all_greedy``)."""
    t = np.asarray(sc.temperature, np.float32)
    k = np.asarray(sc.top_k, np.int32)
    p = np.asarray(sc.top_p, np.float32)
    return bool(np.all((t == 0.0) | ((k <= 1) & (p <= 0.0))))


def check_greedy_config(sc: SamplingConfig) -> None:
    """Raise for what :func:`dynamic_decode` does not port: sampling,
    penalties at other than their neutral values (where they are
    identities), bad and stop words."""
    if not all_greedy(sc):
        raise NotImplementedError("top-k/top-p sampling is not ported")
    if (np.any(np.asarray(sc.repetition_penalty) != 1.0)
            or np.any(np.asarray(sc.presence_penalty) != 0.0)
            or np.any(np.asarray(sc.min_length) > 0)):
        raise NotImplementedError("repetition/presence penalties and "
                                  "min_length are not ported")
    if sc.bad_words_list or sc.stop_words_list:
        raise NotImplementedError("bad and stop words are not ported")


def dynamic_decode(logits: torch.Tensor, sc: SamplingConfig
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One greedy decoding step on [B, V] logits: ([B] tokens, the first
    of equal maxima, as ``jnp.argmax``; [B] fp32 log-probabilities of the
    chosen tokens).  Every other mode of the JAX function raises
    (:func:`check_greedy_config`)."""
    check_greedy_config(sc)
    logits = logits.float()
    tok = torch.argmax(logits, dim=-1)
    lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, lp


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest entries of each row of x, the
    lower index first among equal values (``jax.lax.top_k``'s order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _per_row(value, ndim: int):
    """A per-row [B] tensor shaped to broadcast over ``ndim`` dimensions; a
    scalar as it is (a Python number is not copied to the device, which
    would make the host wait for the stream)."""
    if torch.is_tensor(value) and value.dim():
        return value.reshape((-1,) + (1,) * (ndim - 1))
    return value


def beam_search_step(logprobs: torch.Tensor, cum_log_probs: torch.Tensor,
                     finished: torch.Tensor, num_beams: int,
                     end_id: Union[int, torch.Tensor],
                     length_penalty: float = 1.0, cur_len=None):
    """One beam expansion.

    logprobs [B, beam, V] log-softmax fp32; cum_log_probs [B, beam];
    finished [B, beam] bool; ``end_id`` an int or a per-row [B] tensor.
    Returns (parent [B, beam], token [B, beam], new_cum [B, beam],
    new_finished [B, beam]); parent and token are int64, torch's index
    type.  A finished beam continues only with the end token, its score
    frozen.  With ``length_penalty != 1`` and ``cur_len`` (the generated
    length before this expansion, a scalar) candidates are ranked by
    cum / ((5 + len) / 6) ** length_penalty while the returned scores stay
    raw.  The beam width is read from ``logprobs`` (axis 1); ``num_beams``
    is kept for the JAX signature and not read, as there."""
    b, k, v = logprobs.shape
    end3 = _per_row(end_id, 3)
    col = torch.arange(v, device=logprobs.device)[None, None, :]
    frozen = torch.where(col == end3, 0.0, NEG_INF).to(logprobs.dtype)
    step_scores = torch.where(finished[..., None], frozen, logprobs)
    flat = (cum_log_probs[..., None] + step_scores).reshape(b, k * v)
    if length_penalty != 1.0 and cur_len is not None:
        # fp32 as in the JAX package; a Python cur_len stays on the host
        new_len = torch.as_tensor(cur_len, dtype=torch.float32) + 1.0
        penalty = ((5.0 + new_len) / 6.0) ** length_penalty
        _, top_idx = _top_k(flat / torch.clamp(penalty, min=1e-9), k)
        top_scores = torch.gather(flat, 1, top_idx)
    else:
        top_scores, top_idx = _top_k(flat, k)
    parent = top_idx // v
    token = top_idx % v
    new_finished = (torch.gather(finished, 1, parent)
                    | (token == _per_row(end_id, 2)))
    return parent, token, top_scores, new_finished


def gather_beams(tree, parent: torch.Tensor):
    """Reorder every [B, beam, ...] tensor of ``tree`` (a tensor, or a dict,
    list or tuple of them) along the beam axis by ``parent`` [B, beam]."""
    if isinstance(tree, dict):
        return {key: gather_beams(x, parent) for key, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_beams(x, parent) for x in tree)
    idx = parent.long().reshape(parent.shape + (1,) * (tree.dim() - 2))
    return torch.gather(tree, 1, idx.expand(parent.shape + tree.shape[2:]))


def update_indirection(indirection: torch.Tensor, parent: torch.Tensor,
                       cur) -> torch.Tensor:
    """Advance the [B, beam, S] cache-indirection table one step: after
    ``parent`` [B, beam] is chosen, beam j's history (positions other than
    ``cur``) is its parent's, and position ``cur`` (about to be written by
    the decoder step) is beam j's own physical row.  ``cur`` is a scalar or
    a per-row [B] tensor.  Returns a new table; the input is unchanged."""
    b, k, s = indirection.shape
    hist = gather_beams(indirection, parent)
    own = torch.arange(k, dtype=indirection.dtype,
                       device=indirection.device)[None, :, None]
    pos = torch.arange(s, device=indirection.device)[None, None, :]
    return torch.where(pos == _per_row(cur, 3), own, hist)


def finalize_beams(tokens: torch.Tensor, cum_log_probs: torch.Tensor,
                   lengths: torch.Tensor, length_penalty: float = 1.0):
    """The best beam of each row by the GNMT length penalty: tokens
    [B, beam, T], cum_log_probs and lengths [B, beam] -> (tokens [B, T],
    best [B]); the first beam wins a tie."""
    penalty = ((5.0 + lengths.float()) / 6.0) ** length_penalty
    scores = cum_log_probs / torch.clamp(penalty, min=1e-9)
    best = torch.argmax(scores, dim=1)
    return tokens[torch.arange(tokens.shape[0], device=tokens.device),
                  best], best
