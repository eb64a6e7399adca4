"""Decoding steps (the JAX package's ``runtime/sampling.py``, whole), in
PyTorch on the logits' device: the per-request parameters
(``SamplingConfig`` :34, ``DecodeParams`` :118 with ``pack_words`` :97),
the logit filters (penalties, min-length, top-k, top-p and bad words
:174-287), stop words (:290), one decoding step (``dynamic_decode`` :330,
``sample_step`` :369) and beam search (``beam_search_step`` :380,
``gather_beams`` :422, ``update_indirection`` :437, ``finalize_beams``
:456).

A sampled row draws argmax(logits + Gumbel noise), which is what
``jax.random.categorical`` computes.  The port cannot reproduce
``jax.random``'s streams, so :func:`dynamic_decode` takes the noise
itself, or a ``torch.Generator`` to draw it from (:func:`gumbel_noise`).

Beams advance together: every tensor is ``[B, beam, ...]`` with B the
number of groups.  The KV cache is never reordered; the ``[B, beam, S]``
indirection table maps each (beam, position) to the physical cache row
that wrote it, and the decode attention reads through it.  Ties between
equal scores go to the lower flat index first, the rule of
``jax.lax.top_k`` (``torch.topk`` promises no order among ties).
Serving (``runtime/batch_manager.py``) takes every knob per request, with
one row of each [B] tensor a slot; its beams are not ported.
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
    scalar or one value per row.  ``bad_words_list`` bans the last token
    of a word whenever the sequence ends with the rest of it;
    ``stop_words_list`` finishes a row whose sequence ends with a word."""
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


def max_top_k(top_k) -> int:
    """The width of the per-row top-k working set: the largest k, bucketed
    to a power of two from 8 (the JAX package's ``_max_top_k``)."""
    if np.ndim(top_k):
        raw = int(max(int(np.max(np.asarray(top_k))), 1))
    else:
        raw = max(int(top_k), 1)
    if raw <= 1:
        return 1
    b = 8
    while b < raw:
        b *= 2
    return b


def all_greedy(sc: SamplingConfig) -> bool:
    """True when every row is greedy: temperature 0, or top_k <= 1 with
    top_p <= 0 (the JAX package's ``_all_greedy``)."""
    t = np.asarray(sc.temperature, np.float32)
    k = np.asarray(sc.top_k, np.int32)
    p = np.asarray(sc.top_p, np.float32)
    return bool(np.all((t == 0.0) | ((k <= 1) & (p <= 0.0))))


def uses_penalties(sc: SamplingConfig) -> bool:
    """True when a repetition or presence penalty is off its neutral value
    (where both are identities)."""
    return bool(np.any(np.asarray(sc.repetition_penalty) != 1.0)
                or np.any(np.asarray(sc.presence_penalty) != 0.0))


def uses_min_length(sc: SamplingConfig) -> bool:
    return bool(np.any(np.asarray(sc.min_length) > 0))


def pack_words(words: Optional[List[List[int]]], device=None):
    """[[ids...], ...] -> (padded [N, M] int32, lengths [N] int32) on
    ``device``; (None, None) for no words."""
    if not words:
        return None, None
    m = max(len(w) for w in words)
    arr = np.zeros((len(words), m), np.int32)
    lens = np.zeros((len(words),), np.int32)
    for i, w in enumerate(words):
        arr[i, :len(w)] = w
        lens[i] = len(w)
    return (torch.as_tensor(arr, device=device),
            torch.as_tensor(lens, device=device))


def _row(x, b: int, dtype, device) -> torch.Tensor:
    """A scalar-or-[B] host value as a [B] tensor on ``device``."""
    a = np.asarray(x, dtype)
    a = np.array(np.broadcast_to(a.reshape(-1), (b,))) if a.ndim else \
        np.full((b,), a, dtype)
    return torch.as_tensor(a, device=device)


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Per-request sampling state as [B] tensors on one device (made once
    a call); ``max_top_k`` and ``greedy`` are host values."""
    temperature: torch.Tensor           # [B] f32
    top_k: torch.Tensor                 # [B] i32
    top_p: torch.Tensor                 # [B] f32
    repetition_penalty: torch.Tensor    # [B] f32
    presence_penalty: torch.Tensor      # [B] f32
    min_length: torch.Tensor            # [B] i32
    end_id: torch.Tensor                # [B] i32
    bad_words: Optional[torch.Tensor] = None        # [N, M] i32
    bad_word_lens: Optional[torch.Tensor] = None    # [N] i32
    stop_words: Optional[torch.Tensor] = None       # [S, M] i32
    stop_word_lens: Optional[torch.Tensor] = None   # [S] i32
    max_top_k: int = 1
    greedy: bool = True                 # every row provably greedy

    @classmethod
    def from_config(cls, sc: SamplingConfig, batch_size: int, end_id=None,
                    device=None) -> "DecodeParams":
        b = batch_size
        bw, bwl = pack_words(sc.bad_words_list, device)
        sw, swl = pack_words(sc.stop_words_list, device)
        return cls(
            temperature=_row(sc.temperature, b, np.float32, device),
            top_k=_row(sc.top_k, b, np.int32, device),
            top_p=_row(sc.top_p, b, np.float32, device),
            repetition_penalty=_row(sc.repetition_penalty, b, np.float32,
                                    device),
            presence_penalty=_row(sc.presence_penalty, b, np.float32,
                                  device),
            min_length=_row(sc.min_length, b, np.int32, device),
            end_id=_row(sc.end_id if end_id is None else end_id, b,
                        np.int32, device),
            bad_words=bw, bad_word_lens=bwl, stop_words=sw,
            stop_word_lens=swl, max_top_k=max_top_k(sc.top_k),
            greedy=all_greedy(sc))

    def repeat_rows(self, n: int) -> "DecodeParams":
        """Each row repeated ``n`` times in place (beams); shared [N, M]
        word tables stay as they are, per-row [B, N, M] ones repeat."""
        out = {}
        for f in dataclasses.fields(self):
            x = getattr(self, f.name)
            if not torch.is_tensor(x):
                continue
            table = f.name.startswith(("bad_word", "stop_word"))
            words = getattr(self, f.name.replace("_lens", "s"))
            if not table or words.dim() == 3:
                out[f.name] = x.repeat_interleave(n, dim=0)
        return dataclasses.replace(self, **out)


# -- the filters (a scalar or a per-row [B] tensor each) ---------------------

def _col(x):
    """[B] -> [B, 1] for broadcasting over the vocab axis; a Python
    number as it is (never copied to the device, which would make the
    host wait for the stream); a host sequence as a tensor."""
    if isinstance(x, (int, float, bool)):
        return x
    x = torch.as_tensor(x)
    return x.reshape(-1, 1) if x.dim() == 1 else x


def _on(x, like: torch.Tensor):
    return x.to(like.device) if torch.is_tensor(x) else x


def apply_repetition_penalty(logits, token_counts, penalty):
    """CTRL-style: the logits of tokens seen ([B, V] counts > 0) divided by
    the penalty where positive, multiplied where not."""
    if isinstance(penalty, (int, float)) and penalty == 1.0:
        return logits
    p = _on(_col(penalty), logits)
    if torch.is_tensor(p):
        p = p.float()
    scaled = torch.where(logits > 0, logits / p, logits * p)
    return torch.where(token_counts > 0, scaled, logits)


def apply_presence_penalty(logits, token_counts, penalty):
    if isinstance(penalty, (int, float)) and penalty == 0.0:
        return logits
    p = _on(_col(penalty), logits)
    if torch.is_tensor(p):
        p = p.float()
    return logits - p * (token_counts > 0).to(logits.dtype)


def apply_min_length(logits, cur_lengths, min_length, end_id):
    """The end token's logit at -inf while fewer than ``min_length`` tokens
    were generated (``cur_lengths``, a scalar or [B])."""
    if isinstance(min_length, int) and min_length <= 0:
        return logits
    short = _on(_col(cur_lengths), logits) < _on(_col(min_length), logits)
    if not torch.is_tensor(short):
        if not short:
            return logits
        short = torch.ones((), dtype=torch.bool, device=logits.device)
    col = torch.arange(logits.shape[-1], device=logits.device)[None, :]
    eos = col == _on(_col(end_id), logits)
    return torch.where(short & eos, NEG_INF, logits)


def apply_top_k(logits, k, max_k: Optional[int] = None):
    """Every logit below the k-th largest of its row at -inf (ties with it
    kept).  ``k`` an int for all rows, or a per-row [B] tensor (rows with
    k <= 0 unfiltered) with ``max_k`` >= max(k) the host's bound."""
    v = logits.shape[-1]
    if isinstance(k, int):
        if k <= 0:
            return logits
        kth = torch.topk(logits, min(k, v), dim=-1).values[..., -1:]
        return torch.where(logits < kth, NEG_INF, logits)
    if max_k is None:
        raise ValueError("per-row top_k needs the host's max_k")
    k = _on(torch.as_tensor(k), logits).long()
    max_k = min(max_k, v)
    vals = torch.topk(logits, max_k, dim=-1).values         # [B, max_k]
    kth = torch.gather(vals, -1, (torch.clamp(k, 1, max_k) - 1)[:, None])
    return torch.where((k > 0)[:, None] & (logits < kth), NEG_INF, logits)


def apply_top_p(logits, p):
    """Nucleus: the smallest prefix of the sorted distribution whose mass
    reaches ``p`` is kept, by value (ties with its last logit kept).  ``p``
    a scalar or per-row [B] (rows with p <= 0 or p >= 1 unfiltered).  The
    softmax is the JAX package's formula, exp(x - max) / sum."""
    if isinstance(p, (int, float)) and (p <= 0.0 or p >= 1.0):
        return logits
    pa = _on(_col(p), logits)
    if torch.is_tensor(pa):
        pa = pa.float()
    srt = torch.sort(logits, dim=-1, descending=True).values
    e = torch.exp(srt - srt[..., :1])
    probs = e / e.sum(-1, keepdim=True)
    cum = torch.cumsum(probs, dim=-1)
    # a token is kept while the mass before it is below p
    kth = ((cum - probs) < pa).sum(-1, keepdim=True) - 1
    threshold = torch.gather(srt, -1, torch.clamp(kth, min=0))
    enabled = (pa > 0.0) & (pa < 1.0)
    return torch.where(enabled & (logits < threshold), NEG_INF, logits)


def _rows3(x, like: torch.Tensor):
    """A scalar, or a [B] tensor as [B, 1, 1]."""
    x = _on(x, like)
    return x.reshape(-1, 1, 1).long() if torch.is_tensor(x) else int(x)


def ban_bad_words(logits, tokens, cur, words, word_lens):
    """The final token of every bad word whose prefix ends the sequence at
    -inf.  tokens [B, T] (prompt and generated, valid below ``cur``, a
    scalar or per-row [B]); words [N, M] shared by the rows or [B, N, M]
    per request, with lengths [N] or [B, N].  A word of one token is
    always banned; a word of length 0 is padding."""
    if words is None:
        return logits
    b, v = logits.shape
    if words.dim() == 2:
        words = words[None].expand(b, -1, -1)
        word_lens = word_lens[None].expand(b, -1)
    n, m = words.shape[1:]
    t = tokens.shape[1]
    mm1 = max(m - 1, 1)
    j = torch.arange(mm1, device=logits.device)[None, None, :]
    cur3 = _rows3(cur, logits)
    lens3 = word_lens[..., None].long()                       # [B, N, 1]
    # the prefix of word i lies at positions cur - (L - 1) .. cur - 1
    first = cur3 - (lens3 - 1)
    fits = (first[..., 0] >= 0) & (word_lens > 0)              # [B, N]
    hist = torch.gather(tokens[:, None, :].expand(b, n, t), 2,
                        torch.clamp(first + j, 0, t - 1))      # [B, N, M-1]
    pad = j >= (lens3 - 1)
    match = ((hist == words[..., :mm1]) | pad).all(-1) & fits
    ban_tok = torch.gather(words, 2, torch.clamp(lens3 - 1, min=0))[..., 0]
    banned = torch.zeros((b, v), dtype=torch.int32,
                         device=logits.device).scatter_reduce_(
        1, ban_tok.long(), match.to(torch.int32), reduce="amax")
    return torch.where(banned > 0, NEG_INF, logits)


def match_stop_words(tokens, cur, words, word_lens) -> torch.Tensor:
    """[B] bool: the sequence (valid through position ``cur`` inclusive,
    a scalar or per-row [B]) ends with one of the words ([N, M] shared by
    the rows or [B, N, M] per request, lengths [N] or [B, N]; length 0 is
    padding)."""
    b, t = tokens.shape
    if words is None:
        return torch.zeros((b,), dtype=torch.bool, device=tokens.device)
    if words.dim() == 2:
        words = words[None].expand(b, -1, -1)
        word_lens = word_lens[None].expand(b, -1)
    n, m = words.shape[1:]
    j = torch.arange(m, device=tokens.device)[None, None, :]
    lens3 = word_lens[..., None].long()                        # [B, N, 1]
    first = _rows3(cur, tokens) - lens3 + 1
    fits = (first[..., 0] >= 0) & (word_lens > 0)              # [B, N]
    hist = torch.gather(tokens[:, None, :].expand(b, n, t), 2,
                        torch.clamp(first + j, 0, t - 1))      # [B, N, M]
    match = ((hist == words) | (j >= lens3)).all(-1)
    return (match & fits).any(-1)


# -- one decoding step ------------------------------------------------------

def gumbel_noise(shape, generator: Optional[torch.Generator],
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise [shape] fp32 drawn from ``generator`` on
    ``device``: -log(-log(u)), u uniform, clamped above 0."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_(min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def filtered_logits(logits: torch.Tensor, p: DecodeParams,
                    token_counts=None, cur_lengths=None, tokens=None,
                    cur=None) -> torch.Tensor:
    """The filter half of :func:`dynamic_decode` on fp32 logits: the
    penalties, min-length and bad words, each skipped where its input is
    None (the JAX package's ``_filtered_logits``, ``runtime/generation.py``
    :397, which its beam loop calls before choosing tokens itself)."""
    logits = logits.float()
    if token_counts is not None:
        logits = apply_repetition_penalty(logits, token_counts,
                                          p.repetition_penalty)
        logits = apply_presence_penalty(logits, token_counts,
                                        p.presence_penalty)
    if cur_lengths is not None:
        logits = apply_min_length(logits, cur_lengths, p.min_length,
                                  p.end_id)
    if tokens is not None and p.bad_words is not None:
        logits = ban_bad_words(logits, tokens, cur, p.bad_words,
                               p.bad_word_lens)
    return logits


def dynamic_decode(logits: torch.Tensor, noise, p: DecodeParams,
                   token_counts=None, cur_lengths=None, tokens=None,
                   cur=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decoding step on [B, V] logits with per-request parameters, as
    the JAX function: penalties (``token_counts`` [B, V]), min-length
    (``cur_lengths``, the generated length, a scalar or [B]), bad words
    (``tokens`` [B, T] valid below ``cur``), then greedy or temperature /
    top-k / top-p sampling.  A row is greedy with temperature <= 0 or
    top_k <= 1 with top_p <= 0; ``noise`` ([B, V] Gumbel noise, or a
    ``torch.Generator`` to draw it from) is read only when a row samples.
    Returns ([B] int64 tokens, the first of equal maxima for greedy rows;
    [B] fp32 log-probabilities of the chosen tokens under the filtered
    logits before temperature)."""
    logits = filtered_logits(logits, p, token_counts, cur_lengths, tokens,
                             cur)
    greedy_tok = torch.argmax(logits, dim=-1)
    if p.greedy:
        tok = greedy_tok
    else:
        scaled = logits / torch.clamp(p.temperature[:, None], min=1e-6)
        scaled = apply_top_k(scaled, p.top_k, p.max_top_k)
        scaled = apply_top_p(scaled, p.top_p)
        if noise is None:
            raise ValueError("sampled rows need Gumbel noise or a generator")
        if isinstance(noise, torch.Generator):
            noise = gumbel_noise(scaled.shape, noise, scaled.device)
        sampled = torch.argmax(noise + scaled, dim=-1)
        greedy_row = (p.temperature <= 0.0) | ((p.top_k <= 1)
                                               & (p.top_p <= 0.0))
        tok = torch.where(greedy_row, greedy_tok, sampled)
    lp = torch.log_softmax(logits, dim=-1).gather(1, tok[:, None])[:, 0]
    return tok, lp


def sample_step(logits: torch.Tensor, noise, config: SamplingConfig,
                token_counts=None, cur_lengths=None):
    """:func:`dynamic_decode` with the parameters of one config (the JAX
    package's scalar-config entry point)."""
    p = DecodeParams.from_config(config, logits.shape[0],
                                 device=logits.device)
    return dynamic_decode(logits, noise, p, token_counts, cur_lengths)


# -- beam search ------------------------------------------------------------

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
