"""Whisper transcription: encode -> cross-KV precompute -> language
detection -> prefill -> greedy, sampled or beam-search decode loop with
Whisper's logit filters -> text; and long-form transcription over a
sliding 30 s window.

Port of the JAX package's ``models/whisper/pipeline.py``
(``DecodingOptions``, the option checks, ``_get_initial_tokens``,
``_get_suppress_tokens``, ``_apply_filters``, ``_detect_impl`` /
``detect_language``, the greedy, sampled and beam branches of
``_generate_impl``, the ``n_group`` tiling of ``main_loop``,
``post_process`` with ``_maximum_likelihood_rank``, ``transcribe`` and
``transcribe_long``).  The JAX package runs the loop as one
``lax.while_loop``; here it is a Python loop over single-token decoder
steps (at batch 1 on the card, each one megakernel launch for all layers,
as the JAX package runs it on its accelerator).  Unlike the JAX loop it
does not run the decoder once more after the last token is chosen (those
logits were never read), so an utterance of n new tokens takes n - 1
decode steps.  The JAX package's ``fused=`` variant of ``transcribe`` (one
XLA program from mel to tokens) has no counterpart.

Sampling (``temperature > 0``) draws each token as argmax(logits / T +
Gumbel noise), which is what ``jax.random.categorical`` computes; the
noise comes from a ``torch.Generator`` on the pipeline's device seeded
with ``seed`` (the port cannot reproduce ``jax.random``'s streams).
``best_of`` decodes ``best_of`` sampled rows per audio and keeps the most
likely.  Beam search (``beam_size``): each audio's ``beam_size`` rows
expand jointly by cumulative log-probability; the KV cache stays put and a
``[n_audio, beam, n_text_ctx]`` cache-indirection table, advanced each
step, tells the decode attention which row wrote each position; tokens and
the timestamp-filter state are reordered by parent.

Tensor and data parallelism: with a decoder sharded by
``parallel.parallelize`` every rank of a tensor-parallel group runs the
encoder, the cross K/V and the loop (layer by layer: a shard never takes
the megakernel) on its heads; the filters and the argmax read the
gathered logits, which are the same on every rank, so every rank takes
the same token.  Over data-parallel ranks :meth:`WhisperPipeline.transcribe`
splits the batch (rank d of the ``dp`` group takes the d-th equal part)
and returns every rank's results, gathered in batch order.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ...audio.mel import HOP_LENGTH, SAMPLE_RATE, log_mel_spectrogram
from ...runtime.sampling import (beam_search_step, gather_beams,
                                 gumbel_noise, update_indirection)
from ...text.languages import LANGUAGES
from ...text.tokenizer import get_tokenizer
from .config import WhisperConfig
from .model import CrossAttnKV, WhisperDecoder, WhisperEncoder

CHUNK_LENGTH = 30
NEG_INF = float("-inf")


@dataclasses.dataclass(frozen=True)
class DecodingOptions:
    """The JAX package's options (same fields, same defaults)."""
    task: str = "transcribe"
    language: Optional[str] = None
    temperature: float = 0.0
    sample_len: Optional[int] = None
    best_of: Optional[int] = None
    beam_size: Optional[int] = None
    patience: Optional[float] = None
    length_penalty: Optional[float] = None
    prompt: Optional[Union[str, List[int]]] = None
    prefix: Optional[Union[str, List[int]]] = None
    suppress_tokens: Optional[Union[str, Sequence[int]]] = "-1"
    suppress_blank: bool = True
    without_timestamps: bool = False
    max_initial_timestamp: Optional[float] = 1.0


@dataclasses.dataclass(frozen=True)
class DecodingResult:
    audio_features: Optional[np.ndarray]
    language: str
    language_probs: Optional[Dict[str, float]] = None
    tokens: List[int] = dataclasses.field(default_factory=list)
    text: str = ""
    avg_logprob: float = np.nan
    no_speech_prob: float = np.nan
    temperature: float = np.nan
    compression_ratio: float = np.nan


def _maximum_likelihood_rank(tokens_groups, sum_logprobs_groups,
                             length_penalty: Optional[float]) -> List[int]:
    """The index of the best sequence of each group: sum of log-probs over
    the length, or over the GNMT penalty ((5 + len) / 6) ** length_penalty
    when it is given (the JAX package's ``_maximum_likelihood_rank``)."""
    selected = []
    for toks, lps in zip(tokens_groups, sum_logprobs_groups):
        scores = []
        for t, lp in zip(toks, lps):
            penalty = (len(t) if length_penalty is None
                       else ((5 + len(t)) / 6) ** length_penalty)
            scores.append(lp / penalty)
        selected.append(int(np.argmax(scores)))
    return selected


class WhisperPipeline:
    """Greedy or beam-search transcription over the port's three modules,
    on the device that holds their weights."""

    def __init__(self, config: WhisperConfig, encoder: WhisperEncoder,
                 decoder: WhisperDecoder, cross_kv: CrossAttnKV,
                 options: DecodingOptions = DecodingOptions(),
                 decode_megakernel: Optional[bool] = None):
        """``decode_megakernel``: decode steps at batch 1 run every decoder
        layer in one megakernel launch (``ops/decoder_layer.py``) when the
        decoder is eligible (on a card that includes a bf16 model; any
        other takes the layer-by-layer path).  None (the default) means on
        when the
        decoder's weights are on a CUDA card, off on the CPU (the JAX
        package's default is on its accelerator only); False keeps the
        layer-by-layer path."""
        # the JAX package's option checks
        if options.beam_size is not None and options.best_of is not None:
            raise ValueError("beam_size and best_of can't be given together")
        if options.temperature == 0 and options.best_of is not None:
            raise ValueError("best_of with greedy sampling is not compatible")
        if options.patience is not None and options.beam_size is None:
            raise ValueError("patience requires beam_size to be given")
        if options.patience is not None and options.patience != 1.0:
            raise NotImplementedError(
                "patience != 1 is not supported (finished beams are kept "
                "in-beam with frozen scores; extra finished-candidate "
                "collection is not implemented)")
        # beam rows per audio (1: greedy or sampled), and rows per audio
        # (differs from beam only with best_of)
        self.beam = options.beam_size or 1
        self.n_group = options.beam_size or options.best_of or 1
        self.config = config
        self.encoder = encoder
        self.decoder = decoder
        self.cross_kv = cross_kv
        heads = cross_kv.kv_weight.shape[2] // config.head_dim
        if heads != decoder.blocks[0].cross_attn.num_attention_heads:
            raise ValueError(
                f"the cross-KV makes {heads} heads a rank, the decoder's "
                "cross attention reads "
                f"{decoder.blocks[0].cross_attn.num_attention_heads}: they "
                "were sharded apart")
        self.options = options
        self.device = decoder.positional_embedding.device
        self.decode_megakernel = (self.device.type == "cuda"
                                  if decode_megakernel is None
                                  else decode_megakernel)
        self._mk_blobs = None
        self._rng: Optional[torch.Generator] = None
        self.tokenizer = get_tokenizer(config.n_vocab >= 51865,
                                       language=options.language or "en",
                                       task=options.task)
        tok = self.tokenizer
        self.sample_len = options.sample_len or config.n_text_ctx // 2
        self.sot_sequence = tok.sot_sequence
        if options.without_timestamps:
            self.sot_sequence = tok.sot_sequence_including_notimestamps
        self.initial_tokens = self._get_initial_tokens()
        self.sample_begin = len(self.initial_tokens)
        self.sot_index = self.initial_tokens.index(tok.sot)
        self.decode_steps = 0            # decoder steps of the last utterance

        v = config.n_vocab
        suppress = torch.zeros((v,), dtype=torch.float32)
        suppress[list(self._get_suppress_tokens())] = NEG_INF
        self._suppress_mask = suppress.to(self.device)
        blank = torch.zeros((v,), dtype=torch.float32)
        blank[tok.encode(" ") + [tok.eot]] = NEG_INF
        self._blank_mask = blank.to(self.device)
        self._col = torch.arange(v, device=self.device)[None, :]
        self._lang_ids = torch.tensor(tok.all_language_tokens,
                                      device=self.device)
        self.max_initial_timestamp_index = 0
        if options.max_initial_timestamp:
            precision = CHUNK_LENGTH / config.n_audio_ctx
            self.max_initial_timestamp_index = round(
                options.max_initial_timestamp / precision)

    def _get_initial_tokens(self) -> Tuple[int, ...]:
        tok = self.tokenizer
        tokens = list(self.sot_sequence)
        if self.options.prefix:
            prefix = self.options.prefix
            prefix_tokens = (tok.encode(" " + prefix.strip())
                             if isinstance(prefix, str) else list(prefix))
            if self.sample_len is not None:
                max_prefix_len = self.config.n_text_ctx // 2 - self.sample_len
                if max_prefix_len > 0:
                    prefix_tokens = prefix_tokens[-max_prefix_len:]
            tokens = tokens + prefix_tokens
        if self.options.prompt:
            prompt = self.options.prompt
            prompt_tokens = (tok.encode(" " + prompt.strip())
                             if isinstance(prompt, str) else list(prompt))
            tokens = ([tok.sot_prev]
                      + prompt_tokens[-(self.config.n_text_ctx // 2 - 1):]
                      + tokens)
        return tuple(tokens)

    def _get_suppress_tokens(self) -> Tuple[int, ...]:
        tok = self.tokenizer
        suppress = self.options.suppress_tokens
        if isinstance(suppress, str):
            suppress = [int(t) for t in suppress.split(",")]
        suppress = list(suppress) if suppress else []
        if -1 in suppress:
            suppress = [t for t in suppress if t >= 0]
            suppress.extend(tok.non_speech_tokens)
        suppress.extend([tok.transcribe, tok.translate, tok.sot,
                         tok.sot_prev, tok.sot_lm])
        if tok.no_speech is not None:
            suppress.append(tok.no_speech)
        return tuple(sorted(set(suppress)))

    def _apply_filters(self, logits: torch.Tensor, cur_len: int,
                       last_tok: torch.Tensor, penult_tok: torch.Tensor,
                       last_ts: torch.Tensor, has_ts: torch.Tensor
                       ) -> torch.Tensor:
        """logits [B, V] fp32; cur_len = tokens so far including the
        prompt; the rest is per-row state.  Returns filtered logits."""
        tok = self.tokenizer
        ts_begin = tok.timestamp_begin
        is_first = cur_len == self.sample_begin
        col = self._col
        if self.options.suppress_blank and is_first:
            logits = logits + self._blank_mask
        if self.options.suppress_tokens:
            logits = logits + self._suppress_mask
        if self.options.without_timestamps:
            return logits
        logits = logits.masked_fill(col == tok.no_timestamps, NEG_INF)
        last_was_ts = (last_tok >= ts_begin) & (cur_len > self.sample_begin)
        penult_was_ts = ((penult_tok >= ts_begin)
                         | (cur_len - self.sample_begin < 2))
        mask_ts = (last_was_ts & penult_was_ts)[:, None]
        mask_text = (last_was_ts & ~penult_was_ts)[:, None]
        logits = logits.masked_fill(mask_ts & (col >= ts_begin), NEG_INF)
        logits = logits.masked_fill(mask_text & (col < tok.eot), NEG_INF)
        # non-decreasing timestamps
        ts_last = torch.where(last_was_ts & ~penult_was_ts, last_ts,
                              last_ts + 1)
        lo = torch.where(has_ts, ts_last, ts_begin)[:, None]
        logits = logits.masked_fill(
            has_ts[:, None] & (col >= ts_begin) & (col < lo), NEG_INF)
        if is_first:
            # the first sampled token is a timestamp, bounded at the start
            logits = logits.masked_fill(col < ts_begin, NEG_INF)
            if self.max_initial_timestamp_index:
                last_allowed = ts_begin + self.max_initial_timestamp_index
                logits = logits.masked_fill(col > last_allowed, NEG_INF)
        # a timestamp wins when its total probability beats every text token
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_logprob = torch.logsumexp(logprobs[:, ts_begin:], dim=-1)
        max_text = logprobs[:, :ts_begin].max(dim=-1).values
        force_ts = (ts_logprob > max_text)[:, None]
        return logits.masked_fill(force_ts & (col < ts_begin), NEG_INF)

    def _megakernel_blobs(self, batch: int = 1):
        """The megakernel's weight image, packed once per pipeline; None
        when the megakernel is off, the batch is above 1 or the decoder is
        not eligible (the JAX package's ``_megakernel_blobs``)."""
        if (not self.decode_megakernel or batch != 1
                or not self.decoder.megakernel_eligible(self.device)):
            return None
        if self._mk_blobs is None:
            self._mk_blobs = self.decoder.megakernel_blobs()
        return self._mk_blobs

    def _gumbel(self, shape) -> torch.Tensor:
        """Standard Gumbel noise [shape] fp32 from the pipeline's generator
        (seeded by :meth:`main_loop`), one draw for each sampled step."""
        return gumbel_noise(shape, self._rng, self.device)

    @torch.inference_mode()
    def _detect(self, cross_kv) -> torch.Tensor:
        """One ``[sot]`` step over a fresh cache -> the softmax over the
        language tokens' logits [B, 99] (the JAX package's
        ``_detect_impl``)."""
        b = (cross_kv[0] if isinstance(cross_kv, tuple) else cross_kv
             ).shape[1]
        cache = self.decoder.new_kv_cache(b)
        x = torch.full((b, 1), self.tokenizer.sot, dtype=torch.long,
                       device=self.device)
        logits, _ = self.decoder(x, cache, cross_kv, 0, 1)
        return torch.softmax(logits[:, 0, self._lang_ids].float(), dim=-1)

    def detect_language(self, audio_features, cross_kv=None
                        ) -> Tuple[List[str], Optional[List[Dict]]]:
        """-> (the most likely language code of each audio, each audio's
        {code: probability}); with a language given (and a task other than
        ``lang_id``), that language and None."""
        n_audio = audio_features.shape[0]
        if (self.options.language is not None
                and self.options.task != "lang_id"):
            return [self.options.language] * n_audio, None
        if cross_kv is None:
            cross_kv = self.precompute_cross_kv(audio_features)
        lang_probs = self._detect(cross_kv).cpu().numpy()
        codes = self.tokenizer.all_language_codes
        probs = [{c: float(lang_probs[i, j]) for j, c in enumerate(codes)}
                 for i in range(lang_probs.shape[0])]
        return [max(p, key=p.get) for p in probs], probs

    @torch.inference_mode()
    def _generate(self, init_tokens: torch.Tensor, cross_kv, prompt_len: int,
                  max_new: int):
        """Greedy, sampled or beam-search decode.  init_tokens [B,
        prompt_len], in groups of ``n_group`` rows per audio with beams or
        ``best_of`` -> (tokens
        [B, prompt_len + max_new], cur_len, sum_logprobs [B],
        no_speech_probs [B]); with beams each row is one beam, its tokens
        its whole history."""
        tok = self.tokenizer
        b = init_tokens.shape[0]
        beam = self.beam
        ng = b // beam
        max_total = prompt_len + max_new
        ts_begin = tok.timestamp_begin
        dev = self.device
        cache = self.decoder.new_kv_cache(b)
        blobs = self._megakernel_blobs(b)
        logits_all, cache = self.decoder(init_tokens, cache, cross_kv, 0,
                                         prompt_len)
        probs_at_sot = torch.softmax(logits_all[:, self.sot_index].float(),
                                     dim=-1)
        no_speech_probs = probs_at_sot[:, tok.no_speech]
        logits = logits_all[:, -1].float()

        tokens = torch.full((b, max_total), tok.eot, dtype=torch.long,
                            device=dev)
        tokens[:, :prompt_len] = init_tokens
        bidx = torch.arange(b, device=dev)
        sum_lp = torch.zeros((b,), dtype=torch.float32, device=dev)
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        last_ts = torch.zeros((b,), dtype=torch.long, device=dev)
        has_ts = torch.zeros((b,), dtype=torch.bool, device=dev)
        ind = None
        if beam > 1:
            # every beam of a group is a copy of the prefill, so before the
            # first expansion only beam 0 may win: the rest start at -1e9
            sum_lp = torch.where(bidx % beam != 0, -1e9, 0.0)
            ind = torch.arange(beam, dtype=torch.int32, device=dev)[
                None, :, None].expand(ng, beam, self.config.n_text_ctx)
        cur = prompt_len
        steps = 0
        while True:
            logits = self._apply_filters(logits, cur, tokens[:, cur - 1],
                                         tokens[:, cur - 2], last_ts, has_ts)
            logprobs = torch.log_softmax(logits, dim=-1)
            if beam > 1:
                # the beams of a group expand jointly; state that belongs
                # to a beam follows its parent; the cache stays put and
                # the indirection table records where each history lives
                parent, tok_b, cum, fin = beam_search_step(
                    logprobs.reshape(ng, beam, -1),
                    sum_lp.reshape(ng, beam), finished.reshape(ng, beam),
                    beam, tok.eot)
                tokens, last_ts, has_ts, was_finished = (
                    x.reshape(b, *x.shape[2:]) for x in gather_beams(
                        (tokens.reshape(ng, beam, -1),
                         last_ts.reshape(ng, beam),
                         has_ts.reshape(ng, beam),
                         finished.reshape(ng, beam)), parent))
                ind = update_indirection(ind, parent, cur)
                next_tok = tok_b.reshape(b)
                finished = fin.reshape(b)
                sum_lp = cum.reshape(b)
            else:
                if self.options.temperature == 0:
                    next_tok = torch.argmax(logits, dim=-1)
                else:
                    next_tok = torch.argmax(
                        logits / self.options.temperature
                        + self._gumbel(logits.shape), dim=-1)
                cur_lp = logprobs[bidx, next_tok]
                sum_lp = sum_lp + torch.where(finished, 0.0, cur_lp)
                was_finished = finished
                finished = finished | (next_tok == tok.eot)
            # a finished row carries the end token
            next_tok = torch.where(was_finished, tok.eot, next_tok)
            live_ts = (next_tok >= ts_begin) & ~was_finished
            last_ts = torch.where(live_ts, next_tok, last_ts)
            has_ts = has_ts | live_ts
            tokens[:, cur] = next_tok
            cur += 1
            if cur >= max_total or bool(finished.all()):
                break
            step_logits, cache = self.decoder(next_tok[:, None], cache,
                                              cross_kv, cur - 1, cur,
                                              megakernel_blobs=blobs,
                                              beam_indirection=ind)
            logits = step_logits[:, -1].float()
            steps += 1
        self.decode_steps = steps
        return tokens, cur, sum_lp, no_speech_probs

    @torch.inference_mode()
    def get_audio_features(self, mel) -> torch.Tensor:
        dtype = self.encoder.conv1.weight.dtype
        mel = torch.as_tensor(mel, device=self.device).to(dtype)
        if mel.dim() == 2:
            mel = mel[None]
        return self.encoder(mel)

    @torch.inference_mode()
    def precompute_cross_kv(self, audio_features: torch.Tensor):
        return self.cross_kv(audio_features)

    def main_loop(self, audio_features, cross_kv=None, seed: int = 0,
                  languages: Optional[List[str]] = None):
        """-> (tokens [R, T] np, lengths [R], sum_logprobs [R],
        no_speech_probs [R]), R = n_audio * n_group rows (each audio's rows
        are consecutive).  ``languages`` (from :meth:`detect_language`)
        fills each audio's language slot when no language was given;
        ``seed`` seeds the sampling noise."""
        if cross_kv is None:
            cross_kv = self.precompute_cross_kv(audio_features)
        init = np.tile(np.asarray(self.initial_tokens, np.int64),
                       (audio_features.shape[0], 1))
        if languages is not None and self.options.language is None:
            for i, lang in enumerate(languages):
                init[i, self.sot_index + 1] = (self.tokenizer.sot + 1
                                               + list(LANGUAGES).index(lang))
        g = self.n_group
        if g > 1:
            # each audio's rows and its cross K/V once per row of its group
            # (the int8 cache is repeated, its per-layer scales are not)
            init = np.repeat(init, g, axis=0)
            if isinstance(cross_kv, tuple):
                cross_kv = (cross_kv[0].repeat_interleave(g, dim=1),
                            cross_kv[1])
            else:
                cross_kv = cross_kv.repeat_interleave(g, dim=1)
        self._rng = None
        if self.options.temperature > 0:
            self._rng = torch.Generator(device=self.device)
            self._rng.manual_seed(seed)
        tokens, cur, sum_lp, ns = self._generate(
            torch.from_numpy(init).to(self.device), cross_kv,
            len(self.initial_tokens), self.sample_len)
        lengths = np.full((init.shape[0],), cur, np.int32)
        return (tokens.cpu().numpy(), lengths, sum_lp.cpu().numpy(),
                ns.cpu().numpy())

    @staticmethod
    def compression_ratio(text: str) -> float:
        tb = text.encode("utf-8")
        return len(tb) / len(zlib.compress(tb))

    def post_process(self, tokens, lengths, sum_logprobs, no_speech_probs,
                     languages, audio_features=None) -> List[DecodingResult]:
        tok = self.tokenizer
        if audio_features is not None:
            audio_features = audio_features.float().cpu().numpy()
        g = self.n_group
        if g > 1:
            # rank each audio's rows (beams or samples) and keep the best
            n_audio = tokens.shape[0] // g
            groups_t, groups_lp = [], []
            for i in range(n_audio):
                rows = []
                for j in range(g):
                    seq = tokens[i * g + j,
                                 self.sample_begin:lengths[i * g + j]]
                    eot_pos = np.nonzero(seq == tok.eot)[0]
                    rows.append(seq[:eot_pos[0]] if eot_pos.size else seq)
                groups_t.append(rows)
                groups_lp.append([float(sum_logprobs[i * g + j])
                                  for j in range(g)])
            best = _maximum_likelihood_rank(groups_t, groups_lp,
                                            self.options.length_penalty)
            idx = [i * g + best[i] for i in range(n_audio)]
            tokens = tokens[idx]
            lengths = np.asarray(lengths)[idx]
            sum_logprobs = np.asarray(sum_logprobs)[idx]
            no_speech_probs = np.asarray(no_speech_probs)[idx]
        results = []
        for i in range(tokens.shape[0]):
            seq = tokens[i, self.sample_begin:lengths[i]]
            eot_pos = np.nonzero(seq == tok.eot)[0]
            if eot_pos.size:
                seq = seq[:eot_pos[0]]
            toks = [int(t) for t in seq]
            text = tok.decode(toks).strip()
            lp = float(sum_logprobs[i])
            results.append(DecodingResult(
                audio_features=(None if audio_features is None
                                else audio_features[i]),
                language=languages[i],
                tokens=toks,
                text=text,
                avg_logprob=lp / (len(toks) + 1),
                no_speech_prob=float(no_speech_probs[i]),
                temperature=self.options.temperature,
                compression_ratio=self.compression_ratio(text),
            ))
        return results

    def transcribe(self, mel, seed: int = 0,
                   keep_audio_features: bool = False
                   ) -> List[DecodingResult]:
        """A batch of 30 s mel windows [B, n_mels, 3000] -> results: encode,
        cross-KV, language detection, then the decode loop (``seed``: the
        sampling noise's).  With data-parallel ranks (the decoder's
        ``mapping``) each rank transcribes its part of the batch and every
        rank returns all the results."""
        mapping = getattr(self.decoder, "mapping", None)
        if mapping is None or not mapping.dp.active:
            return self._transcribe(mel, seed, keep_audio_features)
        import torch.distributed as dist
        mel = torch.as_tensor(mel)
        if mel.dim() == 2:
            mel = mel[None]
        n, dp = mel.shape[0], mapping.dp
        if n % dp.size:
            raise ValueError(f"a batch of {n} over {dp.size} data-parallel "
                             "ranks")
        part = n // dp.size
        mine = self._transcribe(mel[dp.rank * part:(dp.rank + 1) * part],
                                seed, keep_audio_features)
        every = [None] * dp.size
        dist.all_gather_object(every, mine, group=dp.group)
        return [r for rows in every for r in rows]

    def _transcribe(self, mel, seed: int, keep_audio_features: bool
                    ) -> List[DecodingResult]:
        xa = self.get_audio_features(mel)
        cross_kv = self.precompute_cross_kv(xa)
        languages, _ = self.detect_language(xa, cross_kv)
        tokens, lengths, sum_lp, ns = self.main_loop(xa, cross_kv, seed,
                                                     languages=languages)
        return self.post_process(tokens, lengths, sum_lp, ns, languages,
                                 xa if keep_audio_features else None)

    def transcribe_long(self, audio, seed: int = 0) -> Dict:
        """Long-form transcription: a window of 2 * n_audio_ctx mel frames
        (30 s on large-v2) slides over the clip, each decoded by
        :meth:`transcribe` and moved on by its last consecutive timestamp
        pair (the whole window when it has none).

        audio: 1-D float waveform at 16 kHz (any length).
        Returns {"text", "segments": [{start, end, text}], "language"}."""
        tok = self.tokenizer
        ts_begin = tok.timestamp_begin
        mel = log_mel_spectrogram(audio, device=self.device)     # [80, T]
        n_frames_total = mel.shape[-1]
        n_frames = 2 * self.config.n_audio_ctx
        input_stride = 2                    # mel frames per audio position
        time_precision = input_stride * HOP_LENGTH / SAMPLE_RATE
        seek = 0
        segments: List[Dict] = []
        language = self.options.language or "en"
        while seek < n_frames_total:
            window = mel[:, seek:seek + n_frames]
            pad = n_frames - window.shape[-1]
            if pad > 0:
                window = torch.nn.functional.pad(window, (0, pad))
            time_offset = seek * HOP_LENGTH / SAMPLE_RATE
            result = self.transcribe(window[None], seed=seed)[0]
            language = result.language
            tokens = np.asarray(result.tokens, np.int64)
            is_ts = tokens >= ts_begin
            # a consecutive timestamp pair closes a segment and opens the
            # next; each slice ends at the first timestamp of a pair
            consecutive = np.where(is_ts[:-1] & is_ts[1:])[0] + 1
            if len(consecutive):
                last_slice = 0
                for c in consecutive:
                    seg = tokens[last_slice:c]
                    ts_in = seg[seg >= ts_begin]
                    if len(ts_in) >= 2:
                        segments.append(dict(
                            start=time_offset + float(ts_in[0] - ts_begin)
                            * time_precision,
                            end=time_offset + float(ts_in[-1] - ts_begin)
                            * time_precision,
                            text=tok.decode([int(t) for t in seg
                                             if t < tok.eot]).strip()))
                    last_slice = c
                seek_units = int(tokens[consecutive[-1]] - ts_begin)
                # a pair at 0 would not move the window: take all of it
                seek += (seek_units * input_stride if seek_units > 0
                         else n_frames)
            else:
                # no closing pair: the whole window is consumed; trailing
                # timestamps give the segment's end where there are any
                ts_in = tokens[is_ts]
                end = (time_offset + float(ts_in[-1] - ts_begin)
                       * time_precision if len(ts_in)
                       else time_offset + min(
                           n_frames, n_frames_total - seek) * HOP_LENGTH
                       / SAMPLE_RATE)
                text = tok.decode([int(t) for t in tokens
                                   if t < tok.eot]).strip()
                if text:
                    segments.append(dict(start=time_offset, end=end,
                                         text=text))
                seek += n_frames
        return dict(text=" ".join(t for t in (s["text"] for s in segments)
                                  if t).strip(),
                    segments=segments, language=language)
