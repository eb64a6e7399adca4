"""Whisper tokenizer without tiktoken.

The GPU machine has neither ``tiktoken`` nor ``regex``.  This tokenizer
reads the port's own copies of the JAX package's rank files
(``<base64 bytes> <rank>`` per line, in ``../assets/``) and adds Whisper's
special tokens after them in the same order.

* ``decode`` concatenates the tokens' bytes (invalid UTF-8 replaced, as
  tiktoken does).
* ``encode`` is a byte-level BPE that merges the lowest-ranked adjacent
  pair first.  It takes its whole input as ONE pre-token, which is what
  the GPT-2 split pattern does for the strings the pipeline encodes (a
  space, the non-speech symbols, an optional leading space before a run of
  letters, digits or symbols) and raises for any other string.  Special
  token strings map to their ids.
"""
from __future__ import annotations

import base64
from dataclasses import dataclass, field
from functools import cached_property, lru_cache
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .languages import LANGUAGES, TO_LANGUAGE_CODE

ASSET_DIR = Path(__file__).resolve().parents[1] / "assets"


def _special_token_names() -> List[str]:
    return [
        "<|endoftext|>",
        "<|startoftranscript|>",
        *[f"<|{lang}|>" for lang in LANGUAGES],
        "<|translate|>",
        "<|transcribe|>",
        "<|startoflm|>",
        "<|startofprev|>",
        "<|nospeech|>",
        "<|notimestamps|>",
        *[f"<|{i * 0.02:.2f}|>" for i in range(1501)],
    ]


def _char_class(c: str) -> str:
    if c.isalpha():
        return "letter"
    if c.isnumeric():
        return "number"
    if c.isspace():
        return "space"
    return "other"


class Encoding:
    """Byte-level BPE ranks plus special tokens."""

    def __init__(self, name: str, ranks: Dict[bytes, int],
                 special_tokens: Dict[str, int]):
        self.name = name
        self.ranks = ranks
        self.n_vocab = len(ranks)
        self.special_tokens = special_tokens
        self._bytes = {rank: tok for tok, rank in ranks.items()}
        self._bytes.update({i: s.encode("utf-8")
                            for s, i in special_tokens.items()})

    def encode(self, text: str) -> List[int]:
        if text in self.special_tokens:
            return [self.special_tokens[text]]
        body = text[1:] if text.startswith(" ") and len(text) > 1 else text
        classes = {_char_class(c) for c in body}
        if len(classes) != 1 and not text.isspace():
            raise ValueError(f"{text!r} is not a single pre-token; this "
                             "tokenizer encodes only such strings")
        return self._bpe(text.encode("utf-8"))

    def _bpe(self, piece: bytes) -> List[int]:
        if piece in self.ranks:
            return [self.ranks[piece]]
        parts = [piece[i:i + 1] for i in range(len(piece))]
        while len(parts) > 1:
            best_rank, best_i = None, -1
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            parts[best_i:best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [self.ranks[p] for p in parts]

    def decode(self, ids) -> str:
        return b"".join(self._bytes[int(i)] for i in ids).decode(
            "utf-8", errors="replace")


@lru_cache(maxsize=None)
def get_encoding(name: str = "multilingual") -> Encoding:
    with open(ASSET_DIR / f"{name}.tiktoken") as f:
        ranks = {base64.b64decode(token): int(rank)
                 for token, rank in (line.split() for line in f if line)}
    n_vocab = len(ranks)
    specials = {tok: n_vocab + i
                for i, tok in enumerate(_special_token_names())}
    return Encoding(name, ranks, specials)


@dataclass
class Tokenizer:
    encoding: Encoding
    language: Optional[str] = None
    task: Optional[str] = None
    sot_sequence: Tuple[int, ...] = field(default=())

    def __post_init__(self):
        self.special_tokens = dict(self.encoding.special_tokens)
        sot = self.special_tokens["<|startoftranscript|>"]
        seq = [sot]
        if self.language is not None:
            seq.append(sot + 1 + list(LANGUAGES).index(self.language))
        if self.task is not None:
            seq.append(self.special_tokens["<|transcribe|>"]
                       if self.task == "transcribe"
                       else self.special_tokens["<|translate|>"])
        self.sot_sequence = tuple(seq)

    def encode(self, text: str) -> List[int]:
        return self.encoding.encode(text)

    def decode(self, token_ids) -> str:
        ids = [int(t) for t in token_ids if int(t) < self.timestamp_begin]
        return self.encoding.decode(ids)

    def decode_with_timestamps(self, token_ids) -> str:
        """The text with each timestamp token written as ``<|1.08|>``."""
        parts: List[str] = []
        run: List[int] = []
        for t in (int(x) for x in token_ids):
            if t >= self.timestamp_begin:
                if run:
                    parts.append(self.encoding.decode(run))
                    run = []
                parts.append(f"<|{(t - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                run.append(t)
        if run:
            parts.append(self.encoding.decode(run))
        return "".join(parts)

    @cached_property
    def eot(self) -> int:
        return self.special_tokens["<|endoftext|>"]

    @cached_property
    def transcribe(self) -> int:
        return self.special_tokens["<|transcribe|>"]

    @cached_property
    def translate(self) -> int:
        return self.special_tokens["<|translate|>"]

    @cached_property
    def sot(self) -> int:
        return self.special_tokens["<|startoftranscript|>"]

    @cached_property
    def sot_lm(self) -> int:
        return self.special_tokens["<|startoflm|>"]

    @cached_property
    def sot_prev(self) -> int:
        return self.special_tokens["<|startofprev|>"]

    @cached_property
    def no_speech(self) -> int:
        return self.special_tokens["<|nospeech|>"]

    @cached_property
    def no_timestamps(self) -> int:
        return self.special_tokens["<|notimestamps|>"]

    @cached_property
    def timestamp_begin(self) -> int:
        return self.special_tokens["<|0.00|>"]

    @cached_property
    def language_token(self) -> int:
        if self.language is None:
            raise ValueError("tokenizer has no language specified")
        return self.sot + 1 + list(LANGUAGES).index(self.language)

    @cached_property
    def all_language_tokens(self) -> Tuple[int, ...]:
        return tuple(self.sot + 1 + i for i in range(len(LANGUAGES)))

    @cached_property
    def all_language_codes(self) -> Tuple[str, ...]:
        return tuple(LANGUAGES)

    @cached_property
    def sot_sequence_including_notimestamps(self) -> Tuple[int, ...]:
        return tuple(list(self.sot_sequence) + [self.no_timestamps])

    @cached_property
    def non_speech_tokens(self) -> Tuple[int, ...]:
        """Speaker tags and annotations to suppress (keeps basic
        punctuation), as in the JAX package."""
        symbols = list('"#()*+/:;<=>@[\\]^_`{|}~「」『』')
        symbols += ("<< >> <<< >>> -- --- -( -[ (' (\" (( )) ((( ))) [[ ]] "
                    "{{ }} ♪♪ ♪♪♪").split()
        miscellaneous = set("♩♪♫♬♭♮♯")
        result = {self.encode(" -")[0], self.encode(" '")[0]}
        for symbol in symbols + list(miscellaneous):
            for toks in [self.encode(symbol), self.encode(" " + symbol)]:
                if len(toks) == 1 or symbol in miscellaneous:
                    result.add(toks[0])
        return tuple(sorted(result))


@lru_cache(maxsize=None)
def get_tokenizer(multilingual: bool = True, language: Optional[str] = None,
                  task: Optional[str] = None) -> Tokenizer:
    if language is not None:
        language = language.lower()
        if language not in LANGUAGES:
            if language in TO_LANGUAGE_CODE:
                language = TO_LANGUAGE_CODE[language]
            else:
                raise ValueError(f"Unsupported language: {language}")
    if multilingual:
        name = "multilingual"
        language = language or "en"
        task = task or "transcribe"
    else:
        name = "gpt2"
        language = None
        task = None
    return Tokenizer(encoding=get_encoding(name), language=language,
                     task=task)
