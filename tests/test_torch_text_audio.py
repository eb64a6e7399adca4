"""The port's text and audio stack against the JAX package on the CPU:

* the tokenizer's language tokens and ``decode_with_timestamps`` equal the
  JAX tokenizer's (seeded token lists);
* the port's assets are byte-identical copies of the JAX package's;
* ``EnglishTextNormalizer``, ``BasicTextNormalizer`` and ``wer`` give
  exactly the JAX package's outputs, on its own test cases and on a seeded
  corpus of numbers, currencies, ordinals, British spellings, symbols and
  diacritics;
* FLAC without a dataset: files written by ``tests/flac_writer.py`` (every
  subframe type, Rice parameters of 4 and 5 bits, escaped partitions,
  wasted bits, all four channel assignments, 16 and 24 bits, mono and
  stereo, short last blocks) decode bit for bit to the seeded samples,
  with the port and with the JAX package's decoder, STREAMINFO's MD5
  matching; a 44.1 kHz file, a corrupt CRC-8, CRC-16 or MD5 raise; and
  processes that build the library at once into a fresh directory all
  load it."""
import filecmp
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from eddie_wang_hackathon2023_tpu.native import flac as j_flac
from eddie_wang_hackathon2023_tpu.text import normalizers as jn
from eddie_wang_hackathon2023_tpu.text.wer import wer as j_wer
from eddie_wang_hackathon2023_tpu.text.wer import wer_single as j_wer_single
from eddie_wang_hackathon2023_tpu.text.tokenizer import (
    get_tokenizer as j_get_tokenizer)
from eddie_wang_hackathon2023_tpu_torch.audio import flac as pf
from eddie_wang_hackathon2023_tpu_torch.text import normalizers as pn
from eddie_wang_hackathon2023_tpu_torch.text.tokenizer import (
    ASSET_DIR, get_tokenizer)
from eddie_wang_hackathon2023_tpu_torch.text.wer import wer, wer_single
from flac_writer import Frame, Subframe, md5_of, write_flac

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
J_ASSETS = os.path.join(ROOT, "eddie_wang_hackathon2023_tpu", "assets")


# -- tokenizer and assets ------------------------------------------------------

TOKENIZERS = [(True, "en", "transcribe"), (True, "fr", "translate"),
              (True, "zh", "lang_id"), (True, None, None),
              (False, None, None)]


@pytest.mark.parametrize("multilingual,language,task", TOKENIZERS)
def test_tokenizer_language_tokens_match_jax(multilingual, language, task):
    j = j_get_tokenizer(multilingual, language=language, task=task)
    p = get_tokenizer(multilingual, language=language, task=task)
    assert p.sot_sequence == j.sot_sequence
    assert p.all_language_tokens == j.all_language_tokens
    assert p.all_language_codes == j.all_language_codes
    assert len(p.all_language_tokens) == 99
    if j.language is None:
        with pytest.raises(ValueError):
            j.language_token
        with pytest.raises(ValueError):
            p.language_token
    else:
        assert p.language_token == j.language_token == p.sot_sequence[1]


@pytest.mark.parametrize("multilingual", [True, False])
def test_decode_with_timestamps_matches_jax(multilingual):
    j = j_get_tokenizer(multilingual, language="en" if multilingual
                        else None)
    p = get_tokenizer(multilingual, language="en" if multilingual else None)
    rs = np.random.RandomState(3)
    top = p.timestamp_begin + 1501
    lists = [list(rs.randint(0, top, rs.randint(0, 40))) for _ in range(60)]
    # mostly text with timestamps among it, as a transcription has
    for _ in range(60):
        n = rs.randint(1, 40)
        toks = rs.randint(0, 20000, n)
        ts = rs.rand(n) < 0.2
        toks[ts] = p.timestamp_begin + rs.randint(0, 1501, ts.sum())
        lists.append(list(toks))
    lists.append([p.timestamp_begin, *p.encode(" hello"),
                  p.timestamp_begin + 54])
    for toks in lists:
        assert p.decode_with_timestamps(toks) == \
            j.decode_with_timestamps(toks), toks
        assert p.decode(toks) == j.decode(toks), toks
    assert p.decode_with_timestamps(lists[-1]) == "<|0.00|> hello<|1.08|>"


@pytest.mark.parametrize("name", ["multilingual.tiktoken", "gpt2.tiktoken",
                                  "english_spelling.json"])
def test_assets_are_byte_identical_copies(name):
    assert os.path.dirname(str(ASSET_DIR / name)) == os.path.join(
        ROOT, "eddie_wang_hackathon2023_tpu_torch", "assets")
    assert filecmp.cmp(ASSET_DIR / name, os.path.join(J_ASSETS, name),
                       shallow=False)


# -- normalizers and WER -------------------------------------------------------

# the JAX package's own cases (tests/test_text_audio.py)
ENGLISH_CASES = [
    "HE HOPED THERE WOULD BE STEW FOR DINNER",
    "Mr. Quilter is the apostle.",
    "he won't go; she'll stay",
    "nineteen sixty four",
    "one hundred and five",
    "twenty twenty",
    "one oh one dalmatians",
    "the colour of the aeroplane was grey",
    "it's the 1960s!",
    "the twenty second",
    "three and a half",
    "one hundred twenty three dollars",
    "five percent",
    "one thousand nine hundred eighty four",
    "Hello, World! (noise)",
]

PIECES = {
    "number": ["one", "two", "three", "eleven", "nineteen", "twenty",
               "forty", "ninety nine", "hundred", "one hundred and five",
               "thousand", "two thousand and one", "million", "billion",
               "a half", "and a half", "point five", "oh", "zero", "minus",
               "nineteen sixty four", "twenty twenty", "one oh one",
               "sixties", "nineteen eighties", "a hundred", "dozen"],
    "digits": ["1960s", "10,000", "1.5", "3.14", "2020", "007", "42",
               "1,234,567", "-7", "+3", "1/2", "24/7", "9-5", "80%"],
    "ordinal": ["first", "second", "third", "twenty second", "hundredth",
                "thirty first", "1st", "22nd", "3rd", "104th", "twelfth",
                "ninetieth"],
    "currency": ["$5", "£20", "€3.50", "¥100", "five dollars",
                 "twenty cents", "one dollar and five cents", "ten pounds",
                 "two euros", "$1.99", "3¢", "one pound"],
    "title": ["Mr.", "Mrs.", "Ms.", "Dr.", "St.", "Jr.", "Prof.", "Capt.",
              "Gen.", "Rev."],
    "contraction": ["won't", "it's", "he'd", "y'all", "ain't", "can't",
                    "they're", "I'm", "we've", "let's", "o'clock"],
    "filler": ["hmm", "uh", "um", "mm", "ah", "hm"],
    "symbol": ["&", "@", "#", "(noise)", "[laughter]", "<unk>", "—", "...",
               "!", "?", ";", ":", "\"quoted\"", "'single'", "a-b",
               "%", "*", "x/y", "♪", "{brace}"],
    "diacritic": ["café", "naïve", "Ångström", "œuvre", "straße", "Đorđe",
                  "þorn", "Łódź", "Æsir", "São Paulo", "résumé", "Øresund",
                  "crème brûlée", "ﬁne", "Ⅻ"],
    "word": ["the", "colour", "and", "of", "a", "was", "he", "she", "it",
             "to", "per", "cent", "percent", "point", "in", "at", "as"],
}


def _corpus(n=300, seed=0):
    rs = np.random.RandomState(seed)
    spelling = json.load(open(ASSET_DIR / "english_spelling.json"))
    british = sorted(spelling)
    kinds = sorted(PIECES) + ["british"]
    out = []
    for _ in range(n):
        words = []
        for _ in range(rs.randint(1, 9)):
            kind = kinds[rs.randint(len(kinds))]
            pool = british if kind == "british" else PIECES[kind]
            w = pool[rs.randint(len(pool))]
            r = rs.rand()
            w = w.upper() if r < 0.15 else (w.capitalize() if r < 0.3
                                            else w)
            words.append(w)
        sep = [" ", " ", ", ", ". ", "  "][rs.randint(5)]
        out.append(sep.join(words) + ["", ".", "!", "?"][rs.randint(4)])
    return out


CORPUS = _corpus()


def test_english_normalizer_matches_jax():
    j, p = jn.EnglishTextNormalizer(), pn.EnglishTextNormalizer()
    texts = ENGLISH_CASES + CORPUS
    out = [p(t) for t in texts]
    assert out == [j(t) for t in texts]
    # the JAX package's expectations hold for the port too
    assert out[:4] == ["he hoped there would be stew for dinner",
                       "mister quilter is the apostle",
                       "he will not go she will stay", "1964"]
    assert p("the colour of the aeroplane was grey") == \
        "the color of the airplane was gray"


@pytest.mark.parametrize("remove_diacritics,split_letters",
                         [(False, False), (True, False), (True, True)])
def test_basic_normalizer_matches_jax(remove_diacritics, split_letters):
    """``split_letters`` asks the standard ``re`` for ``\\X``, which it does
    not know: both raise the same error (a fault of the JAX module that
    the copy keeps)."""
    kw = dict(remove_diacritics=remove_diacritics,
              split_letters=split_letters)
    j, p = jn.BasicTextNormalizer(**kw), pn.BasicTextNormalizer(**kw)
    texts = ENGLISH_CASES + CORPUS
    if split_letters:
        for norm in (j, p):
            with pytest.raises(re.error, match="bad escape"):
                norm(texts[0])
        return
    assert [p(t) for t in texts] == [j(t) for t in texts]
    assert pn.BasicTextNormalizer()("Hello, World! (noise)") == "hello world"


def test_wer_matches_jax():
    cases = [(["a b c"], ["a b c"]), (["a b c d"], ["a x c d"]),
             (["a b"], ["a b c"]), (["a b c"], ["a c"]),
             (["a", "b c d e f g h i j"], ["x", "b c d e f g h i j"]),
             ([""], ["a"]), (["a"], [""])]
    assert [wer(*c) for c in cases] == [j_wer(*c) for c in cases]
    assert wer(*cases[1]) == 0.25 and wer(*cases[4]) == 0.1
    rs = np.random.RandomState(1)
    vocab = "the a of cat dog sat on mat 1964 mister".split()
    refs, hyps = [], []
    for _ in range(200):
        refs.append(" ".join(rs.choice(vocab, rs.randint(0, 12))))
        hyps.append(" ".join(rs.choice(vocab, rs.randint(0, 12))))
    norm_j, norm_p = jn.EnglishTextNormalizer(), pn.EnglishTextNormalizer()
    assert wer(refs, hyps) == j_wer(refs, hyps)
    assert [wer_single(r, h) for r, h in zip(refs, hyps)] == \
        [j_wer_single(r, h) for r, h in zip(refs, hyps)]
    pairs = list(zip(CORPUS[::2], CORPUS[1::2]))
    assert wer([norm_p(r) for r, _ in pairs],
                  [norm_p(h) for _, h in pairs]) == \
        j_wer([norm_j(r) for r, _ in pairs], [norm_j(h) for _, h in pairs])


# -- FLAC ----------------------------------------------------------------------

def _signal(rs, n, bps, channels, smooth=True):
    """Seeded samples: a tone and noise, or noise over the full range."""
    top = (1 << (bps - 1)) - 1
    t = np.arange(n)
    cols = []
    for c in range(channels):
        if smooth:
            x = (0.4 * top * np.sin(2 * np.pi * (220 + 110 * c) * t / 16000)
                 + rs.randn(n) * top * 0.01)
        else:
            x = rs.randn(n) * top * 0.3
        cols.append(np.clip(np.round(x), -top - 1, top).astype(np.int64))
    return np.stack(cols, axis=1)


def _fixed(order, **kw):
    return Subframe(kind="fixed", order=order, **kw)


LPC8 = dict(kind="lpc", coefs=(1800, -900, 300, -150, 80, -40, 20, -10),
            precision=12, shift=10)


def _case(name):
    """(samples int [n, ch], frames, bps) of one seeded FLAC case."""
    rs = np.random.RandomState(sorted(FLAC_CASES).index(name))
    if name == "mono16_fixed_orders":
        x = _signal(rs, 5 * 1024 + 100, 16, 1)
        frames = [Frame(1024, [_fixed(o, porder=2)]) for o in range(5)]
        return x, frames + [Frame(100, [_fixed(2)])], 16
    if name == "mono16_constant_verbatim_wasted":
        x = _signal(rs, 3 * 576 + 300, 16, 1)
        x[:576] = -1234                       # a constant block
        x[2 * 576:3 * 576] &= ~7              # 3 wasted bits
        frames = [Frame(576, [Subframe(kind="constant")]),
                  Frame(576, [Subframe(kind="verbatim")]),
                  Frame(576, [_fixed(3, wasted=3, porder=1)]),
                  Frame(300, [Subframe(kind="verbatim", wasted=0)])]
        return x, frames, 16
    if name == "mono16_lpc_rice_escape":
        x = _signal(rs, 4096 + 2048 + 256, 16, 1)
        frames = [Frame(4096, [Subframe(**LPC8, method=1, porder=3,
                                        escape=(1, 5))]),
                  Frame(2048, [Subframe(kind="lpc", coefs=(700,) * 32,
                                        precision=15, shift=14, method=0,
                                        porder=4, escape=(0,))]),
                  Frame(256, [Subframe(kind="lpc", coefs=(2048, -1024),
                                       precision=13, shift=10)])]
        return x, frames, 16
    if name == "stereo16_assignments":
        x = _signal(rs, 4 * 1152 + 77, 16, 2)
        frames = [Frame(1152, [_fixed(2), Subframe(**LPC8)], a)
                  for a in ("independent", "left_side", "right_side",
                            "mid_side")]
        return x, frames + [Frame(77, [_fixed(1), _fixed(0)],
                                  "mid_side")], 16
    if name == "stereo24_noise":
        x = _signal(rs, 2 * 4608 + 999, 24, 2, smooth=False)
        x[4608:2 * 4608] &= ~0xF              # 4 wasted bits
        frames = [Frame(4608, [Subframe(kind="verbatim"),
                               _fixed(1, method=1, porder=2, escape=(3,))],
                        "mid_side"),
                  Frame(4608, [_fixed(0, wasted=4, method=1),
                               _fixed(2, wasted=4, method=1, porder=1)],
                        "left_side"),
                  Frame(999, [Subframe(**LPC8, method=1),
                              Subframe(kind="verbatim")], "right_side")]
        return x, frames, 24
    if name == "mono24_short_last":
        x = _signal(rs, 2304 + 64, 24, 1)
        frames = [Frame(2304, [_fixed(4, method=1, porder=5)]),
                  Frame(64, [_fixed(4, method=0, escape=(0,))])]
        return x, frames, 24
    raise KeyError(name)


FLAC_CASES = ["mono16_fixed_orders", "mono16_constant_verbatim_wasted",
              "mono16_lpc_rice_escape", "stereo16_assignments",
              "stereo24_noise", "mono24_short_last"]


@pytest.mark.parametrize("name", FLAC_CASES)
def test_flac_decodes_bit_exact(name, tmp_path):
    x, frames, bps = _case(name)
    path = str(tmp_path / f"{name}.flac")
    write_flac(path, x, frames, bps=bps)
    pcm, sr, got_bps = pf.decode_pcm(path)
    assert (sr, got_bps) == (16000, bps)
    np.testing.assert_array_equal(pcm, x)
    with open(path, "rb") as f:
        assert f.read(42)[26:42] == md5_of(pcm, bps) == md5_of(x, bps)
    want = (x[:, 0] if x.shape[1] == 1 else x.mean(axis=1)).astype(
        np.float32) / float(1 << (bps - 1))
    audio = pf.read_flac(path)
    assert audio.dtype == np.float32 and audio.shape == (x.shape[0],)
    np.testing.assert_array_equal(audio, want)
    np.testing.assert_array_equal(audio, j_flac.decode_file(path))
    assert np.abs(audio).max() <= 1.0


def test_flac_other_sample_rate_raises(tmp_path):
    x, frames, bps = _case("mono16_fixed_orders")
    path = str(tmp_path / "44k.flac")
    write_flac(path, x, frames, bps=bps, sample_rate=44100)
    np.testing.assert_array_equal(pf.decode_pcm(path)[0], x)
    for decode in (pf.read_flac, j_flac.decode_file):
        with pytest.raises(RuntimeError, match="44100"):
            decode(path)


@pytest.mark.parametrize("where", ["crc8", "crc16", "md5"])
def test_flac_corruption_raises(where, tmp_path):
    x, frames, bps = _case("stereo16_assignments")
    path = str(tmp_path / "ok.flac")
    offsets = write_flac(path, x, frames, bps=bps)
    data = bytearray(open(path, "rb").read())
    if where == "crc8":
        # the second frame's header CRC-8: sync (2), codes (2), frame
        # number (1), then the CRC
        data[offsets[1] + 5] ^= 0x10
    elif where == "crc16":
        data[offsets[1] - 1] ^= 0x01          # the first frame's CRC-16
    else:
        data[30] ^= 0x80                      # inside STREAMINFO's MD5
    bad = str(tmp_path / "bad.flac")
    open(bad, "wb").write(bytes(data))
    with pytest.raises(RuntimeError):
        pf.read_flac(bad)


BUILD_SCRIPT = """
import sys
from pathlib import Path
sys.path.insert(0, sys.argv[1])
from eddie_wang_hackathon2023_tpu_torch.audio import flac
flac.BUILD_DIR = Path(sys.argv[2])
pcm, sr, bps = flac.decode_pcm(sys.argv[3])
print(flac.library_path().name, pcm.shape[0], sr, bps)
"""


def test_flac_library_builds_concurrently(tmp_path):
    """Four processes build the library at once into a fresh directory:
    each links its own temporary file and renames it onto the final name,
    so every process loads a whole library."""
    x, frames, bps = _case("mono16_fixed_orders")
    path = str(tmp_path / "a.flac")
    write_flac(path, x, frames, bps=bps)
    build = tmp_path / "build"
    procs = [subprocess.Popen(
        [sys.executable, "-c", BUILD_SCRIPT, ROOT, str(build), path],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    lines = {out.strip() for out, _ in outs}
    name = pf.library_path().name
    assert lines == {f"{name} {x.shape[0]} 16000 16"}
    assert sorted(os.listdir(build)) == [name]
