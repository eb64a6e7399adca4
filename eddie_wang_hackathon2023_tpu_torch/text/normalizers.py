"""Text normalisation for WER evaluation: the port's copy of the JAX
package's ``text/normalizers.py`` (pure Python; the spelling table is read
from the port's own ``assets/``).

Behavioural counterpart of ``E/whisper/normalizers/`` (basic.py:56
BasicTextNormalizer, english.py EnglishTextNormalizer used by the WER
harness, summarize.py:159-181).  The British->American spelling table is the
public data file shipped as ``assets/english_spelling.json``.

The spelled-number canonicaliser here is an independent implementation (a
small shift-reduce pass over number words) rather than a port of OpenAI's;
it covers the grammar that occurs in read-speech corpora (cardinals,
tens/units, hundred/thousand/million... multipliers, ordinal and plural
suffixes, "oh" digit strings, decimal points, minus).  It is applied to
reference and hypothesis symmetrically, so residual differences from the
reference normaliser affect both sides equally.
"""
from __future__ import annotations

import json
import os
import re
import unicodedata
from typing import List

_ASSET_DIR = os.path.join(os.path.dirname(__file__), "..", "assets")

ADDITIONAL_DIACRITICS = {
    "œ": "oe", "Œ": "OE", "ø": "o", "Ø": "O", "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS", "đ": "d", "Đ": "D", "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th", "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """Replace markers/symbols/punctuation with a space, drop diacritics
    (ref basic.py:27-44)."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in ADDITIONAL_DIACRITICS:
            out.append(ADDITIONAL_DIACRITICS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            if cat[0] in "MSP":
                out.append(" ")
            else:
                out.append(c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """ref basic.py:46-53: symbols/punctuation -> space, keep diacritics."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    """ref basic.py:56-76."""

    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self.clean = (remove_symbols_and_diacritics if remove_diacritics
                      else remove_symbols)
        self.split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed annotations
        s = re.sub(r"\(([^)]+?)\)", "", s)        # parenthesised
        s = self.clean(s).lower()
        if self.split_letters:
            s = " ".join(re.findall(r"\X", s, re.U))
        s = re.sub(r"\s+", " ", s)
        return s.strip()


# ---------------------------------------------------------------------------
# spelled-number canonicalisation (independent implementation, see module doc)
# ---------------------------------------------------------------------------

_ONES = {w: i for i, w in enumerate(
    ["one", "two", "three", "four", "five", "six", "seven", "eight", "nine",
     "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen", "sixteen",
     "seventeen", "eighteen", "nineteen"], start=1)}
_TENS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50, "sixty": 60,
         "seventy": 70, "eighty": 80, "ninety": 90}
_MULT = {"hundred": 100, "thousand": 10**3, "million": 10**6,
         "billion": 10**9, "trillion": 10**12}
_ZEROS = {"o", "oh", "zero"}

_ORD_ONES = {"first": (1, "st"), "second": (2, "nd"), "third": (3, "rd"),
             "fifth": (5, "th"), "eighth": (8, "th"), "ninth": (9, "th"),
             "twelfth": (12, "th"), "zeroth": (0, "th")}
for _w, _v in _ONES.items():
    if _v not in (1, 2, 3, 5, 8, 9, 12):
        _ORD_ONES[_w + ("h" if _w.endswith("t") else "th")] = (_v, "th")
_ORD_TENS = {w.replace("y", "ieth"): (v, "th") for w, v in _TENS.items()}
_PLURAL_ONES = {("sixes" if w == "six" else w + "s"): (v, "s")
                for w, v in _ONES.items()}
_PLURAL_TENS = {w.replace("y", "ies"): (v, "s") for w, v in _TENS.items()}
_ORD_MULT = {w + "th": (v, "th") for w, v in _MULT.items()}
_PLURAL_MULT = {w + "s": (v, "s") for w, v in _MULT.items()}


_CURRENCY = {"dollar": "$", "dollars": "$", "pound": "£", "pounds": "£",
             "cent": "¢", "cents": "¢", "euro": "€", "euros": "€"}
_PREFIXERS = {"minus": "-", "negative": "-"}


def _is_number_word(w: str) -> bool:
    return (w in _ZEROS or w in _ONES or w in _TENS or w in _MULT
            or w in _ORD_ONES or w in _ORD_TENS or w in _PLURAL_ONES
            or w in _PLURAL_TENS or w in _ORD_MULT or w in _PLURAL_MULT
            or ("-" in w and w.split("-")[0] in _TENS))


class EnglishNumberNormalizer:
    """Spelled numbers -> arabic digits with the composition semantics of
    the reference normaliser: additive composition where place values allow
    ("twenty one" -> 21, "one hundred and five" -> 105), decimal-string
    concatenation where they don't ("nineteen sixty four" -> 1964,
    "one two three" -> 123), multiplier accumulation at >=1000 boundaries
    ("one thousand nine hundred eighty four" -> 1984), ordinal/plural
    suffixes, zeros as digit appends, "point" decimals, "N and a half",
    minus/negative prefixes, and currency words -> prefixed symbols."""

    def __call__(self, s: str) -> str:
        words = s.split()
        out: List[str] = []
        i = 0
        n = len(words)
        while i < n:
            w = words[i]
            if w in _PREFIXERS and i + 1 < n and _is_number_word(words[i + 1]):
                value, suffix, consumed = self._parse(words, i + 1)
                if consumed:
                    i = self._emit(words, i + 1 + consumed,
                                   _PREFIXERS[w] + str(value), suffix, out)
                    continue
            value, suffix, consumed = self._parse(words, i)
            if consumed:
                i = self._emit(words, i + consumed, str(value), suffix, out)
            else:
                out.append(w)
                i += 1
        # glue bare decimals onto the preceding word ("one" ".5" -> "one.5",
        # matching the reference's rendering)
        glued: List[str] = []
        for t in out:
            if t.startswith(".") and glued:
                glued[-1] += t
            else:
                glued.append(t)
        return " ".join(glued)

    def _emit(self, words: List[str], j: int, value: str, suffix: str,
              out: List[str]) -> int:
        """Emit a parsed number, folding in trailing currency/percent/
        'and a half' constructs.  Returns the next index."""
        n = len(words)
        if not suffix and j < n and words[j] in _CURRENCY:
            out.append(_CURRENCY[words[j]] + value)
            return j + 1
        if not suffix and j < n and words[j] == "percent":
            out.append(value + "%")
            return j + 1
        if (not suffix and j + 2 < n and words[j] == "and"
                and words[j + 1] == "a" and words[j + 2] == "half"
                and "." not in value):
            out.append(value + ".5")
            return j + 3
        out.append(value + suffix)
        return j

    def _split_hyphen(self, w: str):
        if "-" in w:
            parts = w.split("-")
            if len(parts) == 2 and parts[0] in _TENS:
                for table in (_ONES, _ORD_ONES, _PLURAL_ONES):
                    if parts[1] in table:
                        entry = table[parts[1]]
                        if table is _ONES:
                            if entry < 10:
                                return _TENS[parts[0]] + entry, "", False
                        elif entry[0] < 10:
                            return _TENS[parts[0]] + entry[0], entry[1], True
        return None

    def _parse(self, words: List[str], i: int):
        """Parse one number phrase.  Returns (value: int|str, suffix,
        consumed).

        ``group`` composes additively while place values are vacant
        ("sixty" + "four" -> 64); when a word cannot compose, the finished
        group's digits are pushed onto ``prefix`` and a new group starts
        ("nineteen" | "sixty four" -> "19" + "64").  ``total`` accumulates
        at thousand-and-above boundaries."""
        prefix = ""        # concatenated completed groups (and zeros)
        base = 0           # accumulated at thousand+ boundaries
        since = None       # additively-composable part since the last mult
        suffix = ""
        prev_class = None  # 'ones' | 'teens' | 'tens' | 'mult' | 'zeros'
        j = i
        n = len(words)

        def group_val():
            return (base + (since or 0)) if (since is not None or base) else None

        def push():
            nonlocal prefix, base, since
            g = group_val()
            if g is not None:
                prefix += str(g)
            base, since = 0, None

        def started():
            return since is not None or base or prefix != ""

        def place_free(sub: int) -> bool:
            g = since if since is not None else (base if base else None)
            return g is not None and g != 0 and \
                g % (10 ** len(str(sub))) == 0

        def classify(w: str):
            """(value, class, suffix) for small number words, else None."""
            if w in _ONES:
                v = _ONES[w]
                return (v, "ones" if v < 10 else "teens", "")
            if w in _TENS:
                return (_TENS[w], "tens", "")
            for table, cls in ((_ORD_ONES, None), (_PLURAL_ONES, None),
                               (_ORD_TENS, "tens"), (_PLURAL_TENS, "tens")):
                if w in table:
                    v, suf = table[w]
                    c = cls or ("ones" if v < 10 else "teens")
                    return (v, c, suf)
            return None

        def apply_mult(m: int):
            """hundred scales the open sub-group; thousand+ closes it into
            base ("five hundred thousand" -> 500*1000; "one thousand nine
            hundred" -> 1000 + 900)."""
            nonlocal base, since
            if m == 100:
                since = (since if since is not None else 1) * 100
            else:
                base += (since if since is not None else 1) * m
                since = None

        def compose_small(v: int, cls: str) -> None:
            nonlocal since
            if since is None:
                since = v
            else:
                since += v

        while j < n:
            w = words[j]
            hyphen = self._split_hyphen(w)
            if hyphen is not None:
                v, suf, _terminal = hyphen
                if prev_class == "mult" and place_free(v):
                    compose_small(v, "tens")
                else:
                    push()
                    since = v
                prev_class = "tens"
                j += 1
                if suf:
                    suffix = suf
                    break
                continue
            if w in _ZEROS:
                push()
                prefix += "0"
                prev_class = "zeros"
                j += 1
                continue
            if w == "double" and j + 1 < n and (
                    words[j + 1] in _ZEROS or
                    (words[j + 1] in _ONES and _ONES[words[j + 1]] < 10)):
                d = 0 if words[j + 1] in _ZEROS else _ONES[words[j + 1]]
                push()
                prefix += str(d) * 2
                prev_class = "zeros"
                j += 2
                continue
            small = classify(w)
            if small is not None:
                v, cls, suf = small
                if not started() and v == 1 and not suf and not (
                        j + 1 < n and _is_number_word(words[j + 1])):
                    break  # standalone "one" stays spelled out
                if not started() and v == 1 and suf == "s":
                    break  # "ones" stays a word
                compose = (place_free(v)
                           and ((cls == "ones" and prev_class in ("tens", "mult"))
                                or (cls in ("teens", "tens")
                                    and prev_class == "mult")))
                if since is None and base and prev_class == "mult" and \
                        (base % (10 ** len(str(v)))) == 0:
                    compose = True
                if not started():
                    since = v
                elif compose:
                    compose_small(v, cls)
                else:
                    push()
                    since = v
                prev_class = cls
                j += 1
                if suf:
                    suffix = suf
                    break
                continue
            if w in _MULT or w in _ORD_MULT or w in _PLURAL_MULT:
                if w in _MULT:
                    m, suf = _MULT[w], ""
                elif w in _ORD_MULT:
                    m, suf = _ORD_MULT[w]
                else:
                    m, suf = _PLURAL_MULT[w]
                if prefix and since is None and not base:
                    break  # "oh five hundred": don't multiply digit strings
                apply_mult(m)
                prev_class = "mult"
                j += 1
                if suf:
                    suffix = suf
                    break
                continue
            if w == "and":
                if (j + 1 < n and not prefix and prev_class == "mult"
                        and _is_number_word(words[j + 1])
                        and words[j + 1] not in _MULT):
                    j += 1
                    continue
                break
            if w == "point" and started() and not prefix:
                frac = self._parse_fraction(words, j + 1)
                if frac is not None:
                    digits, k = frac
                    return (str(group_val() or 0) + "." + digits, "", k - i)
                break
            break

        consumed = j - i
        if consumed == 0 or not started():
            if i < n and words[i] == "point":
                frac = self._parse_fraction(words, i + 1)
                if frac is not None:
                    digits, k = frac
                    return ("." + digits, "", k - i)
            return (0, "", 0)
        if prefix:
            g = group_val()
            value = prefix + (str(g) if g is not None else "")
        else:
            value = group_val() or 0
        return (value, suffix, consumed)

    def _parse_fraction(self, words: List[str], start: int):
        """Digits after "point": zeros, ones, teens/tens (with composition).
        Returns (digit_string, next_index) or None."""
        frac = ""
        k = start
        n = len(words)
        pending_tens = None
        while k < n:
            w = words[k]
            if w in _ZEROS:
                if pending_tens is not None:
                    frac += str(pending_tens)
                    pending_tens = None
                frac += "0"
            elif w in _TENS:
                if pending_tens is not None:
                    frac += str(pending_tens)
                pending_tens = _TENS[w]
            elif w in _ONES:
                v = _ONES[w]
                if pending_tens is not None and v < 10:
                    frac += str(pending_tens + v)
                    pending_tens = None
                elif pending_tens is not None:
                    frac += str(pending_tens) + str(v)
                    pending_tens = None
                else:
                    frac += str(v)
            else:
                break
            k += 1
        if pending_tens is not None:
            frac += str(pending_tens)
        if not frac:
            return None
        return frac, k


class EnglishSpellingNormalizer:
    """British -> American mapping (public data,
    assets/english_spelling.json; ref english.py:480-494)."""

    def __init__(self):
        with open(os.path.join(_ASSET_DIR, "english_spelling.json")) as f:
            self.mapping = json.load(f)

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


class EnglishTextNormalizer:
    """ref english.py:497-550 pipeline: annotations out, contractions and
    abbreviations expanded, symbols stripped, numbers canonicalised,
    spelling americanised, whitespace collapsed."""

    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",
            r"'s got\b": " has got",
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)
        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)
        s = re.sub(r"(\d),(\d)", r"\1\2", s)           # remove commas in nums
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)         # keep decimal points
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")
        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)
        s = re.sub(r"\s+", " ", s)
        return s.strip()
