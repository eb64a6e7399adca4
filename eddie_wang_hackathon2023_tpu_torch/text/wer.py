"""Word error rate, the port's copy of the JAX package's ``text/wer.py``:
word-level Levenshtein with jiwer's definition (the reference's,
summarize.py:181), (S + D + I) / len(reference_words)."""
from __future__ import annotations

from typing import List, Sequence, Tuple


def _edit_distance(ref: Sequence[str], hyp: Sequence[str]) -> int:
    n, m = len(ref), len(hyp)
    if n == 0:
        return m
    prev = list(range(m + 1))
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        ri = ref[i - 1]
        for j in range(1, m + 1):
            cost = 0 if ri == hyp[j - 1] else 1
            cur[j] = min(prev[j] + 1,        # deletion
                         cur[j - 1] + 1,     # insertion
                         prev[j - 1] + cost)  # substitution/match
        prev = cur
    return prev[m]


def wer(references: List[str], hypotheses: List[str]) -> float:
    """Corpus-level WER over whitespace tokens (jiwer.wer semantics)."""
    assert len(references) == len(hypotheses)
    total_edits = 0
    total_words = 0
    for ref, hyp in zip(references, hypotheses):
        r, h = ref.split(), hyp.split()
        total_edits += _edit_distance(r, h)
        total_words += len(r)
    return total_edits / max(total_words, 1)


def wer_single(reference: str, hypothesis: str) -> Tuple[int, int]:
    r, h = reference.split(), hypothesis.split()
    return _edit_distance(r, h), len(r)
