"""WER/CER with a plain-Python edit distance (no ``Levenshtein``)."""

from __future__ import annotations

from typing import Iterable, Sequence, Tuple


def edit_distance(a: Sequence, b: Sequence) -> int:
    """Levenshtein distance (unit insert/delete/substitute) between two
    sequences of hashable items, in O(len(a) * len(b)) time and
    O(len(b)) memory."""
    prev = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        cur = [i]
        for j, y in enumerate(b, 1):
            cur.append(min(prev[j] + 1, cur[j - 1] + 1,
                           prev[j - 1] + (x != y)))
        prev = cur
    return prev[-1]


def word_errors(ref: str, hyp: str) -> Tuple[int, int]:
    """(edit_distance_in_words, ref_word_count)."""
    rw = ref.split()
    return edit_distance(rw, hyp.split()), len(rw)


def char_errors(ref: str, hyp: str) -> Tuple[int, int]:
    return edit_distance(ref, hyp), len(ref)


def wer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    errs = total = 0
    for r, h in zip(refs, hyps):
        e, n = word_errors(r, h)
        errs += e
        total += n
    return errs / max(total, 1)


def cer(refs: Iterable[str], hyps: Iterable[str]) -> float:
    errs = total = 0
    for r, h in zip(refs, hyps):
        e, n = char_errors(r, h)
        errs += e
        total += n
    return errs / max(total, 1)
