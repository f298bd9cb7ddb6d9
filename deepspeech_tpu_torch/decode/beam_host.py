"""Host-side CTC prefix beam search (the oracle and the LM-fusion path).

The port's copy of the JAX package's ``decode/beam_host.py``: the exact
dict-based prefix beam search of the DS2 lineage (Hannun et al.,
"First-Pass Large Vocabulary Continuous Speech Recognition using
Bi-Directional Recurrent DNNs"), with optional word-boundary n-gram LM
fusion:

    score(prefix) = log P_ctc(prefix) + alpha * log P_lm(words)
                    + beta * |words|

It serves two roles:
1. the *oracle* that faster decoders (the on-device search in beam.py,
   and the C++ host decoder) are tested against;
2. the Python path of ``decode.mode="beam_fused"``: word-LM shallow
   fusion, which needs string-keyed LM state.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

LOG_ZERO = -float("inf")


def _lse(a: float, b: float) -> float:
    if a == LOG_ZERO:
        return b
    if b == LOG_ZERO:
        return a
    m = a if a > b else b
    return m + math.log(math.exp(a - m) + math.exp(b - m))


class _LMState:
    """Incremental word-LM scorer over a growing character prefix.

    ``space_id=None`` selects *char mode* for space-less vocabularies
    (Mandarin): every extension closes a one-character
    "word", matching character-level n-gram LM fusion.
    """

    __slots__ = ("lm", "alpha", "beta", "space_id", "id_to_char")

    def __init__(self, lm, alpha: float, beta: float,
                 space_id: Optional[int], id_to_char):
        self.lm = lm
        self.alpha = alpha
        self.beta = beta
        self.space_id = space_id
        self.id_to_char = id_to_char

    def char_bonus(self, prefix: Tuple[int, ...]) -> float:
        """Char mode: LM contribution of the just-appended character."""
        chars = [self.id_to_char(i) for i in prefix]
        logp = self.lm.score_word(chars[:-1], chars[-1])
        return self.alpha * logp + self.beta

    def word_bonus(self, prefix: Tuple[int, ...]) -> float:
        """LM contribution when ``prefix`` just closed a word with a space.

        ``prefix`` ends with space_id; the word is the chars between the
        previous space and this one (split leaves a trailing "" for the
        final space, so the closed word is words[-2]).
        """
        words = self.words_of(prefix)
        if len(words) < 2 or not words[-2]:
            return 0.0
        logp = self.lm.score_word(words[:-2], words[-2])
        return self.alpha * logp + self.beta

    def words_of(self, prefix: Tuple[int, ...]) -> List[str]:
        text = "".join(self.id_to_char(i) for i in prefix)
        return text.split(" ")


def prefix_beam_search_host(
    log_probs: np.ndarray,
    beam_width: int = 64,
    blank_id: int = 0,
    prune_log_prob: float = LOG_ZERO,
    lm=None,
    lm_alpha: float = 0.5,
    lm_beta: float = 1.0,
    space_id: Optional[int] = None,
    id_to_char=None,
) -> List[Tuple[Tuple[int, ...], float]]:
    """Decode one utterance.

    Args:
      log_probs: [T, V] log-softmax outputs.
      beam_width: number of prefixes kept per step.
      blank_id: CTC blank index (0 in this framework).
      prune_log_prob: per-step vocab pruning threshold — symbols with
        log prob below it are not considered for extension.
      lm / lm_alpha / lm_beta / space_id / id_to_char: optional word-LM
        shallow fusion; ``lm`` must expose
        ``score_word(history_words, word) -> logp`` (see ngram.NGramLM).

    Returns:
      List of (prefix_ids, combined_score) sorted best-first; the score
      includes the LM bonus when fusion is enabled. Length <= beam_width.
    """
    T, V = log_probs.shape
    fuse = None
    if lm is not None:
        if id_to_char is None:
            raise ValueError(
                "LM fusion needs id_to_char (and space_id for word-level "
                "vocabs; space_id=None means char-level fusion)")
        fuse = _LMState(lm, lm_alpha, lm_beta, space_id, id_to_char)

    # prefix -> (log p_blank, log p_nonblank), both CTC-only.
    beams: Dict[Tuple[int, ...], Tuple[float, float]] = {(): (0.0, LOG_ZERO)}
    # prefix -> accumulated LM bonus (alpha*logp + beta per closed word).
    lm_bonus: Dict[Tuple[int, ...], float] = {(): 0.0}

    for t in range(T):
        lp = log_probs[t]
        next_beams: Dict[Tuple[int, ...], Tuple[float, float]] = defaultdict(
            lambda: (LOG_ZERO, LOG_ZERO))
        next_bonus: Dict[Tuple[int, ...], float] = {}

        for prefix, (p_b, p_nb) in beams.items():
            last = prefix[-1] if prefix else None
            # Stay via blank.
            nb_b, nb_nb = next_beams[prefix]
            nb_b = _lse(nb_b, _lse(p_b, p_nb) + lp[blank_id])
            # Stay via repeated last symbol (collapses).
            if last is not None:
                nb_nb = _lse(nb_nb, p_nb + lp[last])
            next_beams[prefix] = (nb_b, nb_nb)
            next_bonus.setdefault(prefix, lm_bonus[prefix])

            for v in range(V):
                if v == blank_id or lp[v] < prune_log_prob:
                    continue
                ext = prefix + (v,)
                e_b, e_nb = next_beams[ext]
                if v == last:
                    # Only reachable through a blank gap.
                    e_nb = _lse(e_nb, p_b + lp[v])
                else:
                    e_nb = _lse(e_nb, _lse(p_b, p_nb) + lp[v])
                next_beams[ext] = (e_b, e_nb)
                if ext not in next_bonus:
                    bonus = lm_bonus[prefix]
                    if fuse is not None:
                        if fuse.space_id is None:
                            bonus += fuse.char_bonus(ext)
                        elif v == fuse.space_id:
                            bonus += fuse.word_bonus(ext)
                    next_bonus[ext] = bonus

        def key(item):
            prefix, (p_b, p_nb) = item
            return _lse(p_b, p_nb) + next_bonus[prefix]

        top = sorted(next_beams.items(), key=key, reverse=True)[:beam_width]
        beams = dict(top)
        lm_bonus = {p: next_bonus[p] for p in beams}

    out = []
    for prefix, (p_b, p_nb) in beams.items():
        score = _lse(p_b, p_nb) + lm_bonus[prefix]
        # Score the final (unclosed) word too, as the DS2 decoders do at
        # end-of-utterance. Char mode has no unclosed words.
        if fuse is not None and fuse.space_id is not None:
            words = fuse.words_of(prefix)
            if words and words[-1]:
                score += (fuse.alpha *
                          fuse.lm.score_word(words[:-1], words[-1],
                                             eos=True) + fuse.beta)
        out.append((prefix, float(score)))
    out.sort(key=lambda kv: kv[1], reverse=True)
    return out


def exhaustive_ctc_best(log_probs: np.ndarray, blank_id: int = 0,
                        max_len: Optional[int] = None
                        ) -> Tuple[Tuple[int, ...], float]:
    """Brute force: the most probable *labeling* by summing all paths.

    Only feasible for tiny (T, V); used to validate the beam search
    oracle in tests.
    """
    from itertools import product

    T, V = log_probs.shape
    max_len = T if max_len is None else min(max_len, T)
    symbols = [v for v in range(V) if v != blank_id]

    def labeling_logp(labels: Sequence[int]) -> float:
        # Standard CTC forward over the extended sequence.
        ext = [blank_id]
        for l in labels:
            ext += [l, blank_id]
        S = len(ext)
        if S > 2 * T + 1:
            return LOG_ZERO
        alpha = [LOG_ZERO] * S
        alpha[0] = log_probs[0][blank_id]
        if S > 1:
            alpha[1] = log_probs[0][ext[1]]
        for t in range(1, T):
            new = [LOG_ZERO] * S
            for s in range(S):
                a = alpha[s]
                if s >= 1:
                    a = _lse(a, alpha[s - 1])
                if s >= 2 and ext[s] != blank_id and ext[s] != ext[s - 2]:
                    a = _lse(a, alpha[s - 2])
                new[s] = a + log_probs[t][ext[s]]
            alpha = new
        out = alpha[S - 1]
        if S > 1:
            out = _lse(out, alpha[S - 2])
        return out

    best, best_lp = (), labeling_logp(())
    for L in range(1, max_len + 1):
        for labels in product(symbols, repeat=L):
            lp = labeling_logp(labels)
            if lp > best_lp:
                best, best_lp = labels, lp
    return best, best_lp
