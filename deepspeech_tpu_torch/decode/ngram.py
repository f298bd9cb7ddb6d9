"""Word n-gram LM: ARPA reader + Katz-backoff scoring.

The port's copy of the JAX package's ``decode/ngram.py``. The DS2
lineage rescored CTC beams with the external KenLM C++ library. KenLM
stays external here too: if the ``kenlm`` Python package is importable
it is used, else the port's own C++ ARPA engine (``csrc/host``, bound by
``native.py``), else this pure-Python ARPA reader, all with the same
semantics (log10 probs, Katz backoff, <s>/</s>/<unk> handling) for
standard ARPA files. The fusion tables are built on the host in numpy,
equal to the JAX package's, and handed to the search as tensors.

Scores are log10, matching KenLM/ARPA conventions; the fusion weights
(lm_alpha) are therefore directly comparable to DS2-lineage settings.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

BOS, EOS, UNK = "<s>", "</s>", "<unk>"
# log10 floor for OOV words when the LM has no <unk> entry; shared by
# the host scorer (logp) and the dense device-fusion table so the two
# fusion paths cannot diverge.
OOV_FLOOR = -10.0


class NGramLM:
    """Katz-backoff n-gram LM over words, loaded from an ARPA file."""

    def __init__(self, ngrams: Dict[int, Dict[Tuple[str, ...],
                                              Tuple[float, float]]],
                 order: int):
        # ngrams[n][(w1..wn)] = (log10 prob, log10 backoff)
        self.ngrams = ngrams
        self.order = order
        self.has_unk = (UNK,) in ngrams.get(1, {})

    # -- construction -----------------------------------------------------

    @classmethod
    def from_arpa(cls, path: str) -> "NGramLM":
        ngrams: Dict[int, Dict[Tuple[str, ...], Tuple[float, float]]] = {}
        order = 0
        section = 0
        with open(path, encoding="utf-8") as f:
            in_data = False
            for raw in f:
                line = raw.strip()
                if not line:
                    continue
                if line == "\\data\\":
                    in_data = True
                    continue
                if line.startswith("ngram ") and in_data:
                    continue
                if line.startswith("\\") and line.endswith("-grams:"):
                    section = int(line[1:line.index("-")])
                    order = max(order, section)
                    ngrams.setdefault(section, {})
                    continue
                if line == "\\end\\":
                    break
                if not section:
                    continue
                parts = line.split("\t")
                if len(parts) == 1:
                    parts = line.split()
                    logp, words, backoff = (
                        float(parts[0]), parts[1:1 + section],
                        parts[1 + section:])
                    backoff = float(backoff[0]) if backoff else 0.0
                else:
                    logp = float(parts[0])
                    words = parts[1].split()
                    backoff = float(parts[2]) if len(parts) > 2 else 0.0
                ngrams[section][tuple(words)] = (logp, backoff)
        if not order:
            raise ValueError(f"no n-gram sections found in {path!r}")
        return cls(ngrams, order)

    # -- scoring ----------------------------------------------------------

    def _lookup(self, gram: Tuple[str, ...]) -> Optional[Tuple[float, float]]:
        return self.ngrams.get(len(gram), {}).get(gram)

    def logp(self, history: Sequence[str], word: str) -> float:
        """log10 P(word | history), Katz backoff, KenLM-compatible.

        Unknown words map to <unk> when the LM has it, else a floor.
        """
        word = self._map_unk(word)
        if word is None:
            return OOV_FLOOR
        hist = tuple(self._map_unk(w) or w for w in history)
        hist = hist[-(self.order - 1):] if self.order > 1 else ()
        return self._backoff_logp(hist, word)

    def _map_unk(self, word: str) -> Optional[str]:
        """KenLM semantics: every OOV token (in history too) becomes
        <unk>; None when the LM has no <unk> entry."""
        if (word,) in self.ngrams.get(1, {}):
            return word
        return UNK if self.has_unk else None

    def _backoff_logp(self, hist: Tuple[str, ...], word: str) -> float:
        entry = self._lookup(hist + (word,))
        if entry is not None:
            return entry[0]
        if not hist:
            # Unigram exists by the <unk>/floor check in logp().
            return self.ngrams[1][(word,)][0]
        bo = self._lookup(hist)
        backoff = bo[1] if bo is not None else 0.0
        return backoff + self._backoff_logp(hist[1:], word)

    def score_word(self, history_words: Sequence[str], word: str,
                   eos: bool = False) -> float:
        """log10 P(word | <s> + history); used for shallow fusion.

        With ``eos`` the </s> transition after ``word`` is included,
        for end-of-utterance scoring of the final word.
        """
        history = [BOS] + [w for w in history_words if w]
        logp = self.logp(history, word)
        if eos:
            logp += self.logp(history + [word], EOS)
        return logp

    def score_eos(self, words: Sequence[str]) -> float:
        return self.logp([BOS] + [w for w in words if w], EOS)

    def score_sentence(self, sentence: str, include_eos: bool = True
                       ) -> float:
        """Total log10 prob of a sentence, KenLM ``score()`` semantics."""
        words = sentence.split()
        total = 0.0
        history = [BOS]
        for w in words:
            total += self.logp(history, w)
            history.append(w)
        if include_eos:
            total += self.logp(history, EOS)
        return total


def load_lm(path: str):
    """Load an LM, fastest available engine first: the kenlm package
    (which also reads KenLM binary files), then the port's own C++ ARPA
    engine (``csrc/host/ngram.cc``), then the pure-Python ARPA reader.
    All three have the same ``score_word`` / ``score_sentence``
    semantics (tests/test_torch_ngram.py,
    tests/test_torch_native_decoder.py).

    The ``kenlm`` package is not installed here, so ``_KenLMWrapper``
    is held to a stub of the kenlm API it calls (``Model(path)``,
    ``.order``, ``.score(sent, bos=, eos=)``)."""
    try:
        import kenlm  # type: ignore

        return _KenLMWrapper(kenlm.Model(path))
    except ImportError:
        pass
    from .. import native

    if native.available():
        try:
            return native.NativeNGram(path)
        except (ValueError, RuntimeError):
            pass  # unreadable as ARPA; let the Python reader report it
    return NGramLM.from_arpa(path)


class _KenLMWrapper:
    """Adapts the kenlm package to the NGramLM scoring interface.

    Prefix scores are memoized so the per-word cost of beam-search
    fusion stays O(1) kenlm calls (the previous prefix's full score is
    always in the cache), not O(words).
    """

    _CACHE_MAX = 1 << 16

    def __init__(self, model):
        self.model = model
        self.order = model.order
        self._cache: Dict[Tuple[str, ...], float] = {}

    def _prefix_score(self, words: Tuple[str, ...]) -> float:
        if not words:
            return 0.0
        hit = self._cache.get(words)
        if hit is None:
            hit = self.model.score(" ".join(words), bos=True, eos=False)
            if len(self._cache) >= self._CACHE_MAX:
                self._cache.clear()
            self._cache[words] = hit
        return hit

    def score_word(self, history_words: Sequence[str], word: str,
                   eos: bool = False) -> float:
        hist = tuple(history_words)
        full = self._prefix_score(hist + (word,))
        if eos:
            full = self.model.score(" ".join(hist + (word,)), bos=True,
                                    eos=True)
        return full - self._prefix_score(hist)

    def score_sentence(self, sentence: str, include_eos: bool = True
                       ) -> float:
        return self.model.score(sentence, bos=True, eos=include_eos)


# Dense-table entry budget (256 MB of f32); shared by the builder's
# context cap and fusion_table_for's auto dense-vs-hashed choice so the
# two can never drift.
DENSE_TABLE_MAX_ENTRIES = 64 * 1024 * 1024


def dense_fusion_table(lm: NGramLM, id_to_char, vocab_size: int,
                       alpha: float, beta: float, context_size: int = 0,
                       blank_id: int = 0,
                       max_table_entries: int = DENSE_TABLE_MAX_ENTRIES):
    """Materialize char-level LM fusion as one dense gather table.

    The reference fuses its n-gram LM on the host because LM state is
    string-keyed; the on-device equivalent (a finite-state
    approximation) precomputes, for every
    possible (k-1)-character context, the fully-backed-off fusion bonus
    of every next character:

        table[ctx, v] = alpha * log10 P_lm(char_v | ctx) + beta

    so the on-device beam search (beam.py) carries one int32 rolling
    context index per beam and fuses the LM with a single gather per
    step — no host round-trips, no tries, no hashing.

    Context encoding: base-``vocab_size`` digits of the last (k-1)
    emitted symbol ids, oldest first, left-padded with 0 (the CTC blank,
    which never appears inside a prefix). A leading run of zeros means
    "before sentence start"; the construction below reproduces
    ``NGramLM.score_word``'s ``<s>``-prefixed, order-truncated history
    semantics exactly.

    Args:
      lm: a pure-Python ``NGramLM`` (the builder walks its ARPA tables;
        KenLM binaries must be converted to ARPA text for device fusion).
      id_to_char: symbol id -> character (the tokenizer's decode of 1).
      vocab_size: model vocab size V including the blank.
      alpha / beta: shallow-fusion weights (same meaning as host fusion).
      context_size: LM context length k-1; 0 = auto (lm.order - 1,
        capped so the table stays under ``max_table_entries``).
      blank_id: must be 0 (the context padding digit).

    Returns:
      (table, context_size): float32 ``[V**context_size, V]`` numpy
      array and the context length actually used.
    """
    if blank_id != 0:
        raise ValueError("dense fusion requires blank_id == 0")
    V = vocab_size
    # Contexts beyond order-1 cannot change any score: clamp.
    k1 = min(context_size if context_size > 0 else lm.order - 1,
             lm.order - 1)
    k_req = k1  # what the caller effectively asked for, post order-clamp
    while k1 > 0 and V ** k1 * V > max_table_entries:
        k1 -= 1
    if context_size > 0 and k1 < k_req:
        # The dense table is exponential in context: an EXPLICIT
        # context request the budget can't honor is a hard error with
        # the scale made concrete (bytes, not just entries) and the way
        # out named. E.g. AISHELL V=4336: k=1 is 75 MB, k=2 would be
        # ~326 GB — bigram fusion on device, trigram+ via host
        # rescoring (decode.mode="beam"/"beam_fused").
        # (Order-clamping alone is not an error: extra context beyond
        # order-1 cannot change any score.)
        want = V ** (k_req + 1)
        raise ValueError(
            f"device LM fusion table for context_size={k_req} "
            f"needs V^{k_req + 1} = {want:,} float32 entries "
            f"(~{want * 4 / 2 ** 30:.1f} GiB) at V={V}, over the "
            f"{max_table_entries:,}-entry budget. Use a shorter "
            f"device_lm_context (auto caps to the budget) and rescore "
            f"higher orders on host (decode.mode='beam' n-best "
            f"rescoring or 'beam_fused' full fusion)")

    unigrams = lm.ngrams.get(1, {})
    FLOOR = OOV_FLOOR

    # Per-digit LM tokens. Word columns: the character, <unk>, or the
    # floor. Context rows: digit 0 is the pre-start padding (maps to
    # <s>); OOV context chars with no <unk> get a per-digit sentinel
    # that can never match an ARPA entry (pure-backoff semantics, same
    # as the scorer keeping the raw unseen char in the history).
    word_tok: List[Optional[str]] = [None] * V  # None => floor column
    ctx_tok: List[Optional[str]] = [None] * V   # None => miss-everything
    ctx_tok[0] = BOS
    for d in range(1, V):
        ch = id_to_char(d)
        if (ch,) in unigrams:
            word_tok[d] = ctx_tok[d] = ch
        elif lm.has_unk:
            word_tok[d] = ctx_tok[d] = UNK
    tok_to_word_digits: Dict[str, List[int]] = {}
    tok_to_ctx_digits: Dict[str, List[int]] = {}
    for d in range(1, V):
        if word_tok[d] is not None:
            tok_to_word_digits.setdefault(word_tok[d], []).append(d)
        if ctx_tok[d] is not None:
            tok_to_ctx_digits.setdefault(ctx_tok[d], []).append(d)

    def ctx_rows(tokens: Tuple[str, ...]) -> List[int]:
        """All table rows whose digit tuple maps to ``tokens``."""
        rows = [0]
        for i, t in enumerate(tokens):
            if t == BOS:
                if i != 0:  # histories only ever start with <s>
                    return []
                digits = [0]
            elif t == EOS:
                return []
            else:
                digits = tok_to_ctx_digits.get(t, [])
                if not digits:
                    return []
            rows = [r * V + d for r in rows for d in digits]
        return rows

    import numpy as np

    # Order-1 base: unigram log10 prob per word column.
    table = np.full((V,), FLOOR, np.float64)
    for d in range(1, V):
        if word_tok[d] is not None:
            table[d] = lm._backoff_logp((), word_tok[d])

    # Backoff recursion, one order at a time: a row (d1..dm-1) starts
    # from backoff(tokens(d1..dm-1)) + previous-order row (d2..dm-1),
    # then explicit m-grams overwrite their cells. Dropping the oldest
    # digit also makes multi-zero-padded rows alias the shorter-history
    # rows, matching score_word's truncation at sentence start.
    for m in range(2, k1 + 2):
        rows = V ** (m - 1)
        bo = np.zeros((rows,), np.float64)
        for gram, (_, backoff) in lm.ngrams.get(m - 1, {}).items():
            if backoff:
                for r in ctx_rows(gram):
                    bo[r] = backoff
        table = bo[:, None] + table.reshape(V ** (m - 2), V)[
            np.arange(rows) % V ** (m - 2)]
        for gram, (logp, _) in lm.ngrams.get(m, {}).items():
            cols = tok_to_word_digits.get(gram[-1], [])
            if not cols:
                continue
            for r in ctx_rows(gram[:-1]):
                for c in cols:
                    table[r, c] = logp

    table = table.reshape(V ** k1, V)
    out = (alpha * table + beta).astype(np.float32)
    # Floor columns bypass backoff entirely in the scorer (logp returns
    # the floor before any history handling); the blank column is never
    # queried but gets the same defined value.
    for d in range(V):
        if word_tok[d] is None:
            out[:, d] = alpha * FLOOR + beta
    return out, k1


def fusion_table_for(lm_or_path, id_to_char, vocab_size: int,
                     alpha: float, beta: float, context_size: int = 0,
                     vocab_has_space: bool = False, impl: str = "auto"):
    """Build the device-fusion table from an LM object or ARPA path,
    with the user-facing guardrails shared by every entry point
    (infer's beam_fused_device, serve's --decode=beam): clear error for
    non-ARPA files, a warning for word-level (spaced) vocabs, and a
    warning when the context is capped below the LM order.

    ``impl`` selects the table layout (DecodeConfig.device_lm_impl):
    "dense" -> a ``[V^k, V]`` float32 tensor; "hashed" -> a
    ``hashed_lm.HashedFusionTable`` (O(#ngrams) memory, trigram+ at
    Mandarin vocab sizes); "auto" -> dense while it holds the wanted
    context within its entry budget, else hashed. Both are made on the
    CPU; ``.to(device)`` moves either where the search runs, and
    ``beam_search(..., lm_table=...)`` takes both.
    """
    import logging

    log = logging.getLogger(__name__)
    if impl not in ("auto", "dense", "hashed"):
        raise ValueError(f"device_lm_impl {impl!r} not in "
                         f"('auto', 'dense', 'hashed')")
    if vocab_has_space:
        log.warning(
            "device LM fusion scores the LM per CHARACTER; this vocab "
            "has spaces, so a word-level ARPA will mostly hit <unk>. "
            "Use a char-level LM here, or host fusion/rescoring "
            "(beam_fused / beam) for word-level models.")
    if isinstance(lm_or_path, NGramLM):
        lm = lm_or_path
    else:
        try:
            lm = NGramLM.from_arpa(lm_or_path)
        except (UnicodeDecodeError, ValueError, KeyError, IndexError,
                OverflowError) as e:
            # Beyond decode errors: a KenLM *binary* that happens to
            # decode as text can fail anywhere inside the ARPA reader
            # (KeyError/IndexError on malformed sections) — normalize
            # all parse failures to the same friendly error.
            raise ValueError(
                f"device LM fusion builds its dense table from ARPA "
                f"text; {lm_or_path!r} is not readable as ARPA (KenLM "
                f"binaries must be converted — keep or regenerate the "
                f".arpa produced by lmplz)") from e
    import torch

    if impl == "auto":
        # Dense is one gather per step — prefer it while it can hold
        # the wanted context; switch to hashed when the budget caps
        # dense below that (e.g. AISHELL trigrams: dense tops out at
        # bigram, hashed packs order-3 contexts in int32).
        want = min(context_size if context_size > 0 else lm.order - 1,
                   lm.order - 1)
        k_dense = want  # mirror dense_fusion_table's budget cap
        while (k_dense > 0
               and vocab_size ** (k_dense + 1) > DENSE_TABLE_MAX_ENTRIES):
            k_dense -= 1
        impl = "dense" if k_dense >= want else "hashed"
        if impl == "hashed":
            log.info(
                "device LM fusion: dense table caps at %d-char context "
                "(V=%d); using the hashed table for the full %d-char "
                "context", k_dense, vocab_size, want)
    if impl == "hashed":
        from .hashed_lm import hashed_fusion_table

        table = hashed_fusion_table(lm, id_to_char, vocab_size, alpha,
                                    beta, context_size=context_size)
        wanted = min(context_size if context_size > 0 else lm.order - 1,
                     lm.order - 1)
        if table.k < wanted:  # int32-packing cap, not a user request
            log.warning(
                "hashed device LM context capped to %d chars (order-%d "
                "LM; int32 context packing)", table.k, lm.order)
        return table
    table, k1 = dense_fusion_table(lm, id_to_char, vocab_size, alpha,
                                   beta, context_size=context_size)
    if k1 < lm.order - 1:
        log.warning(
            "device LM context capped to %d chars (order-%d LM; table "
            "memory budget) — fusion uses shorter context than the "
            "host beam_fused path", k1, lm.order)
    return torch.from_numpy(table)


def rescore_nbest(nbest: List[Tuple[str, float]], lm, alpha: float,
                  beta: float, to_lm_text=None) -> List[Tuple[str, float]]:
    """Combine CTC scores with LM evidence over an n-best list.

    score = log P_ctc + alpha * log10 P_lm(text) + beta * |words|
    (the DS2 lineage's KenLM rescoring objective).

    ``to_lm_text`` maps a hypothesis to the token stream the LM expects
    — e.g. space-joining characters for Mandarin char-level LMs.
    """
    out = []
    for text, ctc_score in nbest:
        lm_text = to_lm_text(text) if to_lm_text else text
        words = lm_text.split()
        lm_score = lm.score_sentence(lm_text) if words else 0.0
        out.append((text, ctc_score + alpha * lm_score + beta * len(words)))
    out.sort(key=lambda kv: kv[1], reverse=True)
    return out
