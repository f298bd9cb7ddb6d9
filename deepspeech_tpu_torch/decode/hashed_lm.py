"""Hashed (sparse) on-device LM fusion table: trigram+ at large vocabs.

The port of the JAX package's ``decode/hashed_lm.py``. The dense fusion
table (``ngram.dense_fusion_table``) holds ``alpha*log10 P(v|ctx)+beta``
for every context, ``V^(k+1)`` floats: at AISHELL's V=4336 that caps
device fusion at bigrams. This table stores only the LM's n-grams in
open-addressing hash tables and resolves the Katz backoff chain on the
device at gather time, so its memory is O(#ngrams).

Layout (power-of-two sizes, linear probing with a max probe distance
checked at build):

- For each context length m = 0..k an n-gram table ``NG_m`` keyed by
  ``(ctx_m, w)`` -> ``alpha * log10 p`` and, for m >= 1, a backoff
  table ``BO_m`` keyed by ``ctx_m`` -> ``alpha * log10 backoff``.
- Symbols map to LM-token ids by a ``[V]`` lookup (``tok_of``): 0 =
  ``<s>`` / pre-start padding, 1..U = unigram tokens (with ``<unk>``
  when present), U+1 = a sentinel for characters the LM has never seen
  and cannot map to ``<unk>``; it matches no key (pure backoff).
- A context packs the last k token digits base ``B_tok``, oldest first.

Scoring a candidate (ctx, w), vectorised with no data-dependent control
flow::

    acc = 0; val = alpha*FLOOR; found = False
    for m = k..0:
        hit, v = probe(NG_m, ctx % B^m, w)
        val = where(hit & ~found, acc + v, val)
        found |= hit
        if m > 0 and not found: acc += probe(BO_m, ctx % B^m)  # 0 on miss
    bonus = (found ? val : alpha*FLOOR) + beta

The tables are built on the host in numpy and hold the JAX package's
arrays bit for bit. The probe's uint32 hash is computed in int64 with
``& 0xFFFFFFFF`` after every product, so it wraps as the JAX one does.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .ngram import BOS, EOS, NGramLM, OOV_FLOOR, UNK

# Distinct odd multipliers (not the same constant twice: with
# h = ka*C ^ kb*C every key with ka == kb would hash to 0).
_H1 = np.uint32(0x9E3779B1)  # golden ratio
_H2 = np.uint32(0x85EBCA6B)  # murmur3 fmix
_MASK = 0xFFFFFFFF
PROBES = 8


class HashedFusionTable:
    """Tensors of the hashed tables and the static layout for probing.

    ``bonus`` and ``push`` run where the tensors lie; ``to(device)``
    returns a copy on another device.
    """

    def __init__(self, tok_of, ng_keys_ctx, ng_keys_w, ng_vals,
                 bo_keys, bo_vals, *, k: int, b_tok: int,
                 alpha: float, beta: float):
        self.tok_of = tok_of            # [V] int64 symbol -> token id
        self.ng_keys_ctx = ng_keys_ctx  # list len k+1 of [S_m] int64
        self.ng_keys_w = ng_keys_w      # list len k+1 of [S_m] int64
        self.ng_vals = ng_vals          # list len k+1 of [S_m] f32
        self.bo_keys = bo_keys          # list len k of [T_m] int64 (m=1..k)
        self.bo_vals = bo_vals          # list len k of [T_m] f32
        self.k = k
        self.b_tok = b_tok
        self.alpha = alpha
        self.beta = beta

    @property
    def vocab_size(self) -> int:
        return len(self.tok_of)

    def to(self, device) -> "HashedFusionTable":
        def mv(xs):
            return [x.to(device) for x in xs]

        return HashedFusionTable(
            self.tok_of.to(device), mv(self.ng_keys_ctx),
            mv(self.ng_keys_w), mv(self.ng_vals), mv(self.bo_keys),
            mv(self.bo_vals), k=self.k, b_tok=self.b_tok, alpha=self.alpha,
            beta=self.beta)

    def nbytes(self) -> int:
        return sum(int(x.numel() * x.element_size()) for x in (
            self.tok_of, *self.ng_keys_ctx, *self.ng_keys_w, *self.ng_vals,
            *self.bo_keys, *self.bo_vals))

    # -- device ops -------------------------------------------------------

    @staticmethod
    def _probe(keys_a, keys_b, vals, ka, kb):
        """Vectorised open-address probe: (hit, value) for each (ka, kb),
        the value of the first of the ``PROBES`` slots from the hash on
        whose keys match. ``keys_b`` / ``kb`` None probes a single-key
        (backoff) table."""
        size = keys_a.shape[0]
        h = (ka * int(_H1)) & _MASK
        if kb is not None:
            h = h ^ ((kb * int(_H2)) & _MASK)
        idx = (h[..., None] + torch.arange(PROBES, device=ka.device)) % size
        ok = keys_a[idx] == ka[..., None]
        if kb is not None:
            ok &= keys_b[idx] == kb[..., None]
        hit = ok.any(-1)
        first = idx.gather(-1, ok.to(torch.uint8).argmax(-1, keepdim=True))
        return hit, torch.where(hit, vals[first[..., 0]], 0.0)

    def bonus(self, ctx: torch.Tensor, w_sym: torch.Tensor) -> torch.Tensor:
        """``alpha*log10 P(w|ctx) + beta`` for every (ctx[..., i],
        w_sym[..., j]) pair: ctx [..., W] packed token digits, w_sym
        [..., P] symbol ids with the same leading dims. Returns
        [..., W, P] f32, in place of the dense table's
        ``table[ctx[..., :, None], w_sym[..., None, :]]``."""
        wt = self.tok_of[w_sym][..., None, :]          # [..., 1, P]
        c = ctx[..., :, None]                          # [..., W, 1]
        shape = torch.broadcast_shapes(c.shape, wt.shape)
        c = c.expand(shape)
        wt = wt.expand(shape)
        acc = torch.zeros(shape, dtype=torch.float32, device=ctx.device)
        val = torch.full(shape, float(np.float32(self.alpha * OOV_FLOOR)),
                         dtype=torch.float32, device=ctx.device)
        found = torch.zeros(shape, dtype=torch.bool, device=ctx.device)
        for m in range(self.k, -1, -1):
            ctx_m = c % (self.b_tok ** m)
            hit, v = self._probe(self.ng_keys_ctx[m], self.ng_keys_w[m],
                                 self.ng_vals[m], ctx_m, wt)
            take = hit & ~found
            val = torch.where(take, acc + v, val)
            found |= hit
            if m > 0:
                bhit, bv = self._probe(self.bo_keys[m - 1], None,
                                       self.bo_vals[m - 1], ctx_m, None)
                acc = torch.where(found | ~bhit, acc, acc + bv)
        return val + float(np.float32(self.beta))

    def push(self, ctx: torch.Tensor, sym: torch.Tensor) -> torch.Tensor:
        """Roll symbol ``sym`` into packed context ``ctx`` (the oldest
        digit dropped first, so the packing stays under 2**31)."""
        if self.k == 0:
            return torch.zeros_like(ctx)
        kept = ctx % (self.b_tok ** max(self.k - 1, 0))
        return kept * self.b_tok + self.tok_of[sym]


def _build_table(entries: Dict, two_key: bool):
    """Open-addressing build (linear probing, max displacement <
    PROBES, checked). Load factor starts at 0.25; a failure doubles the
    table."""
    items = list(entries.items())
    n = len(items)
    if two_key:
        ka_arr = np.array([k[0] for k, _ in items], np.int64)
        kb_arr = np.array([k[1] for k, _ in items], np.int64)
    else:
        ka_arr = np.array([k for k, _ in items], np.int64)
        kb_arr = np.zeros((n,), np.int64)
    val_arr = np.array([v for _, v in items], np.float32)
    with np.errstate(over="ignore"):
        h_all = ka_arr.astype(np.uint32) * _H1
        if two_key:
            h_all = h_all ^ (kb_arr.astype(np.uint32) * _H2)
    # Keys sharing one full 32-bit hash can never spread, whatever the
    # table size: fail at once instead of doubling forever.
    if n:
        _, counts = np.unique(h_all, return_counts=True)
        if counts.max() > PROBES:
            raise RuntimeError(
                f"hash degeneracy: {int(counts.max())} keys share one "
                f"32-bit hash (> {PROBES} probes); the hash mix needs "
                f"changing for this key structure")
    size = 8
    while size < 4 * max(n, 1):
        size *= 2
    while True:
        keys_a = np.full((size,), -1, np.int32)
        keys_b = np.full((size,), -1, np.int32)
        vals = np.zeros((size,), np.float32)
        idx0 = (h_all % np.uint32(size)).astype(np.int64).tolist()
        ok = True
        for j, base in enumerate(idx0):
            for i in range(PROBES):
                idx = (base + i) % size
                if keys_a[idx] == -1:
                    keys_a[idx] = ka_arr[j]
                    keys_b[idx] = kb_arr[j]
                    vals[idx] = val_arr[j]
                    break
            else:
                ok = False
                break
        if ok:
            return keys_a, keys_b, vals
        size *= 2


def hashed_arrays(lm: NGramLM, id_to_char, vocab_size: int, alpha: float,
                  beta: float, context_size: int = 0):
    """The hashed tables as numpy arrays: ``(tok_of, ng [(ctx keys,
    word keys, values)] for m = 0..k, bo [(keys, values)] for m = 1..k,
    k, b_tok)``, equal to the JAX package's ``hashed_fusion_table``'s.

    ``context_size=0`` means ``lm.order - 1``, capped only by the int32
    packing bound; raises ValueError when ``B_tok ** k`` cannot fit
    int32 for an explicitly requested context."""
    unigrams = lm.ngrams.get(1, {})
    # Token inventory: 0 = <s>/pad; 1..U = unigram tokens except
    # <s>/</s>; U+1 = never-matching sentinel for unmappable chars.
    toks: List[str] = [w for (w,) in unigrams if w not in (BOS, EOS)]
    tok_id = {w: i + 1 for i, w in enumerate(toks)}
    tok_id[BOS] = 0
    b_tok = len(toks) + 2
    sentinel = len(toks) + 1

    def cap(k: int) -> int:
        while k > 0 and b_tok ** k >= 2 ** 31:
            k -= 1
        return k

    k_req = min(context_size if context_size > 0 else lm.order - 1,
                lm.order - 1)
    k = cap(k_req)
    if context_size > 0 and k < k_req:
        raise ValueError(
            f"hashed LM context {k_req} needs B_tok^{k_req} = "
            f"{b_tok ** k_req:,} packed contexts, over the int32 "
            f"bound; at {b_tok} LM tokens the maximum device context "
            f"is {cap(lm.order - 1)}")

    # Id 0 is the CTC blank: never queried as a word or pushed into a
    # context, so it keeps the sentinel and id_to_char is never asked.
    tok_of = np.full((vocab_size,), sentinel, np.int32)
    for d in range(1, vocab_size):
        ch = id_to_char(d)
        if ch in tok_id and ch not in (BOS, EOS):
            tok_of[d] = tok_id[ch]
        elif lm.has_unk:
            tok_of[d] = tok_id[UNK]

    def pack_ctx(words: Tuple[str, ...]):
        """Context tokens -> packed digits, oldest first; None when the
        context can never be queried at run time."""
        packed = 0
        for i, w in enumerate(words):
            if w == EOS:
                return None
            if w == BOS:
                if i != 0:  # <s> only ever leads a history
                    return None
                d = 0
            elif w in tok_id:
                d = tok_id[w]
            else:
                return None  # unreachable context token
            packed = packed * b_tok + d
        return packed

    ng: List[Dict] = [dict() for _ in range(k + 1)]
    bo: List[Dict] = [dict() for _ in range(k)]
    for grams in lm.ngrams.values():
        for gram, (logp, backoff) in grams.items():
            word, ctx = gram[-1], gram[:-1]
            if len(ctx) <= k and word in tok_id and word != BOS:
                packed = pack_ctx(ctx)
                if packed is not None:
                    ng[len(ctx)][(packed, int(tok_id[word]))] = \
                        np.float32(alpha * logp)
            # Backoff weights: the gram as the context of the next order.
            if backoff and 1 <= len(gram) <= k:
                packed = pack_ctx(gram)
                if packed is not None:
                    bo[len(gram) - 1][packed] = np.float32(alpha * backoff)

    ng_tables = [_build_table(ng[m], two_key=True) for m in range(k + 1)]
    bo_tables = [_build_table(bo[m], two_key=False)[::2] for m in range(k)]
    return tok_of, ng_tables, bo_tables, k, b_tok


def hashed_fusion_table(lm: NGramLM, id_to_char, vocab_size: int,
                        alpha: float, beta: float,
                        context_size: int = 0) -> HashedFusionTable:
    """A ``HashedFusionTable`` (on the CPU; ``.to(device)`` moves it)
    from an ``NGramLM``; the call shape of ``dense_fusion_table``."""
    tok_of, ng, bo, k, b_tok = hashed_arrays(
        lm, id_to_char, vocab_size, alpha, beta, context_size)

    def t(a):
        a = torch.from_numpy(np.asarray(a))
        return a.long() if a.dtype == torch.int32 else a

    return HashedFusionTable(
        t(tok_of), [t(a) for a, _, _ in ng], [t(b) for _, b, _ in ng],
        [t(v) for _, _, v in ng], [t(a) for a, _ in bo],
        [t(v) for _, v in bo], k=k, b_tok=b_tok, alpha=alpha, beta=beta)
