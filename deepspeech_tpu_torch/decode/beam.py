"""CTC prefix beam search on the device, batched, with optional LM fusion.

The port of the JAX package's ``decode/beam.py``: the whole search runs
as tensor ops where the log-probs are (the card, or the CPU when asked),
and only the finalized n-best ids cross to the host.

Design, as in the JAX package:

- Beam state is a struct of tensors ``[B, W, ...]``: prefixes
  ``[B, W, Lmax]``, lengths, rolling hashes (uint32 values held in
  int64), and the CTC log probs split into ``p_b`` (paths ending in
  blank) and ``p_nb`` (paths ending in the last symbol), plus the LM
  context index and bonus of on-device fusion.
- Each frame considers ``W * (P+1)`` candidates an utterance: one *stay*
  candidate a beam and ``P`` *extend* candidates over the frame's top-P
  non-blank symbols (one top-P over the chunk's ``[Tc, V]`` frames, made
  before the loop; P = V-1 is the exact search).
- Prefixes that become identical merge their mass, by one of two
  merges: ``match`` compares each extend's hash with the W current
  beams (``[W*P, W]``; only an extend can land on an existing prefix),
  ``sort`` orders all candidates by hash with a stable sort and takes a
  log-sum-exp over each run of equal hashes. ``merge_impl="auto"``
  means match at W <= 32 and sort above.
- The batch is vectorised across utterances; the loop over time is a
  Python loop over frames. Invalid frames (t >= length) pass the state
  through unchanged.

Where the port differs in means, not in result:

- **Ties.** ``lax.top_k`` keeps the lower index first among equal
  values, and every dead candidate scores ``NEG_INF``. ``torch.topk``
  promises no order among ties, so every selection here is a stable
  descending sort and its first W (or P) entries.
- **uint32.** The rolling hash wraps modulo 2**32 in the JAX package;
  here it is an int64 masked with ``& 0xFFFFFFFF`` after every product
  and sum, and the sort merge orders by that masked value.
- **Determinism.** The sort merge's segments are contiguous runs after
  the sort, so their max and sum are a segmented scan of fixed order
  (log2 steps of shifted elementwise ops) and their results are placed
  with scatters whose targets are unique. No atomic sum is used, so a
  step gives the same bits every time, on the card as on the CPU, and a
  chunked search equals the offline one bit for bit (the per-frame step
  is the same function on the same shapes).
- **No host sync inside the loop**: no ``.item()``, no boolean-mask
  indexing, no ``bool`` of a tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .hashed_lm import HashedFusionTable

NEG_INF = -1e30
_PRIME = 1000003
_SEED = 2166136261
_MASK = 0xFFFFFFFF


class BeamState(NamedTuple):
    prefixes: torch.Tensor  # [B, W, Lmax] int32
    lens: torch.Tensor      # [B, W] int32
    hashes: torch.Tensor    # [B, W] int64, uint32 values
    p_b: torch.Tensor       # [B, W] f32, log P(paths ending in blank)
    p_nb: torch.Tensor      # [B, W] f32, log P(paths ending in last symbol)
    # On-device LM fusion (zeros when no LM): the context index into the
    # fusion table and the accumulated alpha*logP_lm + beta*len bonus.
    ctx: torch.Tensor       # [B, W] int64
    bonus: torch.Tensor     # [B, W] f32


def _lse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(a, b)
    dead = m <= NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    out = m_safe + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))
    return torch.where(dead, NEG_INF, out)


def _top(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k`` over the last dim: the k largest, ties to the lower
    index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _Chunk:
    """What every frame of a chunk shares, made once before its loop:
    the candidates' parents and stay symbols, position ranges, and the
    zero pads of the segmented scans' shifts."""

    def __init__(self, b: int, w: int, p: int, max_len: int, dev):
        self.n = n = w * (p + 1)
        ar = torch.arange(w, device=dev)
        self.cand_parent = torch.cat([ar, ar.repeat_interleave(p)]
                                     ).expand(b, n)
        self.stay_sym = torch.full((b, w), -1, dtype=torch.long, device=dev)
        self.len_pos = torch.arange(max_len, device=dev)[None, None, :]
        self.pos = torch.arange(n, device=dev).expand(b, n)
        self.no_bonus = torch.zeros((b, n), device=dev)
        self.ks = [1 << j for j in range(max(n - 1, 1).bit_length())]
        self.pads = [torch.zeros((2, b, k), device=dev) for k in self.ks]


def _segment_scan(x: torch.Tensor, same, pads, op) -> torch.Tensor:
    """Inclusive scan of ``op`` within each run of equal segment ids,
    along the last dim of ``x`` [2, B, n]; ``same[j]`` is the mask
    "position i and i - 2**j lie in one segment" (Hillis-Steele, a fixed
    order of operations). The last position of a run holds the run's
    total."""
    for s, pad in zip(same, pads):
        k = pad.shape[-1]
        x = torch.where(s, op(x, torch.cat([pad, x[..., :-k]], -1)), x)
    return x


def _merge_sort(cand_pb, cand_pnb, cand_hash, cand_bonus, w: int,
                c: _Chunk):
    """The sort merge: a stable sort of the candidates by hash, a
    log-sum-exp over each run of equal hashes, the top W runs. Returns
    (best candidate [B, W], merged p_b, merged p_nb) of the W chosen."""
    b, n = cand_hash.shape
    order = torch.argsort(cand_hash, dim=1, stable=True)
    h_s = cand_hash.gather(1, order)
    new_seg = torch.ones((b, n), dtype=torch.bool, device=order.device)
    torch.ne(h_s[:, 1:], h_s[:, :-1], out=new_seg[:, 1:])
    seg_id = torch.cumsum(new_seg, dim=1) - 1
    is_end = torch.ones_like(new_seg)
    is_end[:, :-1] = new_seg[:, 1:]
    # How far each position lies past its run's first: the scans' masks.
    start = torch.cummax(torch.where(new_seg, c.pos, 0), dim=1).values
    dist = c.pos - start
    same = [dist >= k for k in c.ks]
    # Segment id -> its last and first sorted position; each target is
    # written once (the rest go to a discarded column n).
    end_of = torch.full((b, n + 1), n - 1, dtype=torch.long,
                        device=order.device)
    end_of.scatter_(1, torch.where(is_end, seg_id, n), c.pos)
    rep = torch.full((b, n + 1), n - 1, dtype=torch.long,
                     device=order.device)
    rep.scatter_(1, torch.where(new_seg, seg_id, n), c.pos)
    rep = rep[:, :n]
    end_i = end_of.gather(1, seg_id)

    x = torch.stack([cand_pb.gather(1, order), cand_pnb.gather(1, order)])
    seg_max = _segment_scan(x, same, c.pads, torch.maximum)
    m = seg_max.gather(2, end_i.expand(2, b, n))
    dead = m <= NEG_INF
    m_safe = torch.where(dead, 0.0, m)
    # Each run's max element contributes exactly 1, so the sum is >= 1
    # where the run is live; a dead run's sum is masked below.
    s = _segment_scan(torch.exp(x - m_safe), same, c.pads, torch.add)
    merged = torch.where(dead, NEG_INF,
                         m_safe + torch.log(torch.clamp(s, min=1e-38)))
    # Place each run's result at its segment id; empty ids stay dead.
    out = torch.full((2, b, n + 1), NEG_INF, dtype=merged.dtype,
                     device=order.device)
    out.scatter_(2, torch.where(is_end, seg_id, n).expand(2, b, n), merged)
    merged_pb, merged_pnb = out[0, :, :n], out[1, :, :n]
    merged_total = _lse(merged_pb, merged_pnb)
    seg_bonus = cand_bonus.gather(1, order).gather(1, rep)
    _, best_seg = _top(torch.where(merged_total <= NEG_INF, NEG_INF,
                                   merged_total + seg_bonus), w)
    best = order.gather(1, rep.gather(1, best_seg))
    return (best, merged_pb.gather(1, best_seg),
            merged_pnb.gather(1, best_seg))


def _merge_match(stay_pb, stay_pnb, ext_pnb, ext_hash, hashes, cand_bonus,
                 w: int):
    """The match merge: each extend is compared with the W current
    prefixes ([W*P, W]); a matched extend's mass moves into its stay
    twin (at most one target an extend). Returns (best, p_b, p_nb)."""
    b = stay_pb.shape[0]
    ext_flat = ext_pnb.reshape(b, -1)                         # [B, W*P]
    match = ext_hash.reshape(b, -1)[:, :, None] == hashes[:, None, :]
    first = match & (torch.cumsum(match, dim=2) == 1)        # [B, W*P, W]
    moved_max = torch.where(first, ext_flat[:, :, None], NEG_INF).amax(1)
    m_w = torch.maximum(stay_pnb, moved_max)
    m_safe = torch.where(m_w <= NEG_INF, 0.0, m_w)
    moved = torch.where(first,
                        torch.exp(ext_flat[:, :, None] - m_safe[:, None, :]),
                        0.0).sum(dim=1)
    ssum = torch.exp(stay_pnb - m_safe) + moved
    stay_pnb = torch.where(ssum > 0, m_safe + torch.log(ssum), NEG_INF)
    ext_flat = torch.where(match.any(dim=2), NEG_INF, ext_flat)
    cand_pb = torch.cat([stay_pb, torch.full_like(ext_flat, NEG_INF)], 1)
    cand_pnb = torch.cat([stay_pnb, ext_flat], 1)
    cand_total = _lse(cand_pb, cand_pnb)
    _, best = _top(torch.where(cand_total <= NEG_INF, NEG_INF,
                               cand_total + cand_bonus), w)
    return best, cand_pb.gather(1, best), cand_pnb.gather(1, best)


def _step(state: BeamState, lp, valid, top_lp, top_v, *, blank_id: int,
          lm_table=None, merge: str = "match",
          c: Optional[_Chunk] = None) -> BeamState:
    """One frame for the batch: lp [B, V] log-softmax frame, valid [B]
    bool, top_lp / top_v [B, P] the frame's top-P non-blank symbols;
    ``c`` the chunk's shared tensors (made here when not given)."""
    b, w, max_len = state.prefixes.shape
    p = top_v.shape[1]
    if c is None:
        c = _Chunk(b, w, p, max_len, lp.device)
    lens = state.lens.long()
    has_last = lens > 0
    last = torch.where(
        has_last,
        state.prefixes.gather(2, (lens - 1).clamp(min=0)[:, :, None])
        .squeeze(2).long(), -1)
    lp_last = torch.where(has_last, lp.gather(1, last.clamp(min=0)),
                          NEG_INF)
    total = _lse(state.p_b, state.p_nb)                       # [B, W]

    # Stay candidates (one a beam): same prefix, same hash.
    stay_pb = total + lp[:, blank_id:blank_id + 1]
    stay_pnb = torch.where(has_last, state.p_nb + lp_last, NEG_INF)

    # Extend candidates: [B, W, P], beam w extended with top_v[p].
    is_last = top_v[:, None, :] == last[:, :, None]
    ext_pnb = torch.where(is_last, state.p_b[:, :, None],
                          total[:, :, None]) + top_lp[:, None, :]
    # Extending past Lmax is not representable; drop such candidates.
    ext_pnb = torch.where((lens < max_len)[:, :, None], ext_pnb, NEG_INF)
    ext_hash = (state.hashes[:, :, None] * _PRIME
                + top_v[:, None, :]) & _MASK

    cand_sym = torch.cat([c.stay_sym,
                          top_v[:, None, :].expand(b, w, p).reshape(b, -1)],
                         1)
    if lm_table is not None:
        # The bonus of the prefix each candidate results in (a function
        # of the prefix, so a merged extend and its stay twin agree on
        # it); stays keep their own.
        if isinstance(lm_table, HashedFusionTable):
            lm_add = lm_table.bonus(state.ctx, top_v)           # [B, W, P]
        else:
            lm_add = lm_table[state.ctx[:, :, None], top_v[:, None, :]]
        cand_bonus = torch.cat(
            [state.bonus, (state.bonus[:, :, None] + lm_add).reshape(b, -1)],
            1)
    else:
        cand_bonus = c.no_bonus

    if merge == "match":
        best, sel_pb, sel_pnb = _merge_match(
            stay_pb, stay_pnb, ext_pnb, ext_hash, state.hashes, cand_bonus,
            w)
    else:
        best, sel_pb, sel_pnb = _merge_sort(
            torch.cat([stay_pb, torch.full((b, w * p), NEG_INF,
                                           dtype=lp.dtype, device=lp.device)],
                      1),
            torch.cat([stay_pnb, ext_pnb.reshape(b, -1)], 1),
            torch.cat([state.hashes, ext_hash.reshape(b, -1)], 1),
            cand_bonus, w, c)
    parent = c.cand_parent.gather(1, best)
    sym = cand_sym.gather(1, best)

    new_prefixes = state.prefixes.gather(
        1, parent[:, :, None].expand(b, w, max_len))
    plen = lens.gather(1, parent)
    is_ext = sym >= 0
    sym0 = sym.clamp(min=0)
    # Append sym at position plen for extend candidates.
    onehot = (c.len_pos == plen[:, :, None]) & is_ext[:, :, None]
    new_prefixes = torch.where(onehot, sym[:, :, None].to(torch.int32),
                               new_prefixes)
    ctx_parent = state.ctx.gather(1, parent)
    if lm_table is not None:
        if isinstance(lm_table, HashedFusionTable):
            pushed = lm_table.push(ctx_parent, sym0)
        else:
            pushed = (ctx_parent * lm_table.shape[1] + sym0) \
                % lm_table.shape[0]
        new_ctx = torch.where(is_ext, pushed, ctx_parent)
        new_bonus = cand_bonus.gather(1, best)
    else:
        new_ctx = ctx_parent
        new_bonus = state.bonus.gather(1, parent)
    hash_parent = state.hashes.gather(1, parent)
    new = BeamState(
        prefixes=new_prefixes,
        lens=(plen + is_ext).to(torch.int32),
        hashes=torch.where(is_ext, (hash_parent * _PRIME + sym0) & _MASK,
                           hash_parent),
        p_b=sel_pb, p_nb=sel_pnb, ctx=new_ctx, bonus=new_bonus)
    # Dead beams keep NEG_INF scores; an extend that merges into one
    # revives that prefix with exactly the extend's mass.
    return BeamState(*(
        torch.where(valid.reshape((b,) + (1,) * (n.dim() - 1)), n, o)
        for n, o in zip(new, state)))


def beam_init(batch: int, beam_width: int, max_len: int,
              device=None) -> BeamState:
    """Batched initial beam state ([B, W, ...]) for chunked decoding
    (``beam_search_chunk``), on ``device`` (default: the CPU)."""
    b, w = batch, beam_width
    p_b = torch.full((b, w), NEG_INF, device=device)
    p_b[:, 0] = 0.0
    return BeamState(
        prefixes=torch.zeros((b, w, max_len), dtype=torch.int32,
                             device=device),
        lens=torch.zeros((b, w), dtype=torch.int32, device=device),
        hashes=torch.full((b, w), _SEED, dtype=torch.long, device=device),
        p_b=p_b,
        p_nb=torch.full((b, w), NEG_INF, device=device),
        ctx=torch.zeros((b, w), dtype=torch.long, device=device),
        bonus=torch.zeros((b, w), device=device),
    )


def _resolve_merge(merge_impl: str, beam_width: int) -> str:
    """'auto' -> match at W <= 32, sort above (the JAX package's split,
    which follows its measurements at W=16 and W=128). Both give the
    same result up to log-sum-exp rounding."""
    if merge_impl == "auto":
        return "match" if beam_width <= 32 else "sort"
    if merge_impl not in ("sort", "match"):
        raise ValueError(f"merge_impl {merge_impl!r} not in "
                         f"('auto', 'sort', 'match')")
    return merge_impl


def _lm_vocab(lm_table) -> int:
    if isinstance(lm_table, HashedFusionTable):
        return lm_table.vocab_size
    return lm_table.shape[1]


def beam_search_chunk(state: BeamState, log_probs: torch.Tensor,
                      valid: torch.Tensor, prune_top_k: int = 40,
                      blank_id: int = 0, lm_table=None,
                      merge_impl: str = "auto") -> BeamState:
    """Advance a batched beam state over one chunk of frames.

    The streaming counterpart of ``beam_search``: chunks scanned through
    this function give the same bits as one offline search over the
    concatenated frames (the per-frame step is the same function).

    Args:
      state: [B, W, ...] beam state (``beam_init`` / previous chunk), on
        the device of ``log_probs``.
      log_probs: [B, Tc, V] log-softmax frames of this chunk.
      valid: [B, Tc] bool; False frames (padding) leave the state as is.
      prune_top_k / blank_id / lm_table / merge_impl: as ``beam_search``.
    """
    b, tc, v = log_probs.shape
    p = min(prune_top_k, v - 1)
    w = state.lens.shape[1]
    if lm_table is not None and _lm_vocab(lm_table) != v:
        raise ValueError(f"lm_table vocab {_lm_vocab(lm_table)} != {v}")
    merge = _resolve_merge(merge_impl, w)
    lp = log_probs.float()
    valid = torch.as_tensor(valid, device=lp.device).bool()
    # Top-P vocab pruning for the whole chunk, blank masked so every
    # selected symbol is a real extension.
    masked = lp.clone()
    masked[:, :, blank_id] = NEG_INF
    top_lp, top_v = _top(masked, p)
    c = _Chunk(b, w, p, state.prefixes.shape[2], lp.device)
    for t in range(tc):
        state = _step(state, lp[:, t], valid[:, t], top_lp[:, t],
                      top_v[:, t], blank_id=blank_id, lm_table=lm_table,
                      merge=merge, c=c)
    return state


def beam_finalize(state: BeamState
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(prefixes [B, W, Lmax] int32, lens [B, W] int32, scores [B, W]
    f32) sorted best-first by the total (fused, with an LM) score."""
    b, w, max_len = state.prefixes.shape
    total = _lse(state.p_b, state.p_nb)
    fused = torch.where(total <= NEG_INF, NEG_INF, total + state.bonus)
    scores, idx = _top(fused, w)
    return (state.prefixes.gather(1, idx[:, :, None].expand(b, w, max_len)),
            state.lens.gather(1, idx), scores)


def beam_search(log_probs: torch.Tensor, lengths, beam_width: int = 64,
                prune_top_k: int = 40, blank_id: int = 0, max_len: int = 0,
                lm_table=None, merge_impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched CTC prefix beam search where ``log_probs`` lie, with
    optional on-device LM fusion.

    Args:
      log_probs: [B, T, V] log-softmax model outputs.
      lengths: [B] valid frame counts (a tensor or host array).
      beam_width: beams kept an utterance.
      prune_top_k: vocab symbols considered a frame; V-1 is exact.
      blank_id: the CTC blank (0 here).
      max_len: longest decoded label sequence; 0 means T.
      lm_table: a dense ``[V**k, V]`` fusion table
        (``ngram.dense_fusion_table``, as a tensor) or a
        ``HashedFusionTable``, on the device of ``log_probs``; beams are
        ranked by log P_ctc + alpha*log10 P_lm + beta*len. None: the
        acoustic search alone.
      merge_impl: "auto", "sort" or "match".

    Returns:
      (prefixes [B, W, Lmax] int32, lens [B, W] int32, scores [B, W]
      f32, fused when ``lm_table`` is given), best first.
    """
    b, t, _ = log_probs.shape
    dev = log_probs.device
    state = beam_init(b, beam_width, max_len if max_len else t, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    valid = torch.arange(t, device=dev)[None, :] < lengths[:, None]
    state = beam_search_chunk(state, log_probs, valid,
                              prune_top_k=prune_top_k, blank_id=blank_id,
                              lm_table=lm_table, merge_impl=merge_impl)
    return beam_finalize(state)


def state_rows(state: BeamState, row: int) -> BeamState:
    """One utterance's rows of ``state`` as host numpy arrays (the
    decoder part of a session snapshot)."""
    return BeamState(*(f[row].detach().cpu().numpy().copy() for f in state))


def set_rows(state: BeamState, row: int, rows: BeamState) -> None:
    """Write host rows (``state_rows``) into ``state`` at ``row``."""
    with torch.no_grad():
        for f, r in zip(state, rows):
            f[row] = torch.as_tensor(r).to(f.device, f.dtype)


def reset_rows(state: BeamState, mask: torch.Tensor,
               fresh: Optional[BeamState] = None) -> BeamState:
    """``state`` with the rows where ``mask`` [B] is True set to a fresh
    search's."""
    b, w, max_len = state.prefixes.shape
    if fresh is None:
        fresh = beam_init(b, w, max_len, device=state.lens.device)
    mask = mask.to(state.lens.device)
    return BeamState(*(
        torch.where(mask.reshape((b,) + (1,) * (cur.dim() - 1)), ini, cur)
        for cur, ini in zip(state, fresh)))
