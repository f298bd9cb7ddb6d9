"""Greedy CTC decoding: argmax, collapse repeats, drop blanks.

Vectorized tensor code, so it runs where the log-probs are; only the
collapsed ids cross to the host for ``ids_to_texts``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..data.tokenizer import CharTokenizer


def _kept(best: torch.Tensor, lens: torch.Tensor):
    """The CTC collapse's bookkeeping for per-frame ids [B, T]: which
    frames emit a symbol (not blank, not a repeat, inside ``lens``),
    each frame's output slot, the row index and the length mask."""
    b, t = best.shape
    tmask = torch.arange(t, device=best.device)[None, :] < lens[:, None]
    prev = torch.cat([torch.zeros_like(best[:, :1]), best[:, :-1]], dim=1)
    keep = (best != 0) & (best != prev) & tmask
    pos = torch.cumsum(keep.long(), dim=1) - 1
    rows = torch.arange(b, device=best.device)[:, None].expand(b, t)
    return keep, pos, rows, tmask


def collapse_ids(best: torch.Tensor, lens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC-collapse per-frame ids [B, T] (frames >= lens ignored): drop
    repeats, then blanks (id 0). Returns (ids [B, T], out_lens [B]);
    ``ids[b, :out_lens[b]]`` is the label sequence, the tail is 0."""
    keep, pos, rows, _ = _kept(best, lens)
    out = torch.zeros_like(best)
    out[rows[keep], pos[keep]] = best[keep]
    return out, keep.sum(dim=1)


def collapse_ids_with_times(best: torch.Tensor, lens: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor, torch.Tensor]:
    """``collapse_ids`` plus each kept symbol's CTC alignment span.

    Returns (ids [B, T], out_lens [B], start [B, T], end [B, T]): start
    is the post-conv frame whose argmax first emitted the symbol, end the
    last frame of its repeat-run (inclusive; a blank ends the run). Past
    ``out_lens`` all three are 0. Callers turn frames into ms by the conv
    time stride times the hop.
    """
    b, t = best.shape
    keep, pos, rows, tmask = _kept(best, lens)
    ids = torch.zeros_like(best)
    ids[rows[keep], pos[keep]] = best[keep]
    frames = torch.arange(t, device=best.device)[None, :].expand(b, t)
    start = torch.zeros((b, t), dtype=torch.long, device=best.device)
    start[rows[keep], pos[keep]] = frames[keep]
    # Every frame of a run shares its head's output slot: the last one
    # is the run's end.
    run = (best != 0) & tmask
    end = torch.zeros((b * t,), dtype=torch.long, device=best.device)
    end.scatter_reduce_(0, (rows * t + pos)[run], frames[run], "amax")
    return ids, keep.sum(dim=1), start, end.view(b, t)


def greedy_decode(logits: torch.Tensor, lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, T, V], lens [B] -> (ids [B, T], out_lens [B])."""
    return collapse_ids(torch.argmax(logits, dim=-1), lens)


def ids_to_texts(ids, out_lens, tokenizer: CharTokenizer) -> List[str]:
    ids = torch.as_tensor(ids).cpu().tolist()
    out_lens = torch.as_tensor(out_lens).cpu().tolist()
    return [tokenizer.decode(row[:n]) for row, n in zip(ids, out_lens)]
