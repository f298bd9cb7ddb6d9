"""Greedy CTC decoding: argmax, collapse repeats, drop blanks.

Vectorized tensor code, so it runs where the log-probs are; only the
collapsed ids cross to the host for ``ids_to_texts``.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from ..data.tokenizer import CharTokenizer


def collapse_ids(best: torch.Tensor, lens: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """CTC-collapse per-frame ids [B, T] (frames >= lens ignored): drop
    repeats, then blanks (id 0). Returns (ids [B, T], out_lens [B]);
    ``ids[b, :out_lens[b]]`` is the label sequence, the tail is 0."""
    b, t = best.shape
    tmask = torch.arange(t, device=best.device)[None, :] < lens[:, None]
    prev = torch.cat([torch.zeros_like(best[:, :1]), best[:, :-1]], dim=1)
    keep = (best != 0) & (best != prev) & tmask
    pos = torch.cumsum(keep.long(), dim=1) - 1
    rows = torch.arange(b, device=best.device)[:, None].expand(b, t)
    out = torch.zeros_like(best)
    out[rows[keep], pos[keep]] = best[keep]
    return out, keep.sum(dim=1)


def greedy_decode(logits: torch.Tensor, lens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [B, T, V], lens [B] -> (ids [B, T], out_lens [B])."""
    return collapse_ids(torch.argmax(logits, dim=-1), lens)


def ids_to_texts(ids, out_lens, tokenizer: CharTokenizer) -> List[str]:
    ids = torch.as_tensor(ids).cpu().tolist()
    out_lens = torch.as_tensor(out_lens).cpu().tolist()
    return [tokenizer.decode(row[:n]) for row, n in zip(ids, out_lens)]
