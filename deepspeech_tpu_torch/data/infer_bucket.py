"""Shape-bucketed batch planning for inference.

Plans an inference request onto a small fixed ladder of ``(B, T)``
shapes, so short utterances do not pay long-utterance FLOPs and the set
of shapes the forward sees stays bounded.

The T rungs are the sampler's bucket edges (``data.bucket_frames``,
assigned by :func:`sampler.assign_buckets`); utterances beyond the
largest edge land on overflow rungs at multiples of the largest edge.
The B rungs are powers of two up to the request size, so a ragged
trailing group pads to the next rung instead of the full batch.

Plans are a pure function of ``(feat_lens, bucket_frames, max_batch)``.
Request order is recoverable from ``plan.indices``; :func:`unbucket`
reassembles per-utterance results.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence

import numpy as np

from .sampler import assign_buckets

Batch = Dict[str, np.ndarray]


@dataclass(frozen=True)
class InferBucketPlan:
    """One ladder-shaped sub-batch of an inference request.

    ``indices`` are positions into the REQUEST, in request order;
    ``len(indices)`` rows are real, rows padded up to ``batch_pad``
    repeat the last real row.
    """

    indices: np.ndarray  # [n_valid] int64 positions into the request
    batch_pad: int       # B rung: pad rows to this count
    bucket_frames: int   # T rung: pad frames to this count

    @property
    def n_valid(self) -> int:
        return len(self.indices)


def batch_rung(n: int, max_batch: int = 0) -> int:
    """Smallest power-of-two >= n, capped at ``max_batch`` when given
    (the cap is always a rung itself so a full batch never over-pads);
    ``max_batch=0`` leaves the ladder uncapped."""
    if n <= 0:
        raise ValueError(f"batch rung needs n >= 1, got {n}")
    if max_batch and n >= max_batch:
        return max_batch
    return 1 << (n - 1).bit_length()


def frame_rung(t: int, bucket_frames: Sequence[int]) -> int:
    """Smallest ladder edge >= t; beyond the largest edge, the next
    multiple of the largest edge (overflow rung)."""
    edges = sorted(bucket_frames)
    b = int(assign_buckets([max(t, 1)], edges)[0])
    if b < len(edges):
        return edges[b]
    top = edges[-1]
    return -(-t // top) * top


def ladder_shapes(bucket_frames: Sequence[int], max_batch: int
                  ) -> List[tuple]:
    """Every non-overflow ``(B, T)`` rung."""
    rungs, b = [], 1
    while b < max_batch:
        rungs.append(b)
        b <<= 1
    rungs.append(max_batch)
    return [(b, t) for t in sorted(bucket_frames) for b in sorted(set(rungs))]


def plan_infer_buckets(feat_lens, bucket_frames: Sequence[int],
                       max_batch: int,
                       rung_of=None) -> List[InferBucketPlan]:
    """Group a request's utterances into ladder-shaped sub-batches.

    Utterances keep request order within each T rung; each rung's run
    is chunked at ``max_batch`` and every chunk's B pads to its batch
    rung. Plans come out in ascending-T order.

    ``rung_of(feat_len) -> T`` overrides the T-rung choice. It must
    never return a rung SMALLER than the utterance's frame count.
    """
    lens = np.asarray(feat_lens, np.int64)
    if lens.ndim != 1 or len(lens) == 0:
        raise ValueError(f"feat_lens must be a non-empty 1-D sequence, "
                         f"got shape {lens.shape}")
    if rung_of is None:
        rung_of = lambda t: frame_rung(t, bucket_frames)  # noqa: E731
    by_rung: Dict[int, List[int]] = {}
    for i, t in enumerate(lens):
        rung = int(rung_of(int(t)))
        if rung < t:
            raise ValueError(f"rung_of returned T={rung} < feat_len={t}; "
                             "frames would be cropped")
        by_rung.setdefault(rung, []).append(i)
    plans = []
    for t_rung in sorted(by_rung):
        members = by_rung[t_rung]
        for start in range(0, len(members), max_batch):
            chunk = np.asarray(members[start:start + max_batch], np.int64)
            plans.append(InferBucketPlan(
                chunk, batch_rung(len(chunk), max_batch), t_rung))
    return plans


def slice_to_plan(batch: Batch, plan: InferBucketPlan) -> Batch:
    """Materialize one plan's sub-batch from a full mixed-length batch.

    Feature rows crop to the T rung (every selected row fits by
    construction) or zero-pad up to it, so the emitted shape is always
    exactly ``(batch_pad, bucket_frames, F)``. Missing rows repeat the
    last real row so decode paths never see a zero-length stream.
    """
    rows = plan.indices
    if plan.batch_pad > len(rows):
        rows = np.concatenate(
            [rows, np.full(plan.batch_pad - len(rows), rows[-1], np.int64)])
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)[rows]
        if k == "features":
            v = v[:, :plan.bucket_frames]
            if v.shape[1] < plan.bucket_frames:
                pad = ((0, 0), (0, plan.bucket_frames - v.shape[1])
                       ) + ((0, 0),) * (v.ndim - 2)
                v = np.pad(v, pad)
        out[k] = v
    return out


def unbucket(plans: Sequence[InferBucketPlan],
             per_plan_results: Sequence[Sequence]) -> List:
    """Reassemble per-utterance results into request order.

    ``per_plan_results[i]`` holds plan i's per-row results (padded rows
    beyond ``n_valid`` are ignored).
    """
    n = max(int(p.indices.max()) for p in plans) + 1
    out: List = [None] * n
    for plan, res in zip(plans, per_plan_results):
        for row, idx in enumerate(plan.indices):
            out[int(idx)] = res[row]
    return out


def padding_waste(feat_lens, plans: Sequence[InferBucketPlan]) -> float:
    """Fraction of computed frames that are padding under ``plans``:
    ``1 - sum(real frames) / sum(B_rung * T_rung)``."""
    lens = np.asarray(feat_lens, np.int64)
    computed = sum(p.batch_pad * p.bucket_frames for p in plans)
    real = int(sum(min(int(lens[i]), p.bucket_frames)
                   for p in plans for i in p.indices))
    return 1.0 - real / computed if computed else 0.0
